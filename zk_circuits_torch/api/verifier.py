"""WormholeVerifier — the user-facing verification API.

Port of wormhole/verifier/src/lib.rs: verification is host-side (numpy
only), cheap enough for on-chain-style environments.  Built from circuit
data, from its parts, or from the common.bin and verifier.bin that
api/artifacts.py writes, it stays on the host: ``from_parts``,
``new_from_files`` and ``verify`` touch no device.  Built from a config,
it builds the wormhole circuit on ``device`` (the card by default), which
commits the constants and sigmas there."""

from __future__ import annotations

from ..plonk.config import CircuitConfig
from ..plonk.verifier import verify as plonk_verify


class WormholeVerifier:
    def __init__(self, config: CircuitConfig | None = None, circuit_data=None,
                 device="cuda"):
        if circuit_data is None:
            from .. import resolve_device
            from ..circuits.wormhole.circuit import WormholeCircuit

            device = resolve_device(device)
            circuit_data = WormholeCircuit(config).build_circuit(device)
        self.common = circuit_data.common
        self.verifier_only = circuit_data.verifier_only

    @staticmethod
    def from_parts(common, verifier_only) -> "WormholeVerifier":
        v = WormholeVerifier.__new__(WormholeVerifier)
        v.common = common
        v.verifier_only = verifier_only
        return v

    @staticmethod
    def new_from_files(verifier_path, common_path) -> "WormholeVerifier":
        from .artifacts import load_verifier

        return load_verifier(verifier_path, common_path)

    def verify(self, proof_with_pis) -> None:
        plonk_verify(self.common, self.verifier_only, proof_with_pis)
