"""WormholeProver — the user-facing proving API.

Port of wormhole/prover/src/lib.rs: construct (fresh build
on ``device``, from given circuit data, or from the artifacts that
api/artifacts.py writes), ``commit(inputs)`` converts the inputs into
the four fragment structs and fills their targets (commit-once semantics),
``prove()`` produces the proof."""

from __future__ import annotations

from ..circuits.wormhole.circuit import WormholeCircuit
from ..circuits.wormhole.inputs import CircuitInputs
from ..circuits.wormhole.nullifier import Nullifier
from ..circuits.wormhole.storage_proof import StorageProof
from ..circuits.wormhole.substrate_account import SubstrateAccount
from ..circuits.wormhole.unspendable_account import UnspendableAccount
from ..iop.witness import PartialWitness
from ..plonk.config import CircuitConfig


class WormholeProver:
    def __init__(self, config: CircuitConfig | None = None, circuit_data=None,
                 targets=None, device="cuda"):
        if circuit_data is None:
            from .. import resolve_device

            device = resolve_device(device)
            circuit = WormholeCircuit(config)
            targets = circuit.targets()
            circuit_data = circuit.build_circuit(device)
        self.circuit_data = circuit_data
        self.targets = targets
        self.partial_witness = PartialWitness()
        self._committed = False

    @staticmethod
    def new_from_files(prover_path, common_path, device="cuda") -> "WormholeProver":
        """The prover of the circuit whose prover.bin and common.bin are at
        these paths, its device state made on ``device``."""
        from .artifacts import load_prover

        return load_prover(prover_path, common_path, device)

    def commit(self, inputs: CircuitInputs) -> "WormholeProver":
        """Fill all fragment targets from the inputs (consumes the targets —
        commit may only run once, prover/src/lib.rs:209-225)."""
        if self._committed or self.targets is None:
            raise RuntimeError("prover already committed")
        t = self.targets
        pw = self.partial_witness
        Nullifier.from_inputs(inputs).fill_targets(pw, t.nullifier)
        StorageProof.from_inputs(inputs).fill_targets(pw, t.storage_proof)
        UnspendableAccount.from_inputs(inputs).fill_targets(pw, t.unspendable_account)
        SubstrateAccount.from_bytes(inputs.public.exit_account).fill_targets(
            pw, t.exit_account
        )
        self._committed = True
        return self

    def prove(self, check_witness: bool | None = None, device="cuda"):
        if not self._committed:
            raise RuntimeError("commit inputs before proving")
        return self.circuit_data.prove(self.partial_witness,
                                       check_witness=check_witness,
                                       device=device)
