"""Exit-account fragment.

Port of wormhole/circuit/src/substrate_account.rs: the
circuit is a no-op — it exists solely to register the exit account as 4
public-input felts, binding the withdrawal address into the proof."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...iop.builder import CircuitBuilder
from ...iop.targets import HashOutTarget
from ...iop.witness import PartialWitness
from ...utils import codecs


@dataclass
class SubstrateAccount:
    account_id: np.ndarray  # Digest (4,)

    @staticmethod
    def from_bytes(address: bytes) -> "SubstrateAccount":
        codecs.validate_bytes_digest(bytes(address))
        return SubstrateAccount(codecs.digest_bytes_to_felts(bytes(address)))

    def to_bytes(self) -> bytes:
        return codecs.digest_felts_to_bytes(self.account_id)

    @staticmethod
    def circuit(t: "ExitAccountTargets", builder: CircuitBuilder) -> None:
        """Intentionally empty (substrate_account.rs:88)."""

    def fill_targets(self, pw: PartialWitness, t: "ExitAccountTargets") -> None:
        pw.set_hash_target(t.address, self.account_id)


@dataclass
class ExitAccountTargets:
    address: HashOutTarget

    @staticmethod
    def new(builder: CircuitBuilder) -> "ExitAccountTargets":
        return ExitAccountTargets(address=builder.add_virtual_hash_public_input())
