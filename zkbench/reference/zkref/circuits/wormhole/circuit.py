"""Wormhole circuit assembly.

Port of wormhole/circuit/src/circuit.rs: builds the four
fragments and connects shared targets — nullifier.secret ≡
unspendable.secret, nullifier.transfer_count ≡ leaf.transfer_count,
unspendable.account_id ≡ leaf.to_account (circuit.rs:111-137)."""

from __future__ import annotations

from dataclasses import dataclass

from ...iop.builder import CircuitBuilder
from ...plonk.config import CircuitConfig
from .nullifier import Nullifier, NullifierTargets
from .storage_proof import StorageProof, StorageProofTargets
from .substrate_account import ExitAccountTargets, SubstrateAccount
from .unspendable_account import UnspendableAccount, UnspendableAccountTargets


@dataclass
class CircuitTargets:
    nullifier: NullifierTargets
    unspendable_account: UnspendableAccountTargets
    storage_proof: StorageProofTargets
    exit_account: ExitAccountTargets

    @staticmethod
    def new(builder: CircuitBuilder) -> "CircuitTargets":
        return CircuitTargets(
            nullifier=NullifierTargets.new(builder),
            unspendable_account=UnspendableAccountTargets.new(builder),
            storage_proof=StorageProofTargets.new(builder),
            exit_account=ExitAccountTargets.new(builder),
        )


class WormholeCircuit:
    """Builds the full wormhole circuit; default config matches the
    reference's standard_recursion_zk_config default (circuit.rs:68-73)."""

    def __init__(self, config: CircuitConfig | None = None):
        self.config = config or CircuitConfig.standard_recursion_zk_config()
        self.builder = CircuitBuilder(self.config)
        self._targets = CircuitTargets.new(self.builder)
        Nullifier.circuit(self._targets.nullifier, self.builder)
        UnspendableAccount.circuit(self._targets.unspendable_account, self.builder)
        StorageProof.circuit(self._targets.storage_proof, self.builder)
        SubstrateAccount.circuit(self._targets.exit_account, self.builder)
        self._connect_shared_targets()

    def targets(self) -> CircuitTargets:
        return self._targets

    def _connect_shared_targets(self):
        t = self._targets
        b = self.builder
        for a, bb in zip(t.nullifier.secret, t.unspendable_account.secret):
            b.connect(a, bb)
        for a, bb in zip(
            t.nullifier.transfer_count, t.storage_proof.leaf_inputs.transfer_count
        ):
            b.connect(a, bb)
        b.connect_hashes(
            t.unspendable_account.account_id, t.storage_proof.leaf_inputs.to_account
        )

    def build_circuit(self, device="cuda"):
        return self.builder.build(device)
