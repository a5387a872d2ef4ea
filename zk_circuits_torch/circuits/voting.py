"""Anonymous voting circuit: Merkle membership of a private key + a
double-vote-preventing nullifier.

Port of voting/src/lib.rs (semantics and public-input
layout identical): public inputs are proposal_id (4), merkle_root (4),
vote (1), nullifier (4); the Merkle path supports variable depth up to
MAX_MERKLE_DEPTH=32 with is_const_less_than-gated levels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..host import poseidon as hposeidon
from ..iop.builder import CircuitBuilder
from ..iop.targets import BoolTarget, HashOutTarget
from ..iop.witness import PartialWitness
from .fragment import is_const_less_than

MAX_MERKLE_DEPTH = 32  # voting/src/lib.rs:20

ZERO_DIGEST = np.zeros(4, dtype=np.uint64)


@dataclass
class VotePublicInputs:
    proposal_id: np.ndarray   # Digest (4,)
    merkle_root: np.ndarray   # Digest (4,)
    vote: bool
    nullifier: np.ndarray     # Digest (4,)


@dataclass
class VotePrivateInputs:
    private_key: np.ndarray          # (4,)
    merkle_siblings: list            # list of Digest
    path_indices: list               # list of bool
    actual_merkle_depth: int


@dataclass
class VoteTargets:
    proposal_id: HashOutTarget
    expected_merkle_root: HashOutTarget
    vote: BoolTarget
    expected_nullifier: HashOutTarget
    private_key: HashOutTarget
    merkle_siblings: list
    path_indices: list
    actual_merkle_depth: int

    @staticmethod
    def new(builder: CircuitBuilder) -> "VoteTargets":
        proposal_id = builder.add_virtual_hash_public_input()
        expected_merkle_root = builder.add_virtual_hash_public_input()
        vote = builder.add_virtual_bool_target_safe()
        builder.register_public_input(vote.target)
        expected_nullifier = builder.add_virtual_hash_public_input()
        private_key = builder.add_virtual_hash()
        merkle_siblings = [builder.add_virtual_hash() for _ in range(MAX_MERKLE_DEPTH)]
        path_indices = [
            builder.add_virtual_bool_target_safe() for _ in range(MAX_MERKLE_DEPTH)
        ]
        actual_merkle_depth = builder.add_virtual_target()
        return VoteTargets(
            proposal_id, expected_merkle_root, vote, expected_nullifier,
            private_key, merkle_siblings, path_indices, actual_merkle_depth,
        )


@dataclass
class VoteCircuitData:
    public_inputs: VotePublicInputs
    private_inputs: VotePrivateInputs

    @staticmethod
    def circuit(t: VoteTargets, builder: CircuitBuilder) -> None:
        # 1. Merkle membership (voting/src/lib.rs:123-179)
        leaf_hash = builder.hash_n_to_hash_no_pad(list(t.private_key.elements))
        current = leaf_hash
        n_log = (MAX_MERKLE_DEPTH - 1).bit_length()
        for i in range(MAX_MERKLE_DEPTH):
            is_active = is_const_less_than(builder, i, t.actual_merkle_depth, n_log)
            sibling = t.merkle_siblings[i]
            path_bit = t.path_indices[i]
            left = [
                builder.select(path_bit, sibling.elements[k], current.elements[k])
                for k in range(4)
            ]
            right = [
                builder.select(path_bit, current.elements[k], sibling.elements[k])
                for k in range(4)
            ]
            parent = builder.hash_n_to_hash_no_pad(left + right)
            nxt = [
                builder.select(is_active, parent.elements[k], current.elements[k])
                for k in range(4)
            ]
            current = HashOutTarget.from_list(nxt)
        builder.connect_hashes(current, t.expected_merkle_root)

        # 2. Nullifier = H(leaf_hash ‖ proposal_id) (lib.rs:181-192)
        nullifier = builder.hash_n_to_hash_no_pad(
            list(leaf_hash.elements) + list(t.proposal_id.elements)
        )
        builder.connect_hashes(nullifier, t.expected_nullifier)

    def fill_targets(self, pw: PartialWitness, t: VoteTargets) -> None:
        priv = self.private_inputs
        if priv.actual_merkle_depth > MAX_MERKLE_DEPTH:
            raise ValueError(
                f"Merkle tree depth {priv.actual_merkle_depth} exceeds maximum "
                f"allowed depth {MAX_MERKLE_DEPTH}"
            )
        if len(priv.merkle_siblings) != len(priv.path_indices):
            raise ValueError(
                f"Merkle proof length mismatch: {len(priv.merkle_siblings)} "
                f"siblings vs {len(priv.path_indices)} path indices"
            )
        pub = self.public_inputs
        pw.set_hash_target(t.proposal_id, pub.proposal_id)
        pw.set_hash_target(t.expected_merkle_root, pub.merkle_root)
        pw.set_bool_target(t.vote, pub.vote)
        pw.set_hash_target(t.expected_nullifier, pub.nullifier)
        pw.set_hash_target(t.private_key, priv.private_key)
        pw.set_target(t.actual_merkle_depth, priv.actual_merkle_depth)
        for i in range(MAX_MERKLE_DEPTH):
            if i < priv.actual_merkle_depth:
                pw.set_hash_target(t.merkle_siblings[i], priv.merkle_siblings[i])
                pw.set_bool_target(t.path_indices[i], priv.path_indices[i])
            else:
                pw.set_hash_target(t.merkle_siblings[i], ZERO_DIGEST)
                pw.set_bool_target(t.path_indices[i], False)


def compute_nullifier(private_key: np.ndarray, proposal_id: np.ndarray) -> np.ndarray:
    """Out-of-circuit nullifier (voting/src/lib.rs:277-283)."""
    pk_hash = hposeidon.hash_no_pad(np.asarray(private_key, dtype=np.uint64))
    inp = np.concatenate([pk_hash, np.asarray(proposal_id, dtype=np.uint64)])
    return hposeidon.hash_no_pad(inp)
