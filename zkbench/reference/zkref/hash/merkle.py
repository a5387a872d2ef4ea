"""Merkle tree with cap (Poseidon two-to-one), host + torch builders.

Semantics match the reference engine's MerkleTree/MerkleCap: leaf digest =
hash_or_noop(leaf vector), internal nodes = compress(left, right), and the
``cap`` is the set of 2^cap_height subtree roots.  A proof for leaf i is the
sibling digest path up to the cap (verified against
cap[i >> (height - cap_height)]).  ``MerkleTree.build`` hashes on the host
in the host runtime (zk_circuits_torch.native).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..host import poseidon as hposeidon
from . import poseidon_plain as pp
from .poseidon import batch_hash_or_noop


@dataclass
class MerkleTree:
    """Host-side tree: levels[0] = leaf digests (n, 4) ... levels[-1] = cap."""

    leaves: np.ndarray  # (n, leaf_len) u64
    cap_height: int
    levels: list  # list of (m, 4) u64 arrays

    @property
    def cap(self) -> np.ndarray:
        return self.levels[-1]

    @staticmethod
    def build(leaves: np.ndarray, cap_height: int, leaf_digests: np.ndarray | None = None) -> "MerkleTree":
        n = leaves.shape[0]
        assert n & (n - 1) == 0 and n >= (1 << cap_height)
        if leaf_digests is None:
            if leaves.shape[1] <= 4:
                leaf_digests = np.zeros((n, 4), dtype=np.uint64)
                leaf_digests[:, : leaves.shape[1]] = leaves
            else:
                leaf_digests = hposeidon.batch_hash_no_pad(leaves)
        levels = [leaf_digests]
        while levels[-1].shape[0] > (1 << cap_height):
            levels.append(hposeidon.batch_hash_no_pad(levels[-1].reshape(-1, 8)))
        return MerkleTree(leaves, cap_height, levels)

    def prove(self, index: int) -> list[np.ndarray]:
        """Sibling digests from leaf level up to (excluding) the cap."""
        siblings = []
        i = index
        for level in self.levels[:-1]:
            siblings.append(level[i ^ 1].copy())
            i >>= 1
        return siblings


def verify_merkle_proof(
    leaf: np.ndarray, index: int, cap: np.ndarray, siblings: list[np.ndarray]
) -> bool:
    """Verify leaf (vector of felts) against the cap."""
    current = hposeidon.hash_or_noop(np.asarray(leaf, dtype=np.uint64))
    i = index
    for sib in siblings:
        if i & 1:
            current = hposeidon.compress(sib, current)
        else:
            current = hposeidon.compress(current, sib)
        i >>= 1
    return bool(np.array_equal(current, cap[i]))


def device_merkle_levels(leaves: torch.Tensor, cap_height: int) -> list:
    """Tree builder on tensors: leaves (n, cols) row-major -> every level
    (leaf digests first, cap last) as (m, 4) int64 tensors, through K1's
    tree mode (hash_or_noop of narrower rows pads them).  A batch of
    trees, leaves (B, n, cols), gives levels (B, m, 4) from the same
    launches."""
    n = leaves.shape[-2]
    assert n & (n - 1) == 0 and n >= (1 << cap_height)
    return pp.hash_tree(leaves, cap_height)


def leaf_digests(leaves: torch.Tensor) -> torch.Tensor:
    """hash_or_noop of every row of the row-major (n, cols) leaf matrix:
    the sponge kernel for cols > 4, zero padding below."""
    if leaves.shape[1] > 4:
        return pp.hash_leaves(leaves)
    return batch_hash_or_noop(leaves)


def device_merkle_levels_values(values: torch.Tensor, cap_height: int) -> list:
    """Like :func:`device_merkle_levels` but takes the leaf matrix
    COLUMN-MAJOR -- ``values`` (cols, n), leaf row i = values[:, i] -- the
    natural orientation of the LDE output, hashed in place; a batch
    (B, cols, n) too."""
    n = values.shape[-1]
    assert n & (n - 1) == 0 and n >= (1 << cap_height)
    return pp.hash_tree(values.transpose(-1, -2), cap_height)

