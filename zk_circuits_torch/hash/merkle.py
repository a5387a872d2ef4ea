"""Merkle tree with cap (Poseidon two-to-one), host + torch builders.

Semantics match the reference engine's MerkleTree/MerkleCap: leaf digest =
hash_or_noop(leaf vector), internal nodes = compress(left, right), and the
``cap`` is the set of 2^cap_height subtree roots.  A proof for leaf i is the
sibling digest path up to the cap (verified against
cap[i >> (height - cap_height)]).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..host import poseidon as hposeidon
from . import poseidon_pallas as pp
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
            cur = levels[-1]
            levels.append(hposeidon.compress(cur[0::2], cur[1::2]))
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


def _compress_levels(levels: list, cap_height: int) -> list:
    """Append compress levels up to the cap.  compress(l, r) is
    hash_no_pad(l || r) for 8 felts, so a level (m, 4) viewed row-major as
    (m/2, 8) is one more leaf-kernel launch."""
    while levels[-1].shape[0] > (1 << cap_height):
        cur = levels[-1]
        levels.append(pp.hash_leaves(cur.reshape(cur.shape[0] // 2, 8)))
    return levels


def device_merkle_levels(leaves: torch.Tensor, cap_height: int) -> list:
    """Tree builder on tensors: leaves (n, cols) row-major -> every level
    (leaf digests first, cap last) as (m, 4) int64 tensors.  The leaf level
    goes through the sponge kernel for cols > 4 (hash_or_noop pads
    narrower rows)."""
    n, cols = leaves.shape
    assert n & (n - 1) == 0 and n >= (1 << cap_height)
    if cols > 4:
        first = pp.hash_leaves(leaves)
    else:
        first = batch_hash_or_noop(leaves)
    return _compress_levels([first], cap_height)


def device_merkle_levels_values(values: torch.Tensor, cap_height: int) -> list:
    """Like :func:`device_merkle_levels` but takes the leaf matrix
    COLUMN-MAJOR -- ``values`` (cols, n), leaf row i = values[:, i] -- the
    natural orientation of the LDE output, hashed in place."""
    cols, n = values.shape
    assert n & (n - 1) == 0 and n >= (1 << cap_height)
    if cols > 4:
        first = pp.hash_values(values)
    else:
        first = batch_hash_or_noop(values.t())
    return _compress_levels([first], cap_height)
