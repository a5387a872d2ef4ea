"""The leaf and tree hashes of the Merkle commits in plain PyTorch: the
torch sponge of hash/poseidon.py over rows, on any device."""

from __future__ import annotations

import torch

from .poseidon import batch_hash_no_pad, batch_hash_or_noop


def hash_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """(n, cols) row-major leaf matrix -> (n, 4) digests (hash_no_pad)."""
    return batch_hash_no_pad(leaves)


def hash_values(values: torch.Tensor) -> torch.Tensor:
    """Column-major variant: values (cols, n), leaf row i = values[:, i]."""
    return batch_hash_no_pad(values.t())


def hash_tree(x: torch.Tensor, cap_height: int) -> list:
    """Every level of the Merkle tree over the rows of ``x`` (..., n, cols):
    the leaf digests (hash_or_noop of each row), then one compress level at
    a time up to the cap (2^cap_height digests)."""
    n = x.shape[-2]
    if n < (1 << cap_height) or n & (n - 1):
        raise ValueError(f"{n} leaves: need a power of two >= 2^{cap_height}")
    levels = [batch_hash_or_noop(x)]
    while levels[-1].shape[-2] > (1 << cap_height):
        cur = levels[-1]
        levels.append(batch_hash_no_pad(cur.reshape(*cur.shape[:-2], cur.shape[-2] // 2, 8)))
    return levels
