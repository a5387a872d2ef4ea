"""Leaf-hash entry points of the Poseidon sponge kernel (K1).

Counterpart of the JAX package's hash/poseidon_pallas.py.  On the H100
the kernel is csrc/poseidon_leaf.cu, reached through hash/poseidon_cuda.py;
on the CPU the same calls run the plain torch sponge (hash/poseidon.py).
Unlike the TPU kernel, any row count is accepted (the ragged edge is
masked), so there is no ``available_for`` gate.
"""

from __future__ import annotations

import torch

from . import poseidon_cuda


def hash_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """(n, cols) row-major leaf matrix -> (n, 4) digests (hash_no_pad)."""
    return poseidon_cuda.hash_rows(leaves)


def hash_values(values: torch.Tensor) -> torch.Tensor:
    """Column-major variant: values (cols, n), leaf row i = values[:, i]
    -> (n, 4) row digests, read in place (no transpose is materialised)."""
    return poseidon_cuda.hash_rows(values.t())
