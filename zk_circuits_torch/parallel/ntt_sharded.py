"""Distributed NTT, coset LDE and batch LDE over a shard mesh.

Counterpart of the JAX package's parallel/ntt_sharded.py.  There the
four-step's transposes were left to GSPMD; here there is no partitioner,
so ``ntt_sharded``/``intt_sharded`` are the same explicit four-step as
parallel/ntt_exchange.py (one body, both names), and every transpose is
the block exchange K2.  Each function takes the JAX version's ``axis``:
a name or a tuple of names of the mesh (``("dcn", "ici")`` on the hybrid
mesh of parallel/distributed.py; ``_axis_size`` counts its blocks).

- ``coset_lde_sharded``: one long polynomial, block-sharded; scale by
  shift^k, zero-pad by 2^rate_bits, four-step NTT.
- ``lde_batch_sharded``: many polynomials, the POLY axis sharded; each
  shard extends its own polynomials, with no communication.
"""

from __future__ import annotations

import functools

import numpy as np

from ..field import goldilocks as gfd
from ..host import gl
from ..ntt import ntt as nttm
from .mesh import Mesh, _axis_size, flatten, reshard  # noqa: F401  (_axis_size: the JAX name)


@functools.lru_cache(maxsize=None)
def _dft_matrix_e(n_dev: int, inverse: bool) -> np.ndarray:
    """Small dense DFT matrix W[s1, t1] = w_E^{±s1·t1} as host u64."""
    w = gl.primitive_root_of_unity(n_dev.bit_length() - 1)
    if inverse:
        w = pow(w, gl.P_INT - 2, gl.P_INT)
    return np.array(
        [[pow(w, j * k, gl.P_INT) for k in range(n_dev)] for j in range(n_dev)],
        dtype=np.uint64,
    )


@functools.lru_cache(maxsize=8)
def _twiddle_matrix(n: int, n_dev: int, inverse: bool) -> np.ndarray:
    """T[t1, s0] = w_n^{±s0·t1}, shape (E, n/E), host u64."""
    m = n // n_dev
    w = gl.primitive_root_of_unity(n.bit_length() - 1)
    if inverse:
        w = pow(w, gl.P_INT - 2, gl.P_INT)
    t = np.empty((n_dev, m), dtype=np.uint64)
    for t1 in range(n_dev):
        t[t1] = gl.powers(np.uint64(pow(w, t1, gl.P_INT)), m)
    return t


def ntt_sharded(xs: list, mesh: Mesh, axis=None) -> list:
    """Distributed NTT of a vector split over ``axis`` (a name or a tuple
    of names covering every axis of the mesh; all of them by default):
    ``xs`` holds this process's shards."""
    from .ntt_exchange import ntt_sharded_pallas

    return ntt_sharded_pallas(xs, mesh, axis)


def intt_sharded(xs: list, mesh: Mesh, axis=None) -> list:
    """Distributed inverse NTT (natural order in and out)."""
    from .ntt_exchange import intt_sharded_pallas

    return intt_sharded_pallas(xs, mesh, axis)


def coset_ntt_pieces(pieces: list, shift: int, size: int, mesh: Mesh) -> list:
    """Evaluate the coefficients ``pieces`` (1-D, in order, on any shards)
    on the coset shift*<w_size> over a 1-D one-process mesh: zero-pad to
    ``size``, block-shard, scale each block by its slice of shift^k,
    four-step NTT."""
    blocks = reshard(pieces, size, mesh)
    b = size // mesh.size
    scaled = [gfd.mul(x, nttm.powers(shift, size, x.device)[d * b:(d + 1) * b])
              for d, x in enumerate(blocks)]
    return ntt_sharded(scaled, mesh)


def coset_lde_sharded(coeffs: list, rate_bits: int, mesh: Mesh, axis=None,
                      shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> list:
    """Distributed low-degree extension of one long polynomial split over
    ``axis`` (every axis of a one-process mesh): scale by shift^k,
    zero-pad 2^rate_bits, distributed NTT."""
    flat, blocks = flatten(mesh, axis)
    n = sum(c.shape[-1] for c in coeffs)
    out = coset_ntt_pieces([coeffs[blocks.index(b)] for b in range(mesh.size)], shift,
                           n << rate_bits, flat)
    return [out[b] for b in blocks]


def lde_batch_sharded(coeffs: list, rate_bits: int, mesh: Mesh, axis=None,
                      shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> list:
    """Batch-parallel LDE: the polynomial axis split over ``axis`` (every
    axis by default; ``"dcn"`` alone over hosts), each of this process's
    shards holding (k, n) polynomials and extending them on its own
    device.  No communication; shards that hold one block on one device
    (copies along the other axes) share one result."""
    if len(coeffs) != len(mesh.local):
        raise ValueError(f"expected {len(mesh.local)} shards, got {len(coeffs)}")
    mesh.axes(axis)
    done: dict = {}
    for c in coeffs:
        if id(c) not in done:
            done[id(c)] = nttm.lde(c, rate_bits, shift)
    return [done[id(c)] for c in coeffs]
