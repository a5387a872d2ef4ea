"""The four-step NTT over a shard mesh with K2 as its stage exchange.

Counterpart of the JAX package's parallel/ntt_exchange.py.  A length-n
vector is block-sharded over E shards (shard d holds x[d*m:(d+1)*m],
m = n/E) and transformed as

    y[t1, :]  = sum_s1 w_E^(s1*t1) * A[s1, :]     (size-E DFT across shards)
    z         = y * T,  T[t1, s0] = w_n^(s0*t1)   (local twiddle)
    Z[t1, :]  = NTT_m(z[t1, :])                    (local row NTT)
    X[t1+E*t2] = Z[t1, t2]                         (global transpose)

with A[s1, s0] = x[s1*m + s0].  Every cross-shard move is the block
all-to-all ``all_to_all_blocks``: three per transform.  On CUDA shards it
is the hand-written kernel (parallel/exchange_cuda.py, K2); on CPU shards
its plain version.  The JAX package's lo|hi packing (the exchange moved
two u32 limbs) is gone: a field element is one int64 here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..host import gl
from ..ntt import ntt as nttm
from . import exchange_cuda
from .mesh import Mesh
from .ntt_sharded import _dft_matrix_e, _twiddle_matrix

_TABLES: dict = {}


def all_to_all_blocks(xs: list) -> list:
    """Shard d enters with ``xs[d]`` of shape (E, B) (or (E, rows, row_len))
    and leaves with ``out[d][s] = xs[s][d]``: the block transpose of the
    global (E, E, B) tensor."""
    return exchange_cuda.exchange(xs)


def _check(xs: list, mesh: Mesh) -> tuple[int, int]:
    e = mesh.size
    if len(xs) != e or any(x.device != d for x, d in zip(xs, mesh.devices)):
        raise ValueError(f"expected one shard on each of {mesh.devices}, got "
                         f"{[str(x.device) for x in xs]}")
    m = xs[0].shape[-1]
    if any(x.dim() != 1 or x.shape[0] != m for x in xs) or m % e:
        raise ValueError(f"expected E={e} 1-D shards of one length divisible "
                         f"by E, got {[tuple(x.shape) for x in xs]}")
    return e * m, m


def _twiddle_row(n: int, e: int, inverse: bool, d: int, device) -> torch.Tensor:
    key = (n, e, inverse, d, str(device))
    if key not in _TABLES:
        _TABLES[key] = gfd.from_u64(_twiddle_matrix(n, e, inverse)[d], device)
    return _TABLES[key]


def _four_step(xs: list, mesh: Mesh, inverse: bool) -> list:
    """Block-sharded coefficient slices in, the same slices of the
    transform out (natural order).  Same math as the JAX package's
    ``_four_step_local``, shard by shard."""
    n, m = _check(xs, mesh)
    e = mesh.size
    bm = m // e
    w = _dft_matrix_e(e, inverse)
    # exchange 1: shard d gets r[s] = A[s, d-slice]
    r = all_to_all_blocks([x.reshape(e, bm) for x in xs])
    # size-E DFT across the now-local shard axis: row t1 = sum_s W[s,t1] r[s]
    y_t = []
    for rd in r:
        rows = []
        for t1 in range(e):
            acc = gfd.mul_const(rd[0], int(w[0, t1]))
            for s1 in range(1, e):
                acc = gfd.add(acc, gfd.mul_const(rd[s1], int(w[s1, t1])))
            rows.append(acc)
        y_t.append(torch.stack(rows))
    # exchange 2: back to rows, shard d holds y[d, :]
    r2 = all_to_all_blocks(y_t)
    big = []
    for d, rd in enumerate(r2):
        z = gfd.mul(rd.reshape(m), _twiddle_row(n, e, inverse, d, rd.device))
        zt = nttm.ntt(z)                                    # Z[d, :]
        if inverse:   # NTT_{w^-1}(x)[k] = NTT_w(x)[-k mod m]
            zt = torch.cat([zt[:1], zt[1:].flip(0)])
        big.append(zt.reshape(e, bm))
    # exchange 3: r3[t1] = Z[t1, d-slice]; interleave to t1-minor order
    r3 = all_to_all_blocks(big)
    return [rd.t().reshape(m) for rd in r3]


def ntt_sharded_pallas(xs: list, mesh: Mesh) -> list:
    """Distributed NTT of a block-sharded vector (n divisible by E^2)."""
    return _four_step(xs, mesh, inverse=False)


def intt_sharded_pallas(xs: list, mesh: Mesh) -> list:
    """Distributed inverse NTT (natural order in and out)."""
    n, _ = _check(xs, mesh)
    n_inv = int(gl.inverse(np.uint64(n)))
    return [gfd.mul_const(y, n_inv) for y in _four_step(xs, mesh, inverse=True)]
