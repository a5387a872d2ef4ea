"""The four-step NTT over a shard mesh with K2 as its stage exchange.

Counterpart of the JAX package's parallel/ntt_exchange.py.  A length-n
vector is block-sharded over E shards (shard d holds x[d*m:(d+1)*m],
m = n/E) and transformed as

    y[t1, :]  = sum_s1 w_E^(s1*t1) * A[s1, :]     (size-E DFT across shards)
    z         = y * T,  T[t1, s0] = w_n^(s0*t1)   (local twiddle)
    Z[t1, :]  = NTT_m(z[t1, :])                    (local row NTT)
    X[t1+E*t2] = Z[t1, t2]                         (global transpose)

with A[s1, s0] = x[s1*m + s0].  Every cross-shard move is a block
all-to-all, three per transform, each with the arithmetic around it fused
in: the DFT into the first, the twiddle into the second, the transpose to
natural order (and the inverse's reversal and n^-1) into the third.  On
CUDA shards they are the hand-written kernel's modes (parallel/
exchange_cuda.py, K2); on CPU shards their plain versions.  The JAX
package's lo|hi packing (the exchange moved two u32 limbs) is gone: a
field element is one int64 here.  ``all_to_all_blocks`` is the bare
exchange (commit re-shards, FRI fiber regroups).
"""

from __future__ import annotations

from ..ntt import ntt as nttm
from . import exchange_cuda
from .mesh import Mesh


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


def _four_step(xs: list, mesh: Mesh, inverse: bool) -> list:
    """Block-sharded coefficient slices in, the same slices of the
    transform out (natural order; the inverse scaled by n^-1).  Same math
    as the JAX package's ``_four_step_local``, shard by shard: K2's three
    fused modes around the local row NTT, with no torch field operation
    between the exchanges on CUDA shards."""
    n, m = _check(xs, mesh)
    e = mesh.size
    # exchange 1 + the size-E DFT: shard d holds y^T's rows d*bm..
    y_t = exchange_cuda.exchange_dft([x.reshape(e, m // e) for x in xs], inverse)
    # exchange 2 + twiddle: shard d holds z[d, :] = y[d, :] * T[d, :]
    z = exchange_cuda.exchange_twiddle(y_t, n, inverse)
    # the local row NTT: Z[d, :]
    zt = [nttm.ntt(row) for row in z]
    # exchange 3 + interleave to t1-minor order (the inverse: reversed, / n)
    return exchange_cuda.exchange_interleave(zt, inverse)


def ntt_sharded_pallas(xs: list, mesh: Mesh) -> list:
    """Distributed NTT of a block-sharded vector (n divisible by E^2)."""
    return _four_step(xs, mesh, inverse=False)


def intt_sharded_pallas(xs: list, mesh: Mesh) -> list:
    """Distributed inverse NTT (natural order in and out)."""
    return _four_step(xs, mesh, inverse=True)
