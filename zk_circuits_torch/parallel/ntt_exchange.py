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

Over a mesh with named axes the vector is split over ``axis`` (a name or
a tuple of names covering every axis, in any order: block b sits on the
shard whose coordinates along them are b, row-major), so a hybrid
(dcn, ici) mesh in one process is the flattened 1-D four-step over its
shards.  When the mesh spans processes, each exchange runs in two parts:
the blocks that shards of other processes will read cross in one
``torch.distributed.all_to_all_single`` into local staging tensors
(parallel/distributed.py; the counterpart of the collective GSPMD inserts
over DCN in the JAX package), and K2's fused mode then runs over sources
that are all local, filling this process's shards only.
"""

from __future__ import annotations

import torch

from ..ntt import ntt as nttm
from . import exchange_cuda
from .mesh import Mesh, flatten


def all_to_all_blocks(xs: list) -> list:
    """Shard d enters with ``xs[d]`` of shape (E, B) (or (E, rows, row_len))
    and leaves with ``out[d][s] = xs[s][d]``: the block transpose of the
    global (E, E, B) tensor."""
    return exchange_cuda.exchange(xs)


def _check(xs: list, mesh: Mesh) -> tuple[int, int]:
    e = mesh.size
    local = [mesh.devices[i] for i in mesh.local]
    if len(xs) != len(local) or any(x.device != d for x, d in zip(xs, local)):
        raise ValueError(f"expected one shard on each of {local}, got "
                         f"{[str(x.device) for x in xs]}")
    m = xs[0].shape[-1]
    if any(x.dim() != 1 or x.shape[0] != m for x in xs) or m % e:
        raise ValueError(f"expected {len(local)} 1-D shards of one length divisible "
                         f"by E={e}, got {[tuple(x.shape) for x in xs]}")
    return e * m, m


class _Hop:
    """One process's part of an exchange over a mesh that spans
    processes: the sources of all E blocks (its own, and staged copies of
    the others' holding what its shards read) and its destinations."""

    def __init__(self, mesh: Mesh, axis):
        blocks = mesh.block_index(axis)
        self.e = mesh.size
        self.owner = [0] * self.e          # the process holding block b
        self.device = [None] * self.e      # ... on its shard's device
        for i, b in enumerate(blocks):
            self.owner[b], self.device[b] = mesh.processes[i], mesh.devices[i]
        self.me = mesh.process
        self.procs = sorted(set(mesh.processes))
        self.held = [blocks[i] for i in mesh.local]        # local order
        self.dst = [(b, self.device[b]) for b in self.held]
        self.stage = mesh.first
        self._index: dict = {}

    def blocks_of(self, p: int) -> list:
        return [b for b in range(self.e) if self.owner[b] == p]

    def reads(self, p: int, length: int, inverse_interleave: bool) -> torch.Tensor:
        """The flat positions of a source that process p's destinations
        read, in block order: d's block of ``length // E`` (exchange 3 of
        the inverse reads it reversed mod length)."""
        key = (p, length, inverse_interleave)
        if key not in self._index:
            bm = length // self.e
            idx = torch.cat([torch.arange(d * bm, (d + 1) * bm) for d in self.blocks_of(p)])
            if inverse_interleave:
                idx = (length - idx) % length
            self._index[key] = idx.to(self.stage)
        return self._index[key]

    def sources(self, held: list, inverse_interleave: bool = False) -> list:
        """``held`` (this process's sources, local order) -> the E
        sources in block order: its own as they are, the others' staged
        on the first local device with the positions this process reads
        filled (one collective for all of them)."""
        from .distributed import all_to_all

        own = dict(zip(self.held, held))
        shape, length = held[0].shape, held[0].numel()
        mine = self.blocks_of(self.me)
        send, recv_sizes = [], []
        for p in self.procs:
            if p == self.me:
                send.append(held[0].new_empty(0))
                recv_sizes.append(0)
                continue
            idx = self.reads(p, length, inverse_interleave)
            send.append(torch.stack([own[b].reshape(-1).to(self.stage)[idx] for b in mine]))
            recv_sizes.append(len(self.blocks_of(p)) * len(self.reads(
                self.me, length, inverse_interleave)))
        got = all_to_all(send, recv_sizes, self.stage)
        idx = self.reads(self.me, length, inverse_interleave)
        out = [own.get(b) for b in range(self.e)]
        for p, chunk in zip(self.procs, got):
            if p == self.me:
                continue
            for b, part in zip(self.blocks_of(p), chunk.view(-1, idx.numel())):
                staged = torch.empty(length, dtype=torch.int64, device=self.stage)
                staged[idx] = part
                out[b] = staged.view(shape)
        return out


def _four_step(xs: list, mesh: Mesh, inverse: bool, axis=None) -> list:
    """Block-sharded coefficient slices in (this process's shards, in
    mesh order), the same slices of the transform out (natural order; the
    inverse scaled by n^-1).  Same math as the JAX package's
    ``_four_step_local``, shard by shard: K2's three fused modes around
    the local row NTT, with no torch field operation between the
    exchanges on CUDA shards."""
    n, m = _check(xs, mesh)
    e = mesh.size
    bm = m // e
    if mesh.spans_processes:
        if set(mesh.axes(axis)) != set(mesh.axis_names):
            raise ValueError(f"the four-step splits the vector over every axis of the "
                             f"mesh {mesh.axis_names}, got {axis!r}")
        hop = _Hop(mesh, axis)
        y_t = exchange_cuda.exchange_dft(
            hop.sources([x.reshape(e, bm) for x in xs]), inverse, hop.dst)
        z = exchange_cuda.exchange_twiddle(hop.sources(y_t), n, inverse, hop.dst)
        zt = [nttm.ntt(row) for row in z]
        return exchange_cuda.exchange_interleave(hop.sources(zt, inverse), inverse, hop.dst)
    _, blocks = flatten(mesh, axis)     # one process: the shards in block order
    out = _four_step_1d([xs[blocks.index(b)] for b in range(e)], n, inverse)
    return [out[b] for b in blocks]


def _four_step_1d(xs: list, n: int, inverse: bool) -> list:
    """The four-step over E shards holding blocks 0..E-1 in order."""
    e = len(xs)
    bm = n // e // e
    # exchange 1 + the size-E DFT: shard d holds y^T's rows d*bm..
    y_t = exchange_cuda.exchange_dft([x.reshape(e, bm) for x in xs], inverse)
    # exchange 2 + twiddle: shard d holds z[d, :] = y[d, :] * T[d, :]
    z = exchange_cuda.exchange_twiddle(y_t, n, inverse)
    # the local row NTT: Z[d, :]
    zt = [nttm.ntt(row) for row in z]
    # exchange 3 + interleave to t1-minor order (the inverse: reversed, / n)
    return exchange_cuda.exchange_interleave(zt, inverse)


def ntt_sharded_pallas(xs: list, mesh: Mesh, axis=None) -> list:
    """Distributed NTT of a block-sharded vector (n divisible by E^2)."""
    return _four_step(xs, mesh, inverse=False, axis=axis)


def intt_sharded_pallas(xs: list, mesh: Mesh, axis=None) -> list:
    """Distributed inverse NTT (natural order in and out)."""
    return _four_step(xs, mesh, inverse=True, axis=axis)
