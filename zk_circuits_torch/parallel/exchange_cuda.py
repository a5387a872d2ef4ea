"""Wrapper of the Hopper block exchange kernel (csrc/block_exchange.cu), K2.

Replaces the JAX package's ``parallel/ntt_exchange.py::_exchange_kernel``:
a block all-to-all over E shards.  Every shard s hands an ``(E, B)`` or
``(E, rows, row_len)`` view ``x_s``; afterwards shard d holds
``out_d[s] = x_s[d]`` -- the transpose of the two leading axes of the global
``(E, E, ...)`` tensor -- as a contiguous tensor on ``x_d``'s device.

Four modes, one launch per card each (``launches``, and
``launches_by_mode`` and ``launches_by_device``):

- ``exchange`` (``copy``): the all-to-all itself (commit re-shards, FRI
  fiber regroups).
- ``exchange_dft``: the four-step's exchange 1 and its size-E DFT across
  the now-local shard axis.
- ``exchange_twiddle``: exchange 2 and the twiddle multiply.
- ``exchange_interleave``: exchange 3, the t1-minor interleave and, for
  the inverse transform, the index reversal and the n^-1 scaling.

Every mode takes ``dst``, the destination shards to fill (their
indices and devices; by default every source's own): in a mesh that
spans processes, parallel/ntt_exchange.py stages the blocks of the other
processes' shards locally and asks for its own shards only.  Each has
its plain PyTorch version here (``exchange_plain``,
``dft_plain``, ``twiddle_plain``, ``interleave_plain``): the plain
exchange followed by the torch arithmetic the mode absorbs (``dft_local``,
``twiddle_local``, ``interleave_in`` / ``interleave_out``).  A CPU tensor
goes to the plain version; a CUDA tensor goes to the kernel or raises --
there is no fallback.  Bound on the H100: bytes; see the kernel source.

The TPU kernel's start barrier and DMA semaphores become stream order:
across cards each destination stream waits on an event recorded on every
source's current stream before its launch, and every source stream waits
on the destination's completion event after it, so the caching allocator
cannot hand a source buffer to new work while a peer still reads it.
Shards on one card share one stream and need neither.  Sources on another
card are read through peer pointers; the wrapper enables peer access and
raises if the hardware has none.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..host import gl
from ..utils.nvcc import build_library
from .ntt_sharded import _dft_matrix_e, _twiddle_matrix

MAX_SHARDS = 32
MODES = ("copy", "dft", "twiddle", "interleave")

# Launches of the CUDA kernel in this process (the plain versions on CPU
# tensors are not counted): in all, by mode and by card.
launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)
launches_by_device: dict = {}
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build and the counters, shared by threads
_PEERS: set = set()
_TABLES: dict = {}


class _Call(ctypes.Structure):
    """ctypes mirror of csrc/block_exchange.cuh's BxCall."""

    _fields_ = [("src", ctypes.c_void_p * MAX_SHARDS),
                ("dst", ctypes.c_void_p * MAX_SHARDS),
                ("table", ctypes.c_void_p),
                ("blk_stride", ctypes.c_longlong), ("rows", ctypes.c_longlong),
                ("row_len", ctypes.c_longlong), ("row_stride", ctypes.c_longlong),
                ("bm", ctypes.c_longlong), ("scale", ctypes.c_ulonglong),
                ("dst_index", ctypes.c_int * MAX_SHARDS),
                ("mode", ctypes.c_int), ("n_src", ctypes.c_int), ("n_dst", ctypes.c_int),
                ("inverse", ctypes.c_int), ("tw_log", ctypes.c_int),
                ("wshift", ctypes.c_ubyte * (MAX_SHARDS * MAX_SHARDS))]


def reset_launches() -> None:
    global launches
    with _LOCK:
        launches = 0
        for k in launches_by_mode:
            launches_by_mode[k] = 0
        launches_by_device.clear()


def _count(mode: str, device) -> None:
    global launches
    with _LOCK:
        launches += 1
        launches_by_mode[mode] += 1
        launches_by_device[str(device)] = launches_by_device.get(str(device), 0) + 1


def build() -> Path:
    """Compile csrc/block_exchange.cu (cached by the hash of its sources);
    returns the library's path."""
    global build_log
    lib, log = build_library("block_exchange", "block_exchange.cu",
                             headers=("block_exchange.cuh", "goldilocks.cuh"))
    if log:
        build_log = log
    return lib


def _lib():
    """The built library, built and loaded once (under a lock: callers on
    several threads may ask at once)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.block_exchange.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.block_exchange.restype = ctypes.c_int
            lib.block_exchange_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.block_exchange_enable_peer.restype = ctypes.c_int
            lib.block_exchange_call_size.restype = ctypes.c_int
            if lib.block_exchange_call_size() != ctypes.sizeof(_Call):
                raise RuntimeError(f"BxCall is {lib.block_exchange_call_size()} bytes in "
                                   f"the library, {ctypes.sizeof(_Call)} in its ctypes mirror")
            _LIB = lib
    return _LIB


# --- checks -------------------------------------------------------------------


def _check(xs: list, dims=(2, 3)) -> None:
    if not xs:
        raise ValueError("no shards")
    e, x0 = len(xs), xs[0]
    shape = x0.shape
    if x0.dim() not in dims or (x0.dim() > 1 and shape[0] != e) or any(
            x.dtype != torch.int64 or x.shape != shape for x in xs):
        raise ValueError(f"expected {e} int64 shards of one shape, "
                         f"{' or '.join(f'{d}-D' for d in dims)}"
                         f"{f', ({e}, ...)' if dims != (1,) else ''}; got "
                         f"{[(t.dtype, tuple(t.shape)) for t in xs]}")
    cuda = x0.is_cuda
    if any(x.is_cuda != cuda for x in xs) or not (cuda or x0.device.type == "cpu"):
        raise ValueError(f"shards must all lie on the CPU or all on CUDA: "
                         f"{[str(x.device) for x in xs]}")


def _check_fused(xs: list, dims: tuple) -> tuple[int, int]:
    """The four-step's shards: (E, bm) blocks (dims (2,)) or (m,) rows
    (dims (1,)), E and m powers of two; returns (E, m)."""
    _check(xs, dims)
    e = len(xs)
    m = xs[0].numel()
    if e & (e - 1) or m & (m - 1) or m % e:
        raise ValueError(f"the four-step needs E and m powers of two, E | m; got "
                         f"E={e}, m={m}")
    return e, m


# --- plain versions -------------------------------------------------------------


def _dst(xs: list, dst) -> list:
    """The destinations (index, device) to fill: by default every
    source's own."""
    if dst is None:
        return [(d, x.device) for d, x in enumerate(xs)]
    dst = [(int(d), torch.device(dev)) for d, dev in dst]
    if not dst or any(not 0 <= d < len(xs) for d, _ in dst):
        raise ValueError(f"destinations {dst} outside the {len(xs)} shards")
    return dst


def exchange_plain(xs: list, dst=None) -> list:
    """The plain PyTorch version: out_d = stack_s(x_s[d] moved to d)."""
    _check(xs)
    return [torch.stack([x[d].to(dev) for x in xs]) for d, dev in _dst(xs, dst)]


def dft_local(r: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The size-E DFT of one shard's exchanged blocks r (E, bm): row t1 =
    sum_s W[s, t1] r[s]."""
    e = r.shape[0]
    w = _dft_matrix_e(e, inverse)
    rows = []
    for t1 in range(e):
        acc = gfd.mul_const(r[0], int(w[0, t1]))
        for s1 in range(1, e):
            acc = gfd.add(acc, gfd.mul_const(r[s1], int(w[s1, t1])))
        rows.append(acc)
    return torch.stack(rows)


def _twiddle_row(n: int, e: int, inverse: bool, d: int, device) -> torch.Tensor:
    key = ("row", n, e, inverse, d, str(device))
    if key not in _TABLES:
        _TABLES[key] = gfd.from_u64(_twiddle_matrix(n, e, inverse)[d], device)
    return _TABLES[key]


def twiddle_local(r: torch.Tensor, d: int, n: int, inverse: bool) -> torch.Tensor:
    """Shard d's exchanged blocks r (E, bm) as one row of m, times the
    twiddles T[d, :] = w_n^(+-d k)."""
    m = r.numel()
    return gfd.mul(r.reshape(m), _twiddle_row(n, r.shape[0], inverse, d, r.device))


def interleave_in(z: torch.Tensor, e: int, inverse: bool) -> torch.Tensor:
    """Row t1's NTT output z (m,) as the (E, bm) blocks exchange 3 sends;
    the inverse reverses the index first: NTT_{w^-1}(x)[k] = NTT_w(x)[-k]."""
    if inverse:
        z = torch.cat([z[:1], z[1:].flip(0)])
    return z.reshape(e, -1)


def interleave_out(r: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """Exchange 3's blocks r (E, bm) in t1-minor order, scaled by n^-1 for
    the inverse."""
    out = r.t().reshape(-1)
    if inverse:
        out = gfd.mul_const(out, _n_inverse(n))
    return out


def dft_plain(xs: list, inverse: bool, dst=None) -> list:
    return [dft_local(r, inverse) for r in exchange_plain(xs, dst)]


def twiddle_plain(xs: list, n: int, inverse: bool, dst=None) -> list:
    dst = _dst(xs, dst)
    return [twiddle_local(r, d, n, inverse) for (d, _), r in zip(dst, exchange_plain(xs, dst))]


def interleave_plain(zs: list, inverse: bool, dst=None) -> list:
    e = len(zs)
    n = e * zs[0].numel()
    return [interleave_out(r, n, inverse)
            for r in exchange_plain([interleave_in(z, e, inverse) for z in zs], dst)]


# --- the kernel's entry points ----------------------------------------------------


def exchange(xs: list, dst=None) -> list:
    """Block all-to-all of the shards ``xs``: returns ``out`` with
    ``out[d][s] == xs[s][d]`` (one entry for each of ``dst``)."""
    _check(xs)
    if xs[0].device.type == "cpu":
        return exchange_plain(xs, dst)
    return _copy(xs, _dst(xs, dst))


def exchange_dft(xs: list, inverse: bool, dst=None) -> list:
    """Exchange 1 of the four-step and the size-E DFT: shard d enters with
    its (E, bm) blocks and leaves with ``dft_local(out_d)``."""
    e, m = _check_fused(xs, (2,))
    if xs[0].device.type == "cpu":
        return dft_plain(xs, inverse, dst)
    shifts = _dft_shifts(e, inverse)

    def fill(c):
        c.bm, c.inverse = m // e, int(inverse)
        ctypes.memmove(c.wshift, shifts, len(shifts))

    return _launch("dft", xs, (e, m // e), fill, _dst(xs, dst))


def exchange_twiddle(xs: list, n: int, inverse: bool, dst=None) -> list:
    """Exchange 2 of the four-step and the twiddle multiply: shard d
    enters with its (E, bm) blocks and leaves with
    ``twiddle_local(out_d, d, n, inverse)`` (m,)."""
    e, m = _check_fused(xs, (2,))
    if n != e * m:
        raise ValueError(f"n={n} is not E*m = {e * m}")
    if xs[0].device.type == "cpu":
        return twiddle_plain(xs, n, inverse, dst)
    log, table = _twiddle_tables(n, e, inverse, xs[0].device)

    def fill(c):
        c.bm, c.inverse, c.table, c.tw_log = m // e, int(inverse), table.data_ptr(), log

    return _launch("twiddle", xs, (m,), fill, _dst(xs, dst))


def exchange_interleave(zs: list, inverse: bool, dst=None) -> list:
    """Exchange 3 of the four-step: shard t1 enters with its row NTT output
    (m,) and shard d leaves with ``interleave_out`` of the blocks
    ``interleave_in`` makes, i.e. out_d[j E + t1] = z_t1[d bm + j] (the
    inverse: z_t1[-(d bm + j) mod m] / n)."""
    e, m = _check_fused(zs, (1,))
    if zs[0].device.type == "cpu":
        return interleave_plain(zs, inverse, dst)
    scale = _n_inverse(e * m) if inverse else 1

    def fill(c):
        c.bm, c.inverse, c.scale = m // e, int(inverse), scale

    return _launch("interleave", zs, (m,), fill, _dst(zs, dst))


def enable_peer_access(device: int, peer: int) -> None:
    """Let ``device`` read ``peer``'s memory (once per pair)."""
    if device == peer or (device, peer) in _PEERS:
        return
    err = _lib().block_exchange_enable_peer(device, peer)
    if err == -1:
        raise RuntimeError(f"cuda:{device} cannot access cuda:{peer}'s memory "
                           "(cudaDeviceCanAccessPeer); K2 needs peer access")
    if err != 0:
        raise RuntimeError(f"enabling peer access cuda:{device} -> cuda:{peer} "
                           f"failed: CUDA error {err}")
    _PEERS.add((device, peer))


# --- launch -------------------------------------------------------------------------


def _dft_shifts(e: int, inverse: bool) -> bytes:
    """W[s, t1] = 2^k as the shift counts k.  The order of 2 mod p is 192,
    so for E | 64 the E-th roots of unity are the powers of 2^(192/E)."""
    key = ("dft", e, inverse)
    if key not in _TABLES:
        log2 = {pow(2, k, gl.P_INT): k for k in range(192)}
        w = [int(v) for v in _dft_matrix_e(e, inverse).ravel()]
        if any(v not in log2 for v in w):
            raise ValueError(f"the {e}-point DFT matrix has an entry that is no power of two")
        _TABLES[key] = bytes(log2[v] for v in w)
    return _TABLES[key]


def _n_inverse(n: int) -> int:
    if ("n^-1", n) not in _TABLES:
        _TABLES["n^-1", n] = pow(n, gl.P_INT - 2, gl.P_INT)
    return _TABLES["n^-1", n]


def _twiddle_tables(n: int, e: int, inverse: bool, device) -> tuple:
    """Per destination d: lo[i] = w_d^i (i < L) then hi[h] = w_d^(h L)
    (h < m / L), w_d = w_n^(+-d), L = 2^log near sqrt(m); returns log and
    the tables as one (E, L + m / L) tensor on ``device``."""
    key = ("twiddle", n, e, inverse, str(device))
    if key not in _TABLES:
        m = n // e
        log = m.bit_length() // 2
        split = 1 << log
        w = gl.primitive_root_of_unity(n.bit_length() - 1)
        if inverse:
            w = pow(w, gl.P_INT - 2, gl.P_INT)
        rows = []
        for d in range(e):
            wd = pow(w, d, gl.P_INT)
            rows.append(np.concatenate([gl.powers(wd, split),
                                        gl.powers(pow(wd, split, gl.P_INT), m // split)]))
        _TABLES[key] = (log, gfd.from_u64(np.stack(rows), device))
    return _TABLES[key]


def _copy(xs: list, dst: list) -> list:
    x0 = xs[0]
    if x0.dim() == 2:   # (E, B) blocks: one row each
        rows, row_len = 1, x0.shape[1]
        strides = (x0.stride(0), row_len, 1)
    else:
        _, rows, row_len = x0.shape
        strides = x0.stride()
    if any(x.stride() != x0.stride() for x in xs) or (row_len > 1 and strides[2] != 1):
        raise ValueError(f"shards need one stride pattern with contiguous rows: "
                         f"{[x.stride() for x in xs]}")

    def fill(c):
        c.blk_stride, c.row_stride, c.rows, c.row_len = strides[0], strides[1], rows, row_len

    return _launch("copy", xs, tuple(x0.shape), fill, dst, skip=rows == 0 or row_len == 0)


def _launch(mode: str, srcs: list, out_shape: tuple, fill, dst: list,
            skip: bool = False) -> list:
    """One launch of ``mode`` per card holding destinations ``dst``: one
    output allocation per card, viewed per destination; the call's
    arguments in one ctypes buffer.  ``fill`` sets the mode's fields."""
    e = len(srcs)
    if e > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards, got {e}")
    by_device: dict = {}
    for j, (d, dev) in enumerate(dst):
        by_device.setdefault(dev, []).append((j, d))
    outs: list = [None] * len(dst)
    bases = {}
    for dev, js in by_device.items():
        buf = torch.empty((len(js), *out_shape), dtype=torch.int64, device=dev)
        bases[dev] = buf.data_ptr()
        for (j, _), o in zip(js, buf.unbind(0)):
            outs[j] = o
    if skip:
        return outs
    lib = _lib()
    call = _Call()
    call.mode, call.n_src = MODES.index(mode), e
    call.src[:e] = [x.data_ptr() for x in srcs]
    fill(call)
    out_bytes = 8 * math.prod(out_shape)
    cards = list(dict.fromkeys([*by_device, *(x.device for x in srcs)]))
    for dev, js in by_device.items():
        k = len(js)
        call.n_dst = k
        call.dst[:k] = [bases[dev] + i * out_bytes for i in range(k)]
        call.dst_index[:k] = [d for _, d in js]
        dst_stream = torch.cuda.current_stream(dev)
        waits = []
        if len(cards) > 1:
            waits = [s for s in (torch.cuda.current_stream(c) for c in cards)
                     if s != dst_stream]
            for s in waits:   # the barrier: sources are written before we read
                ev = torch.cuda.Event()
                ev.record(s)
                dst_stream.wait_event(ev)
            for c in cards:
                enable_peer_access(dev.index, c.index)
        err = lib.block_exchange(dev.index, ctypes.byref(call), dst_stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"block_exchange ({mode}) launch failed on {dev}: "
                               f"CUDA error {err}")
        _count(mode, dev)
        for s in waits:   # sources stay allocated until the reads are done
            ev = torch.cuda.Event()
            ev.record(dst_stream)
            s.wait_event(ev)
    return outs
