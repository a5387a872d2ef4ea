"""Wrapper of the Hopper block exchange kernel (csrc/block_exchange.cu), K2.

Replaces the JAX package's ``parallel/ntt_exchange.py::_exchange_kernel``:
a block all-to-all over E shards.  Every shard s hands an ``(E, B)`` or
``(E, rows, row_len)`` view ``x_s``; afterwards shard d holds
``out_d[s] = x_s[d]`` -- the transpose of the two leading axes of the global
``(E, E, ...)`` tensor -- as a contiguous tensor on ``x_d``'s device.
Bound on the H100: bytes (a pure copy); see the kernel source for what the
design does about it.

The TPU kernel's start barrier and DMA semaphores become stream order:
each destination stream waits on an event recorded on every source's
current stream before its launch, and every source stream waits on the
destination's completion event after it, so the caching allocator cannot
hand a source buffer to new work while a peer still reads it.  Shards on
one card share one stream and need neither.  Sources on another card are
read through peer pointers; the wrapper enables peer access and raises if
the hardware has none.

One launch per device that holds destination shards (one per exchange on
a one-card mesh); ``launches`` counts them.  A CPU tensor goes to the
plain version (``exchange_plain``); a CUDA tensor goes to the kernel or
raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils.nvcc import build_library

MAX_SHARDS = 32

# Launches of the CUDA kernel in this process (the plain version on CPU
# tensors is not counted).
launches = 0
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_PEERS: set = set()


def build() -> Path:
    """Compile csrc/block_exchange.cu (cached by the hash of its source);
    returns the library's path."""
    global build_log
    lib, log = build_library("block_exchange", "block_exchange.cu")
    if log:
        build_log = log
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.block_exchange.argtypes = [i, p, i, p, p, i, ll, ll, ll, ll, i, p]
        lib.block_exchange.restype = i
        lib.block_exchange_enable_peer.argtypes = [i, i]
        lib.block_exchange_enable_peer.restype = i
        _LIB = lib
    return _LIB


def _as_blocks(x: torch.Tensor) -> torch.Tensor:
    """(E, B) -> (E, 1, B); (E, rows, row_len) as it is."""
    return x.unsqueeze(1) if x.dim() == 2 else x


def _check(xs: list) -> None:
    if not xs:
        raise ValueError("no shards")
    e = len(xs)
    shape = tuple(xs[0].shape)
    for x in xs:
        if x.dtype != torch.int64 or x.dim() not in (2, 3):
            raise ValueError(f"expected 2-D or 3-D int64 shards, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if tuple(x.shape) != shape or shape[0] != e:
            raise ValueError(f"every shard must be ({e}, ...) of one shape; got "
                             f"{[tuple(t.shape) for t in xs]}")
    kinds = {x.device.type for x in xs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"shards must all lie on the CPU or all on CUDA: "
                         f"{[str(x.device) for x in xs]}")


def exchange_plain(xs: list) -> list:
    """The plain PyTorch version: out_d = stack_s(x_s[d] moved to d)."""
    _check(xs)
    e = len(xs)
    return [torch.stack([xs[s][d].to(xs[d].device) for s in range(e)])
            for d in range(e)]


def exchange(xs: list) -> list:
    """Block all-to-all of the shards ``xs``: returns ``out`` with
    ``out[d][s] == xs[s][d]``.  CUDA shards go to the kernel."""
    _check(xs)
    if xs[0].device.type == "cpu":
        return exchange_plain(xs)
    return _launch(xs)


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


def _launch(xs: list) -> list:
    global launches
    e = len(xs)
    if e > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards, got {e}")
    views = [_as_blocks(x) for x in xs]
    strides = views[0].stride()
    if any(v.stride() != strides for v in views) or (
            views[0].shape[2] > 1 and strides[2] != 1):
        raise ValueError(f"shards need one stride pattern with contiguous rows: "
                         f"{[v.stride() for v in views]}")
    _, rows, row_len = views[0].shape
    blk_stride, row_stride = strides[0], strides[1]
    outs = [torch.empty((e, rows, row_len), dtype=torch.int64, device=x.device)
            for x in xs]
    if rows == 0 or row_len == 0:
        return [o.reshape(xs[d].shape) for d, o in enumerate(outs)]
    fn = _lib().block_exchange
    by_device: dict = {}
    for d, x in enumerate(xs):
        by_device.setdefault(x.device, []).append(d)
    src_devices = list(dict.fromkeys(x.device for x in xs))
    src_ptrs = (ctypes.c_void_p * e)(*[v.data_ptr() for v in views])
    even = row_len % 2 == 0 and blk_stride % 2 == 0 and (rows == 1 or row_stride % 2 == 0)
    for dev, ds in by_device.items():
        dst_stream = torch.cuda.current_stream(dev)
        waits = [torch.cuda.current_stream(sd) for sd in src_devices]
        waits = [s for s in waits if s != dst_stream]
        for s in waits:   # the barrier: sources are written before we read
            ev = torch.cuda.Event()
            ev.record(s)
            dst_stream.wait_event(ev)
        for sd in src_devices:
            enable_peer_access(dev.index, sd.index)
        vec16 = even and all(v.data_ptr() % 16 == 0 for v in views) and all(
            outs[d].data_ptr() % 16 == 0 for d in ds)
        dst_ptrs = (ctypes.c_void_p * len(ds))(*[outs[d].data_ptr() for d in ds])
        dst_idx = (ctypes.c_int * len(ds))(*ds)
        err = fn(dev.index, src_ptrs, e, dst_ptrs, dst_idx, len(ds), blk_stride,
                 rows, row_len, row_stride, int(vec16), dst_stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"block_exchange launch failed on {dev}: CUDA error {err}")
        launches += 1
        for s in waits:   # sources stay allocated until the reads are done
            ev = torch.cuda.Event()
            ev.record(dst_stream)
            s.wait_event(ev)
    return [o.reshape(xs[d].shape) for d, o in enumerate(outs)]
