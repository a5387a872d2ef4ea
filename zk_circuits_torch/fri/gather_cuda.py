"""Wrapper of the Hopper FRI query gather K10 (csrc/gather.cu).

Replaces the XLA programs the JAX package jits for the query phase
(``fri/fri_device.py:312 _gather_fn`` and ``:384 _gather_batch_fn``); no
Pallas kernel.  ``gather`` returns, for a batch of proofs, every tree's
query rows and sibling paths in one flat int64 tensor, in the order of the
plain version (``fri/fri_device.py::_gather_plain``, which CPU tensors
take): per tree, the B Q leaf rows, then for each level below the cap the
B Q sibling digests ``level[(i >> l) ^ 1]``.  The kernel computes each
level's sibling index from the query index; the trees' descriptors
(addresses, strides, widths, levels) and every tree's (B, Q) indices go up
as one int64 blob (``describe``): one host-to-device copy and one launch
a call, whatever the trees and proofs.

A tree is ``(leaves, levels)``: leaves (B, w, N) column-major (the
oracles' values), (B, N, w) row-major (the FRI trees' leaves), or without
the proof axis where ``shared`` says so (the circuit's constants/sigmas
oracle, read for every proof through a batch stride of 0); levels, the
leaf digests first and the cap last, each (B, N >> l, 4), or (N >> l, 4)
for a shared tree, with a contiguous last axis.  Any other strides are
read in place.

Bound on the H100: neither bytes nor operations (about 16k words a wormhole
proof; chip_smoke.py's gather_work): its launch.  Counter: ``launches``.
Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first use, a
plain C interface loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..utils.nvcc import build_library

HEADERS = ("goldilocks.cuh", "gather.cuh")
THREADS = 256          # csrc/gather.cuh K10_THREADS
MAX_BLOCKS = 1024      # K10_MAX_BLOCKS: blocks a tree
MAX_TREES = 65535      # K10_MAX_TREES
# csrc/gather.cuh K10Field, in order: a tree's descriptor
FIELDS = ("leaves", "bs", "si", "sc", "w", "q", "nlev", "idx", "lvl", "out", "total")
DESC = len(FIELDS)

launches = 0
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build and the counters


class _Call(ctypes.Structure):
    """ctypes mirror of csrc/gather.cuh's K10Call."""

    _fields_ = [("blob", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("total", ctypes.c_longlong), ("trees", ctypes.c_int),
                ("batch", ctypes.c_int), ("blocks", ctypes.c_int)]


def reset_launches() -> None:
    global launches
    with _LOCK:
        launches = 0


def _count() -> None:
    global launches
    with _LOCK:
        launches += 1


def build():
    """Compile csrc/gather.cu (cached by the hash of its sources); returns
    the library's path."""
    global build_log
    lib, log = build_library("gather", "gather.cu", HEADERS)
    if log:
        build_log = log
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare gather.cu's C interface on ``lib`` (the built library, or in
    the tests a host build of it) and check the mirrors against it."""
    lib.k10_gather.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.k10_gather.restype = ctypes.c_int
    lib.k10_call_size.restype = ctypes.c_int
    lib.k10_desc_words.restype = ctypes.c_int
    if lib.k10_call_size() != ctypes.sizeof(_Call) or lib.k10_desc_words() != DESC:
        raise RuntimeError(f"K10Call is {lib.k10_call_size()} bytes and a descriptor "
                           f"{lib.k10_desc_words()} words in the library, "
                           f"{ctypes.sizeof(_Call)} and {DESC} in the wrapper")
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def _strides(x: torch.Tensor, batch: int, shared: bool, colmajor: bool, what: str) -> tuple:
    """(N, w, batch stride, stride along the leaves, stride along a leaf)
    of a leaf matrix."""
    if x.dim() != (2 if shared else 3) or (not shared and x.shape[0] != batch):
        raise ValueError(f"{what}: expected {'(w, N) or (N, w)' if shared else f'({batch}, ...)'}"
                         f" leaves, got {tuple(x.shape)}")
    st = x.stride()
    bs = 0 if shared else st[0]
    if colmajor:
        return x.shape[-1], x.shape[-2], bs, st[-1], st[-2]
    return x.shape[-2], x.shape[-1], bs, st[-2], st[-1]


def describe(trees: list, idxs: list, shared: list, colmajor: list) -> tuple:
    """The call's blob (int64, csrc/gather.cuh's layout: the descriptors,
    then every tree's levels, then every tree's indices), its output words
    and the most words of a tree; every shape and index checked."""
    if not (len(trees) == len(idxs) == len(shared) == len(colmajor)) or \
            not 1 <= len(trees) <= MAX_TREES:
        raise ValueError(f"K10 takes 1-{MAX_TREES} trees with an index array, a shared flag "
                         f"and a layout each; got {len(trees)}, {len(idxs)}, {len(shared)}, "
                         f"{len(colmajor)}")
    idxs = [np.asarray(i, dtype=np.int64) for i in idxs]
    batch = idxs[0].shape[0] if idxs[0].ndim == 2 else 0
    if batch < 1:
        raise ValueError(f"query indices are (B, Q) with B >= 1, got {idxs[0].shape}")
    desc, lvl = [], []
    lvl_pos = DESC * len(trees)
    idx_pos = lvl_pos + 3 * sum(max(len(levels) - 1, 0) for _, levels in trees)
    out = most = 0
    for t, ((leaves, levels), idx, sh, cm) in enumerate(zip(trees, idxs, shared, colmajor)):
        what = f"tree {t}"
        n, w, bs, si, sc = _strides(leaves, batch, sh, cm, what)
        if idx.ndim != 2 or idx.shape[0] != batch:
            raise ValueError(f"{what}: expected ({batch}, Q) indices, got {idx.shape}")
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{what}: a query index outside [0, {n})")
        nlev = len(levels) - 1
        if nlev < 0:
            raise ValueError(f"{what}: no level (the cap at least)")
        for l in range(nlev):
            lv, rows = levels[l], n >> l
            st = lv.stride()
            if lv.shape != ((rows, 4) if sh else (batch, rows, 4)) or st[-1] != 1 or rows % 2:
                raise ValueError(f"{what}, level {l}: expected ({'' if sh else f'{batch}, '}"
                                 f"{rows}, 4) digests with a contiguous last axis, got "
                                 f"{tuple(lv.shape)}, strides {st}")
            lvl += (lv.data_ptr(), 0 if sh else st[0], st[-2])
        q = idx.shape[1]
        total = batch * q * (w + 4 * nlev)
        desc += (leaves.data_ptr(), bs, si, sc, w, q, nlev, idx_pos, lvl_pos, out, total)
        lvl_pos += 3 * nlev
        idx_pos += idx.size
        out += total
        most = max(most, total)
    head = np.array(desc + lvl, dtype=np.int64)
    return np.concatenate([head] + [i.reshape(-1) for i in idxs]), out, most


class Prepared:
    """A call ready to launch: its K10Call, the blob on the device and the
    output it writes (``prepare``)."""

    __slots__ = ("call", "blob", "out", "device")

    def __init__(self, call, blob, out, device):
        self.call, self.blob, self.out, self.device = call, blob, out, device


def prepare(trees: list, idxs: list, shared: list, colmajor: list, *, lib=None) -> Prepared:
    """Check a call, upload its blob (its one host-to-device copy) and
    allocate its output; ``launch`` runs it.  ``lib``, a host build of the
    C interface, takes CPU tensors (the tests); without it every tree lies
    on one CUDA device."""
    dev = trees[0][0].device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"K10 runs on CUDA tensors, got one on {dev} (the plain version is "
                         f"fri/fri_device.py::_gather_plain)")
    tensors = [x for leaves, levels in trees for x in (leaves, *levels)]
    if any(x.device != dev for x in tensors):
        raise ValueError("K10's trees must lie on one device")
    if any(x.dtype != torch.int64 for x in tensors):
        raise ValueError("K10 takes int64 tensors")
    blob, total, most = describe(trees, idxs, shared, colmajor)
    blob_t = torch.from_numpy(blob).to(dev)
    out = torch.empty(total, dtype=torch.int64, device=dev)
    call = _Call(blob=blob_t.data_ptr(), out=out.data_ptr(), total=total, trees=len(trees),
                 batch=int(np.asarray(idxs[0]).shape[0]),
                 blocks=max(1, min(MAX_BLOCKS, -(-most // THREADS))))
    return Prepared(call, blob_t, out, dev)


def launch(prep: Prepared, *, lib=None) -> torch.Tensor:
    """K10's one launch on a prepared call; returns its output."""
    dev = prep.device
    lib = _lib() if dev.type == "cuda" else lib
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    err = lib.k10_gather(dev.index or 0, ctypes.byref(prep.call), stream)
    if err != 0:
        raise RuntimeError(f"k10_gather ({prep.call.trees} trees, {prep.call.total} words) "
                           f"failed: CUDA error {err}")
    if dev.type == "cuda":
        _count()
    return prep.out


def gather(trees: list, idxs: list, shared: list, colmajor: list, *, lib=None) -> torch.Tensor:
    """K10: every tree's query rows and sibling paths for the (B, Q) indices
    ``idxs`` (one array a tree) as one flat int64 tensor on the trees'
    device, in ``_gather_plain``'s order: one upload and one launch."""
    return launch(prepare(trees, idxs, shared, colmajor, lib=lib), lib=lib)
