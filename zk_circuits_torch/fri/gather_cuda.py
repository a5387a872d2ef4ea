"""Wrapper of the Hopper FRI query gather K10 (csrc/gather.cu).

Replaces the XLA programs the JAX package jits for the query phase
(``fri/fri_device.py:312 _gather_fn`` and ``:384 _gather_batch_fn``); no
Pallas kernel.  ``gather`` returns, for a batch of proofs, every tree's
query rows and sibling paths in one flat int64 tensor, in the order of
the plain versions (``fri/fri_device.py::_gather_plain``, and
``gather_trees`` with ``plonk/prover_sharded.py::_take_sharded`` for
row-sharded trees, which CPU tensors take): per tree, the B Q leaf rows,
then for each level below the cap the B Q sibling digests
``level[(i >> l) ^ 1]``.  The kernel computes each level's sibling index
from the query index; the trees' descriptors (addresses, strides, widths,
levels), their pieces' addresses and every tree's (B, Q) indices go up as
one int64 blob (``describe``): one host-to-device copy and one launch a
call, whatever the trees, shards and proofs.

A tree is ``(leaves, levels)``: leaves (B, w, N) column-major (the
oracles' values), (B, N, w) row-major (the FRI trees' leaves), or without
the proof axis where ``shared`` says so (the circuit's constants/sigmas
oracle, read for every proof through a batch stride of 0; a row-sharded
tree of one proof); levels, the leaf digests first and the cap last, each
(B, N >> l, 4), or (N >> l, 4) for a shared tree, with a contiguous last
axis.  The leaf matrix and each level may be a list of pieces instead of
one tensor: a power-of-two number of them of equal shape and strides,
splitting the rows in order (a row-sharded tree, shard s's piece holding
rows [s N/E, (s + 1) N/E); the levels above the point where the shards'
roots meet are one piece).  Pieces on other cards than the first piece's,
where the launch runs, are read through peer pointers, after that card's
stream has waited for theirs (as K2 does).  Any other strides are read in
place.

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
ONE_PIECE_LOG = 62     # K10_ONE_PIECE_LOG: log2 rows a piece of a one-piece matrix
# csrc/gather.cuh K10Field, in order: a tree's descriptor
FIELDS = ("leaves", "llog", "bs", "si", "sc", "w", "q", "nlev", "idx", "lvl", "out", "total")
DESC = len(FIELDS)
# csrc/gather.cuh K10LevelField, in order: a level's record
LEVEL_FIELDS = ("pieces", "log", "bs", "rs")
LEVEL = len(LEVEL_FIELDS)

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


def pieces(x) -> list:
    """A leaf matrix or level as its list of pieces (one for a tensor)."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _piece_rows(parts: list, rows: int, what: str, level=None) -> tuple:
    """(log2 of the rows each of ``parts`` holds, ``rows`` in all; their
    addresses in order), every piece of one shape and strides; at least
    two pieces."""
    p0 = parts[0]
    s0, st0, k = p0.shape, p0.stride(), len(parts)
    ptrs = [p.data_ptr() for p in parts if p.shape == s0 and p.stride() == st0]
    what = what if level is None else f"{what}, level {level}"
    if len(ptrs) != k:
        raise ValueError(f"{what}: pieces of different shapes or strides "
                         f"{[(tuple(p.shape), p.stride()) for p in parts]}")
    if k & (k - 1) or rows % k or (rows // k) & (rows // k - 1):
        raise ValueError(f"{what}: {k} pieces of {rows} rows; K10 takes a power-of-two "
                         f"number of pieces of a power of two rows each")
    return (rows // k).bit_length() - 1, ptrs


def _strides(parts: list, batch: int, shared: bool, colmajor: bool, what: str) -> tuple:
    """(N, w, batch stride, stride along the leaves, stride along a leaf) of
    a leaf matrix's pieces, N their rows in all."""
    x = parts[0]
    if x.dim() != (2 if shared else 3) or (not shared and x.shape[0] != batch):
        raise ValueError(f"{what}: expected {'(w, N) or (N, w)' if shared else f'({batch}, ...)'}"
                         f" leaves, got {tuple(x.shape)}")
    st = x.stride()
    bs = 0 if shared else st[0]
    if colmajor:
        return x.shape[-1] * len(parts), x.shape[-2], bs, st[-1], st[-2]
    return x.shape[-2] * len(parts), x.shape[-1], bs, st[-2], st[-1]


def describe(trees: list, idxs: list, shared: list, colmajor: list) -> tuple:
    """The call's blob (int64, csrc/gather.cuh's layout: the descriptors,
    every tree's level records, the piece tables of the matrices of more
    than one piece, then every tree's indices), its output words and the
    most words of a tree; every shape and index checked."""
    if not (len(trees) == len(idxs) == len(shared) == len(colmajor)) or \
            not 1 <= len(trees) <= MAX_TREES:
        raise ValueError(f"K10 takes 1-{MAX_TREES} trees with an index array, a shared flag "
                         f"and a layout each; got {len(trees)}, {len(idxs)}, {len(shared)}, "
                         f"{len(colmajor)}")
    idxs = [np.asarray(i, dtype=np.int64) for i in idxs]
    batch = idxs[0].shape[0] if idxs[0].ndim == 2 else 0
    if batch < 1:
        raise ValueError(f"query indices are (B, Q) with B >= 1, got {idxs[0].shape}")
    nlevs = [len(levels) - 1 for _, levels in trees]
    desc, lvl, ptrs = [], [], []
    lvl_pos = DESC * len(trees)
    ptr_pos = lvl_pos + LEVEL * sum(max(k, 0) for k in nlevs)
    out = most = 0
    for t, ((leaves, levels), idx, sh, cm, nlev) in enumerate(
            zip(trees, idxs, shared, colmajor, nlevs)):
        what = f"tree {t}"
        parts = pieces(leaves)
        n, w, bs, si, sc = _strides(parts, batch, sh, cm, what)
        if len(parts) == 1:   # its address in the descriptor
            lg, where = ONE_PIECE_LOG, parts[0].data_ptr()
        else:
            lg, lptrs = _piece_rows(parts, n, what)
            where = ptr_pos + len(ptrs)
            ptrs += lptrs
        if idx.ndim != 2 or idx.shape[0] != batch:
            raise ValueError(f"{what}: expected ({batch}, Q) indices, got {idx.shape}")
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{what}: a query index outside [0, {n})")
        if nlev < 0:
            raise ValueError(f"{what}: no level (the cap at least)")
        total = batch * idx.shape[1] * (w + 4 * nlev)
        desc += (where, lg, bs, si, sc, w, idx.shape[1], nlev, 0, lvl_pos + len(lvl), out, total)
        for l in range(nlev):
            lp, rows = levels[l], n >> l
            if isinstance(lp, torch.Tensor):
                lp = (lp,)
            lv, k = lp[0], len(lp)
            st = lv.stride()
            if rows % 2 or rows % k or lv.shape != ((rows // k, 4) if sh else
                                                    (batch, rows // k, 4)) or st[-1] != 1:
                raise ValueError(f"{what}, level {l}: expected {k} piece(s) of "
                                 f"({'' if sh else f'{batch}, '}{rows // k}, 4) digests with a "
                                 f"contiguous last axis, got {tuple(lv.shape)}, strides {st}")
            if k == 1:
                lvl += (lv.data_ptr(), ONE_PIECE_LOG, 0 if sh else st[0], st[-2])
            else:
                lg, lptrs = _piece_rows(lp, rows, what, l)
                lvl += (ptr_pos + len(ptrs), lg, 0 if sh else st[0], st[-2])
                ptrs += lptrs
        out += total
        most = max(most, total)
    head = np.array(desc + lvl + ptrs, dtype=np.int64)
    sizes = np.array([i.size for i in idxs], dtype=np.int64)
    head[FIELDS.index("idx"): DESC * len(trees): DESC] = len(head) + np.cumsum(sizes) - sizes
    return np.concatenate([head] + [i.reshape(-1) for i in idxs]), out, most


class Prepared:
    """A call ready to launch: its K10Call, the blob on the device and the
    output it writes (``prepare``)."""

    __slots__ = ("call", "blob", "out", "device", "peers")

    def __init__(self, call, blob, out, device, peers):
        self.call, self.blob, self.out, self.device = call, blob, out, device
        self.peers = peers   # the other cards whose pieces the launch reads


def prepare(trees: list, idxs: list, shared: list, colmajor: list, *, lib=None) -> Prepared:
    """Check a call, upload its blob (its one host-to-device copy) and
    allocate its output; ``launch`` runs it.  ``lib``, a host build of the
    C interface, takes CPU tensors (the tests); without it every tree lies
    on CUDA devices, and the launch runs on the first piece's."""
    dev = pieces(trees[0][0])[0].device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"K10 runs on CUDA tensors, got one on {dev} (the plain versions "
                         f"are fri/fri_device.py::_gather_plain and gather_trees)")
    tensors = [x for leaves, levels in trees for x in (leaves, *levels)]
    if not all(isinstance(x, torch.Tensor) for x in tensors):
        tensors = [p for x in tensors for p in pieces(x)]
    devices = {x.device for x in tensors}
    if dev.type != "cuda" and devices != {dev} or any(d.type != dev.type for d in devices):
        raise ValueError(f"K10's trees must lie on CUDA devices or all on the CPU, got "
                         f"{sorted(map(str, devices))}")
    if any(x.dtype != torch.int64 for x in tensors):
        raise ValueError("K10 takes int64 tensors")
    blob, total, most = describe(trees, idxs, shared, colmajor)
    blob_t = torch.from_numpy(blob).to(dev)
    out = torch.empty(total, dtype=torch.int64, device=dev)
    call = _Call(blob=blob_t.data_ptr(), out=out.data_ptr(), total=total, trees=len(trees),
                 batch=int(np.asarray(idxs[0]).shape[0]),
                 blocks=max(1, min(MAX_BLOCKS, -(-most // THREADS))))
    return Prepared(call, blob_t, out, dev, sorted(devices - {dev}, key=str))


def launch(prep: Prepared, *, lib=None) -> torch.Tensor:
    """K10's one launch on a prepared call; returns its output.  Where the
    call reads pieces on other cards, the launch's stream first waits for
    theirs, and theirs wait for the launch after it (so that no piece is
    freed while the kernel reads it)."""
    dev = prep.device
    lib = _lib() if dev.type == "cuda" else lib
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    peers = [torch.cuda.current_stream(p) for p in prep.peers]
    if peers:
        from ..parallel.exchange_cuda import enable_peer_access

        for p, s in zip(prep.peers, peers):
            enable_peer_access(dev.index, p.index)
            stream.wait_event(s.record_event())
    err = lib.k10_gather(dev.index or 0, ctypes.byref(prep.call),
                         stream.cuda_stream if stream is not None else None)
    if err != 0:
        raise RuntimeError(f"k10_gather ({prep.call.trees} trees, {prep.call.total} words) "
                           f"failed: CUDA error {err}")
    if dev.type == "cuda":
        _count()
    if peers:
        done = stream.record_event()
        for s in peers:
            s.wait_event(done)
    return prep.out


def gather(trees: list, idxs: list, shared: list, colmajor: list, *, lib=None) -> torch.Tensor:
    """K10: every tree's query rows and sibling paths for the (B, Q) indices
    ``idxs`` (one array a tree) as one flat int64 tensor on the first
    piece's device, in ``_gather_plain``'s order: one upload and one
    launch."""
    return launch(prepare(trees, idxs, shared, colmajor, lib=lib), lib=lib)
