"""Wrapper of the Hopper Goldilocks NTT kernel K4 (csrc/ntt.cu).

Replaces the JAX package's ``ntt/ntt_mxu.py::ntt_mxu`` (:167; its DFT-128
steps as exact bf16 limb matmuls on the MXU, ``_gf_dot_matrix`` :122),
which the JAX package's ``ntt/ntt.py::ntt`` (:198) takes for large
unsharded NTTs on a TPU (``_use_mxu``, :172); it is no Pallas kernel.  On
the card every NTT of the port takes K4: ``ntt/ntt.py`` routes each of
its transforms on a CUDA tensor to one ``transform`` call here.

Five modes (``MODES``), each one call of the kernel: ``ntt``, ``intt``,
``coset_ntt`` (also zero-padded to a larger size), ``coset_intt`` and
``lde``.  The coset scaling, the LDE's zeros, the inverse's reversal and
n^-1 run inside the kernel (csrc/ntt.cuh gives the formula and the
rounds).  A transform of up to 2^``ROW_MAX_LOG`` points is one launch (the
row path); a larger one is two (the four-step over ``split(n)``'s
factors, through a scratch tensor).  ``tiles`` sizes each pass's tiles
from the card's SM count so that the pass launches ``BLOCKS_PER_SM``
blocks an SM where the call has the columns.  Bound on the H100: bytes or
the products of the radix-16 decomposition, whichever is larger (see the
kernel source and chip_smoke.py's k4_work).

A sixth, ``coset_leaves`` (K4's leaf mode, ``LEAF_MODE``), serves FRI's
codewords: the coset NTT of an extension polynomial's two components, read
from two tensors and stored as fiber leaves, so that K1 hashes K4's output
with no stack before the transform and no regroup copy after it
(``fri/fri_device.py::_commit_codeword``; its plain version is
``_commit_codeword_plain``).  Its storing pass (the row path, or the
four-step's pass B) tiles the same columns of both component rows and
stores whole leaves, consecutive words, from shared memory; the row path
serves it up to 2^(TILE_MAX_LOG - 1) points, where a tile holds a row of
each component (``leaf_plan``).

Counters: ``launches`` (kernel launches: 1 a row-path call, 2 a four-step
call), by mode (the leaf mode among them) and by card, and ``copies``
(inputs copied once because their last axis was not contiguous or their
rows shared no one stride).

Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first use, a
plain C interface loaded with ctypes.  This module launches on CUDA
tensors only; the plain versions are ``ntt/ntt.py``'s stage loop
(``ntt_plain``, ``intt_plain``, ``coset_ntt_plain``, ``coset_intt_plain``,
``lde_plain``), which ntt.py takes for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..host import gl
from ..utils.nvcc import build_library
from . import ntt as nttm

HEADERS = ("goldilocks.cuh", "ntt.cuh")
MODES = ("ntt", "intt", "coset_ntt", "coset_intt", "lde")   # transform's
LEAF_MODE = "coset_leaves"   # coset_leaves' count: the coset NTT stored as fiber leaves
ROW_MAX_LOG = 12      # the row path's largest transform: 2^12 points (a tile)
MAX_LOG_N = 26        # the four-step's: factors of up to 2^13 each
V_LOG = 4             # values a thread holds, log2 (csrc/ntt.cuh K4_LOG_V)
TILE_MAX_LOG = 12     # the kernel's largest tile (csrc/ntt.cuh K4_TILE_MAX_LOG)
TILE_LOG = 12         # a tile's values at most, log2, unless a pass is longer: 32 KB
TILE_MIN_LOG = 9      # and at least (32 threads), where the pass has the columns
COLS_MIN_LOG = 2      # the four-step's columns at least: the runs of j1 (pass A) and
                      # k2 (pass B) that neighbouring threads load and store
LEAF_COLS_MIN_LOG = 2  # the leaf mode's pass B columns at least (both components'),
                       # whose stores go through shared memory
BLOCKS_PER_SM = 4     # tiles shrink until a pass launches this many blocks an SM

# Launches of the CUDA kernel in this process, in all, by mode and by card,
# and the inputs copied to a contiguous last axis.
launches = 0
launches_by_mode = dict.fromkeys(MODES + (LEAF_MODE,), 0)
launches_by_device: dict = {}
copies = 0
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build and the counters, shared by threads


class _Call(ctypes.Structure):
    """ctypes mirror of csrc/ntt.cuh's K4Call."""

    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p), ("tw", ctypes.c_void_p),
                ("pre", ctypes.c_void_p), ("post", ctypes.c_void_p),
                ("scale", ctypes.c_ulonglong), ("rows", ctypes.c_longlong),
                ("in_stride", ctypes.c_longlong), ("n_in", ctypes.c_longlong),
                ("log_n", ctypes.c_int), ("log_n1", ctypes.c_int),
                ("inverse", ctypes.c_int), ("log_cols", ctypes.c_int * 3),
                ("leaf_log", ctypes.c_int), ("x1", ctypes.c_void_p),
                ("half", ctypes.c_longlong)]


def reset_launches() -> None:
    global launches, copies
    with _LOCK:
        launches = copies = 0
        for k in launches_by_mode:
            launches_by_mode[k] = 0
        launches_by_device.clear()


def _count(mode: str, device, k: int = 1) -> None:
    global launches
    with _LOCK:
        launches += k
        launches_by_mode[mode] += k
        launches_by_device[str(device)] = launches_by_device.get(str(device), 0) + k


def build() -> Path:
    """Compile csrc/ntt.cu (cached by the hash of its sources); returns the
    library's path."""
    global build_log
    lib, log = build_library("ntt", "ntt.cu", HEADERS)
    if log:
        build_log = log
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ntt.cu's C interface on the loaded library ``lib`` (the
    built one, or in the tests a host build of the same interface) and
    check the K4Call mirror against it."""
    lib.k4_ntt.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.k4_ntt.restype = ctypes.c_int
    lib.k4_call_size.restype = ctypes.c_int
    lib.k4_sm_count.argtypes = [ctypes.c_int]
    lib.k4_sm_count.restype = ctypes.c_int
    if lib.k4_call_size() != ctypes.sizeof(_Call):
        raise RuntimeError(f"K4Call is {lib.k4_call_size()} bytes in the library, "
                           f"{ctypes.sizeof(_Call)} in its ctypes mirror")
    return lib


def _lib():
    """The built library, built and loaded once (under a lock: callers on
    several threads may ask at once)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


# --- plan and tables -------------------------------------------------------------


def split(n: int) -> tuple[int, int]:
    """The four-step's factors n = n1 * n2: n1 = 2^floor(log2(n) / 2), so
    both fit a pass up to 2^26 and pass A reads runs of several j1 (the
    JAX package's ``_split`` keeps n1 <= 128 for its matmul, which would
    leave n2 = 2^15 at 2^22 points, more than a pass)."""
    log = n.bit_length() - 1
    return 1 << (log // 2), 1 << (log - log // 2)


def plan(n: int) -> int:
    """log2(n1) of the four-step K4 runs for n points, or 0 for the row
    path (n <= 2^ROW_MAX_LOG)."""
    if n <= 1 << ROW_MAX_LOG:
        return 0
    return split(n)[0].bit_length() - 1


def leaf_plan(n: int) -> int:
    """``plan`` for the leaf mode: the row path only while a tile holds a
    row of each component (n < 2^TILE_MAX_LOG), else the four-step."""
    if plan(n) or n < 1 << TILE_MAX_LOG:
        return plan(n)
    return split(n)[0].bit_length() - 1


def _passes(rows: int, log_n: int, log_n1: int) -> list:
    """(pass, log2 of its length, log2 of the columns it has a batch row
    or, for the row path, of the rows rounded up) of each pass of a call."""
    if log_n1 == 0:
        return [(0, log_n, max(rows - 1, 0).bit_length())]
    return [(1, log_n - log_n1, log_n1), (2, log_n1, log_n - log_n1)]


def _blocks(rows: int, p: int, cols: int, lc: int) -> int:
    return -(-rows >> lc) if p == 0 else (rows << cols) >> lc


def tiles(rows: int, n: int, log_n1: int, sms: int, leaf: bool = False) -> tuple[int, int, int]:
    """log2 of the columns a tile of each pass holds (rows on the row path;
    j1 in pass A, k2 in pass B; K4Call's ``log_cols``): 2^TILE_LOG values,
    or the pass's length if longer, shrunk while the pass launches fewer
    than BLOCKS_PER_SM * ``sms`` blocks, but not below 2^TILE_MIN_LOG
    values nor, on the four-step, 2^COLS_MIN_LOG columns, and never past
    the columns there are or the kernel's largest tile.  In the ``leaf``
    mode the storing pass's tile holds the same columns of both component
    rows (csrc/ntt.cuh k4_staged), two columns at least."""
    cols = [0, 0, 0]
    for p, l, have in _passes(rows, n.bit_length() - 1, log_n1):
        staged = leaf and p != 1
        top = have + (staged and p == 2)   # pass B's columns of a proof's two rows
        fit = max(0, TILE_MAX_LOG - l)   # csrc/ntt.cuh k4_tile_fits
        least = LEAF_COLS_MIN_LOG if staged and p else COLS_MIN_LOG if p else int(staged)
        lo = min(top, fit, max(0, TILE_MIN_LOG - l, least))
        lc = max(lo, min(top, fit, TILE_LOG - l))
        while lc > lo and _blocks(rows, p, have, lc) < BLOCKS_PER_SM * sms:
            lc -= 1
        cols[p] = lc
    return tuple(cols)


def rounds(log_len: int) -> int:
    """Rounds of a pass of 2^log_len points (csrc/ntt.cuh k4_rounds)."""
    return 1 if log_len <= V_LOG else -(-log_len // V_LOG)


def radix_logs(log_len: int) -> list:
    """log2 of each round's radix (csrc/ntt.cuh k4_radix_log): 16 but one
    round, which takes what is left: the last of two, the second of three
    or four."""
    k = rounds(log_len)
    logs = [V_LOG] * k
    logs[1 if k > 2 else k - 1] = log_len - V_LOG * (k - 1)
    return logs


def pass_logs(n: int, log_n1: int) -> list:
    """log2 of the length of each pass of a call: n, or n2 then n1."""
    return [l for _, l, _ in _passes(1, n.bit_length() - 1, log_n1)]


def launch_shape(rows: int, n: int, log_n1: int, cols: tuple, leaf: bool = False) -> list:
    """(blocks, threads, shared bytes) of each launch of a call, as
    csrc/ntt.cu makes them (k4_blocks, k4_threads, k4_smem_elems); ``leaf``
    for the leaf mode, whose storing pass also stages its tile in shared
    memory (k4_stage_elems)."""
    out = []
    for p, l, have in _passes(rows, n.bit_length() - 1, log_n1):
        lc = cols[p]
        pitch = (1 << l) + ((1 << l) >> 4) + (p != 0)
        elems = pitch << lc if rounds(l) > 1 else 0
        if leaf and p != 1:
            elems = max(elems, (1 << (l + lc)) + (1 << (l + lc) >> 4))
        out.append((_blocks(rows, p, have, lc), max(1, 1 << (l + lc - V_LOG)), 8 * elems))
    return out


def round_tables(log_len: int) -> np.ndarray:
    """A pass's inter-round twiddles: for each round r but the last, of
    radix R_r over sub-transforms of L_r points, w_(L_r)^(j k) at
    k L_r / R_r + j (k < R_r, j < L_r / R_r)."""
    segs, lr = [], log_len
    for b in radix_logs(log_len)[:-1]:
        e = np.arange(1 << b)[:, None] * np.arange(1 << (lr - b))[None, :]
        segs.append(gl.powers(gl.primitive_root_of_unity(lr), 1 << lr)[e.reshape(-1)])
        lr -= b
    return np.concatenate(segs) if segs else np.zeros(0, dtype=np.uint64)


def tables(n: int, log_n1: int) -> np.ndarray:
    """K4's tables for a call of n points (csrc/ntt.cuh): the row path's
    round tables, or pass A's and pass B's, then for the four-step w_n^e as
    lo (e < 2^h) and hi (w_n^(2^h e), e < n / 2^h), h = ceil(log2(n) / 2);
    at least one value."""
    log_n = n.bit_length() - 1
    if log_n1 == 0:
        segs = [round_tables(log_n)]
    else:
        h = (log_n + 1) // 2
        w = gl.primitive_root_of_unity(log_n)
        segs = [round_tables(log_n - log_n1), round_tables(log_n1), gl.powers(w, 1 << h),
                gl.powers(pow(int(w), 1 << h, gl.P_INT), 1 << (log_n - h))]
    segs.append(np.ones(1, dtype=np.uint64))
    return np.concatenate(segs)


def twiddles(n: int, log_n1: int, device) -> torch.Tensor:
    """``tables(n, log_n1)`` on ``device``, uploaded once and cached beside
    ntt.py's tables."""
    return nttm._cached(("k4_tw", n, log_n1, str(device)),
                        lambda: gfd.from_u64(tables(n, log_n1), device))


def _sm_count(lib, device) -> int:
    """The card's SM count through the library (cached a card); the host
    tests' library gives its own."""
    if device.type != "cuda":
        return lib.k4_sm_count(0)
    return nttm._cached(("k4_sms", str(device)), lambda: lib.k4_sm_count(device.index))


def occupancy(device, log_len: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` shared bytes of a pass of
    2^log_len points that one SM of the CUDA ``device`` holds at once (for
    chip_smoke.py's report)."""
    lib = _lib()
    lib.k4_occupancy.argtypes = [ctypes.c_int] * 4
    lib.k4_occupancy.restype = ctypes.c_int
    return lib.k4_occupancy(torch.device(device).index or 0, log_len, threads, smem)


# --- the entry point ---------------------------------------------------------------


def _coset_intt_post(shift: int, n: int, device) -> torch.Tensor:
    """n^-1 shift^-m for m < n: the coset INTT's output scaling, one table
    (cached)."""
    inv = pow(shift, gl.P_INT - 2, gl.P_INT)
    return nttm._cached(("k4_post", inv, n, str(device)), lambda: gfd.from_u64(
        gl.mul(gl.powers(inv, n), np.uint64(pow(n, gl.P_INT - 2, gl.P_INT))), device))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as (rows, n_in) with a contiguous last axis and one row stride:
    a view, or a contiguous copy (counted in ``copies``)."""
    global copies
    n_in = x.shape[-1]
    try:
        v = x.view(-1, n_in)
        if n_in == 1 or v.stride(1) == 1:
            return v
    except RuntimeError:
        pass
    with _LOCK:
        copies += 1
    return x.contiguous().view(-1, n_in)


def _launch(mode: str, x: torch.Tensor, out: torch.Tensor, rows: int, n: int, log_n1: int, lib,
            *, pre=None, post=None, scale: int = 1, x1=None, leaf_log: int = 0) -> None:
    """One ``k4_ntt`` call of ``rows`` transforms to n points from the rows
    of ``x`` (in the leaf mode, ``x1``'s after x's) into ``out``, counted
    under ``mode`` where it launches on a card."""
    dev = x.device
    lib = _lib() if dev.type == "cuda" else lib
    scratch = torch.empty((rows, n), dtype=torch.int64, device=dev) if log_n1 else None
    call = _Call(x=x.data_ptr(), out=out.data_ptr(),
                 scratch=scratch.data_ptr() if scratch is not None else None,
                 tw=twiddles(n, log_n1, dev).data_ptr(),
                 pre=pre.data_ptr() if pre is not None else None,
                 post=post.data_ptr() if post is not None else None, scale=scale, rows=rows,
                 in_stride=x.stride(0), n_in=x.shape[-1], log_n=n.bit_length() - 1,
                 log_n1=log_n1, inverse=int(mode in ("intt", "coset_intt")),
                 log_cols=(ctypes.c_int * 3)(*tiles(rows, n, log_n1, _sm_count(lib, dev),
                                                    leaf=bool(leaf_log))),
                 leaf_log=leaf_log, x1=x1.data_ptr() if x1 is not None else None,
                 half=x.shape[0] if x1 is not None else 0)
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    err = lib.k4_ntt(dev.index or 0, ctypes.byref(call), stream)
    if err != 0:
        raise RuntimeError(f"k4_ntt ({mode}, n={n}, log_n1={log_n1}, leaf_log={leaf_log}) "
                           f"failed: CUDA error {err}")
    if dev.type == "cuda":
        _count(mode, dev, 2 if log_n1 else 1)


def transform(x: torch.Tensor, mode: str, *, rate_bits: int = 0,
              shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR, size: int | None = None,
              log_n1: int | None = None, lib=None) -> torch.Tensor:
    """One K4 call along the last axis of the int64 tensor ``x`` (..., n_in)
    of canonical values; returns a fresh contiguous (..., n):

    - ``ntt``: values at w^i, n = n_in;
    - ``intt``: the inverse, n = n_in;
    - ``coset_ntt``: values at shift * w^i of ``x`` zero-padded to ``size``
      (default n_in);
    - ``coset_intt``: the inverse of ``coset_ntt``, n = n_in;
    - ``lde``: ``coset_ntt`` at size n_in * 2^rate_bits.

    n is a power of two up to 2^MAX_LOG_N.  Two hooks for the checks (the
    tests, chip_smoke.py's k4_check): ``log_n1`` overrides ``plan`` (0: the
    row path; else the four-step with n1 = 2^log_n1), and ``lib``, a host
    build of the kernel's C interface, runs the call on a CPU tensor;
    without it ``x`` must lie on a CUDA device, where the built library
    runs it."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; K4's modes are {MODES}")
    if x.dtype != torch.int64 or x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"expected an int64 tensor (..., n) with n >= 1, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if lib is None and x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got one on {x.device} (the plain "
                         f"versions are ntt/ntt.py's *_plain)")
    n_in = x.shape[-1]
    n = n_in << rate_bits if mode == "lde" else (size or n_in) if mode == "coset_ntt" else n_in
    if n & (n - 1) or n < n_in or n > 1 << MAX_LOG_N:
        raise ValueError(f"{mode}: {n_in} inputs to {n} points; n must be a power of two "
                         f"in [n_in, 2^{MAX_LOG_N}]")
    log_n1 = plan(n) if log_n1 is None else log_n1
    v = _rows(x)
    out = torch.empty((v.shape[0], n), dtype=torch.int64, device=x.device)
    if v.shape[0]:
        _launch(mode, v, out, v.shape[0], n, log_n1, lib,
                pre=nttm.powers(shift, n_in, x.device) if mode in ("coset_ntt", "lde") else None,
                post=_coset_intt_post(shift, n, x.device) if mode == "coset_intt" else None,
                scale=pow(n, gl.P_INT - 2, gl.P_INT) if mode == "intt" else 1)
    return out.view(*x.shape[:-1], n)


def coset_leaves(c0: torch.Tensor, c1: torch.Tensor, shift: int, size: int, arity_bits: int,
                 *, log_n1: int | None = None, lib=None) -> torch.Tensor:
    """K4's leaf mode, one call: the coset NTT onto shift * <w_size> of both
    components c0, c1 of an extension polynomial (each (B, n_in) or
    (n_in,), zero-padded to ``size``), stored as fiber leaves of arity A =
    2^arity_bits: (B, size / A, 2 A), leaf j holding [v0(0, j), v1(0, j),
    v0(1, j), ...] with v(k, j) the value at point k size / A + j; that is
    ``fri_device._fiber_leaves(*fri_device._ext_coset_ntt_dev(c0, c1,
    shift, size), A)``.  The components are read where they lie (one row
    stride for both; else both are copied, counted in ``copies``).
    ``log_n1`` (default ``leaf_plan``'s) and ``lib`` as for
    ``transform``."""
    global copies
    if c0.shape != c1.shape or c0.dim() not in (1, 2) or c0.dtype != torch.int64 or \
            c1.dtype != torch.int64 or c0.shape[-1] < 1 or c0.device != c1.device:
        raise ValueError(f"K4's leaf mode takes two int64 (B, n) or (n,) components on one "
                         f"device, got {c0.dtype} {tuple(c0.shape)} on {c0.device} and "
                         f"{c1.dtype} {tuple(c1.shape)} on {c1.device}")
    if lib is None and c0.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got one on {c0.device} (the plain version "
                         f"is fri/fri_device.py::_commit_codeword_plain)")
    n_in = c0.shape[-1]
    if size & (size - 1) or size < n_in or size > 1 << MAX_LOG_N or \
            not 1 <= arity_bits <= size.bit_length() - 1:
        raise ValueError(f"K4's leaf mode: {n_in} inputs to {size} points at arity 2^"
                         f"{arity_bits}; the size must be a power of two in [n_in, "
                         f"2^{MAX_LOG_N}] and the arity at most the size")
    x0, x1 = c0.reshape(-1, n_in), c1.reshape(-1, n_in)
    if x0.stride() != x1.stride() or (n_in > 1 and x0.stride(1) != 1):
        x0, x1 = x0.contiguous(), x1.contiguous()
        with _LOCK:
            copies += 1
    batch = x0.shape[0]
    leaves = torch.empty((batch, size >> arity_bits, 2 << arity_bits), dtype=torch.int64,
                         device=c0.device)
    if batch:
        _launch(LEAF_MODE, x0, leaves, 2 * batch, size,
                leaf_plan(size) if log_n1 is None else log_n1,
                lib, pre=nttm.powers(shift, n_in, c0.device), x1=x1, leaf_log=arity_bits)
    return leaves

