"""Wrapper of the Hopper FRI kernels K7, K8 and K9 (csrc/fri.cu).

Replaces the XLA programs the JAX package jits for the openings
(``fri/fri_device.py:158 _make_openings_run``), the composition without its
round-0 commit (``:193 _make_compose_run``) and the fold (``:136
_fold_dev`` in ``:255`` and ``:289``); none is a Pallas kernel.

- ``openings`` (K7, one launch): every row of a list of sets evaluated at
  its table's point (zeta or g zeta) of its proof, a block a tile of
  coefficients (``openings_shape``), a group of rows of one point and a
  proof, the last block of a group summing the tiles;
- ``reduce_alpha`` (K8's point kernel, one launch): each table's rows
  summed with their powers of alpha, computed on the card;
- ``compose`` (K8's scan, two launches): both divisions by a linear factor
  and their sum with alpha^num_zs, the FRI polynomial padded with its zero;

K7 and K8 compute the powers of zeta, g zeta and alpha on the card from
the points (a table of T points a proof, (T, 2, B); K8's scan, in
Horner's form, needs no inverse), where the JAX program uploads
host-computed tables: the integers are the same, and the host's numpy
tables were most of the stages' time once the arithmetic left eager torch;
- ``fold_round`` (K9's round mode, one launch a fold round but the last):
  the fold, the next codeword's coset NTT and its fiber leaves, exactly
  ``fri_device._fold_round_plain``; ``fold`` (K9's fold mode, one launch):
  the fold alone, for the last round and the sharded path's shards, at any
  arity.  Both fold with lanes (``csrc/fri.cuh``), and both take the betas
  on the host and pass them in the launch's parameters (up to
  ``K9_MAX_BATCH`` proofs a launch, a launch a chunk of them above).

A set is ``(tensor, table)`` or ``(tensor, table, exp)``: a (k, n) tensor
shared by the batch (the circuit's constants/sigmas oracle, read once for
every proof) or (B, k, n), read in place through its strides (the last
axis contiguous); K8's point kernel gives its row j the power exp + j of
alpha (exp 0 when left out).  The plain
versions are ``fri/fri_device.py``'s ``_openings_plain``,
``_reduce_alpha_plain``, ``_compose_plain``, ``_fold_plain`` and
``_fold_round_plain``, which the prover takes for CPU tensors.

Bound on the H100: bytes (chip_smoke.py's fri_work).  Counters:
``launches``, in all, by kernel (``k7``, ``k8``, ``k9``), K9's by mode
(``k9_by_mode``: ``round``, ``fold``) and by card.
Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first use, a
plain C interface loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..host import gl
from ..ntt import ntt as nttm
from ..utils.nvcc import build_library

HEADERS = ("goldilocks.cuh", "ntt.cuh", "fri.cuh")
MAX_SETS = 8          # csrc/fri.cuh FRI_MAX_SETS
MAX_POW = 1024        # csrc/fri.cuh K8_MAX_POW
MAX_BATCH = 65535     # the grid's y extent
MAX_ARITY_BITS = 62   # csrc/fri.cuh K9_MAX_BITS
SCAN_LAUNCHES = 2     # K8's scan: its segment sums, then the rest (csrc/fri.cu k8_scan)
K7_GROUP = 32         # K7's rows a block: 4 a warp of its 8
K7_MIN_TILE = 256     # K7's coefficients a block: 8 a lane, up to
K7_MAX_TILE = 2048    # 64 a lane (its shared memory stays below 48 KB)
K7_BLOCKS_PER_SM = 2  # the least blocks an SM openings_shape aims for
KERNELS = ("k7", "k8", "k9")
K9_MAX_BATCH = 32     # csrc/fri.cuh K9_MAX_BATCH: the betas a launch's parameters hold
ROUND_MAX_LOG = 13    # csrc/fri.cuh K9_ROUND_MAX_LOG: the round mode's largest folded polynomial
ROUND_GROUP_LOG = 3   # the round mode's cosets a cluster, at most (csrc/fri.cuh K9_MAX_GROUP_LOG)
ROUND_THREADS = 256   # csrc/fri.cuh K9_ROUND_THREADS (more at 2^13 points: round_threads)
ROUND_UNROLL = 4      # csrc/fri.cuh K9_UNROLL
ROUND_REGS = 16       # csrc/fri.cuh K9_REGS
RADIX_LOG = 3         # csrc/fri.cuh K9_RADIX_LOG: the round NTT's radix
POW_WORDS = 64        # csrc/fri.cuh K9_POW_WORDS: the table of beta^g

launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)
k9_by_mode = {"round": 0, "fold": 0}
launches_by_device: dict = {}
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build, the counters and the caches
_SMS: dict = {}            # SMs by device
_COUNTS: dict = {}         # K7's block counters by device, zero between calls


def _fields(spec: str, names: str) -> list:
    kinds = {"p": ctypes.c_void_p, "l": ctypes.c_longlong, "i": ctypes.c_int}
    return [(name, kinds[k]) for k, name in zip(spec, names.split())]


class _Set(ctypes.Structure):
    """ctypes mirror of csrc/fri.cuh's FriSet."""

    _fields_ = _fields("plliii", "ptr bs rs rows table exp")


class _Rows(ctypes.Structure):
    """ctypes mirror of FriRows."""

    _fields_ = [("sets", _Set * MAX_SETS)] + _fields("liii", "n nsets rows batch")


class _K7Call(ctypes.Structure):
    _fields_ = [("r", _Rows)] + _fields("ppppiii", "pts out part counts tables tile group")


class _K8Call(ctypes.Structure):
    _fields_ = [("r", _Rows), ("alpha", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("tables", ctypes.c_int), ("npow", ctypes.c_int)]


class _K8ScanCall(ctypes.Structure):
    _fields_ = [("comp", ctypes.c_void_p * 4), ("pts", ctypes.c_void_p),
                ("f", ctypes.c_void_p * 2), ("scratch", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("batch", ctypes.c_int)]


class _K9Call(ctypes.Structure):
    _fields_ = [("c", ctypes.c_void_p * 2), ("c_bs", ctypes.c_longlong),
                ("out", ctypes.c_void_p * 2), ("m", ctypes.c_longlong),
                ("arity_bits", ctypes.c_int), ("batch", ctypes.c_int),
                ("beta", ctypes.c_uint64 * 2 * K9_MAX_BATCH)]


class _K9RoundCall(ctypes.Structure):
    _fields_ = [("c", ctypes.c_void_p * 2), ("c_bs", ctypes.c_longlong),
                ("f", ctypes.c_void_p * 2), ("leaves", ctypes.c_void_p),
                ("tw", ctypes.c_void_p), ("pre", ctypes.c_void_p)] + \
        _fields("iiiiii", "arity_bits log_m next_bits rate_bits group_log batch") + \
        [("beta", ctypes.c_uint64 * 2 * K9_MAX_BATCH)]


CALLS = (("k7_openings", _K7Call), ("k8_reduce", _K8Call), ("k8_scan", _K8ScanCall),
         ("k9_fold", _K9Call), ("k9_round", _K9RoundCall))


def reset_launches() -> None:
    global launches
    with _LOCK:
        launches = 0
        for k in launches_by_kernel:
            launches_by_kernel[k] = 0
        for k in k9_by_mode:
            k9_by_mode[k] = 0
        launches_by_device.clear()


def _count(kernel: str, device, k: int, mode: str | None) -> None:
    global launches
    with _LOCK:
        launches += k
        launches_by_kernel[kernel] += k
        if mode:
            k9_by_mode[mode] += k
        launches_by_device[str(device)] = launches_by_device.get(str(device), 0) + k


def build():
    """Compile csrc/fri.cu (cached by the hash of its sources); returns the
    library's path."""
    global build_log
    lib, log = build_library("fri", "fri.cu", HEADERS)
    if log:
        build_log = log
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare fri.cu's C interface on ``lib`` (the built library, or in
    the tests a host build of it) and check the call mirrors' sizes."""
    lib.fri_call_size.argtypes = [ctypes.c_int]
    lib.fri_call_size.restype = ctypes.c_int
    lib.k8_scan_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.k8_scan_scratch.restype = ctypes.c_longlong
    lib.fri_sm_count.argtypes = [ctypes.c_int]
    lib.fri_sm_count.restype = ctypes.c_int
    lib.k7_row_groups.argtypes = [ctypes.c_void_p]
    lib.k7_row_groups.restype = ctypes.c_int
    for kind, (name, mirror) in enumerate(CALLS):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if lib.fri_call_size(kind) != ctypes.sizeof(mirror):
            raise RuntimeError(f"{name}'s call is {lib.fri_call_size(kind)} bytes in the "
                               f"library, {ctypes.sizeof(mirror)} in its ctypes mirror")
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def _launch(kernel: str, name: str, call, dev: torch.device, lib, what: str,
            count: int = 1, mode: str | None = None) -> None:
    """``name`` on ``call``, ``count`` launches: the built library on a
    CUDA device (counted, K9's also by ``mode``), else ``lib``, a host
    build of the C interface."""
    lib = _lib() if dev.type == "cuda" else lib
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    err = getattr(lib, name)(dev.index or 0, ctypes.byref(call), stream)
    if err != 0:
        raise RuntimeError(f"{name} ({what}) failed: CUDA error {err}")
    if dev.type == "cuda":
        _count(kernel, dev, count, mode)


def _device(tensors: list, lib, kernel: str, plain: str) -> torch.device:
    dev = tensors[0].device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got one on {dev} (the plain version "
                         f"is fri/fri_device.py::{plain})")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel}'s inputs must lie on one device")
    if any(t.dtype != torch.int64 for t in tensors):
        raise ValueError(f"{kernel} takes int64 tensors")
    return dev


def _rows(sets: list, batch: int, n: int | None = None) -> tuple:
    """The FriRows over ``sets`` for ``batch`` proofs; returns it, its rows
    and n."""
    if not 1 <= len(sets) <= MAX_SETS or not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"expected 1-{MAX_SETS} sets and 1-{MAX_BATCH} proofs, got "
                         f"{len(sets)} and {batch}")
    rows = _Rows(nsets=len(sets), batch=batch)
    total = 0
    for s, (x, table, *exp) in enumerate(sets):
        shared = x.dim() == 2
        n = x.shape[-1] if n is None else n
        exp = exp[0] if exp else 0
        if x.dim() not in (2, 3) or (not shared and x.shape[0] != batch) or \
                x.shape[-1] != n or (n > 1 and x.stride(-1) != 1) or table not in (0, 1) \
                or exp < 0:
            raise ValueError(f"set {s}: expected (k, {n}) or ({batch}, k, {n}) with a "
                             f"contiguous last axis, table 0 or 1 and a power of alpha >= "
                             f"0, got {tuple(x.shape)}, strides {x.stride()}, table {table}, "
                             f"power {exp}")
        rows.sets[s] = _Set(ptr=x.data_ptr(), bs=0 if shared else x.stride(0),
                            rs=x.stride(-2), rows=x.shape[-2], table=table, exp=exp)
        total += x.shape[-2]
    if total < 1 or n < 1:
        raise ValueError("the sets hold no coefficient")
    rows.n, rows.rows = n, total
    return rows, total, n


def _pairs(name: str, pairs: list, shape: tuple) -> list:
    """Contiguous copies (no copy when already so) of the component pairs,
    each of ``shape``."""
    out = []
    for p in pairs:
        for t in p:
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
            out.append(t.contiguous())
    return out


def _points(pts: torch.Tensor, counts: tuple) -> tuple:
    """``pts`` as K7Call's and K8ScanCall's (T, 2, B) int64 table of T
    points a proof (T in ``counts``), contiguous; returns it and B."""
    if pts.dim() != 3 or pts.shape[0] not in counts or pts.shape[1] != 2 or \
            pts.dtype != torch.int64 or not 1 <= pts.shape[2] <= MAX_BATCH:
        raise ValueError(f"points: expected int64 (T, 2, B) with T in {counts}, got "
                         f"{pts.dtype} {tuple(pts.shape)}")
    return pts.contiguous(), pts.shape[2]


def openings_shape(n: int, groups: int, batch: int, sms: int) -> int:
    """K7's coefficients a block for n coefficients, ``groups`` row groups
    and ``batch`` proofs on a card of ``sms`` SMs: the largest power of two
    from K7_MIN_TILE to K7_MAX_TILE that still gives K7_BLOCKS_PER_SM blocks
    an SM (fewer, larger blocks spend less on their powers and partial
    sums), K7_MIN_TILE where none does."""
    tile = K7_MIN_TILE
    while tile < K7_MAX_TILE and \
            -(-n // (2 * tile)) * groups * batch >= K7_BLOCKS_PER_SM * sms:
        tile *= 2
    return tile


def _sm_count(dev: torch.device, lib) -> int:
    key = str(dev)
    with _LOCK:
        sms = _SMS.get(key)
    if sms is None:
        sms = lib.fri_sm_count(dev.index or 0)
        if sms < 1:
            raise RuntimeError(f"fri_sm_count({dev}) failed")
        if dev.type == "cuda":     # the shim's count may change between calls
            with _LOCK:
                _SMS[key] = sms
    return sms


def _counts(dev: torch.device, size: int) -> torch.Tensor:
    """K7's block counters on ``dev`` (int32, at least ``size``): zero
    between calls, since each call's last blocks set theirs back to 0; so
    calls on one card run in stream order."""
    key = str(dev)
    with _LOCK:
        t = _COUNTS.get(key)
        if t is None or t.numel() < size:
            t = torch.zeros(max(size, 1 << 16), dtype=torch.int32, device=dev)
            _COUNTS[key] = t
    return t


def openings(sets: list, pts: torch.Tensor, *, lib=None) -> tuple:
    """K7: ``e`` (B, R) as a component pair, row r of the sets (in order,
    R rows in all) evaluated at its table's point of its proof:
    e[b, r] = sum_i row_r[b, i] z_t[b]^i, with z_t[b] = (pts[t, 0, b],
    pts[t, 1, b]) for the T = 1 or 2 points of ``pts`` (T, 2, B); the
    powers are computed on the card.  ``lib``, a host build of the C
    interface, runs the call on CPU tensors (the tests); without it every
    tensor lies on one CUDA device."""
    pts, batch = _points(pts, (1, 2))
    dev = _device([x for x, *_ in sets] + [pts], lib, "K7", "_openings_plain")
    rows, total, n = _rows(sets, batch)
    if any(t >= pts.shape[0] for _, t, *_ in sets):
        raise ValueError(f"a set names table {max(t for _, t, *_ in sets)} of "
                         f"{pts.shape[0]}")
    lib = _lib() if dev.type == "cuda" else lib
    call = _K7Call(r=rows, pts=pts.data_ptr(), tables=pts.shape[0], group=K7_GROUP)
    groups = lib.k7_row_groups(ctypes.byref(call))   # csrc/fri.cuh k7_groups
    call.tile = openings_shape(n, groups, batch, _sm_count(dev, lib))
    out = torch.empty((2, batch, total), dtype=torch.int64, device=dev)
    part = torch.empty((batch * groups * -(-n // call.tile) * K7_GROUP * 2,),
                       dtype=torch.int64, device=dev)
    counts = _counts(dev, batch * groups)
    call.out, call.part, call.counts = out.data_ptr(), part.data_ptr(), counts.data_ptr()
    _launch("k7", "k7_openings", call, dev, lib, f"B={batch}, {total} rows of {n}")
    return out[0], out[1]


def reduce_alpha(sets: list, alpha: torch.Tensor, *, lib=None) -> list:
    """K8's point kernel: for each table t named by the sets (0, or 0 and
    1), comp_t (B, n) as a component pair, comp_t[b, i] = sum over the rows
    r of table t of alpha[b]^e row_r[b, i], where row j of a set ``(rows,
    table, exp)`` takes e = exp + j (e < MAX_POW); ``alpha`` (1, 2, B)
    holds each proof's alpha, whose powers are computed on the card."""
    alpha, batch = _points(alpha, (1,))
    dev = _device([x for x, *_ in sets] + [alpha], lib, "K8", "_reduce_alpha_plain")
    rows, total, n = _rows(sets, batch)
    npow = max(x.shape[-2] + (e[0] if e else 0) for x, _, *e in sets)
    if npow > MAX_POW:
        raise ValueError(f"the sets take {npow} powers of alpha, K8 keeps {MAX_POW}")
    tables = 1 + max(t for _, t, *_ in sets)
    out = torch.empty((tables, 2, batch, n), dtype=torch.int64, device=dev)
    call = _K8Call(r=rows, alpha=alpha.data_ptr(), out=out.data_ptr(), tables=tables,
                   npow=npow)
    _launch("k8", "k8_reduce", call, dev, lib, f"B={batch}, {total} rows of {n}")
    return [(out[t, 0], out[t, 1]) for t in range(tables)]


def compose(comp0: tuple, comp1: tuple, pts: torch.Tensor, *, lib=None) -> tuple:
    """K8's scan (two launches): the FRI polynomial f (B, n) as a component
    pair from the alpha-reduced comp0 (at zeta) and comp1 (at g zeta), each
    a (B, n) pair, and ``pts`` (3, 2, B): each proof's zeta, g zeta and s
    = alpha^num_zs: f[i] = q1[i] + s q0[i] for i < n - 1 and f[n - 1] =
    0, where q[i] = sum_{j > i} comp[j] z^(j - i - 1) (= z^-(i+1) sum_{j >
    i} comp[j] z^j); the powers are computed on the card."""
    batch, n = comp0[0].shape
    ins = _pairs("compose", [comp0, comp1], (batch, n))
    pts, pb = _points(pts, (3,))
    dev = _device(ins + [pts], lib, "K8's scan", "_compose_plain")
    if pb != batch:
        raise ValueError(f"{pb} points' proofs for {batch}")
    f = torch.empty((2, batch, n), dtype=torch.int64, device=dev)
    scratch = torch.empty(((_lib() if dev.type == "cuda" else lib).k8_scan_scratch(n, batch),),
                          dtype=torch.int64, device=dev)
    call = _K8ScanCall(comp=(ctypes.c_void_p * 4)(*(t.data_ptr() for t in ins)),
                       pts=pts.data_ptr(),
                       f=(ctypes.c_void_p * 2)(f[0].data_ptr(), f[1].data_ptr()),
                       scratch=scratch.data_ptr(), n=n, batch=batch)
    _launch("k8", "k8_scan", call, dev, lib, f"B={batch}, n={n}", count=SCAN_LAUNCHES)
    return f[0], f[1]


def _betas(beta, batch: int) -> np.ndarray:
    """Host betas as (batch, 2) u64: one a proof (a (2,) array for one)."""
    if isinstance(beta, torch.Tensor):
        raise ValueError("K9 takes its betas on the host (a (B, 2) array), not as a tensor")
    b = np.asarray(beta, dtype=np.uint64).reshape(-1, 2)
    if b.shape[0] != batch:
        raise ValueError(f"{b.shape[0]} betas for {batch} proofs")
    return b


def _rows2(c0: torch.Tensor, c1: torch.Tensor) -> tuple:
    """c (N,) or (B, N) as (B, N) views sharing one stride, the last axis
    contiguous (copied where not)."""
    size = c0.shape[-1]
    x0, x1 = (c.reshape(-1, size) for c in (c0, c1))
    if x0.stride() != x1.stride() or (size > 1 and x0.stride(1) != 1):
        x0, x1 = x0.contiguous(), x1.contiguous()
    return x0, x1


def _chunks(batch: int):
    """The proofs of each launch: K9_MAX_BATCH at most."""
    return [(b, min(batch, b + K9_MAX_BATCH)) for b in range(0, batch, K9_MAX_BATCH)]


def fold(c0: torch.Tensor, c1: torch.Tensor, beta, arity_bits: int, *, lib=None) -> tuple:
    """K9's fold mode: new_c[m] = sum_j beta^j c[A m + j] (A =
    2^arity_bits, any arity_bits >= 1 with A dividing N) for c (N,) or
    (B, N) as a component pair, with each proof's beta on the host (a (B, 2)
    array, or (2,) for c (N,)), passed in the launch's parameters; returns
    (..., N / A).  One launch a chunk of K9_MAX_BATCH proofs."""
    *lead, size = c0.shape
    if not 1 <= arity_bits <= MAX_ARITY_BITS or size % (1 << arity_bits) or len(lead) > 1 \
            or c1.shape != c0.shape:
        raise ValueError(f"K9 folds (N,) or (B, N) pairs with N a multiple of the arity "
                         f"(arity bits >= 1); got {tuple(c0.shape)}, {tuple(c1.shape)} at "
                         f"{arity_bits} bits")
    x0, x1 = _rows2(c0, c1)
    batch = x0.shape[0]
    dev = _device([x0, x1], lib, "K9", "_fold_plain")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"expected 1-{MAX_BATCH} proofs, got {batch}")
    betas = _betas(beta, batch)
    m = size >> arity_bits
    out = torch.empty((2, batch, m), dtype=torch.int64, device=dev)
    for lo, hi in _chunks(batch):
        call = _K9Call(c=(ctypes.c_void_p * 2)(x0[lo].data_ptr(), x1[lo].data_ptr()),
                       c_bs=x0.stride(0),
                       out=(ctypes.c_void_p * 2)(out[0, lo].data_ptr(), out[1, lo].data_ptr()),
                       m=m, arity_bits=arity_bits, batch=hi - lo)
        for i, (a, b) in enumerate(betas[lo:hi]):
            call.beta[i][0], call.beta[i][1] = int(a), int(b)
        _launch("k9", "k9_fold", call, dev, lib, f"B={hi - lo}, N={size}, {arity_bits} bits",
                mode="fold")
    return out[0].reshape(*lead, m), out[1].reshape(*lead, m)


def round_fits(n: int, arity_bits: int) -> bool:
    """The round mode's size rule (``fri_device.commit_phase`` takes it
    where this holds, else K9's fold mode, K4's coset NTT and the eager
    fiber regroup): a folded polynomial of at most 2^ROUND_MAX_LOG
    coefficients, whose NTT a coset, its share of f and its tables fit one
    block's shared memory; with the configs' rate of 2^3, next codewords
    up to 2^16 points."""
    return n >> arity_bits <= 1 << ROUND_MAX_LOG


def round_threads(log_m: int) -> int:
    """A round block's threads at 2^log_m points a coset (csrc/fri.cuh
    k9_round_threads): ROUND_THREADS, or as many as keep a thread's NTT
    values within ROUND_REGS."""
    return max(ROUND_THREADS, (1 << log_m) // ROUND_REGS)


def round_group_log(rate_bits: int, log_m: int, arity_bits: int) -> int:
    """log2 of the cosets a cluster (a group that folds once): the fewest
    whose blocks fold their shares of the 2^log_m outputs in one pass of
    round_threads' lanes folding ROUND_UNROLL outputs each (a
    cluster's barriers and remote reads cost more than a second pass of a
    small fold; scripts/k9_variants.py), at most every coset and
    2^ROUND_GROUP_LOG."""
    per_pass = (round_threads(log_m) >> min(arity_bits, 5)) * ROUND_UNROLL
    need = max(0, (log_m - per_pass.bit_length() + 1))
    return min(rate_bits, ROUND_GROUP_LOG, log_m, need)


def _ntt_radix_logs(log_m: int) -> list:
    """log2 of each round's radix in the round mode's NTT (csrc/fri.cuh
    K9Ntt): RADIX_LOG, the last round what is left."""
    rounds = max(1, -(-log_m // RADIX_LOG))
    return [RADIX_LOG] * (rounds - 1) + [log_m - RADIX_LOG * (rounds - 1)]


def ntt_tables(log_m: int) -> np.ndarray:
    """The round mode's NTT tables (csrc/fri.cuh k9_ntt): for each round
    but the last, of radix 2^b over sub-transforms of L_r points,
    w_(L_r)^(j k) at k L_r / 2^b + j; then a 1 (at least one value)."""
    segs, lr = [], log_m
    for b in _ntt_radix_logs(log_m)[:-1]:
        e = np.arange(1 << b)[:, None] * np.arange(1 << (lr - b))[None, :]
        segs.append(gl.powers(gl.primitive_root_of_unity(lr), 1 << lr)[e.reshape(-1)])
        lr -= b
    return np.concatenate(segs + [np.ones(1, dtype=np.uint64)])


def round_smem(log_m: int, group_log: int) -> int:
    """A round block's shared memory in bytes (csrc/fri.cuh
    k9_round_smem): its share of f, the NTT's column, its tables and the
    table of beta^g."""
    n = 1 << log_m
    return 8 * ((n >> group_log) + n + (n >> 4) + ntt_tables(log_m).size - 1 + POW_WORDS)


def coset_powers(shift: int, log_m: int, rate_bits: int, device) -> torch.Tensor:
    """(2^rate_bits, 2^log_m): (shift w_S^c)^i for coset c of the
    2^(log_m + rate_bits)-point codeword (w_S its root of unity), uploaded
    once a shape and card."""
    def make():
        w = gl.primitive_root_of_unity(log_m + rate_bits)
        return gfd.from_u64(np.stack([
            gl.powers(shift * pow(w, c, gl.P_INT) % gl.P_INT, 1 << log_m)
            for c in range(1 << rate_bits)]), device)

    return nttm._cached(("k9_pre", int(shift) % gl.P_INT, log_m, rate_bits, str(device)), make)


def fold_round(c0: torch.Tensor, c1: torch.Tensor, beta, arity_bits: int, next_bits: int,
               rate_bits: int, shift: int, *, lib=None, group_log: int | None = None) -> tuple:
    """K9's round mode, one launch (a chunk of K9_MAX_BATCH proofs): from c
    (B, N) as a component pair and each proof's beta on the host (B, 2),
    the fold f = fold(c, beta) (B, N / A) and the leaves of the next
    codeword, f's coset NTT on shift * <w> at 2^rate_bits times its length,
    in fiber rows of arity 2^next_bits (B, m', 2^(next_bits + 1)), the
    components interleaved: ``_fiber_leaves(*_ext_coset_ntt_dev(f, shift,
    size), 2^next_bits)``.  Returns (f0, f1, leaves).  Takes the rounds of
    ``round_fits``; ``group_log`` (default ``round_group_log``) sets the
    cosets that fold once together (a cluster on the card)."""
    if c0.dim() != 2 or c1.shape != c0.shape:
        raise ValueError(f"K9's round mode takes (B, N) pairs, got {tuple(c0.shape)}, "
                         f"{tuple(c1.shape)}")
    batch, size = c0.shape
    log_m = size.bit_length() - 1 - arity_bits
    group_log = round_group_log(rate_bits, log_m, arity_bits) if group_log is None \
        else group_log
    if size & (size - 1) or not 1 <= arity_bits <= MAX_ARITY_BITS or \
            not 1 <= next_bits <= log_m or not round_fits(size, arity_bits) or \
            not 0 <= rate_bits <= 16 or not 0 <= group_log <= min(rate_bits, ROUND_GROUP_LOG, log_m):
        raise ValueError(f"K9's round mode: N={size} at {arity_bits} bits, next arity "
                         f"{next_bits} bits, rate {rate_bits} bits, group {group_log}: the "
                         f"folded polynomial must hold 2-2^{ROUND_MAX_LOG} coefficients and "
                         f"the next arity at most that")
    x0, x1 = _rows2(c0, c1)
    dev = _device([x0, x1], lib, "K9", "_fold_round_plain")
    betas = _betas(beta, batch)
    m = 1 << log_m
    f = torch.empty((2, batch, m), dtype=torch.int64, device=dev)
    rows = (m << rate_bits) >> next_bits
    leaves = torch.empty((batch, rows, 2 << next_bits), dtype=torch.int64, device=dev)
    tw = nttm._cached(("k9_tw", log_m, RADIX_LOG, str(dev)),
                      lambda: gfd.from_u64(ntt_tables(log_m), dev))
    pre = coset_powers(shift, log_m, rate_bits, dev)
    for lo, hi in _chunks(batch):
        call = _K9RoundCall(c=(ctypes.c_void_p * 2)(x0[lo].data_ptr(), x1[lo].data_ptr()),
                            c_bs=x0.stride(0),
                            f=(ctypes.c_void_p * 2)(f[0, lo].data_ptr(), f[1, lo].data_ptr()),
                            leaves=leaves[lo].data_ptr(), tw=tw.data_ptr(), pre=pre.data_ptr(),
                            arity_bits=arity_bits, log_m=log_m, next_bits=next_bits,
                            rate_bits=rate_bits, group_log=group_log, batch=hi - lo)
        for i, (a, b) in enumerate(betas[lo:hi]):
            call.beta[i][0], call.beta[i][1] = int(a), int(b)
        _launch("k9", "k9_round", call, dev, lib,
                f"B={hi - lo}, N={size}, {arity_bits} -> {next_bits} bits, rate {rate_bits}",
                mode="round")
    return f[0], f[1], leaves
