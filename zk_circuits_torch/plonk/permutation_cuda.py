"""Wrapper of the Hopper permutation-argument kernels K6 (csrc/permutation.cu).

Replaces the XLA program the JAX package jits for the Z and
partial-product values (``plonk/prover.py:266 _zs_coeffs_body``, jitted at
:349); it is no Pallas kernel.  ``products`` is two launches for a proof or
a batch (a point kernel, then a scan, each a block a tile of points of a
proof, ``tile_shape``; two a group of at most MAX_CH challenges): the
values (B, nc (1 + pp), n) that ``plonk/prover.py::_zs_coeffs_body`` hands
to the INTT on the card, and each challenge's closing product (B, nc).
The plain version is ``plonk/prover.py::_zs_values_plain``, which the
prover takes for a CPU tensor.

Bound on the H100: bytes (chip_smoke.py's k6_work, which counts the
inversions as one batch inversion a point with zeros masked; the kernel
inverts each (point, challenge)'s chunk denominators as one batch, an
inverse a challenge).  Counters: ``launches`` (two a group), in all and
by card.  Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first
use, a plain C interface loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..utils.nvcc import build_library

HEADERS = ("goldilocks.cuh", "perm_chunk.cuh", "permutation.cuh")
MAX_CH = 4            # csrc/permutation.cuh K6_MAX_CH: challenges a launch at most
MIN_TILE = 32         # points a block: a warp's lanes, up to
MAX_TILE = 256        # csrc/permutation.cuh K6_MAX_TILE
MAX_ROUTED = 256      # csrc/perm_chunk.cuh PERM_MAX_ROUTED
MAX_BATCH = 65535     # the grid's y extent

launches = 0
launches_by_device: dict = {}
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build, the counters and the caches
_KIS: dict = {}
_SMS: dict = {}            # SMs by device


class _Call(ctypes.Structure):
    """ctypes mirror of csrc/permutation.cuh's K6Call."""

    _fields_ = [(name, ctypes.c_void_p if kind == "p" else ctypes.c_longlong)
                for name, kind in (
                    ("wv", "p"), ("wv_rs", "l"), ("wv_ps", "l"), ("sig", "p"),
                    ("sig_rs", "l"), ("x", "p"), ("kis", "p"), ("betas", "p"),
                    ("gammas", "p"), ("out", "p"), ("out_ps", "l"), ("pp_row", "l"),
                    ("finals", "p"), ("fin_bs", "l"), ("tiles", "p"), ("n", "l"))] + [
                        (name, ctypes.c_int) for name in ("routed", "q", "nc", "batch", "tile")]


def reset_launches() -> None:
    global launches
    with _LOCK:
        launches = 0
        launches_by_device.clear()


def _count(device, k: int) -> None:
    global launches
    with _LOCK:
        launches += k
        launches_by_device[str(device)] = launches_by_device.get(str(device), 0) + k


def build():
    """Compile csrc/permutation.cu (cached by the hash of its sources);
    returns the library's path."""
    global build_log
    lib, log = build_library("permutation", "permutation.cu", HEADERS)
    if log:
        build_log = log
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare permutation.cu's C interface on ``lib`` (the built library,
    or in the tests a host build of it) and check the K6Call mirror."""
    lib.k6_products.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.k6_products.restype = ctypes.c_int
    lib.k6_call_size.restype = ctypes.c_int
    lib.k6_challenges.argtypes = [ctypes.c_int] * 3
    lib.k6_challenges.restype = ctypes.c_int
    lib.k6_sm_count.argtypes = [ctypes.c_int]
    lib.k6_sm_count.restype = ctypes.c_int
    lib.k6_point_threads.restype = ctypes.c_int
    if lib.k6_call_size() != ctypes.sizeof(_Call):
        raise RuntimeError(f"K6Call is {lib.k6_call_size()} bytes in the library, "
                           f"{ctypes.sizeof(_Call)} in its ctypes mirror")
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def _k_is(common, device) -> torch.Tensor:
    """The routed wires' coset shifts on ``device`` (cached)."""
    key = (common.config.num_routed_wires, str(device))
    with _LOCK:
        t = _KIS.get(key)
    if t is None:
        t = gfd.from_u64(np.asarray(common.k_is, dtype=np.uint64), device)
        with _LOCK:
            _KIS[key] = t
    return t


def tile_shape(common, n: int, batch: int, sms: int, lib) -> tuple:
    """(points a tile, challenges a launch) of a call: the largest tile,
    a power of two from MIN_TILE to MAX_TILE, that still gives every one of
    ``sms`` SMs a block and whose (point, challenge) chains the point
    block's threads run at once (a larger tile puts more of a block's
    threads on the inverse chains), halved while a tile's chunk values
    would take fewer challenges a launch than the circuit has, up to
    MAX_CH; then the challenges its shared memory takes
    (csrc/permutation.cuh k6_max_ch)."""
    routed, q = common.config.num_routed_wires, common.quotient_degree_factor
    want = min(common.config.num_challenges, MAX_CH)
    threads = lib.k6_point_threads()
    tile = MIN_TILE
    while tile < MAX_TILE and 2 * tile * want <= threads and \
            -(-n // (2 * tile)) * batch >= sms:
        tile *= 2
    while tile > MIN_TILE and lib.k6_challenges(routed, q, tile) < want:
        tile //= 2
    return tile, lib.k6_challenges(routed, q, tile)


def _sm_count(dev: torch.device, lib) -> int:
    with _LOCK:
        sms = _SMS.get(str(dev))
    if sms is None:
        sms = lib.k6_sm_count(dev.index or 0)
        if sms < 1:
            raise RuntimeError(f"k6_sm_count({dev}) failed")
        if dev.type == "cuda":     # the shim's count may change between calls
            with _LOCK:
                _SMS[str(dev)] = sms
    return sms


def _prepare(common, wvals: torch.Tensor, sigmas: torch.Tensor, x: torch.Tensor,
             betas: torch.Tensor, gammas: torch.Tensor, *, lib=None) -> tuple:
    """Checks ``products``' arguments and returns ``(calls, out, finals)``:
    the K6Calls over them, one a group of the challenges a launch takes
    (``tile_shape``), and their output tensors (B, nc (1 + pp), n) and (B,
    nc), not yet written."""
    cfg = common.config
    nc, routed, q = cfg.num_challenges, cfg.num_routed_wires, common.quotient_degree_factor
    rows = nc * -(-routed // q)
    dev = wvals.device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"K6 runs on CUDA tensors, got one on {dev} (the plain version is "
                         f"plonk/prover.py::_zs_values_plain)")
    if nc < 1 or routed > MAX_ROUTED:
        raise NotImplementedError(f"K6 takes challenges and at most {MAX_ROUTED} routed "
                                  f"wires; got {nc}, {routed}")
    wv = wvals.unsqueeze(0) if wvals.dim() == 2 else wvals
    b, n = wv.shape[0], wv.shape[-1]
    if wv.dim() != 3 or wv.shape[1] < routed or wv.dtype != torch.int64 or \
            (n > 1 and wv.stride(2) != 1) or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"wvals: expected int64 (B, >= {routed}, n) with a contiguous last "
                         f"axis, got {wvals.dtype} {tuple(wvals.shape)}")
    if sigmas.shape[0] < routed or sigmas.shape[-1] != n or (n > 1 and sigmas.stride(1) != 1):
        raise ValueError(f"sigmas: expected ({routed}, {n}), got {tuple(sigmas.shape)}")
    xs = x.contiguous()
    if xs.shape != (n,):
        raise ValueError(f"x: expected ({n},), got {tuple(x.shape)}")
    be, ga = (t.reshape(nc, -1).contiguous() for t in (betas, gammas))
    if be.shape != (nc, b) or ga.shape != (nc, b):
        raise ValueError(f"expected {nc} x {b} challenges, got {tuple(betas.shape)}")
    kis = _k_is(common, dev)
    if any(t.device != dev for t in (sigmas, xs, be, ga)):
        raise ValueError("K6's inputs must lie on one device")
    lib = _lib() if dev.type == "cuda" else lib
    tile, group = tile_shape(common, n, b, _sm_count(dev, lib), lib)
    tiles = -(-n // tile)
    out = torch.empty((b, rows, n), dtype=torch.int64, device=dev)
    finals = torch.empty((b, nc), dtype=torch.int64, device=dev)
    # each call's tiles' products (B, its challenges, tiles)
    scratch = torch.empty((-(-nc // group), b * group * tiles), dtype=torch.int64, device=dev)
    pp = rows // nc - 1
    calls = []
    for k, c0 in enumerate(range(0, nc, group)):
        call = _Call(wv=wv.data_ptr(), wv_rs=wv.stride(1), wv_ps=wv.stride(0),
                     sig=sigmas.data_ptr(), sig_rs=sigmas.stride(0), x=xs.data_ptr(),
                     kis=kis.data_ptr(), betas=be[c0:].data_ptr(), gammas=ga[c0:].data_ptr(),
                     out=out[:, c0:].data_ptr(), out_ps=rows * n, pp_row=nc - c0 + c0 * pp,
                     finals=finals[:, c0:].data_ptr(), fin_bs=nc, tiles=scratch[k].data_ptr(),
                     n=n, routed=routed, q=q, nc=min(group, nc - c0), batch=b, tile=tile)
        # the tensors the call points into live as long as the call
        call._keep = (wv, sigmas, xs, be, ga, kis, scratch)
        calls.append(call)
    return calls, out, finals


def products(common, wvals: torch.Tensor, sigmas: torch.Tensor, x: torch.Tensor,
             betas: torch.Tensor, gammas: torch.Tensor, *, lib=None) -> tuple:
    """K6's two launches (two a group of challenges, ``tile_shape``): from
    the routed wires' values on H ``wvals`` (B,
    routed, n) (or (routed, n) for one proof), the circuit's ``sigmas``
    (routed, n), the subgroup ``x`` (n,) and the challenges (nc, B, 1), the
    Z and partial-product values (B, nc (1 + pp), n) and the closing
    products (B, nc), canonical (without the proof axis for unbatched
    ``wvals``).  ``lib``, a host build of the kernels' C interface, runs the
    call on CPU tensors (the tests); without it every tensor lies on one
    CUDA device."""
    calls, out, finals = _prepare(common, wvals, sigmas, x, betas, gammas, lib=lib)
    dev = wvals.device
    lib = _lib() if dev.type == "cuda" else lib
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    for call in calls:
        for step in (0, 1):
            err = lib.k6_products(dev.index or 0, ctypes.byref(call), step, stream)
            if err != 0:
                raise RuntimeError(f"k6_products (step {step}, B={call.batch}, n={call.n}) "
                                   f"failed: CUDA error {err}")
    if dev.type == "cuda":
        _count(dev, 2 * len(calls))
    return (out[0], finals[0]) if wvals.dim() == 2 else (out, finals)
