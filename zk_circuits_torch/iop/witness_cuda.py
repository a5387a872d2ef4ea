"""Wrapper of the Hopper witness kernels K3 (csrc/witness.cu).

Replaces the XLA program of the JAX package's
``iop/witness_device.py::_witness_body`` (it has no Pallas kernel; the JAX
package runs the witness as one jitted program): the circuit's static
schedule over a (B, R) table of representative values, then the wire
matrix (B, W, n) and the public inputs (B, P) gathered from it.  The
launches of a witness or a batch of them (``plan``): ``walk`` (one block of
256 threads a proof walks a run of levels from the level records of the
table's blob, synchronising between levels inside the block; a team of 4
threads a Poseidon gate, its trace written into the gate's row), ``ops`` (a
level of more than ``WIDE_OPS`` ops over the whole card) and ``cells`` (the
wire cells and the public inputs).  The zk wormhole's witness is 6 walks, 7
ops launches and the cells, alone or in a batch.

Bound on the H100: the schedule's depth, not bytes or multiplies (see
csrc/witness.cu): 395 dependent levels, each a barrier and a round trip
for its values, and 24 of them a permutation's chain of rounds.

Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first use, a
plain C interface loaded with ctypes.  The plain version is
``witness_device.witness_plain``; this module takes CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..hash import poseidon_cuda
from ..utils.nvcc import BUILD_DIR, build_library
from .witness_device import LEVEL_FIELDS, WitnessTable

HEADERS = ("goldilocks.cuh", "poseidon.cuh", "witness.cuh")
MAX_BATCH = 65535     # proofs per launch (the grid's y extent of ops and cells)
WIDE_OPS = 1024       # a level of more ops runs as an ``ops`` launch over the card

# Launches of the CUDA kernels in this process, in all, by kernel and by card.
launches = 0
launches_by_kernel = {"walk": 0, "ops": 0, "cells": 0}
launches_by_device: dict = {}
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build and the counters, shared by threads


def reset_launches() -> None:
    global launches
    with _LOCK:
        launches = 0
        for k in launches_by_kernel:
            launches_by_kernel[k] = 0
        launches_by_device.clear()


def build():
    """Compile csrc/witness.cu into a shared library (cached by the hash of
    its sources); returns its path."""
    global build_log
    hdr = poseidon_cuda.write_constants_header(BUILD_DIR)
    lib, log = build_library("witness", "witness.cu", HEADERS, (hdr,))
    if log:
        build_log = log
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare witness.cu's C interface on the loaded library ``lib``."""
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.k3_walk.argtypes = [p, ll, i, i, p, ll, p, ll, ll, i, p]
    lib.k3_ops.argtypes = [p, ll, ll, p, ll, i, p]
    lib.k3_cells.argtypes = [ll, p, p, ll, p, p, ll, p, ll, p, i, p]
    for fn in (lib.k3_walk, lib.k3_ops, lib.k3_cells):
        fn.restype = i
    return lib


def _lib():
    """The built library, built and loaded once (under a lock: callers on
    several threads may ask at once)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def plan(levels: list, first: int, last: int) -> list:
    """K3's launches over the levels [first, last) of a schedule whose
    levels are ``levels``, (kind, ops) each: (kernel, first, last) of an
    ``ops`` launch for each level of more than ``WIDE_OPS`` ops (not a
    Poseidon level), and of a walk over each run of levels between them."""
    out, start = [], first
    for lvl in range(first, last):
        kind, m = levels[lvl]
        if m > WIDE_OPS and kind != "poseidon":
            if start < lvl:
                out.append(("walk", start, lvl))
            out.append(("ops", lvl, lvl + 1))
            start = lvl + 1
    if start < last:
        out.append(("walk", start, last))
    return out


def launch_schedule(lib, table: WitnessTable, values: torch.Tensor, wires: torch.Tensor,
                    pis: torch.Tensor, stream, first: int = 0, last: int | None = None,
                    cells: bool = True) -> list:
    """Issue K3's launches through ``lib`` (the built library, or in the
    tests a host build of the same C interface) over the value table
    (B, R), into the zeroed wire matrix (B, W, n) and the public inputs
    (B, P): the schedule's levels [first, last) as ``plan`` splits them
    (none when the range is empty), then, with ``cells``, the cells.
    Returns each launch's kernel and error code,
    up to the first that failed."""
    b, r = values.shape
    n, w = table.n, table.num_wires
    last = len(table.steps) if last is None else last
    if not 0 <= first <= last <= len(table.steps):
        raise ValueError(f"levels [{first}, {last}) outside the schedule's "
                         f"{len(table.steps)}")
    key = (first, last)
    if key not in table.launch_plans:
        table.launch_plans[key] = plan([(st.kind, st.m) for st in table.steps], *key)
    vptr, wptr = values.data_ptr(), wires.data_ptr()
    done = []
    for kernel, lo, hi in table.launch_plans[key]:
        if kernel == "walk":
            err = lib.k3_walk(table.blob.data_ptr(), table.levels_off, lo, hi, vptr, r, wptr,
                              w * n, n, b, stream)
        else:
            err = lib.k3_ops(table.blob.data_ptr(), table.levels_off + lo * len(LEVEL_FIELDS),
                             table.steps[lo].m, vptr, r, b, stream)
        done.append((kernel, err))
        if err:
            return done
    ncells, npis = table.cell_pos.numel(), pis.shape[1]
    if cells and ncells + npis:
        done.append(("cells", lib.k3_cells(ncells, table.cell_pos.data_ptr(),
                                           table.cell_rep.data_ptr(), npis,
                                           table.pi_reps.data_ptr(), vptr, r, wptr, w * n,
                                           pis.data_ptr(), b, stream)))
    return done


def run_schedule(table: WitnessTable, values: torch.Tensor):
    """K3 over the seeded value table ``values`` (B, R) on the card (filled
    in place): returns the wire matrix (B, W, n) and the public inputs (B,
    P), as ``witness_device.witness_plain`` does."""
    if values.device.type != "cuda" or values.device != table.blob.device:
        raise ValueError(f"K3 runs on the table's card ({table.blob.device}), "
                         f"got values on {values.device}")
    b, r = values.shape
    if values.dtype != torch.int64 or not values.is_contiguous() or r != table.num_reps \
            or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"expected contiguous int64 values (B, {table.num_reps}), "
                         f"B <= {MAX_BATCH}; got {values.dtype} {tuple(values.shape)}")
    wires = torch.zeros((b, table.num_wires, table.n), dtype=torch.int64, device=values.device)
    pis = torch.empty((b, table.pi_reps.numel()), dtype=torch.int64, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        for kernel, err in launch_schedule(_lib(), table, values, wires, pis, stream):
            if err != 0:
                raise RuntimeError(f"k3_{kernel} launch failed: error {err}")
            _count(kernel, values.device)
    return wires, pis


def _count(kernel: str, device) -> None:
    global launches
    with _LOCK:
        launches += 1
        launches_by_kernel[kernel] += 1
        launches_by_device[str(device)] = launches_by_device.get(str(device), 0) + 1
