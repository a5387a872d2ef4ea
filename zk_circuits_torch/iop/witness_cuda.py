"""Wrapper of the Hopper witness kernels K3 (csrc/witness.cu).

Replaces the XLA program of the JAX package's
``iop/witness_device.py::_witness_body`` (it has no Pallas kernel; the JAX
package runs the witness as one jitted program): the circuit's static
schedule over a (B, R) table of representative values, then the wire
matrix (B, W, n) and the public inputs (B, P) gathered from it.  One
launch a schedule batch, ``ops`` (one thread an op) or ``poseidon`` (one
thread a gate, its trace written into the gate's row), and one ``cells``
launch for the wire cells and the public inputs; the proofs of a batch
lie on the grid's y axis.

Bound on the H100: the schedule's depth, not bytes or multiplies (see
csrc/witness.cu): a wormhole witness is ~400 dependent launches of a few
microseconds each, and each Poseidon level one permutation's latency.

Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first use, a
plain C interface loaded with ctypes.  The plain version is
``witness_device.witness_plain``; this module takes CUDA tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from ..hash import poseidon_cuda
from ..utils.nvcc import BUILD_DIR, build_library
from .witness_device import KINDS, WitnessTable

HEADERS = ("goldilocks.cuh", "poseidon.cuh", "witness.cuh")
MAX_BATCH = 65535   # proofs per launch (the grid's y extent)

# Launches of the CUDA kernels in this process, in all and by kernel.
launches = 0
launches_by_kernel = {"ops": 0, "poseidon": 0, "cells": 0}
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None


def reset_launches() -> None:
    global launches
    launches = 0
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


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
    lib.k3_ops.argtypes = [i, ll, p, i, p, i, p, i, p, ll, i, p]
    lib.k3_poseidon.argtypes = [ll, p, p, p, p, ll, p, ll, i, i, p]
    lib.k3_cells.argtypes = [ll, p, p, ll, p, p, ll, p, ll, p, i, p]
    for fn in (lib.k3_ops, lib.k3_poseidon, lib.k3_cells):
        fn.restype = i
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def _plan(table: WitnessTable) -> list:
    """Each schedule batch's kernel and its arguments before the value
    table's: built once per table."""
    if table.k3_plan is None:
        plan = []
        for st in table.steps:
            if st.kind == "poseidon":
                plan.append(("poseidon", (st.m, st.ins.data_ptr(), st.outs.data_ptr(),
                                          st.rows.data_ptr())))
            else:
                plan.append(("ops", (KINDS[st.kind], st.m, st.ins.data_ptr(), st.ins.shape[1],
                                     st.outs.data_ptr(), st.outs.shape[1],
                                     st.consts.data_ptr(), st.nbits)))
        table.k3_plan = plan
    return table.k3_plan


def launch_schedule(lib, table: WitnessTable, values: torch.Tensor, wires: torch.Tensor,
                    pis: torch.Tensor, stream) -> list:
    """Issue K3's launches through ``lib`` (the built library, or in the
    tests a host build of the same C interface) over the value table
    (B, R), into the zeroed wire matrix (B, W, n) and the public inputs
    (B, P): one launch a schedule batch, then the cells.  Returns each
    launch's kernel and error code, up to the first that failed."""
    b, r = values.shape
    n, w = table.n, table.num_wires
    vptr, wptr = values.data_ptr(), wires.data_ptr()
    done = []
    for kernel, args in _plan(table):
        if kernel == "ops":
            err = lib.k3_ops(*args, vptr, r, b, stream)
        else:
            err = lib.k3_poseidon(*args, vptr, r, wptr, n, w, b, stream)
        done.append((kernel, err))
        if err:
            return done
    ncells, npis = table.cell_pos.numel(), pis.shape[1]
    if ncells + npis:
        done.append(("cells", lib.k3_cells(ncells, table.cell_pos.data_ptr(),
                                           table.cell_rep.data_ptr(), npis,
                                           table.pi_reps.data_ptr(), vptr, r, wptr, w * n,
                                           pis.data_ptr(), b, stream)))
    return done


def run_schedule(table: WitnessTable, values: torch.Tensor):
    """K3 over the seeded value table ``values`` (B, R) on the card (filled
    in place): returns the wire matrix (B, W, n) and the public inputs (B,
    P), as ``witness_device.witness_plain`` does."""
    global launches
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
            launches += 1
            launches_by_kernel[kernel] += 1
    return wires, pis
