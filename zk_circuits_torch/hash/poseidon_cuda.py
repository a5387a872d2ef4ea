"""Wrapper of the Hopper Poseidon leaf kernel (csrc/poseidon_leaf.cu).

Replaces the JAX package's ``hash/poseidon_pallas.py::_leaf_hash_kernel``:
hash_no_pad of every row of a leaf matrix, (n, cols) -> (n, 4) canonical
digests.  Bound on the H100: integer multiplies, not bytes -- a row of
``cols`` felts costs ceil(cols/8) permutations of 118 S-boxes (four
64x64->128 products each) plus 30 MDS layers, against 8*cols + 32 bytes
moved.  The kernel's design answers that with one thread per row, the
state in registers as native u64 and ``__umul64hi`` for the high products,
and reads the input through its strides so the column-major LDE output is
hashed coalesced with no transpose.

Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first use, a
plain C interface loaded with ctypes.  A tensor on the CPU goes to the
plain PyTorch version (hash/poseidon.py); a CUDA tensor goes to the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import torch

from ..utils.nvcc import BUILD_DIR, build_library
from . import constants as C

HEADERS = ("goldilocks.cuh", "poseidon.cuh")

# Launches of the CUDA kernel in this process (the plain version on CPU
# tensors is not counted).
launches = 0
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None


def constants_header() -> str:
    """poseidon_constants.h, generated from hash/constants.py."""

    def switch(name, vals):
        cases = " ".join(f"case {k}: return {v}ULL;" for k, v in enumerate(vals))
        return (f"GL_HD uint64_t {name}(int k) {{ switch (k) {{ {cases} "
                "default: return 0; } }")

    rc = ", \\\n  ".join(", ".join(f"0x{v:016x}ULL" for v in C.ALL_ROUND_CONSTANTS[i:i + 4])
                         for i in range(0, len(C.ALL_ROUND_CONSTANTS), 4))
    return "\n".join([
        "// Generated from zk_circuits_torch/hash/constants.py; do not edit.",
        "#pragma once",
        '#include "goldilocks.cuh"',
        f"#define POSEIDON_WIDTH {C.WIDTH}",
        f"#define POSEIDON_RATE {C.RATE}",
        f"#define POSEIDON_HALF_FULL {C.HALF_N_FULL_ROUNDS}",
        f"#define POSEIDON_PARTIAL {C.N_PARTIAL_ROUNDS}",
        f"#define POSEIDON_ROUNDS {C.N_ROUNDS}",
        switch("poseidon_mds_circ", C.MDS_MATRIX_CIRC),
        switch("poseidon_mds_diag", C.MDS_MATRIX_DIAG),
        f"#define POSEIDON_RC_INIT {{ \\\n  {rc}}}",
        "",
    ])


def write_constants_header(directory: Path) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "poseidon_constants.h"
    text = constants_header()
    if not path.exists() or path.read_text() != text:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, path)
    return path


def build() -> Path:
    """Compile csrc/poseidon_leaf.cu into a shared library (cached by the
    hash of its sources); returns its path."""
    global build_log
    hdr = write_constants_header(BUILD_DIR)
    lib, log = build_library("poseidon_leaf", "poseidon_leaf.cu", HEADERS, (hdr,))
    if log:
        build_log = log
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.poseidon_leaf_hash
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(x: torch.Tensor) -> torch.Tensor:
    global launches
    n, cols = x.shape
    row_stride, col_stride = x.stride()
    out = torch.empty((n, 4), dtype=torch.int64, device=x.device)
    if n == 0:
        return out
    fn = _lib().poseidon_leaf_hash
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, cols, row_stride,
                 col_stride, stream)
    if err != 0:
        raise RuntimeError(f"poseidon_leaf_hash launch failed: CUDA error {err}")
    launches += 1
    return out


def hash_rows(x: torch.Tensor) -> torch.Tensor:
    """hash_no_pad of every row of the (n, cols) matrix ``x`` -> (n, 4).

    ``x`` may be any strided view (e.g. ``values.T`` of a column-major
    (cols, n) tensor); the kernel reads it in place."""
    if x.dtype != torch.int64 or x.dim() != 2:
        raise ValueError(f"expected a 2-D int64 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] < 1:
        raise ValueError("rows must hold at least one element")
    if x.device.type == "cpu":
        from .poseidon import batch_hash_no_pad

        return batch_hash_no_pad(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if min(x.stride()) < 0 or (x.shape[0] > 1 and x.stride(0) == 0) or (
            x.shape[1] > 1 and x.stride(1) == 0):
        raise ValueError(f"unsupported strides {x.stride()}")
    return _launch(x)
