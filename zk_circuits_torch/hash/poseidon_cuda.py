"""Wrapper of the Hopper Poseidon kernel K1 (csrc/poseidon_leaf.cu).

Replaces the JAX package's ``hash/poseidon_pallas.py::_leaf_hash_kernel``:
hash_no_pad of every row of a leaf matrix, (n, cols) -> (n, 4) canonical
digests, and -- new on Hopper -- whole Merkle trees up to their cap.  Bound
on the H100: integer instructions, not bytes (a row of ``cols`` felts costs
ceil(cols/8) permutations against 8*cols + 32 bytes moved).  The kernel
hashes a row with one thread (the fewest instructions) where there are
rows enough to fill the card, and with a team of threads of a warp that
share the 12-lane state through warp shuffles where there are few
(``config``); it stages the input through shared memory, reads the
column-major LDE output in place, and builds each block's Merkle subtree
in shared memory; one more launch, one block a tree, builds the levels
above the blocks' subtrees.  A batch of B matrices of one shape (the
proofs of a batched prover, a leading axis of the tensor) goes through the
same launches: B times the blocks, each proof's digests and tree at a
stride of their own.

Three launch modes, each counted in ``launches_by_mode``: ``sponge``
(``hash_rows``: digests only), ``tree`` (the leaves and the blocks'
subtrees of ``hash_tree``) and ``top`` (the levels above them).

Build: nvcc for sm_90a into ``zk_circuits_torch/_build`` at first use, a
plain C interface loaded with ctypes.  A tensor on the CPU goes to the
plain PyTorch version (``hash_rows_plain``, ``hash_tree_plain``); a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import torch

from ..utils.nvcc import BUILD_DIR, build_library
from . import constants as C

HEADERS = ("goldilocks.cuh", "poseidon.cuh")
TEAMS = (1, 4)                # threads per row the sponge is built for
MAX_ROWS = 256                # rows per block
TREE_TEAM = 4                 # threads per node above the first tree levels

# Launches of the CUDA kernels in this process (the plain version on CPU
# tensors is not counted): ``launches`` in all, by mode and by card.
launches = 0
launches_by_mode = {"sponge": 0, "tree": 0, "top": 0}
launches_by_device: dict = {}
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build and the counters, shared by threads


def reset_launches() -> None:
    global launches
    with _LOCK:
        launches = 0
        for k in launches_by_mode:
            launches_by_mode[k] = 0
        launches_by_device.clear()


def config(n: int) -> tuple[int, int]:
    """(threads per row, rows per block) for a launch over ``n`` rows in
    all (every matrix of a batch): one thread per row where there are rows
    enough to fill the card, teams of four below; blocks of 256 rows where
    that still makes 128 blocks or more.  From chip_smoke.py's k1_time
    candidates: one thread a row wins from 2^14 rows (a sharded commit's
    shard) up, teams of four at 2^13 (its first compress level) and below;
    at 2^14 rows, blocks of 128 rows beat 256 by a third."""
    if n >= 1 << 15:
        return 1, 256
    return (1, 128) if n >= 1 << 14 else (4, 32)


def _launch_config(x: torch.Tensor, team, rows) -> tuple[int, int]:
    """``config`` of all of x's rows, the rows per block at most one
    matrix's rows, unless the caller chose them."""
    n = x.shape[-2]
    t, r = config(x.shape[:-1].numel())
    return (t if team is None else team), (min(r, n) if rows is None else rows)


def max_threads(team: int) -> int:
    """The kernel's __launch_bounds__ for ``team`` threads per row."""
    return 256 if team == 1 else 512


def tree_plan(n: int, cap_height: int, rows: int) -> dict:
    """How ``hash_tree`` splits a tree over n leaves: ``depth`` compress
    levels up to the cap, the first ``in_block`` of them inside each
    block's subtree (the tree launch), the rest in one block of
    ``top_threads`` threads (the top launch, when ``in_block < depth``);
    ``sizes``: nodes per level."""
    depth = n.bit_length() - 1 - cap_height
    in_block = min(min(rows, n).bit_length() - 1, depth)
    sizes = [n >> lvl for lvl in range(depth + 1)]
    top_threads = 0
    if in_block < depth:
        top_threads = min(512, -(-sizes[in_block + 1] // (32 // TREE_TEAM)) * 32)
    return {"depth": depth, "in_block": in_block, "sizes": sizes,
            "top_threads": top_threads}


def freq_blocks() -> dict:
    """The circulant MDS in the frequency domain (csrc/poseidon.cuh,
    poseidon_mds_freq_half): for the 4-point DFT over lanes b, b+3, b+6,
    b+9 and output group q, the coefficients of X0[b], X2[b] (real) and
    X1[b] (complex) in Z0[q], Z2[q], Z1[q], with the inverse DFT's 1/4
    folded in.  Exact integers, or a ValueError."""
    circ = C.MDS_MATRIX_CIRC

    def h(q, b, k):   # sum_e circ[(b - q + 3e) % 12] * i^(-e k), as (re, im)
        re = im = 0
        for e in range(4):
            c = circ[(b - q + 3 * e) % 12]
            w = (-e * k) % 4           # i^w: 1, i, -1, -i
            re += c * (1, 0, -1, 0)[w]
            im += c * (0, 1, 0, -1)[w]
        return re, im

    out = {"freq0": [], "freq2": [], "freq1r": [], "freq1i": []}
    for q in range(3):
        for b in range(3):
            (r0, i0), (r1, i1), (r2, i2) = h(q, b, 0), h(q, b, 1), h(q, b, 2)
            if r0 % 4 or r2 % 4 or r1 % 2 or i1 % 2 or i0 or i2:
                raise ValueError("MDS circulant has no small integer frequency form")
            out["freq0"].append(r0 // 4)
            out["freq2"].append(r2 // 4)
            out["freq1r"].append(r1 // 2)
            out["freq1i"].append(i1 // 2)
    return out


def constants_header() -> str:
    """poseidon_constants.h, generated from hash/constants.py."""

    def switch(name, vals, ctype="uint64_t", suffix="ULL"):
        cases = " ".join(f"case {k}: return {v}{suffix};" for k, v in enumerate(vals))
        return (f"GL_HD {ctype} {name}(int k) {{ switch (k) {{ {cases} "
                "default: return 0; } }")

    rc = ", \\\n  ".join(", ".join(f"0x{v:016x}ULL" for v in C.ALL_ROUND_CONSTANTS[i:i + 4])
                         for i in range(0, len(C.ALL_ROUND_CONSTANTS), 4))
    freq = [switch(f"poseidon_{k}", v, "int64_t", "LL") for k, v in freq_blocks().items()]
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
        *freq,
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
    """The built library, built and loaded once (under a lock: callers on
    several threads may ask at once)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
            lib.k1_sponge.argtypes = [p, p, ll, i, ll, ll, i, i, i, i, i, ll, ll, p]
            lib.k1_sponge.restype = i
            lib.k1_top.argtypes = [p, ll, i, i, i, i, ll, p]
            lib.k1_top.restype = i
            _LIB = lib
    return _LIB


def _check(x: torch.Tensor) -> None:
    """x: an (n, cols) matrix, or a batch (B, n, cols) of them."""
    if x.dtype != torch.int64 or x.dim() not in (2, 3):
        raise ValueError(f"expected a 2-D or 3-D int64 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[-1] < 1:
        raise ValueError("rows must hold at least one element")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and (min(x.stride()) < 0 or any(
            size > 1 and stride == 0 for size, stride in zip(x.shape, x.stride()))):
        raise ValueError(f"unsupported strides {x.stride()}")


def _vec16(x: torch.Tensor) -> int:
    """1 if the kernel may copy two neighbouring elements of the contiguous
    axis at once (16 bytes, 16-byte aligned, in every matrix of a batch)."""
    rs, cs = x.stride()[-2:]
    if x.data_ptr() % 16 or (x.dim() == 3 and x.stride(0) % 2):
        return 0
    if rs == 1 and cs != 1:
        return int(cs % 2 == 0)
    return int(cs == 1 and rs % 2 == 0)


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(mode: str, device) -> None:
    global launches
    with _LOCK:
        launches += 1
        launches_by_mode[mode] += 1
        launches_by_device[str(device)] = launches_by_device.get(str(device), 0) + 1


def _batch(x: torch.Tensor, out: torch.Tensor) -> tuple[int, int, int]:
    """(matrices, input stride, output stride) of a launch over x: one
    matrix for a 2-D x; else its leading axis, out contiguous."""
    if x.dim() == 2:
        return 1, 0, 0
    return x.shape[0], x.stride(0), out[0].numel()


def _sponge(x, out, team, rows, levels, mode) -> None:
    n, cols = x.shape[-2:]
    batch, in_bstride, out_bstride = _batch(x, out)
    with torch.cuda.device(x.device):
        err = _lib().k1_sponge(x.data_ptr(), out.data_ptr(), n, cols, x.stride(-2),
                               x.stride(-1), team, rows, levels, _vec16(x), batch,
                               in_bstride, out_bstride, _stream(x))
    if err != 0:
        raise RuntimeError(f"k1_sponge launch failed: error {err}")
    _count(mode, x.device)


def hash_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``hash_rows``."""
    from .poseidon import batch_hash_no_pad

    return batch_hash_no_pad(x)


def hash_rows(x: torch.Tensor, team: int | None = None,
              rows: int | None = None) -> torch.Tensor:
    """hash_no_pad of every row of the (n, cols) matrix ``x`` -> (n, 4),
    or of each matrix of a batch (B, n, cols) -> (B, n, 4), in one launch.

    ``x`` may be any strided view (e.g. ``values.T`` of a column-major
    (cols, n) tensor, ``values.transpose(1, 2)`` of a (B, cols, n) one);
    the kernel reads it in place.  ``team`` and ``rows`` override the
    threads per row and rows per block of ``config``."""
    _check(x)
    if x.device.type == "cpu":
        return hash_rows_plain(x)
    team, rows = _launch_config(x, team, rows)
    if team not in TEAMS or not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"unsupported team {team} / rows per block {rows}")
    out = torch.empty((*x.shape[:-1], 4), dtype=torch.int64, device=x.device)
    if out.numel():
        _sponge(x, out, team, rows, 0, "sponge")
    return out


def hash_tree_plain(x: torch.Tensor, cap_height: int) -> list:
    """Plain PyTorch version of ``hash_tree``: the leaf digests
    (hash_or_noop of each row), then one compress level at a time, over
    any leading axes."""
    from .poseidon import batch_hash_no_pad, batch_hash_or_noop

    levels = [batch_hash_or_noop(x)]
    while levels[-1].shape[-2] > (1 << cap_height):
        cur = levels[-1]
        levels.append(batch_hash_no_pad(cur.reshape(*cur.shape[:-2], cur.shape[-2] // 2, 8)))
    return levels


def hash_tree(x: torch.Tensor, cap_height: int) -> list:
    """Every level of the Merkle tree over the rows of ``x`` (n, cols), n a
    power of two >= 2^cap_height: the leaf digests (hash_or_noop of each
    row) first, the cap (2^cap_height digests) last, each an (m, 4) int64
    tensor.  For a batch ``x`` (B, n, cols), the B trees, each level (B, m,
    4).  ``x`` may be any strided view, as for ``hash_rows``.

    On the card: one launch hashes the leaves and builds each block's
    subtree in shared memory, and, when the blocks' subtree roots are more
    than the cap, one more launch, a block a tree, builds the levels
    above; a batch takes the same two launches."""
    _check(x)
    n, cols = x.shape[-2:]
    if n < (1 << cap_height) or n & (n - 1):
        raise ValueError(f"{n} leaves: need a power of two >= 2^{cap_height}")
    if x.device.type == "cpu":
        return hash_tree_plain(x, cap_height)
    lead = x.shape[:-2]
    if cols <= 4:
        # hash_or_noop pads narrow rows; the compress levels are the tree
        # of the padded digests paired up into rows of 8
        from .poseidon import batch_hash_or_noop

        leaves = batch_hash_or_noop(x)
        if n == 1 << cap_height:
            return [leaves]
        return [leaves] + hash_tree(leaves.reshape(*lead, n // 2, 8), cap_height)
    team, rows = _launch_config(x, None, None)
    plan = tree_plan(n, cap_height, rows)
    out = torch.empty((*lead, sum(plan["sizes"]), 4), dtype=torch.int64, device=x.device)
    _sponge(x, out, team, rows, plan["in_block"], "tree")
    if plan["top_threads"]:
        batch, _, out_bstride = _batch(x, out)
        with torch.cuda.device(x.device):
            err = _lib().k1_top(out.data_ptr(), n, plan["in_block"], plan["depth"],
                                plan["top_threads"], batch, out_bstride, _stream(x))
        if err != 0:
            raise RuntimeError(f"k1_top launch failed: error {err}")
        _count("top", x.device)
    return list(torch.split(out, plan["sizes"], dim=-2))
