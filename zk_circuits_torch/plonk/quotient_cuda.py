"""Wrapper of the Hopper vanishing-polynomial kernel K5 (csrc/quotient.cu).

Replaces the XLA program the JAX package jits for the quotient
(``plonk/prover.py:186 _quotient_commit_body``, jitted at :230, over
``plonk/vanishing.py:161 eval_vanishing``); it is no Pallas kernel.
``vanishing`` is two launches for a proof or a batch (the permutation
argument's terms, then the gates; two a group of at most ``MAX_CH``
challenges): the vanishing polynomial of every challenge at every point of
the LDE coset, times 1/Z_H(x), (nc, B, points), which
``plonk/prover.py::_quotient_commit_body`` hands to the coset INTT on the
card.  The plain version is
``plonk/prover.py::_device_vanishing_eval`` (times 1/Z_H), which the prover
takes for a CPU tensor.

The gates come from a per-circuit table (``circuit_table``: one upload a
circuit shape and card) of one record a gate type: its kind (``KINDS``),
parameters, selector column, filter constants and the power of alpha its
folded constraints take (csrc/quotient.cuh).  A gate class the table does
not know raises NotImplementedError; nothing falls back to the eager body.

Bound on the H100: operations, the 64x64 products of the gates and of the
permutation argument (see the kernel source and chip_smoke.py's k5_work).

Counters: ``launches``, in all and by card.  Build: nvcc for sm_90a into
``zk_circuits_torch/_build`` at first use, a plain C interface loaded with
ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..hash import poseidon_cuda
from ..iop import gates as G
from ..utils.nvcc import BUILD_DIR, build_library

HEADERS = ("goldilocks.cuh", "perm_chunk.cuh", "poseidon.cuh", "quotient.cuh")
# gate class -> (csrc/quotient.cuh kind, the attributes that are its two
# parameters); the classes, not their subclasses
KINDS = {G.NoopGate: (0, ()), G.ConstantGate: (1, ("num_consts",)),
         G.PublicInputGate: (2, ()), G.ArithmeticGate: (3, ("num_ops",)),
         G.BaseSum2Gate: (4, ("num_limbs",)), G.ArithmeticExtensionGate: (5, ("num_ops", "W")),
         G.RandomAccessGate: (6, ("bits", "num_copies")), G.PoseidonGate: (7, ())}
HEAD = 16             # csrc/quotient.cuh K5_HEAD
GATE_FIELDS = 16      # K5_GATE_FIELDS
MAX_CH = 4            # K5_MAX_CH: challenges a launch
LAUNCHES_PER_GROUP = 2   # csrc/quotient.cu k5_launch: the permutation kernel, then the gates
MAX_POW = 256         # K5_MAX_POW: M + 1 powers of alpha
MAX_ROUTED = 256      # csrc/perm_chunk.cuh PERM_MAX_ROUTED
MAX_FILT = 8          # K5_MAX_FILT
RA_MAX_BITS = 16      # K5_RA_MAX_BITS
MAX_BATCH = 65535     # the grid's y extent

# Launches of the CUDA kernel in this process, in all and by card.
launches = 0
launches_by_device: dict = {}
build_log = ""   # nvcc's output of the last build (ptxas register report)
_LIB = None
_LOCK = threading.Lock()   # the build and the counters, shared by threads
_TABLES: dict = {}


class _Call(ctypes.Structure):
    """ctypes mirror of csrc/quotient.cuh's K5Call."""

    _fields_ = [(name, ctypes.c_void_p if kind == "p" else ctypes.c_longlong)
                for name, kind in (
                    ("circuit", "p"), ("cs", "p"), ("cs_rs", "l"), ("wires", "p"),
                    ("w_rs", "l"), ("w_ps", "l"), ("zsp", "p"), ("z_rs", "l"), ("z_ps", "l"),
                    ("pp_row", "l"),
                    ("znext", "p"), ("zn_rs", "l"), ("zn_ps", "l"), ("zn_shift", "l"),
                    ("zn_len", "l"), ("x", "p"), ("l1", "p"), ("zh_inv", "p"), ("row0", "l"),
                    ("pi_hash", "p"), ("betas", "p"), ("gammas", "p"), ("alphas", "p"),
                    ("out", "p"), ("points", "l"))] + [("batch", ctypes.c_int),
                                                        ("nc", ctypes.c_int)]


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
    """Compile csrc/quotient.cu (cached by the hash of its sources); returns
    the library's path."""
    global build_log
    hdr = poseidon_cuda.write_constants_header(BUILD_DIR)
    lib, log = build_library("quotient", "quotient.cu", HEADERS, (hdr,))
    if log:
        build_log = log
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare quotient.cu's C interface on ``lib`` (the built library, or
    in the tests a host build of it) and check the K5Call mirror."""
    lib.k5_vanishing.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.k5_vanishing.restype = ctypes.c_int
    lib.k5_call_size.restype = ctypes.c_int
    if lib.k5_call_size() != ctypes.sizeof(_Call):
        raise RuntimeError(f"K5Call is {lib.k5_call_size()} bytes in the library, "
                           f"{ctypes.sizeof(_Call)} in its ctypes mirror")
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


# --- the circuit table -----------------------------------------------------------


def gate_record(gate, common) -> list:
    """A gate type's record (csrc/quotient.cuh K5_G_*): kind, two
    parameters, selector column, filter constants' count, M - K, and the
    filter constants (the other gates of its selector group, then the
    unused-selector index when there are several groups)."""
    if type(gate) not in KINDS:
        raise NotImplementedError(f"K5 has no evaluator for gate {gate.id!r} "
                                  f"({type(gate).__name__})")
    kind, names = KINDS[type(gate)]
    p0, p1 = ([getattr(gate, a) for a in names] + [0, 0])[:2]
    if kind == 6 and gate.bits > RA_MAX_BITS:
        raise NotImplementedError(f"K5 takes random-access gates of up to {RA_MAX_BITS} "
                                  f"bits, got {gate.id}")
    gi = common.gate_to_index[gate.id]
    grp = common.gate_to_group[gate.id]
    filt = [gj for gj in common.selector_groups[grp] if gj != gi]
    if len(common.selector_groups) > 1:
        filt.append(common.unused_selector)
    if len(filt) > MAX_FILT:
        raise NotImplementedError(f"K5 takes filters of up to {MAX_FILT} terms, gate "
                                  f"{gate.id} has {len(filt)}")
    rec = [kind, p0, p1, grp, len(filt), common.num_gate_constraints - gate.num_constraints]
    return rec + filt + [0] * (GATE_FIELDS - len(rec) - len(filt))


def circuit_blob(common) -> np.ndarray:
    """The circuit's K5 table on the host (int64): the header, the routed
    wires' coset shifts, a record a gate type."""
    cfg = common.config
    q, routed = common.quotient_degree_factor, cfg.num_routed_wires
    chunks = -(-routed // q)
    m, nc = common.num_gate_constraints, cfg.num_challenges
    if nc < 1 or m >= MAX_POW or routed > MAX_ROUTED:
        raise NotImplementedError(f"K5 takes challenges, fewer than {MAX_POW} constraint "
                                  f"slots and at most {MAX_ROUTED} routed wires; got {nc}, "
                                  f"{m}, {routed}")
    head = [len(common.gate_types), common.num_selectors, cfg.num_constants, routed, q,
            chunks, chunks - 1, m, nc, cfg.num_wires]
    head += [0] * (HEAD - len(head))
    k_is = np.asarray(common.k_is, dtype=np.uint64).view(np.int64)
    recs = [gate_record(g, common) for g in common.gate_types]
    return np.concatenate([np.array(head, dtype=np.int64), k_is,
                           np.array(recs, dtype=np.int64).reshape(-1)])


def _key(common) -> tuple:
    cfg = common.config
    return (tuple(g.id for g in common.gate_types),
            tuple(tuple(g) for g in common.selector_groups), common.num_gate_constraints,
            cfg.num_routed_wires, cfg.num_constants, cfg.num_challenges, cfg.num_wires,
            common.quotient_degree_factor)


def circuit_table(common, device) -> torch.Tensor:
    """``circuit_blob`` on ``device``, uploaded once a circuit shape and
    device (NotImplementedError for a gate K5 does not know)."""
    key = (_key(common), str(device))
    with _LOCK:
        table = _TABLES.get(key)
    if table is None:
        table = torch.from_numpy(circuit_blob(common)).to(device)
        with _LOCK:
            _TABLES[key] = table
    return table


# --- the entry point ---------------------------------------------------------------


def _matrix(t: torch.Tensor, what: str, rows: int, points: int) -> torch.Tensor:
    """``t`` as (B, >= rows, points) int64 with a contiguous last axis (a
    view; a 2-D tensor is one proof)."""
    if t.dim() == 2:
        t = t.unsqueeze(0)
    if t.dim() != 3 or t.dtype != torch.int64 or t.shape[1] < rows or t.shape[2] != points \
            or (points > 1 and t.stride(2) != 1):
        raise ValueError(f"{what}: expected int64 (B, >= {rows}, {points}) with a contiguous "
                         f"last axis, got {t.dtype} {tuple(t.shape)} {t.stride()}")
    return t


def _challenges(t: torch.Tensor, nc: int, batch: int, what: str) -> torch.Tensor:
    """(nc, B, 1), (nc, B) or (nc, 1) for one proof -> contiguous (nc, B)."""
    v = t.reshape(nc, -1)
    if v.shape[1] != batch or v.dtype != torch.int64:
        raise ValueError(f"{what}: expected {nc} x {batch} int64 challenges, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return v.contiguous()


def vanishing(common, cs: torch.Tensor, wires: torch.Tensor, zsp: torch.Tensor,
              tables: tuple, pi_hash: torch.Tensor, betas: torch.Tensor,
              gammas: torch.Tensor, alphas: torch.Tensor, *, zs_next=None, row0: int = 0,
              lib=None) -> torch.Tensor:
    """K5's launches, two a group of at most ``MAX_CH`` challenges (the
    group's challenge, zs, partial-product and output rows read and written
    in place): the vanishing polynomial of each challenge times 1/Z_H at
    ``points`` coset points, canonical, (nc, B, points) (or (nc, points)
    for unbatched ``wires``).

    ``cs`` (selectors, constants, sigmas: (k, points)) is the circuit's,
    ``wires`` (B, >= num_wires, points) and ``zsp`` (B, >= nc (1 + pp),
    points) the proofs' column-major LDE values; ``tables`` (x, l1,
    1/Z_H) are the coset's columns, read from row ``row0`` on;
    ``pi_hash`` holds a proof's 4 elements and the challenges (nc, B, 1)
    a proof's in each column.  ``zs_next``, the zs rows at g x (a shard's
    rows and its halo), defaults to ``zsp``'s zs rows 2^rate_bits points
    further on, wrapping at ``points``.  ``lib``, a host build of the
    kernel's C interface, runs the call on CPU tensors (the tests); without
    it every tensor lies on one CUDA device."""
    cfg = common.config
    nc, points = cfg.num_challenges, cs.shape[-1]
    pp = -(-cfg.num_routed_wires // common.quotient_degree_factor) - 1
    unbatched = wires.dim() == 2
    dev = cs.device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors, got one on {dev} (the plain version is "
                         f"plonk/prover.py::_device_vanishing_eval)")
    table = circuit_table(common, dev)
    csm = _matrix(cs, "cs", common.num_constants_sigmas_polys, points)[0]
    w = _matrix(wires, "wires", cfg.num_wires, points)
    z = _matrix(zsp, "zsp", nc * (1 + pp), points)
    b = w.shape[0]
    if z.shape[0] != b or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"wires and zsp hold {b} and {z.shape[0]} proofs (1 to {MAX_BATCH})")
    if zs_next is None:
        zn, shift = z, 1 << cfg.rate_bits
    else:
        zn, shift = _matrix(zs_next, "zs_next", nc, points), 0
        if zn.shape[0] != b:
            raise ValueError(f"zs_next holds {zn.shape[0]} proofs, the wires {b}")
    if shift >= points:
        raise ValueError(f"{points} points: fewer than the zs shift {shift}")
    x, l1, zh_inv = (t.contiguous() for t in tables)
    if any(t.dim() != 1 or t.shape[0] < row0 + points for t in (x, l1, zh_inv)) or row0 < 0:
        raise ValueError(f"the coset tables must hold rows {row0} .. {row0 + points}")
    pis = pi_hash.reshape(-1, 4).contiguous()
    if pis.shape[0] != b:
        raise ValueError(f"pi_hash holds {pis.shape[0]} proofs, the wires {b}")
    be, ga, al = (_challenges(t, nc, b, name) for t, name in
                  ((betas, "betas"), (gammas, "gammas"), (alphas, "alphas")))
    tensors = (csm, w, z, zn, x, l1, zh_inv, pis, be, ga, al)
    if any(t.device != dev for t in tensors):
        raise ValueError("K5's inputs must lie on one device")
    out = torch.empty((nc, b, points), dtype=torch.int64, device=dev)
    lib = _lib() if dev.type == "cuda" else lib
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    for c0 in range(0, nc, MAX_CH):
        k = min(MAX_CH, nc - c0)
        call = _Call(circuit=table.data_ptr(), cs=csm.data_ptr(), cs_rs=csm.stride(0),
                     wires=w.data_ptr(), w_rs=w.stride(1), w_ps=w.stride(0),
                     zsp=z[:, c0:].data_ptr(), z_rs=z.stride(1), z_ps=z.stride(0),
                     pp_row=nc - c0 + c0 * pp, znext=zn[:, c0:].data_ptr(),
                     zn_rs=zn.stride(1), zn_ps=zn.stride(0), zn_shift=shift, zn_len=points,
                     x=x.data_ptr(), l1=l1.data_ptr(), zh_inv=zh_inv.data_ptr(), row0=row0,
                     pi_hash=pis.data_ptr(), betas=be[c0:].data_ptr(),
                     gammas=ga[c0:].data_ptr(), alphas=al[c0:].data_ptr(),
                     out=out[c0:].data_ptr(), points=points, batch=b, nc=k)
        err = lib.k5_vanishing(dev.index or 0, ctypes.byref(call), stream)
        if err != 0:
            raise RuntimeError(f"k5_vanishing (B={b}, {points} points, challenges {c0}.."
                               f"{c0 + k - 1}) failed: CUDA error {err}")
        if dev.type == "cuda":
            _count(dev, LAUNCHES_PER_GROUP)
    return out[:, 0] if unbatched else out
