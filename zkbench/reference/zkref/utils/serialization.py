"""Binary serialization for proofs (and provisional circuit-data artifacts).

Proof wire format (little-endian, self-describing counts) — the analog of
the reference's ProofWithPublicInputs::to_bytes (used for hex-proof export
for the on-chain pallet, wormhole/tests/src/prover/prover_tests.rs:86-120).
Byte-level compatibility with qp-plonky2's format is a later milestone;
this format is versioned and stable."""

from __future__ import annotations

import io
import struct

import numpy as np

MAGIC = b"ZKTP"
VERSION = 1


def _w_u32(buf, v: int):
    buf.write(struct.pack("<I", v))


def _w_u64s(buf, arr):
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    buf.write(arr.tobytes())


def _r_u32(buf) -> int:
    return struct.unpack("<I", buf.read(4))[0]


def _r_u64s(buf, count: int, shape=None) -> np.ndarray:
    data = buf.read(8 * count)
    if len(data) != 8 * count:
        raise ValueError("truncated proof bytes")
    arr = np.frombuffer(data, dtype="<u8").astype(np.uint64)
    return arr.reshape(shape) if shape is not None else arr


def _w_cap(buf, cap):
    _w_u32(buf, cap.shape[0])
    _w_u64s(buf, cap)


def _r_cap(buf):
    m = _r_u32(buf)
    return _r_u64s(buf, 4 * m, (m, 4))


def _w_siblings(buf, siblings):
    _w_u32(buf, len(siblings))
    for s in siblings:
        _w_u64s(buf, s)


def _r_siblings(buf):
    m = _r_u32(buf)
    return [_r_u64s(buf, 4, (4,)) for _ in range(m)]


def proof_to_bytes(pwpi) -> bytes:
    from ..fri.fri import FriProof  # noqa: F401

    p = pwpi.proof
    buf = io.BytesIO()
    buf.write(MAGIC)
    _w_u32(buf, VERSION)
    _w_u32(buf, len(pwpi.public_inputs))
    _w_u64s(buf, pwpi.public_inputs)
    _w_cap(buf, p.wires_cap)
    _w_cap(buf, p.zs_partial_products_cap)
    _w_cap(buf, p.quotient_cap)
    op = p.openings
    for arr in (op.constants_sigmas, op.wires, op.zs_partial_products,
                op.quotient, op.zs_next):
        _w_u32(buf, arr.shape[0])
        _w_u64s(buf, arr)
    fp = p.opening_proof
    _w_u32(buf, len(fp.commit_phase_caps))
    for cap in fp.commit_phase_caps:
        _w_cap(buf, cap)
    _w_u32(buf, len(fp.query_rounds))
    for qr in fp.query_rounds:
        _w_u32(buf, len(qr.initial_leaves))
        for leaf, siblings in qr.initial_leaves:
            _w_u32(buf, len(leaf))
            _w_u64s(buf, leaf)
            _w_siblings(buf, siblings)
        _w_u32(buf, len(qr.steps))
        for step in qr.steps:
            _w_u32(buf, step.coset_values.shape[0])
            _w_u64s(buf, step.coset_values)
            _w_siblings(buf, step.siblings)
    _w_u32(buf, fp.final_poly.shape[0])
    _w_u64s(buf, fp.final_poly)
    _w_u64s(buf, np.array([fp.pow_witness], dtype=np.uint64))
    return buf.getvalue()


def proof_from_bytes(data: bytes, common=None):
    from ..fri.fri import FriProof, FriQueryRound, FriQueryStep
    from ..plonk.proof import OpeningSet, Proof, ProofWithPublicInputs

    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError("bad proof magic")
    version = _r_u32(buf)
    if version != VERSION:
        raise ValueError(f"unsupported proof version {version}")
    n_pi = _r_u32(buf)
    public_inputs = _r_u64s(buf, n_pi)
    wires_cap = _r_cap(buf)
    zsp_cap = _r_cap(buf)
    q_cap = _r_cap(buf)
    arrs = []
    for _ in range(5):
        k = _r_u32(buf)
        arrs.append(_r_u64s(buf, 2 * k, (k, 2)))
    openings = OpeningSet(*arrs)
    n_caps = _r_u32(buf)
    commit_caps = [_r_cap(buf) for _ in range(n_caps)]
    n_qr = _r_u32(buf)
    query_rounds = []
    for _ in range(n_qr):
        n_oracles = _r_u32(buf)
        initial = []
        for _ in range(n_oracles):
            k = _r_u32(buf)
            leaf = _r_u64s(buf, k)
            initial.append((leaf, _r_siblings(buf)))
        n_steps = _r_u32(buf)
        steps = []
        for _ in range(n_steps):
            a = _r_u32(buf)
            vals = _r_u64s(buf, 2 * a, (a, 2))
            steps.append(FriQueryStep(vals, _r_siblings(buf)))
        query_rounds.append(FriQueryRound(initial, steps))
    n_final = _r_u32(buf)
    final_poly = _r_u64s(buf, 2 * n_final, (n_final, 2))
    pow_witness = int(_r_u64s(buf, 1)[0])
    if buf.read(1):
        raise ValueError("trailing bytes in proof")
    proof = Proof(wires_cap, zsp_cap, q_cap, openings,
                  FriProof(commit_caps, query_rounds, final_poly, pow_witness))
    return ProofWithPublicInputs(proof, public_inputs)
