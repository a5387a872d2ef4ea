"""Witness generation: PartialWitness seeding + vectorized static schedule.

The reference engine fills witnesses with demand-driven generators run to
fixpoint; here the schedule was compiled at build time (circuit_data.py) so
generation is a short sequence of vectorized numpy passes — one batch per
(dependency level, generator kind).

Conflicting assignments raise with the reference's wording ("set twice with
different values"), which the soundness-negative tests rely on
(cf. wormhole/tests/src/circuit/storage_proof_tests.rs:30-100).
"""

from __future__ import annotations

import numpy as np

from ..hash.constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    N_PARTIAL_ROUNDS,
    WIDTH,
)
from ..host import gl
from ..host.poseidon import _mds_layer, _sbox
from ..iop import targets as T
from ..iop.gates import PoseidonGate


class PartialWitness:
    def __init__(self):
        self.values: dict[int, int] = {}

    def set_target(self, t: int, value):
        v = int(value) % gl.P_INT
        if t in self.values and self.values[t] != v:
            raise ValueError(
                f"Target {t} was set twice with different values: "
                f"{self.values[t]} != {v}"
            )
        self.values[t] = v

    def set_target_arr(self, ts, values):
        assert len(ts) == len(values)
        for t, v in zip(ts, values):
            self.set_target(t, v)

    def set_hash_target(self, h: T.HashOutTarget, digest):
        self.set_target_arr(list(h.elements), list(digest))

    def set_bool_target(self, b: T.BoolTarget, value: bool):
        self.set_target(b.target, 1 if value else 0)


class WitnessConflict(ValueError):
    pass


def _poseidon_trace(inputs: np.ndarray, swap: np.ndarray):
    """Batched permutation capturing the PoseidonGate wire trace.

    inputs: (m, 12), swap: (m,) in {0,1}.
    Returns (outputs (m,12), deltas (m,4), full0 (m,36), partial (m,22),
    full1 (m,48))."""
    m = inputs.shape[0]
    rc = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, WIDTH)
    deltas = np.empty((m, 4), dtype=np.uint64)
    state = inputs.astype(np.uint64).copy()
    for i in range(4):
        deltas[:, i] = gl.mul(swap, gl.sub(inputs[:, 4 + i], inputs[:, i]))
        state[:, i] = gl.add(inputs[:, i], deltas[:, i])
        state[:, 4 + i] = gl.sub(inputs[:, 4 + i], deltas[:, i])

    full0 = np.empty((m, 36), dtype=np.uint64)
    partial = np.empty((m, 22), dtype=np.uint64)
    full1 = np.empty((m, 48), dtype=np.uint64)

    r = 0
    for fr in range(HALF_N_FULL_ROUNDS):
        state = gl.add(state, rc[r])
        if fr > 0:
            full0[:, (fr - 1) * WIDTH : fr * WIDTH] = state
        state = _sbox(state)
        state = _mds_layer(state)
        r += 1
    for pr in range(N_PARTIAL_ROUNDS):
        state = gl.add(state, rc[r])
        partial[:, pr] = state[:, 0]
        state0 = _sbox(state[:, 0])
        state = np.concatenate([state0[:, None], state[:, 1:]], axis=1)
        state = _mds_layer(state)
        r += 1
    for fr in range(HALF_N_FULL_ROUNDS):
        state = gl.add(state, rc[r])
        full1[:, fr * WIDTH : (fr + 1) * WIDTH] = state
        state = _sbox(state)
        state = _mds_layer(state)
        r += 1
    return state, deltas, full0, partial, full1


def generate_witness(circuit_data, pw: PartialWitness) -> np.ndarray:
    """Run the static schedule; returns the wire matrix (n, num_wires)."""
    common = circuit_data.common
    po = circuit_data.prover_only
    n = common.degree
    num_wires = common.config.num_wires

    values = np.zeros(po.num_reps, dtype=np.uint64)
    is_set = np.zeros(po.num_reps, dtype=bool)
    matrix = np.zeros((n, num_wires), dtype=np.uint64)

    def set_reps(reps: np.ndarray, vals: np.ndarray):
        reps = np.asarray(reps).ravel()
        vals = np.asarray(vals, dtype=np.uint64).ravel()
        conflict = is_set[reps] & (values[reps] != vals)
        if conflict.any():
            raise WitnessConflict(
                "Partition was set twice with different values "
                f"(rep {int(reps[conflict.argmax()])})"
            )
        values[reps] = vals
        is_set[reps] = True
        # Intra-batch duplicate reps with different values:
        if not np.array_equal(values[reps], vals):
            raise WitnessConflict(
                "Partition was set twice with different values (within batch)"
            )

    # Seed with the user's partial witness.
    for t, v in pw.values.items():
        rep = po.rep_of_target.get(t)
        if rep is None:
            raise KeyError(f"target {t} is not part of the circuit")
        set_reps(np.array([rep]), np.array([v], dtype=np.uint64))

    def require(reps: np.ndarray):
        reps = np.asarray(reps)
        missing = ~is_set[reps]
        if missing.any():
            raise ValueError(
                f"witness value not set for rep {int(np.asarray(reps).ravel()[np.argmax(missing)])}"
            )

    def write_wires(d, vals):
        rows, cols, pos = d["out_wires"]
        if rows.size:
            flat = np.asarray(vals, dtype=np.uint64).ravel()
            matrix[rows, cols] = flat[pos]

    for batch in po.schedule:
        d = batch.data
        if batch.kind == "const":
            rows = d["rows"]
            consts = po.constants_values[:, rows].T  # (m, num_constants)
            vals = consts[:, : d["out_reps"].shape[1]]
            set_reps(d["out_reps"], vals)
            write_wires(d, vals)
        elif batch.kind == "arith":
            ir = d["in_reps"]
            require(ir)
            m0, m1, addend = values[ir[:, 0]], values[ir[:, 1]], values[ir[:, 2]]
            out = gl.add(gl.mul(d["c0"], gl.mul(m0, m1)), gl.mul(d["c1"], addend))
            set_reps(d["out_reps"], out)
            write_wires(d, out)
        elif batch.kind == "base_sum":
            require(d["in_reps"])
            x = values[d["in_reps"]]
            nbits = d["num_bits"]
            bits = ((x[:, None] >> np.arange(nbits, dtype=np.uint64)[None, :])
                    & np.uint64(1))
            set_reps(d["out_reps"], bits)
            write_wires(d, bits)
        elif batch.kind == "poseidon":
            ir = d["in_reps"]  # (m, 13): 12 inputs + swap
            require(ir)
            inputs = values[ir[:, :12]]
            swap = values[ir[:, 12]]
            outputs, deltas, full0, partial, full1 = _poseidon_trace(inputs, swap)
            set_reps(d["out_reps"], outputs)
            write_wires(d, outputs)
            rows = d["rows"]
            matrix[rows, PoseidonGate.START_DELTA : PoseidonGate.START_FULL_0] = deltas
            matrix[rows, PoseidonGate.START_FULL_0 : PoseidonGate.START_PARTIAL] = full0
            matrix[rows, PoseidonGate.START_PARTIAL : PoseidonGate.START_FULL_1] = partial
            matrix[rows, PoseidonGate.START_FULL_1 : 135] = full1
        elif batch.kind == "eq_inv":
            require(d["in_reps"])
            x = values[d["in_reps"]]
            inv = gl.inverse(x)  # inverse(0) == 0
            set_reps(d["out_reps"], inv)
        elif batch.kind == "ext_inv":
            from ..host import gle

            ir = d["in_reps"]  # (m, 2)
            require(ir)
            x = np.stack([values[ir[:, 0]], values[ir[:, 1]]], axis=-1)
            inv = gle.inverse(x)  # (m, 2)
            set_reps(d["out_reps"], inv)
        elif batch.kind == "arith_ext":
            from ..host import gle

            ir = d["in_reps"]  # (m, 6): m0(2) m1(2) addend(2)
            require(ir)
            m0 = np.stack([values[ir[:, 0]], values[ir[:, 1]]], axis=-1)
            m1 = np.stack([values[ir[:, 2]], values[ir[:, 3]]], axis=-1)
            ad = np.stack([values[ir[:, 4]], values[ir[:, 5]]], axis=-1)
            out = gle.add(gle.mul_base(gle.mul(m0, m1), d["c0"]),
                          gle.mul_base(ad, d["c1"]))
            set_reps(d["out_reps"], out)
            write_wires(d, out)
        elif batch.kind == "random_access":
            ir = d["in_reps"]  # (m, 1 + V): index + list
            require(ir)
            idx = values[ir[:, 0]].astype(np.int64)
            nbits = d["num_bits"]
            assert np.all((idx >= 0) & (idx < (1 << nbits))), \
                "random_access index out of range"
            lists = values[ir[:, 1:]]
            claimed = lists[np.arange(ir.shape[0]), idx]
            bits = ((idx[:, None].astype(np.uint64)
                     >> np.arange(nbits, dtype=np.uint64)[None, :])
                    & np.uint64(1))
            out = np.concatenate([claimed[:, None], bits], axis=1)
            set_reps(d["out_reps"], out)
            write_wires(d, out)
        else:
            raise ValueError(batch.kind)

    # Routed cells from representative values.
    cells = po.wire_cell_reps
    if cells.shape[0]:
        require(cells[:, 2])
        matrix[cells[:, 0], cells[:, 1]] = values[cells[:, 2]]

    public_inputs = np.array(
        [values[po.rep_of_target[t]] for t in po.public_inputs], dtype=np.uint64
    )
    return matrix, public_inputs
