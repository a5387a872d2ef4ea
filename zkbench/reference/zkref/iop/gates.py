"""Gate vocabulary for the plonkish constraint system.

Exactly the gates needed by the reference circuits (SURVEY.md §2.2 usage
surface): arithmetic ops, constants, public inputs, base-2 decompositions
(range checks / split_le) and the width-12 Poseidon permutation.  Each gate
occupies one row of the trace and contributes constraints evaluated through
the algebra abstraction (plonk/algebra.py), so one implementation serves
host (numpy base/extension) and torch tensor evaluation.

Reference counterparts are the qp-plonky2 gates (external crate); wire
budgets follow the 135-wire / 80-routed standard config.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

from ..hash.constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    N_PARTIAL_ROUNDS,
    WIDTH,
)


class EvalVars(NamedTuple):
    """Per-row values handed to gate evaluators.

    local_constants: (npoints, num_constants)   algebra array
    local_wires:     (npoints, num_wires)       algebra array
    public_inputs_hash: (npoints, 4)            algebra array (broadcastable)
    """

    alg: Any
    local_constants: Any
    local_wires: Any
    public_inputs_hash: Any


class Gate:
    id: str = "Gate"
    degree: int = 0
    num_constraints: int = 0
    num_constants_used: int = 0
    num_wires_used: int = 0

    def eval(self, v: EvalVars) -> list:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, Gate) and self.id == other.id


class NoopGate(Gate):
    id = "NoopGate"
    degree = 0
    num_constraints = 0

    def eval(self, v: EvalVars) -> list:
        return []


@dataclass(frozen=True, eq=False)
class ConstantGate(Gate):
    """wires[i] == local_constants[i] for i < num_consts."""

    num_consts: int = 2

    def __post_init__(self):
        object.__setattr__(self, "id", f"ConstantGate(num_consts={self.num_consts})")
        object.__setattr__(self, "degree", 1)
        object.__setattr__(self, "num_constraints", self.num_consts)
        object.__setattr__(self, "num_constants_used", self.num_consts)
        object.__setattr__(self, "num_wires_used", self.num_consts)

    def eval(self, v: EvalVars) -> list:
        return [
            v.alg.sub(v.alg.col(v.local_wires, i), v.alg.col(v.local_constants, i))
            for i in range(self.num_consts)
        ]


class PublicInputGate(Gate):
    """wires[0..4] == hash(public inputs)."""

    id = "PublicInputGate"
    degree = 1
    num_constraints = 4
    num_wires_used = 4

    def eval(self, v: EvalVars) -> list:
        return [
            v.alg.sub(v.alg.col(v.local_wires, i), v.alg.col(v.public_inputs_hash, i))
            for i in range(4)
        ]


@dataclass(frozen=True, eq=False)
class ArithmeticGate(Gate):
    """num_ops ops of: out = c0 * m0 * m1 + c1 * addend.

    Wires per op i: [4i]=m0, [4i+1]=m1, [4i+2]=addend, [4i+3]=out.
    c0, c1 are the row's two constant slots (ops sharing a row share them).
    """

    num_ops: int = 20

    def __post_init__(self):
        object.__setattr__(self, "id", f"ArithmeticGate(num_ops={self.num_ops})")
        object.__setattr__(self, "degree", 3)
        object.__setattr__(self, "num_constraints", self.num_ops)
        object.__setattr__(self, "num_constants_used", 2)
        object.__setattr__(self, "num_wires_used", 4 * self.num_ops)

    def eval(self, v: EvalVars) -> list:
        alg = v.alg
        c0 = alg.col(v.local_constants, 0)
        c1 = alg.col(v.local_constants, 1)
        out = []
        for i in range(self.num_ops):
            m0 = alg.col(v.local_wires, 4 * i)
            m1 = alg.col(v.local_wires, 4 * i + 1)
            addend = alg.col(v.local_wires, 4 * i + 2)
            o = alg.col(v.local_wires, 4 * i + 3)
            computed = alg.add(alg.mul(c0, alg.mul(m0, m1)), alg.mul(c1, addend))
            out.append(alg.sub(computed, o))
        return out

    def eval_device(self, v: EvalVars) -> list:
        """Vectorized over the num_ops axis (one mul chain instead of 20)."""
        from ..field import goldilocks as gfd

        w = v.local_wires  # tensor (npoints, num_wires)
        quad = w[..., : 4 * self.num_ops]
        quad = quad.reshape(*quad.shape[:-1], self.num_ops, 4)
        m0, m1, addend, o = (quad[..., j] for j in range(4))
        c0b = v.local_constants[..., 0:1]
        c1b = v.local_constants[..., 1:2]
        computed = gfd.add(gfd.mul(c0b, gfd.mul(m0, m1)), gfd.mul(c1b, addend))
        diff = gfd.sub(computed, o)  # (npoints, num_ops)
        return [diff[..., i] for i in range(self.num_ops)]


@dataclass(frozen=True, eq=False)
class BaseSum2Gate(Gate):
    """Base-2 decomposition: wire 0 = sum, wires 1..=num_limbs = bits (LE).

    Constraints: sum - Σ 2^i b_i  and  b_i^2 - b_i  per bit.
    Used for split_le / range_check (cf. common/src/gadgets.rs:20 usage).
    """

    num_limbs: int = 32

    def __post_init__(self):
        object.__setattr__(self, "id", f"BaseSum2Gate(num_limbs={self.num_limbs})")
        object.__setattr__(self, "degree", 2)
        object.__setattr__(self, "num_constraints", 1 + self.num_limbs)
        object.__setattr__(self, "num_wires_used", 1 + self.num_limbs)

    WIRE_SUM = 0

    def limb_wire(self, i: int) -> int:
        return 1 + i

    def eval(self, v: EvalVars) -> list:
        alg = v.alg
        s = alg.col(v.local_wires, 0)
        acc = None
        for i in range(self.num_limbs):
            b = alg.col(v.local_wires, 1 + i)
            term = alg.mul_scalar(b, 1 << i)
            acc = term if acc is None else alg.add(acc, term)
        cons = [alg.sub(s, acc)]
        for i in range(self.num_limbs):
            b = alg.col(v.local_wires, 1 + i)
            cons.append(alg.sub(alg.mul(b, b), b))
        return cons

    def eval_device(self, v: EvalVars) -> list:
        """Vectorized: one weighted-sum + one booleanity check over all limbs."""
        import numpy as np

        from ..field import goldilocks as gfd
        from ..host import gl

        w = v.local_wires
        s = w[..., 0]
        bits = w[..., 1 : 1 + self.num_limbs]  # (npoints, num_limbs)
        pow2 = gfd.from_u64(
            np.array([(1 << i) % gl.P_INT for i in range(self.num_limbs)],
                     dtype=np.uint64), w.device
        )
        weighted = gfd.mul(bits, pow2[None, :])
        acc = weighted[..., 0]
        for i in range(1, self.num_limbs):
            acc = gfd.add(acc, weighted[..., i])
        boolean = gfd.sub(gfd.mul(bits, bits), bits)
        return [gfd.sub(s, acc)] + [boolean[..., i] for i in range(self.num_limbs)]


@dataclass(frozen=True, eq=False)
class ArithmeticExtensionGate(Gate):
    """num_ops ops of: out = c0 * (m0 ⊗ m1) + c1 * addend over GF(p^2).

    ⊗ is multiplication in GF(p)[φ]/(φ^2 - 7); operands are wire PAIRS
    (c0-component, c1-component).  Wires per op i: [8i..8i+8) =
    m0(2) ‖ m1(2) ‖ addend(2) ‖ out(2).  c0, c1 are the row's two base
    constant slots.  Halves the row cost of the recursive verifier's
    extension algebra vs expanding each ext op into base ArithmeticGate
    ops (reference analog: qp-plonky2's ArithmeticExtensionGate, used
    pervasively by its recursion module).
    """

    num_ops: int = 10
    W: int = 7  # extension generator: φ^2 = 7

    def __post_init__(self):
        object.__setattr__(
            self, "id", f"ArithmeticExtensionGate(num_ops={self.num_ops})")
        object.__setattr__(self, "degree", 3)
        object.__setattr__(self, "num_constraints", 2 * self.num_ops)
        object.__setattr__(self, "num_constants_used", 2)
        object.__setattr__(self, "num_wires_used", 8 * self.num_ops)

    def eval(self, v: EvalVars) -> list:
        alg = v.alg
        c0 = alg.col(v.local_constants, 0)
        c1 = alg.col(v.local_constants, 1)
        out = []
        for i in range(self.num_ops):
            m0 = (alg.col(v.local_wires, 8 * i), alg.col(v.local_wires, 8 * i + 1))
            m1 = (alg.col(v.local_wires, 8 * i + 2), alg.col(v.local_wires, 8 * i + 3))
            ad = (alg.col(v.local_wires, 8 * i + 4), alg.col(v.local_wires, 8 * i + 5))
            o = (alg.col(v.local_wires, 8 * i + 6), alg.col(v.local_wires, 8 * i + 7))
            # m0 ⊗ m1
            p0 = alg.add(alg.mul(m0[0], m1[0]),
                         alg.mul_scalar(alg.mul(m0[1], m1[1]), self.W))
            p1 = alg.add(alg.mul(m0[0], m1[1]), alg.mul(m0[1], m1[0]))
            comp0 = alg.add(alg.mul(c0, p0), alg.mul(c1, ad[0]))
            comp1 = alg.add(alg.mul(c0, p1), alg.mul(c1, ad[1]))
            out.append(alg.sub(comp0, o[0]))
            out.append(alg.sub(comp1, o[1]))
        return out

    def eval_device(self, v: EvalVars) -> list:
        """Vectorized over the num_ops axis."""
        from ..field import goldilocks as gfd

        w = v.local_wires
        oct_ = w[..., : 8 * self.num_ops]
        oct_ = oct_.reshape(*oct_.shape[:-1], self.num_ops, 8)
        m00, m01, m10, m11, a0, a1, o0, o1 = (oct_[..., j] for j in range(8))
        c0b = v.local_constants[..., 0:1]
        c1b = v.local_constants[..., 1:2]
        p0 = gfd.add(gfd.mul(m00, m10), gfd.mul_const(gfd.mul(m01, m11), self.W))
        p1 = gfd.add(gfd.mul(m00, m11), gfd.mul(m01, m10))
        d0 = gfd.sub(gfd.add(gfd.mul(c0b, p0), gfd.mul(c1b, a0)), o0)
        d1 = gfd.sub(gfd.add(gfd.mul(c0b, p1), gfd.mul(c1b, a1)), o1)
        out = []
        for i in range(self.num_ops):
            out.append(d0[..., i])
            out.append(d1[..., i])
        return out


@dataclass(frozen=True, eq=False)
class RandomAccessGate(Gate):
    """num_copies random accesses into a 2^bits-element list per row.

    Copy c routed wires at [c*(V+2) .. (c+1)*(V+2)): index ‖ claimed ‖
    V list elements.  Unrouted bit wires at [num_copies*(V+2) + c*bits ..
    +bits): LE bit decomposition of index.  Constraints per copy:
    booleanity of each bit, index recomposition, and the bit-muxed list
    element equalling ``claimed`` (degree bits+1).

    Replaces the O(2^cap_height) select-mux trees in the recursive
    verifier's Merkle cap / FRI coset lookups (reference analog:
    qp-plonky2's RandomAccessGate, gate tag 13 in compat/serde.py).
    """

    bits: int = 4
    num_copies: int = 4

    def __post_init__(self):
        V = 1 << self.bits
        object.__setattr__(
            self, "id",
            f"RandomAccessGate(bits={self.bits},copies={self.num_copies})")
        object.__setattr__(self, "degree", self.bits + 1)
        object.__setattr__(self, "num_constraints",
                           self.num_copies * (self.bits + 2))
        object.__setattr__(self, "num_wires_used",
                           self.num_copies * (V + 2 + self.bits))

    @property
    def vec_size(self) -> int:
        return 1 << self.bits

    def wire_index(self, c: int) -> int:
        return c * (self.vec_size + 2)

    def wire_claimed(self, c: int) -> int:
        return c * (self.vec_size + 2) + 1

    def wire_list(self, c: int, k: int) -> int:
        return c * (self.vec_size + 2) + 2 + k

    def wire_bit(self, c: int, j: int) -> int:
        return self.num_copies * (self.vec_size + 2) + c * self.bits + j

    def eval(self, v: EvalVars) -> list:
        alg = v.alg
        w = v.local_wires
        cons = []
        for c in range(self.num_copies):
            idx = alg.col(w, self.wire_index(c))
            claimed = alg.col(w, self.wire_claimed(c))
            bits = [alg.col(w, self.wire_bit(c, j)) for j in range(self.bits)]
            for b in bits:
                cons.append(alg.sub(alg.mul(b, b), b))
            acc = None
            for j, b in enumerate(bits):
                term = alg.mul_scalar(b, 1 << j)
                acc = term if acc is None else alg.add(acc, term)
            cons.append(alg.sub(idx, acc))
            # fold the list by bits, LSB first
            entries = [alg.col(w, self.wire_list(c, k))
                       for k in range(self.vec_size)]
            for b in bits:
                entries = [
                    alg.add(lo, alg.mul(b, alg.sub(hi, lo)))
                    for lo, hi in zip(entries[0::2], entries[1::2])
                ]
            cons.append(alg.sub(entries[0], claimed))
        return cons


class PoseidonGate(Gate):
    """Full width-12 Poseidon permutation in one row (135 wires).

    Wire layout (mirrors the engine's budget; swap/delta wires exist for
    Merkle-path gadgets and are constrained to behave, though the reference
    circuits always use swap = 0):

      [0..12)    inputs
      [12..24)   outputs
      [24]       swap flag
      [25..29)   delta_i = swap * (in[4+i] - in[i])
      [29..65)   full0 round intermediates: state after the constant layer
                 of rounds 1..3 (3 x 12)
      [65..87)   partial round S-box inputs (22): state[0] after the dense
                 constant layer of each partial round
      [87..135)  full1 round intermediates: state after the constant layer
                 of the last 4 rounds (4 x 12)

    Partial rounds use the mathematically-equivalent *naive* formulation
    (dense constant layer + single S-box + full MDS), so the permutation is
    bit-identical to the reference's Poseidon (validated by golden vectors)
    while keeping constraint degree <= 7.
    """

    id = "PoseidonGate(width=12)"
    degree = 7
    num_wires_used = 135
    num_constraints = 1 + 4 + 36 + 22 + 48 + 12

    WIRE_INPUT = 0
    WIRE_OUTPUT = 12
    WIRE_SWAP = 24
    START_DELTA = 25
    START_FULL_0 = 29
    START_PARTIAL = 65
    START_FULL_1 = 87

    @staticmethod
    def wire_input(i: int) -> int:
        return PoseidonGate.WIRE_INPUT + i

    @staticmethod
    def wire_output(i: int) -> int:
        return PoseidonGate.WIRE_OUTPUT + i

    def eval(self, v: EvalVars) -> list:
        alg = v.alg
        w = v.local_wires
        cons = []

        swap = alg.col(w, self.WIRE_SWAP)
        cons.append(alg.sub(alg.mul(swap, swap), swap))
        # delta_i = swap * (rhs_i - lhs_i)
        deltas = []
        for i in range(4):
            lhs = alg.col(w, self.wire_input(i))
            rhs = alg.col(w, self.wire_input(4 + i))
            d = alg.col(w, self.START_DELTA + i)
            deltas.append(d)
            cons.append(alg.sub(alg.mul(swap, alg.sub(rhs, lhs)), d))

        # swapped inputs
        state = []
        for i in range(4):
            state.append(alg.add(alg.col(w, self.wire_input(i)), deltas[i]))
        for i in range(4):
            state.append(alg.sub(alg.col(w, self.wire_input(4 + i)), deltas[i]))
        for i in range(8, 12):
            state.append(alg.col(w, self.wire_input(i)))

        rc = 0

        def constant_layer(st, r):
            return [
                alg.add_scalar(st[i], ALL_ROUND_CONSTANTS[12 * r + i]) for i in range(WIDTH)
            ]

        def sbox(x):
            x2 = alg.mul(x, x)
            x3 = alg.mul(x2, x)
            x6 = alg.mul(x3, x3)
            return alg.mul(x6, x)

        def mds(st):
            stacked = alg.stack(st)
            out = alg.mds12(stacked)
            return [alg.col(out, i) for i in range(WIDTH)]

        # First half full rounds.
        for r in range(HALF_N_FULL_ROUNDS):
            state = constant_layer(state, rc)
            if r > 0:
                base = self.START_FULL_0 + (r - 1) * WIDTH
                for i in range(WIDTH):
                    wv = alg.col(w, base + i)
                    cons.append(alg.sub(state[i], wv))
                    state[i] = wv
            state = [sbox(x) for x in state]
            state = mds(state)
            rc += 1

        # Partial rounds (naive form): dense constants, sbox state[0], MDS.
        for pr in range(N_PARTIAL_ROUNDS):
            state = constant_layer(state, rc)
            wv = alg.col(w, self.START_PARTIAL + pr)
            cons.append(alg.sub(state[0], wv))
            state[0] = sbox(wv)
            state = mds(state)
            rc += 1

        # Last full rounds.
        for r in range(HALF_N_FULL_ROUNDS):
            state = constant_layer(state, rc)
            base = self.START_FULL_1 + r * WIDTH
            for i in range(WIDTH):
                wv = alg.col(w, base + i)
                cons.append(alg.sub(state[i], wv))
                state[i] = wv
            state = [sbox(x) for x in state]
            state = mds(state)
            rc += 1

        for i in range(WIDTH):
            cons.append(alg.sub(state[i], alg.col(w, self.wire_output(i))))
        return cons

    def eval_device(self, v: EvalVars) -> list:
        """Tensor fast path: the permutation on a (npoints, 12) state, one
        Python loop per round phase.  Constraint ORDER matches eval()
        exactly -- the verifier reduces the same slots with alphas on host."""
        import numpy as np
        import torch

        from ..field import goldilocks as gfd
        from ..hash.poseidon import mds_layer

        w = v.local_wires  # tensor (npoints, 135)
        rc = gfd.from_u64(
            np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, WIDTH),
            w.device)

        def sbox(x):
            x2 = gfd.mul(x, x)
            x3 = gfd.mul(x2, x)
            return gfd.mul(gfd.mul(x3, x3), x)

        cons = []
        swap = w[..., self.WIRE_SWAP]
        cons.append(gfd.sub(gfd.mul(swap, swap), swap))
        deltas = []
        for i in range(4):
            lhs = w[..., self.wire_input(i)]
            rhs = w[..., self.wire_input(4 + i)]
            d = w[..., self.START_DELTA + i]
            deltas.append(d)
            cons.append(gfd.sub(gfd.mul(swap, gfd.sub(rhs, lhs)), d))

        state_cols = []
        for i in range(4):
            state_cols.append(gfd.add(w[..., self.wire_input(i)], deltas[i]))
        for i in range(4):
            state_cols.append(gfd.sub(w[..., self.wire_input(4 + i)], deltas[i]))
        for i in range(8, 12):
            state_cols.append(w[..., self.wire_input(i)])
        state = torch.stack(state_cols, dim=-1)  # (npoints, 12)

        # Round 0 (no wire read).
        state = mds_layer(sbox(gfd.add(state, rc[0])))

        # Full rounds 1..3: read trace wires, emit 12 constraints each.
        h = HALF_N_FULL_ROUNDS
        for r in range(1, h):
            base = self.START_FULL_0 + (r - 1) * WIDTH
            wires_row = w[..., base : base + WIDTH]
            c = gfd.sub(gfd.add(state, rc[r]), wires_row)
            cons.extend(c[..., i] for i in range(WIDTH))
            state = mds_layer(sbox(wires_row))

        # Partial rounds: 1 constraint each.
        for pr in range(N_PARTIAL_ROUNDS):
            wire = w[..., self.START_PARTIAL + pr]
            st = gfd.add(state, rc[h + pr])
            cons.append(gfd.sub(st[..., 0], wire))
            state = mds_layer(torch.cat([sbox(wire)[..., None], st[..., 1:]], dim=-1))

        # Last full rounds: 12 constraints each (before sbox).
        for r in range(h):
            base = self.START_FULL_1 + r * WIDTH
            wires_row = w[..., base : base + WIDTH]
            c = gfd.sub(gfd.add(state, rc[h + N_PARTIAL_ROUNDS + r]), wires_row)
            cons.extend(c[..., i] for i in range(WIDTH))
            state = mds_layer(sbox(wires_row))

        for i in range(WIDTH):
            cons.append(gfd.sub(state[..., i], w[..., self.wire_output(i)]))
        return cons


NOOP = NoopGate()
POSEIDON = PoseidonGate()


def gate_from_id(gate_id: str) -> Gate:
    """Reconstruct a gate from its id string (artifact deserialization)."""
    if gate_id == "NoopGate":
        return NOOP
    if gate_id == "PublicInputGate":
        return PublicInputGate()
    if gate_id == "PoseidonGate(width=12)":
        return POSEIDON
    if gate_id.startswith("ConstantGate("):
        return ConstantGate(num_consts=int(gate_id[len("ConstantGate(num_consts="):-1]))
    if gate_id.startswith("ArithmeticGate("):
        return ArithmeticGate(num_ops=int(gate_id[len("ArithmeticGate(num_ops="):-1]))
    if gate_id.startswith("BaseSum2Gate("):
        return BaseSum2Gate(num_limbs=int(gate_id[len("BaseSum2Gate(num_limbs="):-1]))
    if gate_id.startswith("ArithmeticExtensionGate("):
        return ArithmeticExtensionGate(
            num_ops=int(gate_id[len("ArithmeticExtensionGate(num_ops="):-1]))
    if gate_id.startswith("RandomAccessGate("):
        inner = gate_id[len("RandomAccessGate("):-1]
        kv = dict(p.split("=") for p in inner.split(","))
        return RandomAccessGate(bits=int(kv["bits"]), num_copies=int(kv["copies"]))
    raise ValueError(f"unknown gate id: {gate_id}")
