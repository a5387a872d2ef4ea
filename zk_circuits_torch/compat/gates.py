"""Constraint evaluators for the reference engine's gate set.

Each function evaluates a gate's unfiltered constraints at a point, over
the degree-2 Goldilocks extension (the verifier's ζ).  The constraint
ORDER inside each gate and the selector-filter formula must match the
engine exactly — validated by verifying the reference's own proof bytes
(tests/test_compat.py; tests/test_torch_compat.py holds this copy
to the JAX package's).

Gate vocabulary covered: the six gates used by the reference wormhole
circuit (cf. bench-data/common.bin: Noop, Constant, PublicInput,
BaseSum<2>, Arithmetic, Poseidon) plus the extension-arithmetic and
random-access gates that appear in recursion circuits.
"""

from __future__ import annotations

import numpy as np

from ..host import gle
from . import poseidon_fast as pf
from .serde import RefCommonData, RefGate

UNUSED_SELECTOR = (1 << 32) - 1


class ExtAlg:
    """GF(p^2) element algebra for the generic poseidon_fast routines."""

    @staticmethod
    def add(a, b):
        return gle.add(a, b)

    @staticmethod
    def sub(a, b):
        return gle.sub(a, b)

    @staticmethod
    def mul(a, b):
        return gle.mul(a, b)

    @staticmethod
    def from_int(i):
        return np.array([i % gle.gl.P_INT, 0], dtype=np.uint64)


EXT = ExtAlg()
P_INT = gle.gl.P_INT


def _ext(i: int) -> np.ndarray:
    return np.array([i % P_INT, 0], dtype=np.uint64)


# ---------------------------------------------------------------------------
# Per-gate unfiltered constraint evaluation.
# vars: local_constants (list of ext, selectors stripped), local_wires
# (list of ext), public_inputs_hash (4 base felts).
# ---------------------------------------------------------------------------

def eval_arithmetic(gate: RefGate, consts, wires, pi_hash):
    """qp-plonky2's ArithmeticGate emits ``output - (c0*m0*m1 + c1*addend)``
    — the NEGATION of upstream plonky2's ``computed - output``.  This single
    sign flip was the last deviation blocking full reference-proof
    verification; it was isolated by the round-4 per-gate sign scan
    (scripts/compat_vanishing_signs.py: unique hit among 128 sign combos,
    after 184k constraint-order and 10k+ wire-layout variants all failed).
    Sign conventions are invisible to constraint satisfaction, which is why
    every other validation (witness, hashes, FRI) could pass without it."""
    c0, c1 = consts[0], consts[1]
    out = []
    for i in range(gate.params["num_ops"]):
        m0, m1, addend, output = wires[4 * i : 4 * i + 4]
        t = gle.add(gle.mul(c0, gle.mul(m0, m1)), gle.mul(c1, addend))
        out.append(gle.sub(output, t))
    return out


def eval_arithmetic_extension(gate: RefGate, consts, wires, pi_hash):
    # Each op uses 4 extension operands = 8 wires (D=2): computes
    # c0*m0*m1 + c1*addend - output in the *double* extension; over the
    # base proof this means treating wire pairs as ext-of-ext.  Constraint
    # order: per op, the D components of the residual.
    c0, c1 = consts[0], consts[1]
    out = []
    for i in range(gate.params["num_ops"]):
        w = wires[8 * i : 8 * i + 8]
        m0, m1 = (w[0], w[1]), (w[2], w[3])
        addend, output = (w[4], w[5]), (w[6], w[7])

        def ee_mul(a, b):
            # (a0 + a1 X)(b0 + b1 X) mod (X^2 - W), components in GF(p^2)
            lo = gle.add(gle.mul(a[0], b[0]),
                         gle.mul(_ext(int(gle.W)), gle.mul(a[1], b[1])))
            hi = gle.add(gle.mul(a[0], b[1]), gle.mul(a[1], b[0]))
            return (lo, hi)

        def ee_scale(s, a):
            return (gle.mul(s, a[0]), gle.mul(s, a[1]))

        def ee_add(a, b):
            return (gle.add(a[0], b[0]), gle.add(a[1], b[1]))

        t = ee_add(ee_scale(c0, ee_mul(m0, m1)), ee_scale(c1, addend))
        out.append(gle.sub(t[0], output[0]))
        out.append(gle.sub(t[1], output[1]))
    return out


def eval_mul_extension(gate: RefGate, consts, wires, pi_hash):
    c0 = consts[0]
    out = []
    for i in range(gate.params["num_ops"]):
        w = wires[6 * i : 6 * i + 6]
        m0, m1, output = (w[0], w[1]), (w[2], w[3]), (w[4], w[5])
        lo = gle.add(gle.mul(m0[0], m1[0]),
                     gle.mul(_ext(int(gle.W)), gle.mul(m0[1], m1[1])))
        hi = gle.add(gle.mul(m0[0], m1[1]), gle.mul(m0[1], m1[0]))
        out.append(gle.sub(gle.mul(c0, lo), output[0]))
        out.append(gle.sub(gle.mul(c0, hi), output[1]))
    return out


def eval_base_sum(gate: RefGate, consts, wires, pi_hash):
    num_limbs = gate.params["num_limbs"]
    base = gate.params["base"]
    s = wires[0]
    limbs = wires[1 : 1 + num_limbs]
    # sum constraint: reduce_with_powers(limbs, base) - sum
    acc = _ext(0)
    for limb in reversed(limbs):
        acc = gle.add(gle.mul(acc, _ext(base)), limb)
    out = [gle.sub(acc, s)]
    # limb range constraints: Π_{j<base} (limb - j)
    for limb in limbs:
        prod = limb
        for j in range(1, base):
            prod = gle.mul(prod, gle.sub(limb, _ext(j)))
        out.append(prod)
    return out


def eval_constant(gate: RefGate, consts, wires, pi_hash):
    return [gle.sub(consts[i], wires[i]) for i in range(gate.params["num_consts"])]


def eval_public_input(gate: RefGate, consts, wires, pi_hash):
    return [gle.sub(wires[i], _ext(int(pi_hash[i]))) for i in range(4)]


def eval_noop(gate: RefGate, consts, wires, pi_hash):
    return []


def eval_random_access(gate: RefGate, consts, wires, pi_hash):
    """RandomAccessGate: per copy, select list[access_index] via binary
    decomposition of the index into `bits` routed bit wires."""
    bits = gate.params["bits"]
    num_copies = gate.params["num_copies"]
    num_extra = gate.params["num_extra_constants"]
    vec_size = 1 << bits
    out = []

    def w_access(copy):  # layout per plonky2 RandomAccessGate
        start = copy * (2 + vec_size)
        return start, start + 1, list(range(start + 2, start + 2 + vec_size))

    bit_base = num_copies * (2 + vec_size) + num_extra

    for copy in range(num_copies):
        idx_w, claimed_w, list_ws = w_access(copy)
        access_index = wires[idx_w]
        claimed = wires[claimed_w]
        bits_w = [wires[bit_base + copy * bits + b] for b in range(bits)]
        # bit constraints
        for b in bits_w:
            out.append(gle.mul(b, gle.sub(b, _ext(1))))
        # reconstructed index
        acc = _ext(0)
        for b in reversed(bits_w):
            acc = gle.add(gle.add(acc, acc), b)
        out.append(gle.sub(acc, access_index))
        # fold the list by each bit
        items = [wires[w] for w in list_ws]
        for b in bits_w:
            items = [
                gle.add(items[2 * i],
                        gle.mul(b, gle.sub(items[2 * i + 1], items[2 * i])))
                for i in range(len(items) // 2)
            ]
        out.append(gle.sub(items[0], claimed))
    for i in range(num_extra):
        # extra constants copied into routed wires
        out.append(gle.sub(consts[i], wires[num_copies * (2 + vec_size) + i]))
    return out


# --- Poseidon gate ---------------------------------------------------------

W12 = 12
WIRE_SWAP = 24
DELTA_START = 25
FULL0_START = 29    # sbox-input wires, first-half full rounds 1..3
PARTIAL_START = 65  # sbox-input wires, 22 partial rounds
FULL1_START = 87    # sbox-input wires, second-half full rounds


def eval_poseidon(gate: RefGate, consts, wires, pi_hash):
    alg = EXT
    out = []
    swap = wires[WIRE_SWAP]
    out.append(gle.mul(swap, gle.sub(swap, _ext(1))))
    deltas = [wires[DELTA_START + i] for i in range(4)]
    for i in range(4):
        t = gle.mul(swap, gle.sub(wires[i + 4], wires[i]))
        out.append(gle.sub(t, deltas[i]))

    state = []
    for i in range(4):
        state.append(gle.add(wires[i], deltas[i]))
    for i in range(4):
        state.append(gle.sub(wires[i + 4], deltas[i]))
    for i in range(8, 12):
        state.append(wires[i])

    round_ctr = 0
    for r in range(pf.HALF_N_FULL_ROUNDS):
        state = pf.constant_layer(alg, state, round_ctr)
        if r != 0:
            for i in range(W12):
                sbox_in = wires[FULL0_START + (r - 1) * W12 + i]
                out.append(gle.sub(state[i], sbox_in))
                state[i] = sbox_in
        state = [pf.sbox(alg, x) for x in state]
        state = pf.mds_layer(alg, state)
        round_ctr += 1

    state = pf.partial_first_constant_layer(alg, state)
    state = pf.mds_partial_layer_init(alg, state)
    for r in range(pf.N_PARTIAL_ROUNDS - 1):
        sbox_in = wires[PARTIAL_START + r]
        out.append(gle.sub(state[0], sbox_in))
        state[0] = pf.sbox(alg, sbox_in)
        state[0] = gle.add(state[0], _ext(int(pf.FAST_PARTIAL_ROUND_CONSTANTS[r])))
        state = pf.mds_partial_layer_fast(alg, state, r)
    sbox_in = wires[PARTIAL_START + pf.N_PARTIAL_ROUNDS - 1]
    out.append(gle.sub(state[0], sbox_in))
    state[0] = pf.sbox(alg, sbox_in)
    state = pf.mds_partial_layer_fast(alg, state, pf.N_PARTIAL_ROUNDS - 1)
    round_ctr += pf.N_PARTIAL_ROUNDS

    for r in range(pf.HALF_N_FULL_ROUNDS):
        state = pf.constant_layer(alg, state, round_ctr)
        for i in range(W12):
            sbox_in = wires[FULL1_START + r * W12 + i]
            out.append(gle.sub(state[i], sbox_in))
            state[i] = sbox_in
        state = [pf.sbox(alg, x) for x in state]
        state = pf.mds_layer(alg, state)
        round_ctr += 1

    for i in range(W12):
        out.append(gle.sub(state[i], wires[W12 + i]))
    return out


EVALUATORS = {
    "ArithmeticGate": eval_arithmetic,
    "ArithmeticExtensionGate": eval_arithmetic_extension,
    "MulExtensionGate": eval_mul_extension,
    "BaseSumGate": eval_base_sum,
    "ConstantGate": eval_constant,
    "PublicInputGate": eval_public_input,
    "NoopGate": eval_noop,
    "PoseidonGate": eval_poseidon,
    "RandomAccessGate": eval_random_access,
}


def compute_filter(row: int, group: tuple[int, int], s, many_selectors: bool):
    """Π_{i in group, i≠row} (i - s), ×(UNUSED - s) when several groups."""
    prod = _ext(1)
    for i in range(group[0], group[1]):
        if i == row:
            continue
        prod = gle.mul(prod, gle.sub(_ext(i), s))
    if many_selectors:
        prod = gle.mul(prod, gle.sub(_ext(UNUSED_SELECTOR), s))
    return prod


def evaluate_gate_constraints(common: RefCommonData, constants, wires, pi_hash):
    """All gates' filtered constraints, accumulated into a shared vector of
    length num_gate_constraints (each gate adds filter·cᵢ into slot i)."""
    num_sel = common.num_selectors
    many = num_sel > 1
    local_constants = [constants[num_sel + i] for i in range(len(constants) - num_sel)]
    acc = [_ext(0) for _ in range(common.num_gate_constraints)]
    for row, gate in enumerate(common.gates):
        sel_idx = common.selector_indices[row]
        group = common.selector_groups[sel_idx]
        filt = compute_filter(row, group, constants[sel_idx], many)
        ev = EVALUATORS.get(gate.kind)
        if ev is None:
            raise ValueError(f"no evaluator for {gate.kind}")
        for k, c in enumerate(ev(gate, local_constants, wires, pi_hash)):
            acc[k] = gle.add(acc[k], gle.mul(filt, c))
    return acc
