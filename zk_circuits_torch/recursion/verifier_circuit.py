"""Verifier-as-circuit: verify an inner PLONK+FRI proof inside a circuit.

The analog of qp-plonky2's recursion module (used by the reference
aggregator at wormhole/aggregator/src/circuits/tree.rs:111-136:
add_virtual_proof_with_pis / verify_proof / add_virtual_verifier_data /
set_proof_with_pis_target).

The constraint logic mirrors ``plonk/verifier.py`` and ``fri/fri.py``
statement for statement; the PLONK vanishing evaluation at zeta reuses the
exact same ``eval_vanishing`` code through a ``CircuitAlg`` whose values
are in-circuit extension targets.  ``CircuitAlg`` has no ``is_torch``
attribute, so ``eval_vanishing`` takes its generic path for it, the one
the host verifier takes.  A copy of the JAX package's module.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..host import gl
from ..iop.builder import CircuitBuilder
from ..iop.targets import BoolTarget, HashOutTarget
from ..iop.witness import PartialWitness
from ..plonk.vanishing import VanishingVars, eval_vanishing
from . import gadgets as G
from .gadgets import ExtTarget, RecursiveChallenger


# ---------------------------------------------------------------------------
# Circuit algebra: plug in-circuit ext targets into the shared gate evaluators
# ---------------------------------------------------------------------------


class CircuitAlg:
    """Algebra over ExtTarget values; "arrays" are Python lists (npoints is
    always 1 — evaluation at the single point zeta)."""

    is_extension = True

    def __init__(self, builder: CircuitBuilder):
        self.b = builder

    def zeros(self, npoints: int, k: int):
        z = G.ext_zero(self.b)
        return [z] * k

    def broadcast_scalar(self, c: int, npoints: int):
        return G.ext_const(self.b, c % gl.P_INT)

    def add(self, a, b):
        return G.ext_add(self.b, a, b)

    def sub(self, a, b):
        return G.ext_sub(self.b, a, b)

    def mul(self, a, b):
        return G.ext_mul(self.b, a, b)

    def mul_scalar(self, a, c: int):
        return G.ext_mul_const(self.b, a, c % gl.P_INT)

    def add_scalar(self, a, c: int):
        return G.ext_add(self.b, a, G.ext_const(self.b, c % gl.P_INT))

    def sub_from_scalar(self, c: int, a):
        return G.ext_sub(self.b, G.ext_const(self.b, c % gl.P_INT), a)

    def mds12(self, state: list):
        from ..hash.constants import MDS_MATRIX_CIRC, MDS_MATRIX_DIAG, WIDTH

        out = []
        for r in range(WIDTH):
            acc = None
            for i in range(WIDTH):
                coeff = MDS_MATRIX_CIRC[(i - r) % WIDTH] + (
                    MDS_MATRIX_DIAG[r] if i == r else 0
                )
                if acc is None:
                    acc = G.ext_mul_const(self.b, state[i], coeff)
                else:
                    acc = G.ext_mul_const_add(self.b, state[i], coeff, acc)
            out.append(acc)
        return out

    def stack(self, cols):
        return list(cols)

    def col(self, a, i: int):
        return a[i]

    def cols(self, a, lo: int, hi: int):
        return a[lo:hi]


# ---------------------------------------------------------------------------
# Proof targets
# ---------------------------------------------------------------------------


@dataclass
class FriQueryStepTargets:
    coset_values: list            # arity x ExtTarget
    siblings: list                # list[HashOutTarget]


@dataclass
class FriQueryRoundTargets:
    initial_leaves: list          # per oracle: (list[target], list[HashOutTarget])
    steps: list                   # list[FriQueryStepTargets]


@dataclass
class ProofTargets:
    wires_cap: list
    zs_partial_products_cap: list
    quotient_cap: list
    constants_sigmas: list        # ExtTargets
    wires: list
    zs_partial_products: list
    quotient: list
    zs_next: list
    commit_phase_caps: list       # list[list[HashOutTarget]]
    query_rounds: list            # list[FriQueryRoundTargets]
    final_poly: list              # list[ExtTarget]
    pow_witness: int
    public_inputs: list


@dataclass
class VerifierDataTargets:
    constants_sigmas_cap: list    # list[HashOutTarget]
    circuit_digest: HashOutTarget


def _oracle_widths(common) -> list[int]:
    cfg = common.config
    salt = 4 if cfg.zero_knowledge else 0
    return [
        common.num_constants_sigmas_polys,
        cfg.num_wires + salt,
        common.num_zs_partial_products_polys + salt,
        common.num_quotient_polys + salt,
    ]


def _virtual_cap(b: CircuitBuilder, cap_height: int) -> list:
    return [b.add_virtual_hash() for _ in range(1 << cap_height)]


def _virtual_ext(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.add_virtual_target(), b.add_virtual_target())


def add_virtual_verifier_data(b: CircuitBuilder, cap_height: int) -> VerifierDataTargets:
    return VerifierDataTargets(
        constants_sigmas_cap=_virtual_cap(b, cap_height),
        circuit_digest=b.add_virtual_hash(),
    )


def add_virtual_proof_with_pis(b: CircuitBuilder, common) -> ProofTargets:
    cfg = common.config
    fri = cfg.fri_config
    cap_h = fri.cap_height
    widths = _oracle_widths(common)
    lde_bits = common.degree_bits + cfg.rate_bits
    arities = common.fri_reduction_arities()
    final_len = 1 << (common.degree_bits - sum(arities))

    def vexts(k):
        return [_virtual_ext(b) for _ in range(k)]

    query_rounds = []
    for _ in range(fri.num_query_rounds):
        initial = []
        height = lde_bits
        for w in widths:
            leaf = b.add_virtual_targets(w)
            sibs = [b.add_virtual_hash() for _ in range(height - cap_h)]
            initial.append((leaf, sibs))
        steps = []
        size_bits = lde_bits
        for a_bits in arities:
            m_bits = size_bits - a_bits
            steps.append(
                FriQueryStepTargets(
                    coset_values=vexts(1 << a_bits),
                    siblings=[b.add_virtual_hash() for _ in range(m_bits - cap_h)],
                )
            )
            size_bits = m_bits
        query_rounds.append(FriQueryRoundTargets(initial, steps))

    return ProofTargets(
        wires_cap=_virtual_cap(b, cap_h),
        zs_partial_products_cap=_virtual_cap(b, cap_h),
        quotient_cap=_virtual_cap(b, cap_h),
        constants_sigmas=vexts(widths[0]),
        wires=vexts(widths[1]),
        zs_partial_products=vexts(widths[2]),
        quotient=vexts(widths[3]),
        zs_next=vexts(cfg.num_challenges),
        commit_phase_caps=[_virtual_cap(b, cap_h) for _ in arities],
        query_rounds=query_rounds,
        final_poly=vexts(final_len),
        pow_witness=b.add_virtual_target(),
        public_inputs=b.add_virtual_targets(common.num_public_inputs),
    )


# ---------------------------------------------------------------------------
# Witness filling
# ---------------------------------------------------------------------------


def _set_cap(pw: PartialWitness, cap_t: list, cap: np.ndarray):
    assert len(cap_t) == cap.shape[0]
    for h, digest in zip(cap_t, cap):
        pw.set_hash_target(h, digest)


def _set_ext(pw: PartialWitness, t: ExtTarget, v):
    pw.set_target(t.c0, int(v[0]))
    pw.set_target(t.c1, int(v[1]))


def set_proof_with_pis_target(pw: PartialWitness, pt: ProofTargets, pwpi) -> None:
    p = pwpi.proof
    _set_cap(pw, pt.wires_cap, p.wires_cap)
    _set_cap(pw, pt.zs_partial_products_cap, p.zs_partial_products_cap)
    _set_cap(pw, pt.quotient_cap, p.quotient_cap)
    op = p.openings
    for ts, arr in (
        (pt.constants_sigmas, op.constants_sigmas),
        (pt.wires, op.wires),
        (pt.zs_partial_products, op.zs_partial_products),
        (pt.quotient, op.quotient),
        (pt.zs_next, op.zs_next),
    ):
        assert len(ts) == arr.shape[0]
        for t, v in zip(ts, arr):
            _set_ext(pw, t, v)
    fp = p.opening_proof
    for cap_t, cap in zip(pt.commit_phase_caps, fp.commit_phase_caps):
        _set_cap(pw, cap_t, cap)
    for qr_t, qr in zip(pt.query_rounds, fp.query_rounds):
        for (leaf_t, sibs_t), (leaf, sibs) in zip(qr_t.initial_leaves, qr.initial_leaves):
            pw.set_target_arr(leaf_t, leaf)
            for st, s in zip(sibs_t, sibs):
                pw.set_hash_target(st, s)
        for step_t, step in zip(qr_t.steps, qr.steps):
            for vt, v in zip(step_t.coset_values, step.coset_values):
                _set_ext(pw, vt, v)
            for st, s in zip(step_t.siblings, step.siblings):
                pw.set_hash_target(st, s)
    for t, v in zip(pt.final_poly, fp.final_poly):
        _set_ext(pw, t, v)
    pw.set_target(pt.pow_witness, fp.pow_witness)
    pw.set_target_arr(pt.public_inputs, pwpi.public_inputs)


def set_verifier_data_target(pw: PartialWitness, vt: VerifierDataTargets,
                             verifier_only) -> None:
    _set_cap(pw, vt.constants_sigmas_cap, verifier_only.constants_sigmas_cap)
    pw.set_hash_target(vt.circuit_digest, verifier_only.circuit_digest)


# ---------------------------------------------------------------------------
# The in-circuit verifier
# ---------------------------------------------------------------------------


def _pow_product(b: CircuitBuilder, base_const: int, bits: list[BoolTarget],
                 start_const: int = 1) -> int:
    """start * Π_k (base^(2^k))^bits[k] as a base-field target."""
    acc = b.constant(start_const % gl.P_INT)
    cur = base_const % gl.P_INT
    for bit in bits:
        nxt = b.mul_const(cur, acc)
        acc = b.select(bit, nxt, acc)
        cur = cur * cur % gl.P_INT
    return acc


def _mux_ext(b: CircuitBuilder, values: list[ExtTarget],
             bits: list[BoolTarget]) -> ExtTarget:
    """values[index] with index given LSB-first by bits; |values| = 2^|bits|.
    One RandomAccessGate copy per component instead of a select tree."""
    if not bits:
        return values[0]
    return G.random_access_ext(b, G.bits_to_index(b, bits), values)


def _mux_hash(b: CircuitBuilder, entries: list[HashOutTarget],
              bits: list[BoolTarget]) -> HashOutTarget:
    if not bits:
        return entries[0]
    return G.random_access_hashes(b, G.bits_to_index(b, bits), entries)


def _verify_merkle_path(b: CircuitBuilder, leaf: list[int],
                        index_bits: list[BoolTarget],
                        cap: list[HashOutTarget],
                        siblings: list[HashOutTarget]) -> None:
    current = G.hash_or_noop(b, leaf)
    for bit, sib in zip(index_bits, siblings):
        left = HashOutTarget.from_list(
            [b.select(bit, sib.elements[k], current.elements[k]) for k in range(4)]
        )
        right = HashOutTarget.from_list(
            [b.select(bit, current.elements[k], sib.elements[k]) for k in range(4)]
        )
        current = G.compress(b, left, right)
    cap_entry = _mux_hash(b, cap, index_bits[len(siblings):])
    b.connect_hashes(current, cap_entry)


def verify_proof_circuit(
    b: CircuitBuilder,
    common,                      # CommonCircuitData of the INNER circuit
    pt: ProofTargets,
    vd: VerifierDataTargets,
) -> None:
    """Constrain pt to be a valid proof for the inner circuit described by
    ``common`` under verifier data ``vd``.  Mirrors plonk/verifier.py."""
    cfg = common.config
    fri = cfg.fri_config
    n = common.degree
    lde_bits = common.degree_bits + cfg.rate_bits
    arities = common.fri_reduction_arities()
    widths = _oracle_widths(common)
    alg = CircuitAlg(b)

    pi_hash = b.hash_n_to_hash_no_pad(list(pt.public_inputs))

    # ---- transcript ------------------------------------------------------
    ch = RecursiveChallenger(b)
    ch.observe_hash(vd.circuit_digest)
    ch.observe_hash(pi_hash)
    ch.observe_cap(pt.wires_cap)
    betas = ch.get_n_challenges(cfg.num_challenges)
    gammas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(pt.zs_partial_products_cap)
    alphas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(pt.quotient_cap)
    zeta = ch.get_extension_challenge()
    batch0 = (pt.constants_sigmas + pt.wires + pt.zs_partial_products + pt.quotient)
    ch.observe_extension_elements(batch0)
    ch.observe_extension_elements(pt.zs_next)
    alpha = ch.get_extension_challenge()

    # ---- vanishing identity at zeta --------------------------------------
    s = common.num_selectors
    c_ = cfg.num_constants
    num_pp = common.num_partial_products
    zeta_pow_n = G.ext_exp_power_of_2(b, zeta, common.degree_bits)
    one = G.ext_one(b)
    zh_zeta = G.ext_sub(b, zeta_pow_n, one)
    # L1(zeta) = Z_H(zeta) / (n * (zeta - 1))
    denom = G.ext_mul_const(b, G.ext_sub(b, zeta, one), n)
    l1 = G.ext_mul(b, zh_zeta, G.ext_inverse(b, denom))

    def lift_base(t):
        return ExtTarget(t, b.zero())

    cs = pt.constants_sigmas
    vv = VanishingVars(
        x=zeta,
        wires=pt.wires[: cfg.num_wires],
        selectors=cs[:s],
        constants=cs[s : s + c_],
        sigmas=cs[s + c_ : s + c_ + cfg.num_routed_wires],
        zs=[pt.zs_partial_products[i] for i in range(cfg.num_challenges)],
        zs_next=[pt.zs_next[i] for i in range(cfg.num_challenges)],
        partial_products=[
            pt.zs_partial_products[cfg.num_challenges + ci * num_pp :
                                   cfg.num_challenges + (ci + 1) * num_pp]
            for ci in range(cfg.num_challenges)
        ],
        l1=l1,
        pi_hash=[lift_base(t) for t in pi_hash.elements],
        betas=[lift_base(t) for t in betas],
        gammas=[lift_base(t) for t in gammas],
        alphas=[lift_base(t) for t in alphas],
    )
    combined = eval_vanishing(alg, common, vv)

    q = common.quotient_degree_factor
    for c in range(cfg.num_challenges):
        acc = G.ext_zero(b)
        for t in range(q - 1, -1, -1):
            acc = G.ext_mul_add(b, acc, zeta_pow_n, pt.quotient[c * q + t])
        rhs = G.ext_mul(b, zh_zeta, acc)
        G.ext_connect(b, combined[c], rhs)

    # ---- FRI -------------------------------------------------------------
    fri_betas = []
    for cap in pt.commit_phase_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    ch.observe_extension_elements(pt.final_poly)

    pow_base = ch.get_hash()
    pow_inputs = list(pow_base.elements) + [pt.pow_witness]
    pow_hash = b.hash_n_to_hash_no_pad(pow_inputs)
    # h0 < 2^(64 - pow_bits)
    b.range_check(pow_hash.elements[0], 64 - fri.proof_of_work_bits)
    ch.observe_element(pt.pow_witness)

    # reduced openings (two batches: zeta over everything, g*zeta over Zs)
    y0 = G.reduce_with_powers(b, batch0, alpha)
    y1 = G.reduce_with_powers(b, list(pt.zs_next), alpha)
    g_ext = G.ext_const(b, gl.primitive_root_of_unity(common.degree_bits))
    zeta_next = G.ext_mul(b, zeta, g_ext)

    w_lde = gl.primitive_root_of_unity(lde_bits)
    shift0 = gl.MULTIPLICATIVE_GROUP_GENERATOR

    for qr in pt.query_rounds:
        challenge = ch.get_challenge()
        all_bits = b.split_le(challenge, 64)
        idx_bits = all_bits[:lde_bits]

        # initial Merkle openings
        for o, (leaf, sibs) in enumerate(qr.initial_leaves):
            caps = [
                vd.constants_sigmas_cap,
                pt.wires_cap,
                pt.zs_partial_products_cap,
                pt.quotient_cap,
            ][o]
            _verify_merkle_path(b, leaf, idx_bits, caps, sibs)

        # x at the queried point (base field)
        x = _pow_product(b, w_lde, idx_bits, shift0)
        x_ext = lift_base(x)

        # composition value from the leaves
        flat_leaves = [t for (leaf, _) in qr.initial_leaves for t in leaf]
        comp0 = G.reduce_with_powers(
            b, [lift_base(t) for t in flat_leaves], alpha
        )
        num0 = G.ext_sub(b, comp0, y0)
        q0 = G.ext_mul(b, num0, G.ext_inverse(b, G.ext_sub(b, x_ext, zeta)))
        zsp_leaf = qr.initial_leaves[2][0]
        comp1 = G.reduce_with_powers(
            b, [lift_base(zsp_leaf[i]) for i in range(cfg.num_challenges)], alpha
        )
        num1 = G.ext_sub(b, comp1, y1)
        q1 = G.ext_mul(b, num1, G.ext_inverse(b, G.ext_sub(b, x_ext, zeta_next)))
        # combined value = q1 + alpha^{num_challenges} * q0 (prover.py step 7)
        shift_pow = G.ext_exp_u64(b, alpha, cfg.num_challenges)
        cur_value = G.ext_mul_add(b, shift_pow, q0, q1)

        # fold steps
        bits = idx_bits
        size_bits = lde_bits
        cur_shift = shift0
        cur_w = w_lde
        for r, a_bits in enumerate(arities):
            m_bits = size_bits - a_bits
            group_bits = bits[:m_bits]
            k_bits = bits[m_bits:size_bits]
            step = qr.steps[r]

            # consistency: coset_values[k] == cur_value
            opened = _mux_ext(b, step.coset_values, k_bits)
            G.ext_connect(b, opened, cur_value)

            # Merkle proof of the fiber leaf
            leaf_flat = []
            for v in step.coset_values:
                leaf_flat += [v.c0, v.c1]
            _verify_merkle_path(b, leaf_flat, group_bits,
                                pt.commit_phase_caps[r], step.siblings)

            # interpolate the fiber at beta
            x0 = _pow_product(b, cur_w, group_bits, cur_shift)
            omega = pow(cur_w, 1 << m_bits, gl.P_INT)
            cur_value = _fold_single_circuit(
                b, step.coset_values, x0, a_bits, fri_betas[r], omega
            )
            bits = group_bits
            size_bits = m_bits
            cur_shift = pow(cur_shift, 1 << a_bits, gl.P_INT)
            cur_w = pow(cur_w, 1 << a_bits, gl.P_INT)

        # final polynomial evaluation
        xf = _pow_product(b, cur_w, bits, cur_shift)
        acc = G.ext_zero(b)
        for coeff in reversed(pt.final_poly):
            acc = G.ext_mul_base_add(b, acc, xf, coeff)
        G.ext_connect(b, acc, cur_value)


def _fold_single_circuit(b: CircuitBuilder, coset_values: list[ExtTarget],
                         x0: int, a_bits: int, beta: ExtTarget,
                         omega: int) -> ExtTarget:
    """In-circuit mirror of fri.fold_single: halving interpolation.

    coset_values[k] = f(x0 * omega^k); points are base-field targets."""
    vals = list(coset_values)
    pts = [b.mul_const(pow(omega, k, gl.P_INT), x0) for k in range(len(vals))]
    bb = beta
    arity = len(vals)
    inv2 = pow(2, gl.P_INT - 2, gl.P_INT)
    while arity > 1:
        half = arity // 2
        new_vals, new_pts = [], []
        for k in range(half):
            v_plus, v_minus = vals[k], vals[k + half]
            # (v+ + v-) * inv2 in one gate op: inv2*(v+ ⊗ 1) + inv2*v-
            s = G._ae(b, inv2, inv2, v_plus, G._ext_one_t(b), v_minus)
            two_x = b.mul_const(2, pts[k])
            inv_2x = b.inverse(two_x)
            d = G.ext_mul_base(b, G.ext_sub(b, v_plus, v_minus), inv_2x)
            new_vals.append(G.ext_mul_add(b, bb, d, s))
            new_pts.append(b.mul(pts[k], pts[k]))
        vals, pts = new_vals, new_pts
        bb = G.ext_mul(b, bb, bb)
        arity = half
    return vals[0]
