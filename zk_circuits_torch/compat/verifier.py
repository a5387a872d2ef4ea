"""Host verifier for reference-format proofs (qp-plonky2 byte artifacts).

Verifies a ProofWithPublicInputs (proof.bin) against CommonCircuitData
(common.bin) and VerifierOnlyCircuitData (verifier.bin) with the engine's
exact Fiat-Shamir transcript, vanishing-polynomial identity, and FRI
opening checks — the interop analog of the reference's
WormholeVerifier::verify (wormhole/verifier/src/lib.rs:155-160).

All arithmetic is host-side numpy (the verifier must stay cheap enough for
a constrained environment, mirroring the reference's no_std on-chain
verifier; SURVEY.md §3.3).
"""

from __future__ import annotations

import numpy as np

from ..hash.challenger import Challenger
from ..host import gl, gle, poseidon as hposeidon
from . import gates as gatesm
from .serde import RefCommonData, RefProof, RefVerifierData


class RefVerificationError(ValueError):
    pass


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _verify_merkle_proof(leaf: np.ndarray, index: int, cap: np.ndarray,
                         siblings: np.ndarray) -> None:
    leaf = np.asarray(leaf, dtype=np.uint64)
    if leaf.size <= 4:
        current = np.zeros(4, dtype=np.uint64)
        current[: leaf.size] = leaf
    else:
        current = hposeidon.hash_no_pad(leaf)
    i = index
    for sib in siblings:
        if i & 1:
            current = hposeidon.compress(sib, current)
        else:
            current = hposeidon.compress(current, sib)
        i >>= 1
    if not np.array_equal(current, cap[i]):
        raise RefVerificationError("merkle proof failed")


def _reduce_with_powers(terms, alpha):
    """Σ terms[k]·alpha^k (terms in increasing power order)."""
    acc = gle.ZERO.copy()
    for t in reversed(list(terms)):
        acc = gle.add(gle.mul(acc, alpha), t)
    return acc


def _interpolate_at(xs: list[np.ndarray], ys: list[np.ndarray], z: np.ndarray):
    """Lagrange interpolation at z over GF(p^2) points."""
    total = gle.ZERO.copy()
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num = gle.ONE.copy()
        den = gle.ONE.copy()
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = gle.mul(num, gle.sub(z, xj))
            den = gle.mul(den, gle.sub(xi, xj))
        total = gle.add(total, gle.mul(yi, gle.mul(num, gle.inverse(den))))
    return total


def _fork_root_of_unity(common: RefCommonData, bits: int) -> int:
    """The fork's 2^bits-th root of unity.

    qp-plonky2 replaces Goldilocks' MULTIPLICATIVE_GROUP_GENERATOR (7
    upstream) with g0 = 14293326489335486720; every derived constant
    (POWER_OF_TWO_GENERATOR, coset shift, k_is) follows.  Recovered by
    solving the FRI fold/slot systems on bench-data/proof.bin
    (scripts/compat_level{0,1}_solve.py + compat_combine_solve.py,
    validated 28/28 queries at every level); g0 == k_is[1] in common.bin,
    and g0^16 / g0^256 reproduce the solved level-1/2 coset shifts."""
    g0 = int(common.k_is[1])
    return pow(g0, (gl.P_INT - 1) >> bits, gl.P_INT)


def verify(common: RefCommonData, verifier_data: RefVerifierData,
           proof: RefProof, _UNSOUND_skip_vanishing_for_tests: bool = False) -> None:
    fri_cfg = common.fri_config
    cap_len = 1 << fri_cfg.cap_height
    nc = common.num_challenges
    n = common.degree
    lde_bits = common.lde_bits
    op = proof.openings
    fp = proof.opening_proof

    pis = np.asarray(proof.public_inputs, dtype=np.uint64)
    if pis.shape[0] != common.num_public_inputs or (pis >= gl.P_INT).any():
        raise RefVerificationError("bad public inputs")
    pi_hash = hposeidon.hash_no_pad(pis) if pis.size else np.zeros(4, np.uint64)

    # ---- challenges (transcript order per the engine) ---------------------
    ch = Challenger()
    ch.observe_hash(verifier_data.circuit_digest)
    ch.observe_hash(pi_hash)
    ch.observe_cap(proof.wires_cap)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.plonk_zs_partial_products_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_polys_cap)
    zeta = ch.get_extension_challenge()
    ch.observe_extension_elements(op.fri_batch0())
    ch.observe_extension_elements(op.fri_batch1())
    fri_alpha = ch.get_extension_challenge()
    fri_betas = []
    for cap in fp.commit_phase_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    ch.observe_extension_elements(fp.final_poly)
    ch.observe_element(fp.pow_witness)
    pow_response = ch.get_challenge()
    query_indices = [ch.get_challenge() % (1 << lde_bits)
                     for _ in range(fri_cfg.num_query_rounds)]

    # ---- proof of work ----------------------------------------------------
    leading_zeros = 64 - int(pow_response).bit_length()
    if leading_zeros < fri_cfg.proof_of_work_bits:
        raise RefVerificationError("proof-of-work check failed")

    # ---- vanishing identity at zeta ---------------------------------------
    zeta_pow_n = gle.exp_power_of_2(zeta, common.degree_bits)
    zh_zeta = gle.sub(zeta_pow_n, gle.ONE)
    if not np.any(zh_zeta):
        raise RefVerificationError("zeta in H")
    # L_0(zeta) = (zeta^n - 1) / (n*(zeta - 1))
    l0 = gle.mul(zh_zeta, gle.inverse(
        gle.mul_base(gle.sub(zeta, gle.ONE), np.uint64(n))))

    constants = [op.constants[i] for i in range(common.num_constants)]
    wires = [op.wires[i] for i in range(common.num_wires)]
    constraint_terms = gatesm.evaluate_gate_constraints(
        common, constants, wires, pi_hash)

    z1_terms = []
    pp_terms = []
    qdf = common.quotient_degree_factor
    for i in range(nc):
        z_x = op.plonk_zs[i]
        z_gx = op.plonk_zs_next[i]
        z1_terms.append(gle.mul(l0, gle.sub(z_x, gle.ONE)))
        beta = gle.from_base(np.uint64(betas[i]))
        gamma = gle.from_base(np.uint64(gammas[i]))
        numerators, denominators = [], []
        for j in range(common.num_routed_wires):
            wire = op.wires[j]
            s_id = gle.mul_base(zeta, common.k_is[j])
            s_sigma = op.plonk_sigmas[j]
            numerators.append(gle.add(gle.add(wire, gle.mul(beta, s_id)), gamma))
            denominators.append(gle.add(gle.add(wire, gle.mul(beta, s_sigma)), gamma))
        accs = [z_x] + [op.partial_products[i * common.num_partial_products + k]
                        for k in range(common.num_partial_products)] + [z_gx]
        chunk = common.quotient_degree_factor
        n_chunks = common.num_routed_wires // chunk
        for k in range(n_chunks):
            num_prod = gle.ONE.copy()
            den_prod = gle.ONE.copy()
            for j in range(k * chunk, (k + 1) * chunk):
                num_prod = gle.mul(num_prod, numerators[j])
                den_prod = gle.mul(den_prod, denominators[j])
            pp_terms.append(gle.sub(gle.mul(accs[k], num_prod),
                                    gle.mul(accs[k + 1], den_prod)))

    vanishing_terms = z1_terms + pp_terms + constraint_terms
    for i in ([] if _UNSOUND_skip_vanishing_for_tests else range(nc)):
        alpha_i = gle.from_base(np.uint64(alphas[i]))
        combined = _reduce_with_powers(vanishing_terms, alpha_i)
        quotient = _reduce_with_powers(
            [op.quotient_polys[i * qdf + t] for t in range(qdf)], zeta_pow_n)
        if not np.array_equal(combined, gle.mul(zh_zeta, quotient)):
            raise RefVerificationError(f"vanishing identity failed ({i})")

    # ---- FRI ---------------------------------------------------------------
    g_ext = gle.from_base(np.uint64(_fork_root_of_unity(common, common.degree_bits)))
    zeta_next = gle.mul(zeta, g_ext)
    ro0 = _reduce_with_powers(op.fri_batch0(), fri_alpha)
    ro1 = _reduce_with_powers(op.fri_batch1(), fri_alpha)
    n_batch0 = op.fri_batch0().shape[0]

    oracle_caps = [
        verifier_data.constants_sigmas_cap,
        proof.wires_cap,
        proof.plonk_zs_partial_products_cap,
        proof.quotient_polys_cap,
    ]
    widths = common.oracle_widths
    salt = common.salt_size
    # instance polynomial counts per oracle (salts excluded)
    inst_widths = [widths[0], widths[1] - salt, widths[2] - salt, widths[3] - salt]

    g_lde = _fork_root_of_unity(common, lde_bits)
    shift = int(common.k_is[1])   # fork coset shift == its group generator

    if fp.final_poly.shape[0] != 1 << (
            common.degree_bits - sum(common.reduction_arity_bits)):
        raise RefVerificationError("final polynomial length mismatch")

    for qi, x_index in enumerate(query_indices):
        rnd = fp.query_rounds[qi]
        # initial tree openings
        for oi in range(4):
            if rnd.initial.evals[oi].shape[0] != widths[oi]:
                raise RefVerificationError("initial eval width mismatch")
            _verify_merkle_proof(rnd.initial.evals[oi], x_index,
                                 oracle_caps[oi], rnd.initial.proofs[oi].siblings)

        # combine initial evaluations
        x_base = gl.mul(np.uint64(shift),
                        np.uint64(gl.powmod(np.uint64(g_lde),
                                            _bit_reverse(x_index, lde_bits))))
        subgroup_x = gle.from_base(x_base)
        ev0 = np.concatenate([
            rnd.initial.evals[0],
            rnd.initial.evals[1][: inst_widths[1]],
            rnd.initial.evals[2][: inst_widths[2]],
            rnd.initial.evals[3][: inst_widths[3]],
        ])
        re0 = _reduce_with_powers([gle.from_base(e) for e in ev0], fri_alpha)
        ev1 = rnd.initial.evals[2][: nc]
        re1 = _reduce_with_powers([gle.from_base(e) for e in ev1], fri_alpha)

        term0 = gle.mul(gle.sub(re0, ro0),
                        gle.inverse(gle.sub(subgroup_x, zeta)))
        term1 = gle.mul(gle.sub(re1, ro1),
                        gle.inverse(gle.sub(subgroup_x, zeta_next)))
        alpha_pow_b1 = gle.powmod(fri_alpha, op.fri_batch1().shape[0])
        old_eval = gle.add(gle.mul(alpha_pow_b1, term0), term1)

        # fold steps
        x = subgroup_x
        idx = x_index
        domain_bits = lde_bits
        for si, arity_bits in enumerate(common.reduction_arity_bits):
            arity = 1 << arity_bits
            evals = fp.query_rounds[qi].steps[si].evals
            j = idx & (arity - 1)
            if not np.array_equal(evals[j], old_eval):
                raise RefVerificationError(f"fold consistency failed (step {si})")
            # interpolate the coset polynomial at beta
            g_ar = np.uint64(_fork_root_of_unity(common, arity_bits))
            rev_j = _bit_reverse(j, arity_bits)
            coset_start = gle.mul_base(
                x, gl.powmod(g_ar, (arity - rev_j) % arity))
            xs, ys = [], []
            acc = coset_start
            for t in range(arity):
                xs.append(acc)
                acc = gle.mul_base(acc, g_ar)
            for t in range(arity):
                ys.append(evals[_bit_reverse(t, arity_bits)])
            old_eval = _interpolate_at(xs, ys, fri_betas[si])

            idx >>= arity_bits
            _verify_merkle_proof(
                evals.reshape(-1), idx,
                fp.commit_phase_caps[si],
                fp.query_rounds[qi].steps[si].proof.siblings)
            x = gle.exp_power_of_2(x, arity_bits)
            domain_bits -= arity_bits

        # final polynomial evaluation
        final_eval = _reduce_with_powers(list(fp.final_poly), x)
        if not np.array_equal(final_eval, old_eval):
            raise RefVerificationError("final polynomial check failed")
