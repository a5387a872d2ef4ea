"""The PLONK+FRI verifier (host-side, numpy only — the analog of the
reference's on-chain-capable verifier, wormhole/verifier/src/lib.rs:155-160).

Re-derives all challenges from the transcript, checks the vanishing
identity at zeta against the opened quotient, and verifies the FRI opening
proof (Merkle paths, fold consistency, PoW, final polynomial)."""

from __future__ import annotations

import numpy as np

from ..fri import fri as frim
from ..hash.challenger import Challenger
from ..host import gl, gle, poseidon as hposeidon
from . import algebra
from .proof import ProofWithPublicInputs
from .vanishing import VanishingVars, eval_vanishing


class VerificationError(ValueError):
    pass


def _oracle_widths(common) -> list[int]:
    cfg = common.config
    salt = 4 if cfg.zero_knowledge else 0
    return [
        common.num_constants_sigmas_polys,
        cfg.num_wires + salt,
        common.num_zs_partial_products_polys + salt,
        common.num_quotient_polys + salt,
    ]


def verify(common, verifier_only, pwpi: ProofWithPublicInputs) -> None:
    proof = pwpi.proof
    cfg = common.config
    n = common.degree
    cap_len = 1 << cfg.fri_config.cap_height

    public_inputs = np.asarray(pwpi.public_inputs, dtype=np.uint64)
    if public_inputs.shape[0] != common.num_public_inputs:
        raise VerificationError("public input count mismatch")
    if (public_inputs >= gl.P).any():
        raise VerificationError("public input out of field range")
    pi_hash = (
        hposeidon.hash_no_pad(public_inputs)
        if public_inputs.size
        else np.zeros(4, np.uint64)
    )

    widths = _oracle_widths(common)
    op = proof.openings
    for arr, want in zip(
        [op.constants_sigmas, op.wires, op.zs_partial_products, op.quotient],
        widths,
    ):
        if arr.shape != (want, 2):
            raise VerificationError("opening shape mismatch")
    if op.zs_next.shape != (cfg.num_challenges, 2):
        raise VerificationError("zs_next shape mismatch")
    for cap in (proof.wires_cap, proof.zs_partial_products_cap, proof.quotient_cap):
        if cap.shape != (cap_len, 4):
            raise VerificationError("cap shape mismatch")

    # ---- transcript ------------------------------------------------------
    ch = Challenger()
    ch.observe_hash(verifier_only.circuit_digest)
    ch.observe_hash(pi_hash)
    ch.observe_cap(proof.wires_cap)
    betas = ch.get_n_challenges(cfg.num_challenges)
    gammas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(proof.zs_partial_products_cap)
    alphas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_extension_challenge()
    ch.observe_extension_elements(op.batch0_flat())
    ch.observe_extension_elements(op.batch1_flat())
    alpha = ch.get_extension_challenge()

    # ---- vanishing identity at zeta --------------------------------------
    alg = algebra.HOST_EXT
    s = common.num_selectors
    c_ = cfg.num_constants
    num_pp = common.num_partial_products
    zeta_pow_n = gle.exp_power_of_2(zeta, common.degree_bits)
    zh_zeta = gle.sub(zeta_pow_n, gle.ONE)
    if not np.any(zh_zeta):
        raise VerificationError("zeta in H (degenerate)")
    l1 = gle.mul(
        zh_zeta,
        gle.inverse(gle.mul_base(gle.sub(zeta, gle.ONE), np.uint64(n))),
    )

    def lift(x):  # base (k,) -> ext (1, k, 2)
        out = np.zeros((1, len(x), 2), dtype=np.uint64)
        out[0, :, 0] = x
        return out

    cs = op.constants_sigmas
    vv = VanishingVars(
        x=zeta[None, :],
        wires=op.wires[None, : cfg.num_wires],
        selectors=cs[None, :s],
        constants=cs[None, s : s + c_],
        sigmas=cs[None, s + c_ : s + c_ + cfg.num_routed_wires],
        zs=[op.zs_partial_products[None, i] for i in range(cfg.num_challenges)],
        zs_next=[op.zs_next[None, i] for i in range(cfg.num_challenges)],
        partial_products=[
            op.zs_partial_products[None, cfg.num_challenges + ch_i * num_pp :
                                   cfg.num_challenges + (ch_i + 1) * num_pp]
            for ch_i in range(cfg.num_challenges)
        ],
        l1=l1[None, :],
        pi_hash=lift(pi_hash),
        betas=[np.array([b, 0], dtype=np.uint64) for b in betas],
        gammas=[np.array([g, 0], dtype=np.uint64) for g in gammas],
        alphas=[np.array([a, 0], dtype=np.uint64) for a in alphas],
    )
    combined = eval_vanishing(alg, common, vv)

    # quotient recombination: t_c(zeta) = sum_t zeta^{t*n} * chunk_{c,t}(zeta)
    q = common.quotient_degree_factor
    for c in range(cfg.num_challenges):
        acc = gle.ZERO.copy()
        for t in range(q - 1, -1, -1):
            acc = gle.add(gle.mul(acc, zeta_pow_n), op.quotient[c * q + t])
        rhs = gle.mul(zh_zeta, acc)
        if not np.array_equal(combined[c][0], rhs):
            raise VerificationError(f"vanishing identity failed (challenge {c})")

    # ---- FRI -------------------------------------------------------------
    g_ext = np.array([gl.primitive_root_of_unity(common.degree_bits), 0], dtype=np.uint64)
    zeta_next = gle.mul(zeta, g_ext)

    batch0_refs = []
    for oi, w in enumerate(widths):
        batch0_refs += [(oi, pi) for pi in range(w)]
    batch1_refs = [(2, i) for i in range(cfg.num_challenges)]
    y0 = _reduce_evals(op.batch0_flat(), alpha)
    y1 = _reduce_evals(op.batch1_flat(), alpha)

    oracle_caps = [
        verifier_only.constants_sigmas_cap,
        proof.wires_cap,
        proof.zs_partial_products_cap,
        proof.quotient_cap,
    ]
    frim.verify_fri_proof(
        proof.opening_proof,
        [(zeta, batch0_refs, y0), (zeta_next, batch1_refs, y1)],
        oracle_caps,
        widths,
        alpha,
        common.degree_bits,
        cfg.fri_config,
        ch,
    )


def _reduce_evals(evals: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    acc = gle.ZERO.copy()
    apow = gle.ONE.copy()
    for y in evals:
        acc = gle.add(acc, gle.mul(apow, y))
        apow = gle.mul(apow, alpha)
    return acc
