"""FRI proof structures, the proof-of-work grind and verification.

The prover side (composition, fold rounds, query gathers) runs on tensors
in fri/fri_device.py.

Mirrors the reference engine's FRI (qp-plonky2 fri/): the composition
polynomial sums all committed polynomials with powers of alpha per opening
point, quotients by (X - z), then folds with per-round betas at arity
2^reduction_arity_bits down to a clear-text final polynomial.  Folds are
performed in coefficient space (new_c[m] = sum_j beta^j c[A*m+j]) which is
exactly the fiber-interpolation fold evaluated at beta.

Codewords are kept in natural coset order x_i = shift * w_N^i; a fold fiber
for index i is the strided set {i mod M + k*M} (M = N/arity).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..hash import merkle as merklem
from ..hash.challenger import Challenger
from ..host import gl, gle, poseidon as hposeidon
from ..plonk.config import FriConfig


@dataclass
class FriQueryStep:
    coset_values: np.ndarray      # (arity, 2) ext values of the opened fiber
    siblings: list[np.ndarray]


@dataclass
class FriQueryRound:
    initial_leaves: list[tuple[np.ndarray, list[np.ndarray]]]  # per oracle
    steps: list[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_caps: list[np.ndarray]
    query_rounds: list[FriQueryRound]
    final_poly: np.ndarray        # (m, 2) ext coefficients
    pow_witness: int


# ---------------------------------------------------------------------------
# helpers and proof-of-work grind
# ---------------------------------------------------------------------------


def eval_ext_poly(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Horner evaluation of ext-coeff poly at ext point."""
    acc = gle.ZERO.copy()
    for c in coeffs[::-1]:
        acc = gle.add(gle.mul(acc, x), c)
    return acc


# Candidates hashed per sweep: one leaf-kernel launch of (2^17, 5) rows on
# the card; the plain CPU sponge sweeps smaller windows, at most 2^14 and
# about four expected witnesses wide (4 << pow_bits, at least 64), so that
# a cheap config does not hash 2^14 candidates to find a witness near 2^2
# (same result: the windows run from 0 upward and the first hit of the
# first window that has one is the smallest passing witness).
GRIND_BATCH = {"cuda": 1 << 17, "cpu": 1 << 14}


def proof_of_work_grind(pow_base: np.ndarray, pow_bits: int, device) -> int:
    """Min witness w >= 0 with H(pow_base || w)[0] < 2^(64 - pow_bits),
    hashing the candidates on ``device`` through the leaf sponge."""
    return proof_of_work_grind_batch(np.reshape(pow_base, (1, 4)), pow_bits, device)[0]


def proof_of_work_grind_batch(pow_bases: np.ndarray, pow_bits: int,
                              device) -> list[int]:
    """proof_of_work_grind of B bases (one per proof of a batch), each its
    smallest witness: every base scans the same windows from 0 upward, and
    one sweep hashes the window of every base still without a witness in
    one leaf-kernel launch (a (B x window, 5) candidate matrix)."""
    import torch

    from ..field import goldilocks as gfd
    from ..hash import poseidon_plain as pp

    _check_pow_bits(pow_bits)
    device = torch.device(device)
    batch = GRIND_BATCH[device.type]
    if device.type == "cpu":
        batch = min(batch, max(64, 4 << pow_bits))
    threshold = gfd._i64(1 << (64 - pow_bits))
    bases = gfd.from_u64(np.asarray(pow_bases, dtype=np.uint64).reshape(-1, 4), device)
    ramp = torch.arange(batch, dtype=torch.int64, device=device)
    out: list[int | None] = [None] * bases.shape[0]
    start = 0
    while start < 1 << 40:
        todo = [b for b, w in enumerate(out) if w is None]
        if not todo:
            return out  # type: ignore[return-value]
        k = len(todo)
        cand = torch.cat([bases[todo][:, None, :].expand(k, batch, 4),
                          (ramp + start)[None, :, None].expand(k, batch, 1)], dim=-1)
        ok = gfd.ult(pp.hash_leaves(cand.reshape(k * batch, 5))[:, 0], threshold)
        ok = ok.reshape(k, batch)
        first = ok.to(torch.int32).argmax(dim=1)    # the first hit of each row
        for b, i in zip(todo, torch.where(ok.any(dim=1), first, -1).tolist()):
            if i >= 0:
                out[b] = start + i
        start += batch
    raise RuntimeError("proof-of-work grind found no witness below 2^40")


def _check_pow_bits(pow_bits: int) -> None:
    """A witness's hash must lie below 2^(64 - pow_bits): 0 bits would set
    no bound the grind can meet (the JAX package's np.uint64(2^64) raises),
    more than 64 none at all."""
    if not 1 <= pow_bits <= 64:
        raise ValueError(f"proof_of_work_bits must lie in 1..64, got {pow_bits}")


def check_pow(pow_base: np.ndarray, witness: int, pow_bits: int) -> bool:
    _check_pow_bits(pow_bits)
    inp = np.concatenate([pow_base, np.array([witness], dtype=np.uint64)])
    h0 = int(hposeidon.hash_no_pad(inp)[0])
    return h0 < (1 << (64 - pow_bits))


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def fold_single(
    coset_values: np.ndarray, x0: int, a_bits: int, beta: np.ndarray, omega: int
) -> np.ndarray:
    """Evaluate the fiber interpolant at beta for one query point.

    coset_values[k] = f(x0 * omega^k) where omega has order 2^a_bits."""
    vals = [v.copy() for v in coset_values]
    pts = [pow(omega, k, gl.P_INT) * x0 % gl.P_INT for k in range(len(vals))]
    b = beta.copy()
    arity = len(vals)
    inv2 = pow(2, gl.P_INT - 2, gl.P_INT)
    while arity > 1:
        half = arity // 2
        new_vals = []
        new_pts = []
        for k in range(half):
            v_plus, v_minus = vals[k], vals[k + half]
            s = gle.mul_base(gle.add(v_plus, v_minus), np.uint64(inv2))
            inv_2x = pow(2 * pts[k] % gl.P_INT, gl.P_INT - 2, gl.P_INT)
            d = gle.mul_base(gle.sub(v_plus, v_minus), np.uint64(inv_2x))
            new_vals.append(gle.add(s, gle.mul(b, d)))
            new_pts.append(pts[k] * pts[k] % gl.P_INT)
        vals, pts = new_vals, new_pts
        b = gle.mul(b, b)
        arity = half
    return vals[0]


def verify_fri_proof(
    proof: FriProof,
    reduced_openings,              # list of (z_b (2,), batch_poly_indices, y_b (2,))
    oracle_caps: list[np.ndarray],
    oracle_num_polys: list[int],
    alpha: np.ndarray,
    degree_bits: int,
    fri_config: FriConfig,
    challenger: Challenger,
    coset_shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR,
) -> None:
    """Replays the transcript and checks every query round.  ``challenger``
    must be positioned right after alpha was drawn (same as prover's).
    reduced_openings entries: (point z_b, list of (oracle_idx, poly_idx),
    claimed reduced eval y_b)."""
    n = 1 << degree_bits
    lde_size = n << fri_config.rate_bits
    arities = fri_config.reduction_arities(degree_bits)
    assert len(proof.commit_phase_caps) == len(arities)

    betas = []
    for cap in proof.commit_phase_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    challenger.observe_extension_elements(proof.final_poly)

    pow_base = challenger.get_hash()
    if not check_pow(pow_base, proof.pow_witness, fri_config.proof_of_work_bits):
        raise ValueError("FRI proof-of-work check failed")
    challenger.observe_element(proof.pow_witness)

    # final poly degree bound
    final_bits = degree_bits - sum(arities)
    if proof.final_poly.shape[0] > (1 << final_bits):
        raise ValueError("FRI final polynomial too large")

    w_lde = gl.primitive_root_of_unity(degree_bits + fri_config.rate_bits)

    for qr in proof.query_rounds:
        idx = challenger.get_challenge() % lde_size
        if len(qr.initial_leaves) != len(oracle_caps):
            raise ValueError("FRI query round oracle count mismatch")
        # verify oracle openings
        for o, (leaf, siblings) in enumerate(qr.initial_leaves):
            if len(leaf) != oracle_num_polys[o]:
                raise ValueError("FRI initial leaf width mismatch")
            if not merklem.verify_merkle_proof(leaf, idx, oracle_caps[o], siblings):
                raise ValueError(f"FRI initial Merkle proof failed (oracle {o})")

        # composition value at x_idx from leaves
        x = pow(w_lde, idx, gl.P_INT) * coset_shift % gl.P_INT
        x_ext = np.array([x, 0], dtype=np.uint64)
        value = None
        for z_b, poly_refs, y_b in reduced_openings:
            comp = gle.ZERO.copy()
            apow = gle.ONE.copy()
            for (oi, pi) in poly_refs:
                leaf_val = qr.initial_leaves[oi][0][pi]
                comp = gle.add(comp, gle.mul_base(apow, np.uint64(leaf_val)))
                apow = gle.mul(apow, alpha)
            num = gle.sub(comp, y_b)
            den = gle.sub(x_ext, z_b)
            q_val = gle.mul(num, gle.inverse(den))
            if value is None:
                value = q_val
            else:
                # final = q_b + alpha^{|batch_b|} * previous
                shift_pow = gle.powmod(alpha, len(poly_refs))
                value = gle.add(q_val, gle.mul(shift_pow, value))
        cur_value = value
        cur_idx = idx
        cur_size = lde_size
        cur_shift = coset_shift
        cur_w = w_lde
        for r, a_bits in enumerate(arities):
            arity = 1 << a_bits
            m = cur_size // arity
            group = cur_idx % m
            k = cur_idx // m
            step = qr.steps[r]
            if step.coset_values.shape != (arity, 2):
                raise ValueError("FRI step shape mismatch")
            if not np.array_equal(step.coset_values[k], cur_value):
                raise ValueError("FRI fold consistency check failed")
            leaf = step.coset_values.reshape(-1)
            if not merklem.verify_merkle_proof(
                leaf, group, proof.commit_phase_caps[r], step.siblings
            ):
                raise ValueError("FRI commit-phase Merkle proof failed")
            # x0 of the fiber: point at index `group`; omega = w^m has order arity
            x0 = pow(cur_w, group, gl.P_INT) * cur_shift % gl.P_INT
            omega = pow(cur_w, m, gl.P_INT)
            cur_value = fold_single(step.coset_values, x0, a_bits, betas[r], omega)
            cur_idx = group
            cur_size = m
            cur_shift = pow(cur_shift, arity, gl.P_INT)
            cur_w = pow(cur_w, arity, gl.P_INT)
        # final check against the clear final polynomial
        xf = pow(cur_w, cur_idx, gl.P_INT) * cur_shift % gl.P_INT
        expect = eval_ext_poly(proof.final_poly, np.array([xf, 0], dtype=np.uint64))
        if not np.array_equal(expect, cur_value):
            raise ValueError("FRI final polynomial evaluation mismatch")
