"""Tensor-resident FRI opening proof + opening evaluations.

Torch counterpart of the JAX package's fri/fri_device.py (single-proof
path):

- openings: every oracle polynomial evaluated at zeta / g*zeta as one
  base-coefficient matvec against host-computed power tables;
- composition: the alpha-reduced FRI quotient (batch 0 at zeta, batch 1 at
  g*zeta) with the vectorized divide-by-linear, then the round-0 codeword
  NTT and Merkle commit;
- fold rounds: coefficient-space fold (new_c[m] = sum_j beta^j c[A*m+j])
  + next codeword NTT + Merkle commit;
- query phase: every oracle and every commit-phase tree gathered on the
  device and fetched in one transfer.

The Fiat-Shamir challenger stays on the host; only caps, the final
polynomial and query rows leave the device.  Extension elements travel as
pairs of base tensors (components of GF(p^2) = GF(p)[x]/(x^2 - 7)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..field.goldilocks import eadd as _eadd
from ..field.goldilocks import emul as _emul
from ..hash import merkle as merklem
from ..host import gl, gle
from ..ntt import ntt as nttm
from . import fri as frim
from .oracle import ext_powers


def _reduce_alpha(batch, ap0, ap1):
    """sum_i alpha^i * P_i: (k, n) base polys x (k,) ext powers -> (n,) ext."""
    w0 = gfd.mul(batch, ap0[:, None])
    w1 = gfd.mul(batch, ap1[:, None])
    return gfd.sum_mod(w0, axis=0), gfd.sum_mod(w1, axis=0)


def _suffix_sum(s0, s1):
    """s_i <- sum_{j>=i} s_j via log-step doubling (fri.divide_by_linear)."""
    n = s0.shape[-1]
    shift = 1
    while shift < n:
        h0, h1 = _eadd(s0[:-shift], s1[:-shift], s0[shift:], s1[shift:])
        s0 = torch.cat([h0, s0[-shift:]])
        s1 = torch.cat([h1, s1[-shift:]])
        shift *= 2
    return s0, s1


def _ddl(c0, c1, zp0, zp1, zi0, zi1):
    """(P(X) - P(z)) / (X - z) in coefficient space:
    q_i = zinv^(i+1) * sum_{j>=i+1} c_j z^j."""
    w0, w1 = _emul(c0, c1, zp0, zp1)
    s0, s1 = _suffix_sum(w0, w1)
    return _emul(s0[1:], s1[1:], zi0[1:], zi1[1:])


def _ext_coset_ntt_dev(c0, c1, shift: int, out_size: int):
    """Evaluate an ext-coeff pair on the coset shift*<w_N>."""
    m = c0.shape[-1]
    pw = nttm.powers(shift, out_size, c0.device)
    p0 = torch.nn.functional.pad(c0, (0, out_size - m))
    p1 = torch.nn.functional.pad(c1, (0, out_size - m))
    return nttm.ntt(gfd.mul(p0, pw)), nttm.ntt(gfd.mul(p1, pw))


def _fiber_leaves(v0, v1, arity: int) -> torch.Tensor:
    """Codeword (N,) pair -> (m, arity*2) leaf rows, fiber-grouped with
    interleaved ext components: leaf j holds [v(0,j), v(1,j), ...] where
    v(k, j) = v[k*m + j]."""
    m = v0.shape[-1] // arity
    g0 = v0.reshape(arity, m).t()
    g1 = v1.reshape(arity, m).t()
    return torch.stack([g0, g1], dim=-1).reshape(m, arity * 2)


def _fold_dev(c0, c1, b0, b1, arity_bits: int):
    """new_c[m] = sum_j beta^j c[A*m + j] (Horner over j)."""
    arity = 1 << arity_bits
    m = c0.shape[-1] // arity
    r0 = c0.reshape(m, arity)
    r1 = c1.reshape(m, arity)
    acc0, acc1 = r0[:, arity - 1], r1[:, arity - 1]
    for j in range(arity - 2, -1, -1):
        acc0, acc1 = _emul(acc0, acc1, b0, b1)
        acc0, acc1 = _eadd(acc0, acc1, r0[:, j], r1[:, j])
    return acc0, acc1


def _commit_codeword(f0, f1, shift: int, size: int, arity_bits: int,
                     cap_height: int):
    """NTT an ext coefficient pair onto its coset and commit the fiber tree."""
    v0, v1 = _ext_coset_ntt_dev(f0, f1, shift, size)
    leaves = _fiber_leaves(v0, v1, 1 << arity_bits)
    return leaves, merklem.device_merkle_levels(leaves, cap_height)


def take_rows(leaves: torch.Tensor, idx: np.ndarray, colmajor: bool) -> torch.Tensor:
    """Rows ``idx`` of a (N, w) row-major or (w, N) column-major matrix."""
    i = torch.from_numpy(idx).to(leaves.device)
    return leaves[:, i].t() if colmajor else leaves[i]


def gather_trees(trees: list, idxs: list, colmajor: tuple, take=take_rows) -> list:
    """trees: per tree (leaves, levels) with leaves (N, w) row-major, or
    (w, N) column-major where ``colmajor`` says so; idxs: per-tree query
    indices.  Gathers every row and sibling path on the device with
    ``take(leaves_or_level, idx, colmajor)`` and fetches them in ONE
    transfer.  Returns [(rows u64 (Q, w), sibs u64 (Q, L, 4))]."""
    chunks, shapes = [], []
    for (leaves, levels), idx, cm in zip(trees, idxs, colmajor):
        i = np.asarray(idx, dtype=np.int64)
        rows = take(leaves, i, cm)
        chunks.append(rows.reshape(-1))
        for lv in levels[:-1]:
            chunks.append(take(lv, i ^ 1, False).reshape(-1))
            i = i >> 1
        shapes.append((rows.shape, len(levels) - 1))
    flat = gfd.to_u64(torch.cat(chunks))
    out, pos = [], 0
    for (q, w), nlev in shapes:
        rows = flat[pos : pos + q * w].reshape(q, w)
        pos += q * w
        sibs = flat[pos : pos + nlev * q * 4].reshape(nlev, q, 4)
        pos += nlev * q * 4
        out.append((rows, np.ascontiguousarray(sibs.transpose(1, 0, 2))))
    assert pos == flat.shape[0]
    return out


def openings_set(evals: np.ndarray, zs_next: np.ndarray, widths: tuple):
    """OpeningSet from the (K, 2) evaluations at zeta of every oracle
    polynomial (oracle order, ``widths`` polynomials each) and the
    (num_zs, 2) evaluations of the Z polynomials at g*zeta."""
    from ..plonk.proof import OpeningSet

    k0, k1, k2, _ = widths
    return OpeningSet(
        constants_sigmas=evals[:k0],
        wires=evals[k0 : k0 + k1],
        zs_partial_products=evals[k0 + k1 : k0 + k1 + k2],
        quotient=evals[k0 + k1 + k2 :],
        zs_next=zs_next,
    )


def compose(comp0, comp1, zeta, zeta_next, alpha, num_zs: int, zp, znp):
    """The FRI polynomial from the alpha-reduced batches: comp0 (all
    polynomials, opened at zeta) and comp1 (the Z polynomials, at g*zeta),
    each an (n,) ext pair; zp/znp are the powers of zeta/g*zeta as device
    pairs.  final[:n-1] = q1 + alpha^num_zs * q0, final[n-1] = 0."""
    n = comp0[0].shape[-1]
    device = comp0[0].device

    def pair(arr):
        return gfd.ext_pair(arr, device)

    zi0, zi1 = pair(ext_powers(gle.inverse(zeta), n))
    zni0, zni1 = pair(ext_powers(gle.inverse(zeta_next), n))
    q0 = _ddl(*comp0, *zp, zi0, zi1)
    q1 = _ddl(*comp1, *znp, zni0, zni1)
    sq = _emul(*q0, *pair(gle.powmod(alpha, num_zs)))
    f0, f1 = (torch.nn.functional.pad(v, (0, 1)) for v in _eadd(*q1, *sq))
    return f0, f1


def commit_phase(f0, f1, fri_config, degree_bits: int, ch):
    """The FRI commit chain on one device from the (n,) ext coefficient
    pair f: per fold round, NTT onto the round's coset, commit the fiber
    tree, observe its cap, draw beta, fold.  Returns (caps, trees, betas,
    final f0, final f1) with trees the (leaves, levels) of every round."""
    size = f0.shape[-1] << fri_config.rate_bits
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    caps, trees, betas = [], [], []
    for a_bits in fri_config.reduction_arities(degree_bits):
        leaves, levels = _commit_codeword(f0, f1, shift, size, a_bits,
                                          fri_config.cap_height)
        cap = gfd.to_u64(levels[-1])
        caps.append(cap)
        trees.append((leaves, levels))
        ch.observe_cap(cap)
        beta = ch.get_extension_challenge()
        betas.append(beta)
        b0, b1 = gfd.ext_pair(beta, f0.device)
        f0, f1 = _fold_dev(f0, f1, b0, b1, a_bits)
        shift = pow(shift, 1 << a_bits, gl.P_INT)
        size >>= a_bits
    return caps, trees, betas, f0, f1


def query_indices(ch, fri_config, degree_bits: int) -> tuple:
    """Draw the query indices; returns them and each fold round's indices
    into its tree."""
    lde_size = 1 << (degree_bits + fri_config.rate_bits)
    indices = np.array([ch.get_challenge() % lde_size
                        for _ in range(fri_config.num_query_rounds)], dtype=np.int64)
    step_idx, cur = [], lde_size
    for a_bits in fri_config.reduction_arities(degree_bits):
        cur >>= a_bits
        step_idx.append(indices % cur)
    return indices, step_idx


def fri_proof(caps, opened, fri_opened, final_poly, pow_witness):
    """Assemble the FriProof from the gathered oracle rows/paths
    (``opened``) and fold-tree rows/paths (``fri_opened``)."""
    query_rounds = []
    for qi in range(opened[0][0].shape[0]):
        initial = [(rows[qi].copy(), [s.copy() for s in sibs[qi]])
                   for rows, sibs in opened]
        steps = []
        for rows, sibs in fri_opened:
            coset_values = rows[qi].reshape(-1, 2).copy()  # interleaved ext
            steps.append(frim.FriQueryStep(coset_values,
                                           [s.copy() for s in sibs[qi]]))
        query_rounds.append(frim.FriQueryRound(initial, steps))
    return frim.FriProof(caps, query_rounds, final_poly, pow_witness)


def open_and_fri_device(common, oracles, ch, device) -> tuple:
    """Openings and FRI proof on ``device``: returns (OpeningSet, FriProof).

    ``oracles`` are PolynomialBatch instances resident on ``device``."""
    from ..utils.profiling import stage_timer

    cfg = common.config
    n = common.degree
    num_zs = cfg.num_challenges
    zeta = ch.get_extension_challenge()
    g_ext = np.array([gl.primitive_root_of_unity(common.degree_bits), 0],
                     dtype=np.uint64)
    zeta_next = gle.mul(zeta, g_ext)

    def pair(arr):
        return gfd.ext_pair(arr, device)

    sets = [o.coeffs_dev for o in oracles]
    widths = tuple(s.shape[0] for s in sets)
    batch0 = torch.cat(sets, dim=0)
    zs2 = sets[2][:num_zs]

    with stage_timer("fri/openings_eval"):
        zp = pair(ext_powers(zeta, n))
        znp = pair(ext_powers(zeta_next, n))
        e0 = gfd.sum_mod(gfd.mul(batch0, zp[0][None, :]), axis=-1)
        e1 = gfd.sum_mod(gfd.mul(batch0, zp[1][None, :]), axis=-1)
        zn0 = gfd.sum_mod(gfd.mul(zs2, znp[0][None, :]), axis=-1)
        zn1 = gfd.sum_mod(gfd.mul(zs2, znp[1][None, :]), axis=-1)
        openings = openings_set(gfd.to_ext(e0, e1), gfd.to_ext(zn0, zn1), widths)
    ch.observe_extension_elements(openings.batch0_flat())
    ch.observe_extension_elements(openings.batch1_flat())
    alpha = ch.get_extension_challenge()

    fri_config = cfg.fri_config
    with stage_timer("fri/compose_r0"):
        ap0, ap1 = pair(ext_powers(alpha, sum(widths)))
        comp0 = _reduce_alpha(batch0, ap0, ap1)
        comp1 = _reduce_alpha(zs2, ap0[:num_zs], ap1[:num_zs])
        f0, f1 = compose(comp0, comp1, zeta, zeta_next, alpha, num_zs, zp, znp)

    with stage_timer("fri/commit_phase"):
        caps, trees, _, f0, f1 = commit_phase(f0, f1, fri_config,
                                              common.degree_bits, ch)

    final_poly = gfd.to_ext(f0, f1)
    ch.observe_extension_elements(final_poly)

    pow_base = ch.get_hash()
    with stage_timer("fri/pow_grind"):
        pow_witness = frim.proof_of_work_grind(
            pow_base, fri_config.proof_of_work_bits, device)
    ch.observe_element(pow_witness)

    idx_arr, step_idx = query_indices(ch, fri_config, common.degree_bits)

    # --- query gathers: one transfer for oracles and FRI trees together ---
    with stage_timer("fri/query_gather"):
        all_opened = gather_trees(
            [(o.values_dev, o.levels_dev) for o in oracles] + trees,
            [idx_arr] * len(oracles) + step_idx,
            colmajor=(True,) * len(oracles) + (False,) * len(trees),
        )
    opened = all_opened[: len(oracles)]
    proof = fri_proof(caps, opened, all_opened[len(oracles):], final_poly,
                      pow_witness)
    return openings, proof
