"""Tensor-resident FRI opening proof + opening evaluations.

Torch counterpart of the JAX package's fri/fri_device.py, for a batch of
proofs of one circuit, one proof being the batch of one
(``open_and_fri_device_batch``: every tensor but the circuit's
constants/sigmas oracle carries a leading proof axis, and each transcript
stage fetches the whole batch's caps or evaluations in one transfer):

- openings: every oracle polynomial evaluated at zeta / g*zeta
  (``openings``: K7 on the card, which computes the powers itself);
- composition: the alpha-reduced FRI quotient (batch 0 at zeta, batch 1 at
  g*zeta; ``reduce_alpha``: K8's point kernel) with the divide-by-linear
  (``compose``: K8's scan), then the round-0 codeword's coset NTT straight
  into its fiber leaves (``_commit_codeword``: K4's leaf mode) and Merkle
  commit;
- fold rounds: coefficient-space fold (new_c[m] = sum_j beta^j c[A*m+j]),
  the next codeword's coset NTT and its fiber leaves (``fold_round``: K9's
  round mode, one launch), then the Merkle commit; the last round's fold
  alone (``fold``: K9's fold mode);
- query phase: every oracle and every commit-phase tree gathered on the
  device (``gather_trees_batch``: K10, one launch) and fetched in one
  transfer.

On a CUDA tensor the field arithmetic takes the kernels of ``fri_cuda``,
the round-0 codeword K4's leaf mode (``ntt_cuda.coset_leaves``) and the
query gather K10 (``gather_cuda``); on a CPU tensor their plain versions
(``_openings_plain``, ``_reduce_alpha_plain``, ``_compose_plain``,
``_fold_plain``, ``_fold_round_plain``, ``_commit_codeword_plain``,
``_gather_plain``); any other device raises.

The Fiat-Shamir challenger stays on the host; only caps, the final
polynomial and query rows leave the device.  Extension elements travel as
pairs of base tensors (components of GF(p^2) = GF(p)[x]/(x^2 - 7)).
"""

from __future__ import annotations

import math

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
    """sum_i alpha^i * P_i: (..., k, n) base polys x (..., k) ext powers ->
    (..., n) ext."""
    w0 = gfd.mul(batch, ap0[..., None])
    w1 = gfd.mul(batch, ap1[..., None])
    return gfd.sum_mod(w0, axis=-2), gfd.sum_mod(w1, axis=-2)


def _suffix_sum(s0, s1):
    """s_i <- sum_{j>=i} s_j via log-step doubling (fri.divide_by_linear),
    along the last axis."""
    n = s0.shape[-1]
    shift = 1
    while shift < n:
        h0, h1 = _eadd(s0[..., :-shift], s1[..., :-shift], s0[..., shift:], s1[..., shift:])
        s0 = torch.cat([h0, s0[..., -shift:]], dim=-1)
        s1 = torch.cat([h1, s1[..., -shift:]], dim=-1)
        shift *= 2
    return s0, s1


def _ddl(c0, c1, zp0, zp1, zi0, zi1):
    """(P(X) - P(z)) / (X - z) in coefficient space:
    q_i = zinv^(i+1) * sum_{j>=i+1} c_j z^j."""
    w0, w1 = _emul(c0, c1, zp0, zp1)
    s0, s1 = _suffix_sum(w0, w1)
    return _emul(s0[..., 1:], s1[..., 1:], zi0[..., 1:], zi1[..., 1:])


def _ext_coset_ntt_dev(c0, c1, shift: int, out_size: int):
    """Evaluate an ext-coeff pair on the coset shift*<w_N>: each component
    zero-padded to ``out_size`` and coset-transformed in one call."""
    v = nttm.coset_ntt(torch.stack([c0, c1]), shift, out_size)
    return v[0], v[1]


def _fiber_leaves(v0, v1, arity: int) -> torch.Tensor:
    """Codeword (..., N) pair -> (..., m, arity*2) leaf rows, fiber-grouped
    with interleaved ext components: leaf j holds [v(0,j), v(1,j), ...]
    where v(k, j) = v[k*m + j]."""
    *lead, size = v0.shape
    m = size // arity
    g0 = v0.reshape(*lead, arity, m).transpose(-1, -2)
    g1 = v1.reshape(*lead, arity, m).transpose(-1, -2)
    return torch.stack([g0, g1], dim=-1).reshape(*lead, m, arity * 2)


def _fold_plain(c0, c1, b0, b1, arity_bits: int):
    """K9's plain version: new_c[m] = sum_j beta^j c[A*m + j] (Horner over
    j); c (..., N) with one beta (...) per leading index."""
    arity = 1 << arity_bits
    *lead, size = c0.shape
    m = size // arity
    r0 = c0.reshape(*lead, m, arity)
    r1 = c1.reshape(*lead, m, arity)
    b0, b1 = b0.reshape(*lead, 1), b1.reshape(*lead, 1)
    acc0, acc1 = r0[..., arity - 1], r1[..., arity - 1]
    for j in range(arity - 2, -1, -1):
        acc0, acc1 = _emul(acc0, acc1, b0, b1)
        acc0, acc1 = _eadd(acc0, acc1, r0[..., j], r1[..., j])
    return acc0, acc1


def _fold_round_plain(c0, c1, b0, b1, arity_bits: int, next_bits: int, rate_bits: int,
                      shift: int):
    """K9's round mode's plain version: the fold, the next codeword's coset
    NTT (``shift``, 2^rate_bits times the folded length; the NTT's stage
    loop, on any device) and its fiber leaves of arity 2^next_bits;
    returns (f0, f1, leaves)."""
    f0, f1 = _fold_plain(c0, c1, b0, b1, arity_bits)
    v = nttm.coset_ntt_plain(torch.stack([f0, f1]), shift, f0.shape[-1] << rate_bits)
    return f0, f1, _fiber_leaves(v[0], v[1], 1 << next_bits)


def _over_batch(x, batch: int):
    """A set of rows as (B, k, n): a (k, n) set is shared by the batch."""
    return x.expand(batch, *x.shape) if x.dim() == 2 else x


def _host_points(pts: torch.Tensor) -> list:
    """A (T, 2, B) points tensor -> T host (B, 2) ext arrays."""
    return [np.ascontiguousarray(p.T) for p in gfd.to_u64(pts)]


def _power_tables(z: np.ndarray, n: int, device) -> tuple:
    """The (B, n) powers of each point of ``z`` (B, 2) as a device pair."""
    return gfd.ext_pair(ext_powers_each(z, n), device)


def _openings_plain(sets: list, pts: torch.Tensor):
    """K7's plain version (``fri_cuda.openings``): e (B, R) as a component
    pair, every row of the sets (each ``(rows, table, ...)``, in order)
    evaluated at its table's point of ``pts`` (T, 2, B), through
    host-computed power tables."""
    n, batch = sets[0][0].shape[-1], pts.shape[-1]
    tables = [_power_tables(z, n, pts.device) for z in _host_points(pts)]
    e0, e1 = [], []
    for x, t, *_ in sets:
        x = _over_batch(x, batch)
        p0, p1 = tables[t]
        e0.append(gfd.sum_mod(gfd.mul(x, p0[:, None, :]), axis=-1))
        e1.append(gfd.sum_mod(gfd.mul(x, p1[:, None, :]), axis=-1))
    return torch.cat(e0, dim=-1), torch.cat(e1, dim=-1)


def _reduce_alpha_plain(sets: list, alpha: torch.Tensor) -> list:
    """K8's point kernel's plain version (``fri_cuda.reduce_alpha``): per
    table t of the sets (each ``(rows, table, exp)``), the sum of its rows
    times their powers of alpha (row j of a set: exp + j; ``alpha`` (1, 2,
    B)), through a host-computed power table; (B, n) pairs."""
    (a,) = _host_points(alpha)
    npow = max(x.shape[-2] + e for x, _, e in sets)
    ap0, ap1 = _power_tables(a, npow, alpha.device)
    out = {}
    for x, t, e in sets:
        x = _over_batch(x, alpha.shape[-1])
        k = x.shape[-2]
        part = _reduce_alpha(x, ap0[:, e:e + k], ap1[:, e:e + k])
        out[t] = part if t not in out else _eadd(*out[t], *part)
    return [out[t] for t in range(len(out))]


def _compose_plain(comp0, comp1, pts: torch.Tensor):
    """K8's scan's plain version (``fri_cuda.compose``): from (B, n) pairs
    and each proof's zeta, g*zeta and s (``pts``, (3, 2, B)),
    final[:n-1] = q1 + s * q0 and final[n-1] = 0, with q0 and q1 the
    divisions of comp0 by (X - zeta) and comp1 by (X - g*zeta), through
    host-computed power tables."""
    n = comp0[0].shape[-1]
    zeta, zeta_next, _ = _host_points(pts)
    q0 = _ddl(*comp0, *_power_tables(zeta, n, pts.device),
              *_power_tables(gle.inverse(zeta), n, pts.device))
    q1 = _ddl(*comp1, *_power_tables(zeta_next, n, pts.device),
              *_power_tables(gle.inverse(zeta_next), n, pts.device))
    sq = _emul(*q0, pts[2, 0][:, None], pts[2, 1][:, None])
    return tuple(torch.nn.functional.pad(v, (0, 1)) for v in _eadd(*q1, *sq))


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (their
    plain versions); any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"FRI runs on CUDA or CPU tensors, got {t.device}")
    return False


def _points(points: list, device) -> torch.Tensor:
    """Host (B, 2) ext arrays, one a point, -> the (T, 2, B) tensor the
    kernels take, in one upload."""
    return gfd.from_u64(np.stack([np.asarray(z, dtype=np.uint64).T for z in points]), device)


def openings(sets: list, points: list):
    """e (B, R) as a component pair: every row of ``sets`` (each ``(rows,
    table)``: a (k, n) set shared by the batch or (B, k, n), in order)
    evaluated at ``points[table]``, each proof's point as a host (B, 2)
    array."""
    device = sets[0][0].device
    return _openings_plain(sets, _points(points, device))


def reduce_alpha(sets: list, alpha) -> list:
    """Per table of ``sets`` (each ``(rows, table, exp)``), the sum of its
    rows times their powers of alpha (row j of a set: exp + j), each
    proof's alpha a host (B, 2) array: a list of (B, n) pairs."""
    return _reduce_alpha_plain(sets, _points([alpha], sets[0][0].device))


def fold(c0, c1, beta, arity_bits: int):
    """new_c[m] = sum_j beta^j c[A*m + j]; c (N,) or (B, N) with each
    proof's beta on the host ((2,) or (B, 2))."""
    return _fold_plain(c0, c1, *gfd.ext_pair(beta, c0.device), arity_bits)


def fold_round(c0, c1, beta, arity_bits: int, next_bits: int, rate_bits: int, shift: int):
    """One fold round but the last: (f0, f1, leaves) with f the fold of c
    (B, N) by each proof's host beta (B, 2) and leaves the fiber rows of
    arity 2^next_bits of f's coset NTT on shift * <w> at 2^rate_bits times
    its length."""
    return _fold_round_plain(c0, c1, *gfd.ext_pair(beta, c0.device), arity_bits, next_bits,
                             rate_bits, shift)


def _commit_codeword_plain(f0, f1, shift: int, size: int, arity_bits: int):
    """K4's leaf mode's plain version: the coset NTT of both components
    (``_ext_coset_ntt_dev``), then the fiber regroup (``_fiber_leaves``)."""
    v0, v1 = _ext_coset_ntt_dev(f0, f1, shift, size)
    return _fiber_leaves(v0, v1, 1 << arity_bits)


def _commit_codeword(f0, f1, shift: int, size: int, arity_bits: int):
    """The fiber leaves (B, size / A, 2 A) of an ext coefficient pair's
    coset NTT at ``size`` points: on the card one K4 call in its leaf mode,
    which reads both components in place and stores each value at its
    leaf slot."""
    return _commit_codeword_plain(f0, f1, shift, size, arity_bits)


def take_rows_batch(x: torch.Tensor, idx: np.ndarray, colmajor: bool) -> torch.Tensor:
    """Rows ``idx[b]`` (B, Q) of each matrix b of a (B, N, w) row-major or
    (B, w, N) column-major batch, as (B * Q, w)."""
    i = torch.from_numpy(idx).to(x.device)
    b = torch.arange(i.shape[0], device=x.device)[:, None]
    rows = x[b, :, i] if colmajor else x[b, i]
    return rows.reshape(-1, rows.shape[-1])


def _take_all(trees: list, idxs: list, colmajor, take) -> tuple:
    """Each tree's rows, then its sibling digests level by level below the
    cap, each through ``take(leaves_or_level, idx, colmajor)``, as one
    flat tensor; and each tree's row width."""
    chunks, widths = [], []
    for (leaves, levels), idx, cm in zip(trees, idxs, colmajor):
        i = np.asarray(idx, dtype=np.int64)
        rows = take(leaves, i, cm)
        chunks.append(rows.reshape(-1))
        widths.append(rows.shape[-1])
        for lv in levels[:-1]:
            chunks.append(take(lv, i ^ 1, False).reshape(-1))
            i = i >> 1
    return torch.cat(chunks), widths


def _split(flat: np.ndarray, trees: list, idxs: list, widths: list) -> list:
    """The fetched words per tree: (rows (*idx.shape, w), sibs (*idx.shape,
    L, 4))."""
    out, pos = [], 0
    for (_, levels), idx, w in zip(trees, idxs, widths):
        shape, nlev = np.shape(idx), len(levels) - 1
        q = math.prod(shape)
        rows = flat[pos : pos + q * w].reshape(*shape, w)
        pos += q * w
        sibs = flat[pos : pos + nlev * q * 4].reshape(nlev, *shape, 4)
        pos += nlev * q * 4
        axes = (*range(1, len(shape) + 1), 0, len(shape) + 1)   # level axis before the digest
        out.append((rows, np.ascontiguousarray(sibs.transpose(axes))))
    assert pos == flat.shape[0]
    return out


def _gather_plain(trees: list, idxs: list, shared: list, colmajor: list) -> torch.Tensor:
    """K10's plain version (``gather_cuda.gather``): every tree's rows and
    sibling digests as one flat tensor, a take a leaf matrix and a level
    (``take_rows_batch``), a shared tree expanded over the batch (no
    copy)."""
    B = idxs[0].shape[0]

    def over_batch(tree, sh):
        leaves, levels = tree
        if not sh:
            return tree
        return leaves.expand(B, *leaves.shape), [lv.expand(B, *lv.shape) for lv in levels]

    return _take_all([over_batch(t, sh) for t, sh in zip(trees, shared)], idxs, colmajor,
                     take_rows_batch)[0]


def gather_trees_batch(trees: list, idxs: list, shared: list, colmajor: list) -> list:
    """``gather_trees`` for a batch of proofs: trees (leaves, levels) carry a
    leading proof axis B unless ``shared`` (the circuit's constants/sigmas
    oracle, one tree for every proof); idxs are (B, Q) per tree.  Every
    proof's rows and paths are gathered on the device (on the card by one
    K10 launch) and come back in ONE transfer.  Returns per tree (rows u64
    (B, Q, w), sibs u64 (B, Q, L, 4))."""
    idxs = [np.asarray(i, dtype=np.int64) for i in idxs]
    body = _gather_plain
    widths = [lf.shape[-2] if cm else lf.shape[-1] for (lf, _), cm in zip(trees, colmajor)]
    return _split(gfd.to_u64(body(trees, idxs, shared, colmajor)), trees, idxs, widths)


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


def ext_powers_each(z: np.ndarray, n: int) -> np.ndarray:
    """ext_powers of one ext element (2,) -> (n, 2), or of each of a batch
    (B, 2) -> (B, n, 2)."""
    z = np.asarray(z, dtype=np.uint64)
    return ext_powers(z, n) if z.ndim == 1 else np.stack([ext_powers(e, n) for e in z])


def compose(comp0, comp1, zeta, zeta_next, alpha, num_zs: int):
    """The FRI polynomial of B proofs from the alpha-reduced batches: comp0
    (all polynomials, opened at zeta) and comp1 (the Z polynomials, at
    g*zeta), each a (B, n) ext pair; zeta, zeta_next and alpha (B, 2) on
    the host.  final[:n-1] = q1 + alpha^num_zs * q0, final[n-1] = 0."""
    pts = _points([zeta, zeta_next, gle.powmod(alpha, num_zs)], comp0[0].device)
    body = _compose_plain
    return body(comp0, comp1, pts)


def commit_phase(f0, f1, fri_config, degree_bits: int, chs: list):
    """The FRI commit chain on one device for B proofs, from their (B, n)
    ext coefficient pair f and one Challenger a proof: the round-0 codeword
    (K4's leaf mode: its coset NTT as fiber leaves), then per fold round
    commit the B fiber trees at once, fetch their caps in one transfer,
    observe each proof's cap, draw its beta, and fold: with the next
    codeword's leaves in one K9 round launch where a round follows and
    ``round_fits`` holds on the card, else the fold alone and, where a
    round follows, K4's leaf mode.  Returns (caps, trees, betas, final f0,
    final f1): per round the caps (B, m, 4), the trees' (leaves, levels)
    and the betas (B, 2)."""
    size = f0.shape[-1] << fri_config.rate_bits
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    arities = fri_config.reduction_arities(degree_bits)
    caps, trees, betas = [], [], []
    leaves = _commit_codeword(f0, f1, shift, size, arities[0]) if arities else None
    for r, a_bits in enumerate(arities):
        levels = merklem.device_merkle_levels(leaves, fri_config.cap_height)
        cap = gfd.to_u64(levels[-1])
        caps.append(cap)
        trees.append((leaves, levels))
        beta = []
        for ch, proof_cap in zip(chs, cap):
            ch.observe_cap(proof_cap)
            beta.append(ch.get_extension_challenge())
        beta = np.stack(beta)
        betas.append(beta)
        shift = pow(shift, 1 << a_bits, gl.P_INT)
        size >>= a_bits
        if r + 1 == len(arities):
            f0, f1 = fold(f0, f1, beta, a_bits)
        elif not _on_card(f0):
            f0, f1, leaves = fold_round(f0, f1, beta, a_bits, arities[r + 1],
                                        fri_config.rate_bits, shift)
        else:
            f0, f1 = fold(f0, f1, beta, a_bits)
            leaves = _commit_codeword(f0, f1, shift, size, arities[r + 1])
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


# ---------------------------------------------------------------------------
# a batch of proofs of one circuit (plonk/prover_batch.py)
# ---------------------------------------------------------------------------


class BatchedCommit:
    """B same-shape polynomial batches committed on one device: coeffs
    (B, k, n), values (B, k, 8n) -- column-major leaves, leaf row i of
    proof b = values[b, :, i] -- and levels, each (B, m, 4).  The batch's
    PolynomialBatch."""

    __slots__ = ("coeffs", "values", "levels")

    def __init__(self, coeffs, values, levels):
        self.coeffs = coeffs
        self.values = values
        self.levels = list(levels)


def open_and_fri_device_batch(common, cs_oracle, commits: list, chs: list,
                              tag: str) -> list:
    """Openings and FRI proofs of B proofs at once: returns one
    (OpeningSet, FriProof) a proof, in batch order, each equal to the
    proof's alone.

    ``cs_oracle``: the circuit's constants/sigmas PolynomialBatch on the
    device (shared by every proof); ``commits``: the [wires, zs, quotient]
    BatchedCommits; ``chs``: one Challenger a proof, each just after
    observing its quotient cap.  Every device stage runs over the proof
    axis and every transcript stage is one packed fetch.  ``tag`` ends the
    stage timers' names."""
    from ..utils.fetch import fetch_packed
    from ..utils.profiling import stage_timer

    cfg = common.config
    fri_config = cfg.fri_config
    num_zs = cfg.num_challenges
    B = len(chs)
    g_ext = np.array([gl.primitive_root_of_unity(common.degree_bits), 0],
                     dtype=np.uint64)
    zetas = np.stack([ch.get_extension_challenge() for ch in chs])    # (B, 2)
    zetas_next = gle.mul(zetas, g_ext)

    sets = [cs_oracle.coeffs_dev] + [c.coeffs for c in commits]   # (k, n), (B, k_i, n)
    widths = tuple(s.shape[-2] for s in sets)
    k = sum(widths)
    # every oracle row at zeta (table 0; row r of them takes alpha^r), then
    # the Z rows at g*zeta (table 1; alpha^0, ...)
    first = np.cumsum((0,) + widths[:-1])
    rows = [(s, 0, int(e)) for s, e in zip(sets, first)] + [(sets[2][:, :num_zs], 1, 0)]

    with stage_timer(f"fri/openings_eval{tag}"):
        ev0, ev1 = fetch_packed(openings(rows, [zetas, zetas_next]))  # (B, K + num_zs)
    e0, e1, zn0, zn1 = ev0[:, :k], ev1[:, :k], ev0[:, k:], ev1[:, k:]
    openings_l, alphas = [], []
    for b, ch in enumerate(chs):
        oset = openings_set(np.stack([e0[b], e1[b]], axis=-1),
                            np.stack([zn0[b], zn1[b]], axis=-1), widths)
        openings_l.append(oset)
        ch.observe_extension_elements(oset.batch0_flat())
        ch.observe_extension_elements(oset.batch1_flat())
        alphas.append(ch.get_extension_challenge())
    alphas = np.stack(alphas)

    with stage_timer(f"fri/compose_r0{tag}"):
        comp0, comp1 = reduce_alpha(rows, alphas)
        f0, f1 = compose(comp0, comp1, zetas, zetas_next, alphas, num_zs)

    with stage_timer(f"fri/commit_phase{tag}"):
        caps, trees, _, f0, f1 = commit_phase(f0, f1, fri_config,
                                              common.degree_bits, chs)

    fp0, fp1 = fetch_packed([f0, f1])
    final_polys = np.stack([fp0, fp1], axis=-1)                       # (B, len, 2)
    pow_bases = []
    for b, ch in enumerate(chs):
        ch.observe_extension_elements(final_polys[b])
        pow_bases.append(ch.get_hash())

    with stage_timer(f"fri/pow_grind{tag}"):
        pow_witnesses = frim.proof_of_work_grind_batch(
            np.stack(pow_bases), fri_config.proof_of_work_bits, cs_oracle.device)

    drawn = []
    for ch, w in zip(chs, pow_witnesses):
        ch.observe_element(w)
        drawn.append(query_indices(ch, fri_config, common.degree_bits))
    idx_arr = np.stack([d[0] for d in drawn])                         # (B, Q)
    step_idx = [np.stack(s) for s in zip(*(d[1] for d in drawn))]

    # --- query gathers: one transfer for every proof's oracles and trees ---
    oracles = [(cs_oracle.values_dev, cs_oracle.levels_dev)] + [
        (c.values, c.levels) for c in commits]
    with stage_timer(f"fri/query_gather{tag}"):
        all_opened = gather_trees_batch(
            oracles + trees, [idx_arr] * len(oracles) + step_idx,
            shared=[True] + [False] * (len(commits) + len(trees)),
            colmajor=[True] * len(oracles) + [False] * len(trees))
    out = []
    for b in range(B):
        opened = [(rows[b], sibs[b]) for rows, sibs in all_opened]
        proof = fri_proof([c[b] for c in caps], opened[: len(oracles)],
                          opened[len(oracles):], final_polys[b], pow_witnesses[b])
        out.append((openings_l[b], proof))
    return out
