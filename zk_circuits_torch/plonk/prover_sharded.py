"""Sharded single-proof prover: ONE proof spanning a shard mesh.

Counterpart of the JAX package's plonk/prover_sharded.py, with every
cross-shard move written out (there is no partitioner):

- commits (wires, Z/partial products, constants/sigmas, quotient): the
  POLY axis is padded to a multiple of E and sharded; each shard runs its
  INTT+LDE locally (parallel/ntt_sharded.py::lde_batch_sharded); the
  poly->row re-shard is one block exchange (K2) of (E, E, B) blocks with
  B = (k_pad/E)*(8n/E), read in place from the column-major LDE; the zero
  padding is sliced off, and each shard's subtree is one K1 tree-mode
  call on its rows, read in place (hash/merkle.py::sharded_tree);
- quotient: the vanishing evaluation runs row-parallel on the 8n coset;
  the zs(g*x) operand is row i + 2^rate_bits, so each shard takes a
  2^rate_bits-row halo from the next shard (wrapping around), a plain
  copy; the coset INTT of length 8n is ``intt_sharded`` on the row-sharded
  vector (three K2 exchanges), leaving whole quotient chunks per shard for
  the poly-sharded commit;
- openings at zeta and g*zeta and the alpha-reduction run on each shard's
  own polynomials (K7 and K8's point kernel, one launch each a shard); the
  small (n, 2) partial sums are added on the first shard, which composes
  the FRI polynomial (K8's scan); the FRI commit chain is
  fri/fri_sharded.py; the PoW grind runs through K1 on the first shard;
  query rows and Merkle paths are gathered where they lie, every oracle
  and FRI tree in one K10 launch on the first shard's card
  (fri_device.gather_trees; on CPU shards its plain version,
  ``_take_sharded``).

The witness and the Fiat-Shamir challenger stay on the host, as in the
JAX package's sharded prover.  Proof bytes
equal :func:`zk_circuits_torch.plonk.prover.prove`'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..field.goldilocks import eadd
from ..fri import fri as frim
from ..fri.fri_device import (compose, fri_proof, gather_trees, openings, openings_set,
                              query_indices, reduce_alpha)
from ..fri.fri_sharded import commit_phase_sharded
from ..fri.oracle import _deterministic_salt_polys
from ..hash import merkle as merklem
from ..hash.challenger import Challenger
from ..host import gl, gle, poseidon as hposeidon
from ..iop.witness import generate_witness
from ..ntt import ntt as nttm
from ..parallel.mesh import Mesh, axis_mesh, gather, make_mesh, reshard, shard_last
from ..parallel.ntt_exchange import all_to_all_blocks
from ..parallel.ntt_sharded import intt_sharded, lde_batch_sharded
from . import quotient_cuda
from .proof import Proof, ProofWithPublicInputs


@dataclass
class ShardedBatch:
    """A committed polynomial batch spread over a mesh."""

    coeffs: list      # shard i: (k_pad/E, n) polys [i*k_pad/E, ...), zero pad last
    rows: list        # shard d: (num_polys, 8n/E) column-major LDE rows of d
    levels: list      # Merkle levels, each a list of per-shard (m, 4) tensors
    num_polys: int
    cap: np.ndarray

    def polys(self, lo: int, hi: int, device) -> torch.Tensor:
        """Coefficients of polynomials [lo, hi) on ``device``."""
        kps = self.coeffs[0].shape[0]
        return torch.cat([c[max(lo - j * kps, 0): min(hi - j * kps, kps)].to(device)
                          for j, c in enumerate(self.coeffs)
                          if j * kps < hi and (j + 1) * kps > lo])


def rows_from_polys(values: list, mesh: Mesh) -> list:
    """Poly-sharded LDE values (shard s: (k/E, L)) -> row-sharded (shard d:
    (k, L/E) column-major, rows [d*L/E, (d+1)*L/E)): one K2 exchange whose
    source blocks are the strided column ranges values_s[:, rows of d]."""
    e = mesh.size
    kps, lde = values[0].shape
    xs = [v.reshape(kps, e, lde // e).permute(1, 0, 2) for v in values]
    return [o.reshape(e * kps, lde // e) for o in all_to_all_blocks(xs)]


def commit_sharded(coeffs: list, num_polys: int, rate_bits: int,
                   cap_height: int, mesh: Mesh) -> ShardedBatch:
    """Commit poly-sharded coefficients (shard i: (k_pad/E, n), the real
    polynomials first): LDE per shard, re-shard to rows (K2), drop the
    padding, each shard's subtree over its rows (K1's tree mode)."""
    rows = rows_from_polys(lde_batch_sharded(coeffs, rate_bits, mesh), mesh)
    rows = [r[:num_polys] for r in rows]
    levels = merklem.sharded_tree([r.t() for r in rows], cap_height)
    cap = gfd.to_u64(gather(levels[-1], dim=0))
    return ShardedBatch(coeffs, rows, levels, num_polys, cap)


def _poly_shards(pieces: list, mesh: Mesh) -> tuple[list, int]:
    """(k_i, n) blocks in order -> the poly-sharded batch and its k."""
    k = sum(p.shape[0] for p in pieces)
    kps = -(-k // mesh.size)
    return reshard(pieces, kps * mesh.size, mesh, dim=0), k


def _commit_host_values(values: np.ndarray, blinding: bool, cfg, mesh: Mesh):
    """Host (k, n) values over H -> sharded commitment of their
    coefficients (+ the deterministic salt polynomials when blinding)."""
    k, n = values.shape
    pieces = [gfd.from_u64(values)]
    if blinding:
        pieces.append(gfd.from_u64(_deterministic_salt_polys(n, 4)))
    shards, total = _poly_shards(pieces, mesh)
    kps = shards[0].shape[0]
    coeffs = []
    for j, c in enumerate(shards):   # INTT the real polynomials, not the salts
        real = min(max(k - j * kps, 0), kps)
        coeffs.append(torch.cat([nttm.intt(c[:real]), c[real:]]) if real else c)
    return commit_sharded(coeffs, total, cfg.rate_bits, cfg.fri_config.cap_height, mesh)


def _commit_coeffs(pieces: list, cfg, mesh: Mesh) -> ShardedBatch:
    shards, k = _poly_shards(pieces, mesh)
    return commit_sharded(shards, k, cfg.rate_bits, cfg.fri_config.cap_height, mesh)


def _quotient_sharded(common, cs, wires, zsp, pi_hash, betas, gammas,
                      alphas, mesh: Mesh) -> ShardedBatch:
    """Row-parallel vanishing evaluation on the 8n coset, sharded coset
    INTT per challenge (K2), chunk split (+ salts), poly-sharded commit."""
    from .prover import _coset_tables, _device_vanishing_eval, _on

    cfg = common.config
    n, lde, e = common.degree, common.lde_size, mesh.size
    r = lde // e
    rate = 1 << cfg.rate_bits
    if r < rate:
        raise ValueError(f"{e} shards leave fewer than {rate} rows each")

    def col(vals, dev):
        return gfd.from_u64(np.asarray(vals, dtype=np.uint64).reshape(-1, 1), dev)

    nc = cfg.num_challenges
    vals = [[] for _ in range(nc)]
    for d, dev in enumerate(mesh.devices):
        tables = _coset_tables(common, dev)
        halo = zsp.rows[(d + 1) % e][:nc, :rate].to(dev)
        zsp_next = torch.cat([zsp.rows[d][:nc, rate:], halo], dim=1)
        pis = gfd.from_u64(pi_hash.reshape(1, 4), dev)
        chall = [col(v, dev) for v in (betas, gammas, alphas)]
        if _on(cs.rows[d]) == "cuda":   # K5 on the shard's rows, its halo beside them
            y = quotient_cuda.vanishing(common, cs.rows[d], wires.rows[d], zsp.rows[d],
                                        tables, pis, *chall, zs_next=zsp_next, row0=d * r)
        else:
            x, l1, zh_inv = (t[d * r:(d + 1) * r] for t in tables)
            vans = _device_vanishing_eval(
                common, cs.rows[d].t(), wires.rows[d].t(), zsp.rows[d].t(), x, l1, pis,
                *chall, zsp_next=zsp_next.t())
            y = gfd.mul(torch.stack(vans), zh_inv)
        for c in range(nc):
            vals[c].append(y[c])
    inv_shift = pow(gl.MULTIPLICATIVE_GROUP_GENERATOR, gl.P_INT - 2, gl.P_INT)
    q = common.quotient_degree_factor
    pieces = []
    for c in range(cfg.num_challenges):
        coeffs = [gfd.mul(y, nttm.powers(inv_shift, lde, y.device)[d * r:(d + 1) * r])
                  for d, y in enumerate(intt_sharded(vals[c], mesh))]
        if r % n == 0:   # whole chunks per shard
            chunks = [y.reshape(r // n, n) for y in coeffs]
        else:            # more shards than chunks: join them first
            chunks = [gather(coeffs).reshape(lde // n, n)]
        pieces += _first_rows(chunks, q)
    if cfg.zero_knowledge:
        pieces.append(gfd.from_u64(_deterministic_salt_polys(n, 4), mesh.first))
    return _commit_coeffs(pieces, cfg, mesh)


def _first_rows(blocks: list, k: int) -> list:
    """The leading blocks of a list of (k_i, n) blocks that hold its first
    k rows in all."""
    out, have = [], 0
    for b in blocks:
        if have >= k:
            break
        out.append(b[: k - have])
        have += out[-1].shape[0]
    return out


def _take_sharded(shards: list, idx: np.ndarray, colmajor: bool,
                  device) -> torch.Tensor:
    """Rows ``idx`` of a row-sharded matrix, each taken on the shard that
    owns it and assembled on ``device``: K10's plain version for sharded
    trees (``fri_device.gather_trees``' ``take``)."""
    per = shards[0].shape[1 if colmajor else 0]
    owner = idx // per
    parts, order = [], []
    for s, t in enumerate(shards):
        sel = np.nonzero(owner == s)[0]
        if len(sel):
            loc = torch.from_numpy(idx[sel] - s * per).to(t.device)
            parts.append((t[:, loc].t() if colmajor else t[loc]).to(device))
            order.append(sel)
    perm = np.argsort(np.concatenate(order), kind="stable")
    return torch.cat(parts)[torch.from_numpy(perm).to(device)]


def _open_and_fri_sharded(common, oracles: list, ch, mesh: Mesh) -> tuple:
    """Openings and FRI proof from sharded oracles (see the module doc)."""
    cfg = common.config
    fri_config = cfg.fri_config
    num_zs = cfg.num_challenges
    dev0 = mesh.first
    zeta = ch.get_extension_challenge()
    g_ext = np.array([gl.primitive_root_of_unity(common.degree_bits), 0],
                     dtype=np.uint64)
    zeta_next = gle.mul(zeta, g_ext)
    widths = tuple(o.num_polys for o in oracles)

    # openings: each shard evaluates its own polynomials at zeta, one call
    # over its piece of every oracle
    shard_evals = []
    for j in range(mesh.size):
        e0, e1 = openings([(o.coeffs[j], 0) for o in oracles], [zeta[None]])
        shard_evals.append((e0[0].to(dev0), e1[0].to(dev0)))
    ev0, ev1, off = [], [], 0
    for o in oracles:
        kps = o.coeffs[0].shape[0]
        for c, ev in enumerate((ev0, ev1)):
            ev.append(torch.cat([e[c][off:off + kps] for e in shard_evals])[:o.num_polys])
        off += kps
    zs2 = oracles[2].polys(0, num_zs, dev0)
    zn0, zn1 = openings([(zs2, 0)], [zeta_next[None]])
    oset = openings_set(gfd.to_ext(torch.cat(ev0), torch.cat(ev1)),
                        gfd.to_ext(zn0[0], zn1[0]), widths)
    ch.observe_extension_elements(oset.batch0_flat())
    ch.observe_extension_elements(oset.batch1_flat())
    alpha = ch.get_extension_challenge()

    # alpha-reduction per shard over its polynomials (the rows before its
    # zero padding, row r of the oracles in order taking alpha^r); partial
    # sums on dev0
    comp0 = None
    for j in range(mesh.size):
        pieces, off = [], 0
        for o in oracles:
            kps = o.coeffs[0].shape[0]
            real = min(max(o.num_polys - j * kps, 0), kps)
            if real:
                pieces.append((o.coeffs[j][:real], 0, off + j * kps))
            off += o.num_polys
        (part,) = reduce_alpha(pieces, alpha[None])
        part = tuple(t.to(dev0) for t in part)
        comp0 = part if comp0 is None else eadd(*comp0, *part)
    (comp1,) = reduce_alpha([(zs2, 0, 0)], alpha[None])
    f0, f1 = compose(comp0, comp1, zeta[None], zeta_next[None], alpha[None], num_zs)
    f0, f1 = f0[0], f1[0]

    caps, trees, _, p0, p1 = commit_phase_sharded(
        shard_last(f0, mesh), shard_last(f1, mesh), fri_config,
        common.degree_bits, ch, mesh)
    final_poly = gfd.to_ext(gather(p0), gather(p1))
    ch.observe_extension_elements(final_poly)
    pow_witness = frim.proof_of_work_grind(ch.get_hash(),
                                           fri_config.proof_of_work_bits, dev0)
    ch.observe_element(pow_witness)
    idx_arr, step_idx = query_indices(ch, fri_config, common.degree_bits)

    def take(shards, idx, colmajor):
        return _take_sharded(shards, idx, colmajor, dev0)

    all_opened = gather_trees(
        [(o.rows, o.levels) for o in oracles] + trees,
        [idx_arr] * len(oracles) + step_idx,
        colmajor=(True,) * len(oracles) + (False,) * len(trees), take=take)
    proof = fri_proof(caps, all_opened[: len(oracles)], all_opened[len(oracles):],
                      final_poly, pow_witness)
    return oset, proof


def prove_sharded(circuit_data, pw, mesh: Mesh | None = None, axis="x",
                  check_witness: bool | None = None) -> ProofWithPublicInputs:
    """Prove one witness with the pipeline sharded over ``mesh`` (default:
    ``make_mesh()``, every card; it raises without CUDA), a mesh of one
    process, split over ``axis`` (a name, or a tuple of names covering
    every axis of the mesh; anything else raises TypeError).  The
    arguments are the JAX package's, in its order.

    Byte-identical to :func:`zk_circuits_torch.plonk.prover.prove`."""
    from .prover import _resolve_check_witness, _zs_coeffs_body
    from .vanishing import check_constraints_on_h

    mesh = make_mesh() if mesh is None else mesh
    if mesh.spans_processes:
        raise ValueError("prove_sharded takes a mesh of one process")
    mesh = axis_mesh(mesh, axis)
    common = circuit_data.common
    po = circuit_data.prover_only
    cfg = common.config
    check_witness = _resolve_check_witness(check_witness)
    dev0 = mesh.first

    def col(vals):
        return gfd.from_u64(np.asarray(vals, dtype=np.uint64).reshape(-1, 1), dev0)

    # 1. witness (host)
    wires, public_inputs = generate_witness(circuit_data, pw)
    pi_hash = (hposeidon.hash_no_pad(public_inputs)
               if len(public_inputs) else np.zeros(4, np.uint64))
    if check_witness:
        check_constraints_on_h(common, po, wires, pi_hash)

    # 2. wire commit, poly-sharded INTT+LDE, row-sharded tree
    wires_commitment = _commit_host_values(np.ascontiguousarray(wires.T),
                                           cfg.zero_knowledge, cfg, mesh)
    ch = Challenger()
    ch.observe_hash(circuit_data.verifier_only.circuit_digest)
    ch.observe_hash(pi_hash)
    ch.observe_cap(wires_commitment.cap)
    betas = ch.get_n_challenges(cfg.num_challenges)
    gammas = ch.get_n_challenges(cfg.num_challenges)

    # 3. permutation argument on the first shard (a prefix product over the
    # whole subgroup), then a sharded commit
    zs_coeffs, zs_final = _zs_coeffs_body(
        common, po.sigmas_values, po.subgroup,
        wires_commitment.polys(0, cfg.num_routed_wires, dev0), col(betas), col(gammas))
    if check_witness and not np.all(gfd.to_u64(zs_final) == 1):
        raise ValueError("invalid witness: permutation argument does not close")
    zsp_commitment = _commit_coeffs([zs_coeffs], cfg, mesh)
    ch.observe_cap(zsp_commitment.cap)
    alphas = ch.get_n_challenges(cfg.num_challenges)

    # 4. constants/sigmas: a sharded commitment of the stored coefficients,
    # which reproduces the circuit's cap
    cs_commit = _commit_coeffs([po.constants_sigmas_commitment.coeffs_dev], cfg, mesh)
    if not np.array_equal(cs_commit.cap, circuit_data.verifier_only.constants_sigmas_cap):
        raise ValueError("sharded constants/sigmas cap differs from the circuit's")

    # 5. quotient: row-sharded vanishing eval, sharded INTT, commit
    quotient_commitment = _quotient_sharded(common, cs_commit, wires_commitment,
                                            zsp_commitment, pi_hash, betas,
                                            gammas, alphas, mesh)
    ch.observe_cap(quotient_commitment.cap)

    # 6. openings, FRI and PoW
    oracles = [cs_commit, wires_commitment, zsp_commitment, quotient_commitment]
    openings, opening_proof = _open_and_fri_sharded(common, oracles, ch, mesh)
    proof = Proof(
        wires_cap=wires_commitment.cap.copy(),
        zs_partial_products_cap=zsp_commitment.cap.copy(),
        quotient_cap=quotient_commitment.cap.copy(),
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputs(proof, public_inputs)
