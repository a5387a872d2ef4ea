"""The PLONK+FRI prover pipeline on torch tensors.

Torch counterpart of the device branch of the JAX package's
plonk/prover.py::prove: witness fill (host) -> wire INTT (+ salts) ->
LDE + Merkle commit -> Fiat-Shamir challenges -> permutation Z/partial
products -> fused quotient on the 8n coset -> openings at zeta / g*zeta ->
FRI opening proof with PoW grinding.  Every bulk stage runs on the chosen
device; the transcript and the witness generator stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..fri.fri_device import open_and_fri_device
from ..fri.oracle import PolynomialBatch, _deterministic_salt_polys, _device_commit_fn
from ..hash import merkle as merklem
from ..hash.challenger import Challenger
from ..host import gl, poseidon as hposeidon
from ..iop.witness import PartialWitness, generate_witness
from ..ntt import ntt as nttm
from . import algebra
from .proof import Proof, ProofWithPublicInputs
from .vanishing import VanishingVars, check_constraints_on_h, eval_vanishing


def _device_vanishing_eval(common, cs_lde, wires_lde, zsp_lde, x, l1,
                           pi_hash, betas, gammas, alphas, zsp_next=None):
    """Vanishing-polynomial evaluation over the 8n coset on row-major
    (rows, k) tensors.  ``zsp_next`` is zsp at g*x (the rows 2^rate_bits
    further on); by default zsp_lde holds the whole coset and is rolled."""
    alg = algebra.TorchBase(x.device)
    cfg = common.config
    s = common.num_selectors
    c = cfg.num_constants
    num_pp = common.num_partial_products

    if zsp_next is None:
        zsp_next = torch.roll(zsp_lde, -(1 << cfg.rate_bits), dims=0)
    vv = VanishingVars(
        x=x,
        wires=wires_lde,
        selectors=cs_lde[:, :s],
        constants=cs_lde[:, s : s + c],
        sigmas=cs_lde[:, s + c :],
        zs=[zsp_lde[:, i] for i in range(cfg.num_challenges)],
        zs_next=[zsp_next[:, i] for i in range(cfg.num_challenges)],
        partial_products=[
            zsp_lde[:, cfg.num_challenges + ch * num_pp : cfg.num_challenges + (ch + 1) * num_pp]
            for ch in range(cfg.num_challenges)
        ],
        l1=l1,
        pi_hash=pi_hash,
        betas=[betas[i] for i in range(cfg.num_challenges)],
        gammas=[gammas[i] for i in range(cfg.num_challenges)],
        alphas=[alphas[i] for i in range(cfg.num_challenges)],
    )
    return eval_vanishing(alg, common, vv)


def _salts(n: int, device) -> torch.Tensor:
    return gfd.from_u64(_deterministic_salt_polys(n, 4), device)


def _quotient_commit_body(common, blinding: bool, cs_vals, wires_vals,
                          zsp_vals, pi_hash, betas, gammas, alphas):
    """Fused quotient: vanishing eval over the 8n coset -> divide by Z_H ->
    coset INTT -> chunk split (+ salts) -> LDE -> Merkle levels.  Inputs
    are the commits' column-major (num_polys, 8n) LDE values."""
    cfg = common.config
    n = common.degree
    device = cs_vals.device
    x_c, l1_c, zh_inv_c = _coset_tables(common, device)
    vans = _device_vanishing_eval(common, cs_vals.t(), wires_vals.t(),
                                  zsp_vals.t(), x_c, l1_c, pi_hash, betas,
                                  gammas, alphas)
    chunks = []
    for c in range(cfg.num_challenges):
        qc = nttm.coset_intt(gfd.mul(vans[c], zh_inv_c))  # (8n,) coefficients
        for t in range(common.quotient_degree_factor):
            chunks.append(qc[t * n : (t + 1) * n])
    coeffs = torch.stack(chunks, dim=0)
    if blinding:
        coeffs = torch.cat([coeffs, _salts(n, device)], dim=0)
    values = nttm.lde(coeffs, cfg.rate_bits)
    levels = merklem.device_merkle_levels_values(values, cfg.fri_config.cap_height)
    return coeffs, values, levels


def _device_wires_coeffs_fn(values: torch.Tensor, blinding: bool) -> torch.Tensor:
    """values (num_polys, n) -> coefficients (+ deterministic salt polys
    when blinding)."""
    coeffs = nttm.intt(values)
    if blinding:
        coeffs = torch.cat([coeffs, _salts(values.shape[-1], values.device)], dim=0)
    return coeffs


def _zs_coeffs_body(common, sigmas_np, subgroup_np, wire_coeffs, betas, gammas):
    """Permutation argument: wire values on H (NTT of the committed
    coefficients) -> nums/dens -> chunk products -> exclusive prefix
    product -> partial products -> INTT (+ salts).  Returns the
    coefficients and each challenge's closing running product (1 for a
    valid witness)."""
    cfg = common.config
    n = common.degree
    q = common.quotient_degree_factor
    num_routed = cfg.num_routed_wires
    assert num_routed % q == 0
    num_chunks = num_routed // q
    num_pp = common.num_partial_products
    device = wire_coeffs.device

    sig = gfd.from_u64(sigmas_np, device)                       # (80, n)
    x = gfd.from_u64(subgroup_np, device)                       # (n,)
    k = gfd.from_u64(np.asarray(common.k_is, dtype=np.uint64), device)
    wvals = nttm.ntt(wire_coeffs[:num_routed])                  # (80, n)
    kx = gfd.mul(k[:, None], x[None, :])                        # (80, n)
    polys, pps_all, finals = [], [], []
    for c in range(cfg.num_challenges):
        beta, gamma = betas[c], gammas[c]
        nums = gfd.add(wvals, gfd.add(gfd.mul(kx, beta), gamma))
        dens = gfd.add(wvals, gfd.add(gfd.mul(sig, beta), gamma))
        nums = nums.reshape(num_chunks, q, n)
        dens = dens.reshape(num_chunks, q, n)
        cn, cd = nums[:, 0], dens[:, 0]
        for j in range(1, q):
            cn = gfd.mul(cn, nums[:, j])
            cd = gfd.mul(cd, dens[:, j])
        ratios = gfd.mul(cn, gfd.inverse(cd))                   # (num_chunks, n)
        total = ratios[0]
        for t in range(1, num_chunks):
            total = gfd.mul(total, ratios[t])
        s = gfd.prefix_prod(total)                              # inclusive (n,)
        finals.append(s[-1:])
        z = torch.cat([torch.ones_like(s[:1]), s[:-1]])
        polys.append(z)
        p = z
        for t in range(num_pp):
            p = gfd.mul(p, ratios[t])
            pps_all.append(p)
    values = torch.stack(polys + pps_all, dim=0)                # (nc + nc*pp, n)
    coeffs = nttm.intt(values)
    if cfg.zero_knowledge:
        coeffs = torch.cat([coeffs, _salts(n, device)], dim=0)
    return coeffs, torch.cat(finals)


def coset_domain_columns(common):
    """x values, L1(x), and 1/Z_H(x) over the 8n coset (host precompute)."""
    n = common.degree
    lde_size = common.lde_size
    g = gl.MULTIPLICATIVE_GROUP_GENERATOR
    x = gl.mul(
        np.uint64(g),
        gl.powers(gl.primitive_root_of_unity(common.degree_bits + common.config.rate_bits), lde_size),
    )
    # Z_H(x) = x^n - 1 is 8-periodic on the coset: x^n = g^n * w_8^i.
    rate = 1 << common.config.rate_bits
    gn = pow(g, n, gl.P_INT)
    w8 = gl.primitive_root_of_unity(common.config.rate_bits)
    zh_short = np.array(
        [(gn * pow(w8, i, gl.P_INT) - 1) % gl.P_INT for i in range(rate)], dtype=np.uint64
    )
    zh = np.tile(zh_short, lde_size // rate)
    zh_inv = np.tile(gl.inverse(zh_short), lde_size // rate)
    # L1(x) = (x^n - 1) / (n * (x - 1))
    denom = gl.mul(np.uint64(n), gl.sub(x, np.uint64(1)))
    l1 = gl.mul(zh, gl.inverse(denom))
    return x, l1, zh_inv


_COSET_TABLES: dict = {}


def _coset_tables(common, device):
    """coset_domain_columns as tensors on ``device``; they depend only on
    the degree and the rate, so they are computed once per shape."""
    key = (common.degree_bits, common.config.rate_bits, str(device))
    if key not in _COSET_TABLES:
        _COSET_TABLES[key] = tuple(gfd.from_u64(a, device)
                                   for a in coset_domain_columns(common))
    return _COSET_TABLES[key]


def _resolve_check_witness(check_witness: bool | None) -> bool:
    """Witness re-checking (every gate constraint re-evaluated on H on host)
    is a debugging aid: pass check_witness=True or set ZKT_CHECK_WITNESS=1."""
    import os

    if check_witness is None:
        return bool(os.environ.get("ZKT_CHECK_WITNESS"))
    return check_witness


def _commit(coeffs: torch.Tensor, cfg) -> PolynomialBatch:
    values, levels = _device_commit_fn(coeffs, cfg.rate_bits,
                                       cfg.fri_config.cap_height)
    return PolynomialBatch(None, cfg.rate_bits, cfg.zero_knowledge,
                           cfg.fri_config.cap_height, levels_dev=levels,
                           coeffs_dev=coeffs, values_dev=values)


def prove(circuit_data, pw: PartialWitness, check_witness: bool | None = None,
          device="cuda") -> ProofWithPublicInputs:
    """Prove ``pw`` against ``circuit_data`` with every bulk stage on
    ``device`` ("cuda" by default; "cpu" runs the plain torch versions)."""
    import time as _time

    from .. import resolve_device
    from ..utils import profiling

    device = resolve_device(device)
    check_witness = _resolve_check_witness(check_witness)
    _dbg = profiling.timing_enabled()
    _t0 = _time.perf_counter()

    def _mark(stage: str):
        nonlocal _t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = _time.perf_counter()
        profiling._TIMINGS[f"prove/{stage}"].append(now - _t0)
        if _dbg:
            print(f"[prove] {stage}: {now - _t0:.2f}s", flush=True)
        _t0 = now

    common = circuit_data.common
    po = circuit_data.prover_only
    cfg = common.config
    cap_h = cfg.fri_config.cap_height

    def col(vals):
        return gfd.from_u64(np.asarray(vals, dtype=np.uint64).reshape(-1, 1), device)

    # 1. witness (host)
    wires, public_inputs = generate_witness(circuit_data, pw)
    pi_hash = (hposeidon.hash_no_pad(public_inputs)
               if len(public_inputs) else np.zeros(4, np.uint64))
    if check_witness:
        check_constraints_on_h(common, po, wires, pi_hash)
    _mark("witness+check")

    # 2. commit wires
    wires_t = gfd.from_u64(np.ascontiguousarray(wires.T), device)
    wires_commitment = _commit(
        _device_wires_coeffs_fn(wires_t, cfg.zero_knowledge), cfg)

    # 3. challenges: betas, gammas
    ch = Challenger()
    ch.observe_hash(circuit_data.verifier_only.circuit_digest)
    ch.observe_hash(pi_hash)
    ch.observe_cap(wires_commitment.cap)
    betas = ch.get_n_challenges(cfg.num_challenges)
    _mark("wires commit+challenges")
    gammas = ch.get_n_challenges(cfg.num_challenges)

    # 4. permutation polynomials
    zs_coeffs, zs_final = _zs_coeffs_body(
        common, po.sigmas_values, po.subgroup, wires_commitment.coeffs_dev,
        col(betas), col(gammas))
    if check_witness:
        # The running product over the whole subgroup must close to 1, else
        # the witness violates a copy constraint.
        final = gfd.to_u64(zs_final)
        if not np.all(final == 1):
            raise ValueError(
                "invalid witness: permutation argument does not close "
                f"(final running products {final.tolist()} != 1)")
    zsp_commitment = _commit(zs_coeffs, cfg)
    ch.observe_cap(zsp_commitment.cap)
    _mark("zs+partial products commit")
    alphas = ch.get_n_challenges(cfg.num_challenges)

    # 5. quotient on the 8n coset
    cs_commit = po.constants_sigmas_commitment.ensure_device(device)
    q_coeffs, q_vals, q_levels = _quotient_commit_body(
        common, cfg.zero_knowledge,
        cs_commit.values_for_eval(),
        wires_commitment.values_for_eval(),
        zsp_commitment.values_for_eval(),
        gfd.from_u64(pi_hash.reshape(1, 4), device),
        col(betas), col(gammas), col(alphas))
    quotient_commitment = PolynomialBatch(
        None, cfg.rate_bits, cfg.zero_knowledge, cap_h,
        levels_dev=q_levels, coeffs_dev=q_coeffs, values_dev=q_vals)
    ch.observe_cap(quotient_commitment.cap)
    _mark("quotient eval+commit (fused)")

    # 6. openings, FRI and PoW
    oracles = [cs_commit, wires_commitment, zsp_commitment, quotient_commitment]
    openings, opening_proof = open_and_fri_device(common, oracles, ch, device)
    _mark("openings+fri (device)")

    proof = Proof(
        wires_cap=wires_commitment.cap.copy(),
        zs_partial_products_cap=zsp_commitment.cap.copy(),
        quotient_cap=quotient_commitment.cap.copy(),
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputs(proof, public_inputs)
