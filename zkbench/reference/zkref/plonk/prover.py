"""The PLONK+FRI prover pipeline on torch tensors.

Torch counterpart of the device branch of the JAX package's
plonk/prover.py::prove: witness (device) -> wire INTT (+ salts) ->
LDE + Merkle commit -> Fiat-Shamir challenges -> permutation Z/partial
products -> fused quotient on the 8n coset -> openings at zeta / g*zeta ->
FRI opening proof with PoW grinding.  Every bulk stage runs on the chosen
device; the transcript stays on the host.

This module holds the stage bodies, each over optional leading proof
axes, and the entry points; the one orchestration of the stages, for one
proof or a batch, is plonk/prover_batch.py::prove_batch_device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..fri.oracle import _deterministic_salt_polys
from ..hash import merkle as merklem
from ..host import gl
from ..iop.witness import PartialWitness
from ..ntt import ntt as nttm
from . import algebra
from .proof import ProofWithPublicInputs
from .vanishing import VanishingVars, eval_vanishing


def _device_vanishing_eval(common, cs_lde, wires_lde, zsp_lde, x, l1,
                           pi_hash, betas, gammas, alphas, zsp_next=None):
    """Vanishing-polynomial evaluation over the 8n coset on row-major
    (rows, k) tensors.  ``zsp_next`` is zsp at g*x (the rows 2^rate_bits
    further on); by default zsp_lde holds the whole coset and is rolled.

    For a batch of proofs, wires_lde and zsp_lde are (B, rows, k), pi_hash
    (B, 1, 4) and the challenges (num_challenges, B, 1); cs_lde and the
    coset columns are the circuit's, shared by every proof."""
    alg = algebra.TorchBase(x.device)
    cfg = common.config
    s = common.num_selectors
    c = cfg.num_constants
    num_pp = common.num_partial_products

    if zsp_next is None:
        zsp_next = torch.roll(zsp_lde, -(1 << cfg.rate_bits), dims=-2)
    vv = VanishingVars(
        x=x,
        wires=wires_lde,
        selectors=cs_lde[..., :s],
        constants=cs_lde[..., s : s + c],
        sigmas=cs_lde[..., s + c :],
        zs=[zsp_lde[..., i] for i in range(cfg.num_challenges)],
        zs_next=[zsp_next[..., i] for i in range(cfg.num_challenges)],
        partial_products=[
            zsp_lde[..., cfg.num_challenges + ch * num_pp : cfg.num_challenges + (ch + 1) * num_pp]
            for ch in range(cfg.num_challenges)
        ],
        l1=l1,
        pi_hash=pi_hash,
        betas=[betas[i] for i in range(cfg.num_challenges)],
        gammas=[gammas[i] for i in range(cfg.num_challenges)],
        alphas=[alphas[i] for i in range(cfg.num_challenges)],
    )
    return eval_vanishing(alg, common, vv)


def _with_salts(coeffs: torch.Tensor) -> torch.Tensor:
    """(..., k, n) coefficients followed by the 4 deterministic salt
    polynomials (the same for every proof of a batch)."""
    n = coeffs.shape[-1]
    salts = gfd.from_u64(_deterministic_salt_polys(n, 4), coeffs.device)
    return torch.cat([coeffs, salts.expand(*coeffs.shape[:-2], *salts.shape)], dim=-2)


def _quotient_commit_body(common, blinding: bool, cs_vals, wires_vals,
                          zsp_vals, pi_hash, betas, gammas, alphas):
    """Fused quotient: vanishing eval over the 8n coset -> divide by Z_H ->
    coset INTT -> chunk split (+ salts) -> LDE -> Merkle levels.  Inputs
    are the commits' column-major (num_polys, 8n) LDE values; for a batch
    of proofs, wires_vals and zsp_vals (B, num_polys, 8n) beside the
    circuit's cs_vals, with pi_hash and the challenges as
    ``_device_vanishing_eval`` takes them."""
    cfg = common.config
    n = common.degree
    tables = _coset_tables(common, cs_vals.device)
    if True:
        vans = _device_vanishing_eval(common, cs_vals.t(), wires_vals.transpose(-1, -2),
                                      zsp_vals.transpose(-1, -2), *tables[:2], pi_hash,
                                      betas, gammas, alphas)
        vals = gfd.mul(torch.stack(vans), tables[2])
    qs = nttm.coset_intt(vals)                                  # (challenges, ..., 8n)
    chunks = [qs[c, ..., t * n : (t + 1) * n] for c in range(cfg.num_challenges)
              for t in range(common.quotient_degree_factor)]
    coeffs = torch.stack(chunks, dim=-2)
    if blinding:
        coeffs = _with_salts(coeffs)
    values = nttm.lde(coeffs, cfg.rate_bits)
    levels = merklem.device_merkle_levels_values(values, cfg.fri_config.cap_height)
    return coeffs, values, levels


def _device_wires_coeffs_fn(values: torch.Tensor, blinding: bool) -> torch.Tensor:
    """values (..., num_polys, n) -> coefficients (+ deterministic salt
    polys when blinding)."""
    coeffs = nttm.intt(values)
    return _with_salts(coeffs) if blinding else coeffs


def _zs_coeffs_body(common, sigmas_np, subgroup_np, wire_coeffs, betas, gammas):
    """Permutation argument: wire values on H (NTT of the committed
    coefficients) -> nums/dens -> chunk products -> exclusive prefix
    product -> partial products -> INTT (+ salts).  Returns the
    coefficients and each challenge's closing running product (1 for a
    valid witness).

    For a batch of proofs, wire_coeffs is (B, k, n), the challenges
    (num_challenges, B, 1), and the results carry the proof axis too.
    On the card the products are K6's (plonk/permutation_cuda.py), on the
    CPU ``_zs_values_plain``."""
    cfg = common.config
    device = wire_coeffs.device
    sig = gfd.from_u64(sigmas_np, device)                       # (80, n)
    x = gfd.from_u64(subgroup_np, device)                       # (n,)
    wvals = nttm.ntt(wire_coeffs[..., :cfg.num_routed_wires, :])  # (..., 80, n)
    if True:
        values, finals = _zs_values_plain(common, wvals, sig, x, betas, gammas)
    coeffs = nttm.intt(values)
    if cfg.zero_knowledge:
        coeffs = _with_salts(coeffs)
    return coeffs, finals


def _zs_values_plain(common, wvals, sig, x, betas, gammas):
    """The plain version of K6: the Z and partial-product values (...,
    nc + nc * pp, n) and the closing products (..., nc) from the routed
    wires' values on H, eager torch."""
    cfg = common.config
    n = wvals.shape[-1]
    q = common.quotient_degree_factor
    num_routed = cfg.num_routed_wires
    num_chunks = -(-num_routed // q)     # the last chunk shorter where q does not divide
    pad = num_chunks * q - num_routed
    num_pp = common.num_partial_products
    k = gfd.from_u64(np.asarray(common.k_is, dtype=np.uint64), wvals.device)
    lead = wvals.shape[:-2]                                     # () or (B,)
    kx = gfd.mul(k[:, None], x[None, :])                        # (80, n)
    polys, pps_all, finals = [], [], []
    for c in range(cfg.num_challenges):
        beta, gamma = betas[c][..., None], gammas[c][..., None]
        nums = gfd.add(wvals, gfd.add(gfd.mul(kx, beta), gamma))
        dens = gfd.add(wvals, gfd.add(gfd.mul(sig, beta), gamma))
        if pad:                                                 # factors of 1 fill the last chunk
            ones = torch.ones((*nums.shape[:-2], pad, n), dtype=nums.dtype, device=nums.device)
            nums, dens = torch.cat([nums, ones], dim=-2), torch.cat([dens, ones], dim=-2)
        nums = nums.reshape(*lead, num_chunks, q, n)
        dens = dens.reshape(*lead, num_chunks, q, n)
        cn, cd = nums[..., 0, :], dens[..., 0, :]
        for j in range(1, q):
            cn = gfd.mul(cn, nums[..., j, :])
            cd = gfd.mul(cd, dens[..., j, :])
        ratios = gfd.mul(cn, gfd.inverse(cd))                   # (..., num_chunks, n)
        total = ratios[..., 0, :]
        for t in range(1, num_chunks):
            total = gfd.mul(total, ratios[..., t, :])
        s = gfd.prefix_prod(total)                              # inclusive (..., n)
        finals.append(s[..., -1:])
        z = torch.cat([torch.ones_like(s[..., :1]), s[..., :-1]], dim=-1)
        polys.append(z)
        p = z
        for t in range(num_pp):
            p = gfd.mul(p, ratios[..., t, :])
            pps_all.append(p)
    return torch.stack(polys + pps_all, dim=-2), torch.cat(finals, dim=-1)


def _on(t: torch.Tensor) -> str:
    """Where a stage body runs: "cuda" (the kernels) or "cpu" (their plain
    versions); any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the prover runs on CUDA or CPU tensors, got {t.device}")
    return "cpu"


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


def prove(circuit_data, pw: PartialWitness, check_witness: bool | None = None,
          device="cuda") -> ProofWithPublicInputs:
    """Prove ``pw`` against ``circuit_data`` with every bulk stage on
    ``device`` ("cuda" by default; "cpu" runs the plain torch versions):
    the batch of one of plonk/prover_batch.py, its stage timers named
    ``prove/*``."""
    from .. import resolve_device
    from .prover_batch import prove_batch_device

    return prove_batch_device(circuit_data, [pw], resolve_device(device),
                              _resolve_check_witness(check_witness), timers="prove")[0]


def prove_batch(circuit_data, pws: list, check_witness: bool | None = None,
                *, device="cuda") -> list:
    """Prove B independent witnesses of ONE circuit on ``device``, every
    bulk stage batched over a leading proof axis (plonk/prover_batch.py).
    Returns one ProofWithPublicInputs a witness, in the order of ``pws``,
    each byte-identical to :func:`prove` of that witness."""
    from .. import resolve_device
    from .prover_batch import prove_batch_device

    device = resolve_device(device)
    check_witness = _resolve_check_witness(check_witness)
    pws = list(pws)
    if not pws:
        return []
    if len(pws) == 1:
        return [prove(circuit_data, pws[0], check_witness=check_witness, device=device)]
    return prove_batch_device(circuit_data, pws, device, check_witness)
