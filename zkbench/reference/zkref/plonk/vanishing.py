"""Vanishing polynomial: gate constraints (selector-filtered) + the
permutation argument with partial products.

One generic implementation over the algebra abstraction serves:
- the prover's quotient evaluation on the 8n coset (DeviceBase / HostBase),
- the prover's witness-validity check on H,
- the verifier's evaluation at zeta (HostExt).

Structure mirrors the reference engine's eval_vanishing_poly: per challenge
c the combined polynomial is the Horner/alpha_c-reduction of
  [ L1(x) * (Z_c(x) - 1),
    partial-product transition constraints (10),
    gate constraint slots (num_gate_constraints) ]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ..iop.gates import EvalVars


@dataclass
class VanishingVars:
    x: Any                      # (npoints,) domain points
    wires: Any                  # (npoints, num_wires)
    selectors: Any              # (npoints, num_selectors)
    constants: Any              # (npoints, num_constants)
    sigmas: Any                 # (npoints, num_routed)
    zs: list                    # per challenge: (npoints,)
    zs_next: list               # per challenge: (npoints,)
    partial_products: list      # per challenge: (npoints, num_pp)
    l1: Any                     # (npoints,) Lagrange basis at 1
    pi_hash: Any                # (npoints, 4) broadcastable
    betas: list                 # per challenge: algebra value, broadcastable
    gammas: list
    alphas: list


def eval_gate_constraint_slots(alg, common, vv: VanishingVars) -> list:
    """Selector-filtered gate constraints accumulated into shared slots."""
    num_slots = common.num_gate_constraints
    slots = [None] * num_slots
    many_groups = len(common.selector_groups) > 1
    unused = common.unused_selector

    ev = EvalVars(alg, vv.constants, vv.wires, vv.pi_hash)
    for gate in common.gate_types:
        gi = common.gate_to_index[gate.id]
        grp_idx = common.gate_to_group[gate.id]
        group = common.selector_groups[grp_idx]
        s = alg.col(vv.selectors, grp_idx)
        filt = None
        for gj in group:
            if gj == gi:
                continue
            term = alg.sub_from_scalar(gj, s)
            filt = term if filt is None else alg.mul(filt, term)
        if many_groups:
            term = alg.sub_from_scalar(unused, s)
            filt = term if filt is None else alg.mul(filt, term)
        if getattr(alg, "is_torch", False) and hasattr(gate, "eval_device"):
            constraints = gate.eval_device(ev)
        else:
            constraints = gate.eval(ev)
        for k, c in enumerate(constraints):
            term = alg.mul(filt, c) if filt is not None else c
            slots[k] = term if slots[k] is None else alg.add(slots[k], term)

    npoints = _npoints(vv)
    zero = alg.broadcast_scalar(0, npoints)
    return [s if s is not None else zero for s in slots]


def _npoints(vv: VanishingVars) -> int:
    x = vv.x
    # In-circuit evaluation (recursion.CircuitAlg) passes scalar targets
    # with no shape — a single evaluation point.
    return x.shape[0] if hasattr(x, "shape") else 1


def eval_permutation_terms(alg, common, vv: VanishingVars, c: int) -> list:
    """Partial-product transition constraints for challenge c (10 terms for
    80 routed wires / chunk size 8), plus does NOT include the L1 term."""
    cfg = common.config
    beta = vv.betas[c]
    gamma = vv.gammas[c]
    q = common.quotient_degree_factor
    num_routed = cfg.num_routed_wires
    chunks = [(i, min(i + q, num_routed)) for i in range(0, num_routed, q)]
    pps = vv.partial_products[c]
    num_pp = common.num_partial_products

    terms = []
    prev = vv.zs[c]
    for t, (lo, hi) in enumerate(chunks):
        num_prod = None
        den_prod = None
        for j in range(lo, hi):
            wire = alg.col(vv.wires, j)
            kx = alg.mul_scalar(vv.x, int(common.k_is[j]))
            num_j = alg.add(wire, alg.add(alg.mul(kx, beta), gamma))
            sig = alg.col(vv.sigmas, j)
            den_j = alg.add(wire, alg.add(alg.mul(sig, beta), gamma))
            num_prod = num_j if num_prod is None else alg.mul(num_prod, num_j)
            den_prod = den_j if den_prod is None else alg.mul(den_prod, den_j)
        cur = alg.col(pps, t) if t < num_pp else vv.zs_next[c]
        terms.append(alg.sub(alg.mul(cur, den_prod), alg.mul(prev, num_prod)))
        prev = cur
    return terms


def _eval_permutation_terms_device(common, vv: VanishingVars, c: int) -> list:
    """Vectorized tensor version of eval_permutation_terms: whole-tensor
    ops over all routed wires instead of per-wire slices.  The wires may
    carry a leading proof axis (B, npoints, k), with a proof's challenges
    (B, 1) against the circuit's (npoints, k) sigmas."""
    from ..field import goldilocks as gfd

    cfg = common.config
    q = common.quotient_degree_factor
    num_routed = cfg.num_routed_wires
    num_chunks = num_routed // q
    beta = vv.betas[c][..., None]                  # (1, 1) or (B, 1, 1)
    gamma = vv.gammas[c][..., None]
    w = vv.wires[..., :num_routed]                 # (..., npoints, 80)
    sig = vv.sigmas                                # (npoints, 80)
    k = gfd.from_u64(common.k_is, w.device)        # (80,)
    kx = gfd.mul(vv.x[:, None], k[None, :])
    nums = gfd.add(w, gfd.add(gfd.mul(kx, beta), gamma))
    dens = gfd.add(w, gfd.add(gfd.mul(sig, beta), gamma))
    nums = nums.reshape(*nums.shape[:-1], num_chunks, q)
    dens = dens.reshape(*dens.shape[:-1], num_chunks, q)
    num_prod = nums[..., 0]
    den_prod = dens[..., 0]
    for j in range(1, q):
        num_prod = gfd.mul(num_prod, nums[..., j])
        den_prod = gfd.mul(den_prod, dens[..., j])
    # num_prod/den_prod: (npoints, num_chunks)
    pps = vv.partial_products[c]
    num_pp = common.num_partial_products
    terms = []
    prev = vv.zs[c]
    for t in range(num_chunks):
        cur = pps[..., t] if t < num_pp else vv.zs_next[c]
        terms.append(
            gfd.sub(gfd.mul(cur, den_prod[..., t]), gfd.mul(prev, num_prod[..., t]))
        )
        prev = cur
    return terms


def eval_vanishing(alg, common, vv: VanishingVars) -> list:
    """Combined vanishing value per challenge: alpha-Horner over
    [L1*(Z-1), permutation terms, gate slots]."""
    use_dev_perm = (
        getattr(alg, "is_torch", False)
        and common.config.num_routed_wires % common.quotient_degree_factor == 0
    )
    gate_slots = eval_gate_constraint_slots(alg, common, vv)
    out = []
    for c in range(common.config.num_challenges):
        z1_term = alg.mul(vv.l1, alg.add_scalar(vv.zs[c], -1))
        perm_terms = (
            _eval_permutation_terms_device(common, vv, c)
            if use_dev_perm
            else eval_permutation_terms(alg, common, vv, c)
        )
        terms = [z1_term] + perm_terms + gate_slots
        alpha = vv.alphas[c]
        acc = terms[0]
        for t in terms[1:]:
            acc = alg.add(alg.mul(acc, alpha), t)
        out.append(acc)
    return out


def check_constraints_on_h(common, prover_only, wires: np.ndarray, pi_hash: np.ndarray):
    """Debug/validity check: every gate constraint must vanish on H.
    Raises with (row, gate, constraint index) on the first violation."""
    from ..host import gl
    from . import algebra

    alg = algebra.HOST_BASE
    n = common.degree
    x = prover_only.subgroup
    vvars = VanishingVars(
        x=x,
        wires=wires,
        selectors=prover_only.selectors_values.T.copy(),
        constants=prover_only.constants_values.T.copy(),
        sigmas=prover_only.sigmas_values.T.copy(),
        zs=[np.zeros(n, dtype=np.uint64)] * common.config.num_challenges,
        zs_next=[np.zeros(n, dtype=np.uint64)] * common.config.num_challenges,
        partial_products=[
            np.zeros((n, common.num_partial_products), dtype=np.uint64)
        ] * common.config.num_challenges,
        l1=np.zeros(n, dtype=np.uint64),
        pi_hash=np.broadcast_to(pi_hash[None, :], (n, 4)),
        betas=[np.zeros(1, dtype=np.uint64)] * common.config.num_challenges,
        gammas=[np.zeros(1, dtype=np.uint64)] * common.config.num_challenges,
        alphas=[np.zeros(1, dtype=np.uint64)] * common.config.num_challenges,
    )
    slots = eval_gate_constraint_slots(alg, common, vvars)
    for k, slot in enumerate(slots):
        nz = np.nonzero(slot)[0]
        if nz.size:
            row = int(nz[0])
            raise ValueError(
                f"constraint violated at row {row} "
                f"(gate {prover_only.gates_by_row[row].id}, slot {k})"
            )
