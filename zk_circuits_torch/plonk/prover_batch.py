"""Proving: B proofs of ONE circuit, every bulk stage over a leading
proof axis.  One proof (``prover.prove``) is the batch of one.

Torch counterpart of the JAX package's plonk/prover_batch.py
(``prove_batch_device``).  Where the JAX package vmaps each stage's
program over the proof axis, here every tensor of a stage carries that
axis and the field, NTT and vanishing code broadcasts over it: a batch
issues about as many device launches as one proof and does B times the
work, and K1 builds the B Merkle trees of a commit in one launch.  The
circuit's constants/sigmas oracle, its coset tables and the salt
polynomials have no proof axis and are shared.

The witnesses are made on the device (iop/witness_device.py: K3 on the
card, its plain version on the CPU), the B wire matrices in one pass of
the schedule, and only the public inputs come back, with the wires cap
and the count of conflicting writes (a witness the host would refuse
raises there);
with ``check_witness`` the host witness runs instead, one proof after
another, and every gate constraint is re-checked on it, the rule of the
JAX package's prover.  Each proof keeps its own host Challenger;
every transcript stage fetches the whole batch's caps (or evaluations)
with one transfer (utils/fetch.py).  Proof bytes are identical to
sequential ``prove``.
"""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as gfd
from ..fri.fri_device import BatchedCommit, open_and_fri_device_batch
from ..fri.oracle import _device_commit_fn
from ..hash.challenger import Challenger
from ..host import poseidon as hposeidon
from ..iop import witness_device as wdev
from ..iop.witness import generate_witness
from ..utils.fetch import fetch_packed
from ..utils.profiling import stage_timer
from .proof import Proof, ProofWithPublicInputs


def prove_batch_device(circuit_data, pws: list, device,
                       check_witness: bool = False, timers: str = "batch") -> list:
    """Prove the B witnesses ``pws`` of one circuit on ``device`` (a
    torch.device); returns one ProofWithPublicInputs a witness, each
    byte-identical to the proof of that witness alone.

    ``timers`` names the stage timers: ``batch/wires`` and so on, with
    ``fri/...(batch)`` inside, as the JAX package's batched prover names
    them; ``"prove"`` gives ``prove/wires`` and the plain ``fri/...``
    names of its single-proof prover."""
    from .prover import _device_wires_coeffs_fn, _quotient_commit_body, _zs_coeffs_body
    from .vanishing import check_constraints_on_h

    common = circuit_data.common
    po = circuit_data.prover_only
    cfg = common.config
    cap_h = cfg.fri_config.cap_height
    B = len(pws)
    if B == 0:
        return []

    def challenges(per_proof: list):
        """B proofs' challenge lists -> (num_challenges, B, 1) on the device."""
        return gfd.from_u64(np.array(per_proof, dtype=np.uint64).T[..., None], device)

    def pi_hash(pis):
        return hposeidon.hash_no_pad(pis) if len(pis) else np.zeros(4, np.uint64)

    # ---- stage 1: witnesses, then INTT (+ salts), LDE, Merkle ----
    with stage_timer(f"{timers}/wires"):
        conflicts = None
        if check_witness:
            wits = [generate_witness(circuit_data, pw) for pw in pws]
            for wires, pis in wits:
                check_constraints_on_h(common, po, wires, pi_hash(pis))
            values_t = gfd.from_u64(np.stack([w.T for w, _ in wits]), device)
            pis_dev = gfd.from_u64(np.stack([p for _, p in wits]), device)
        else:
            values_t, pis_dev, conflicts = wdev.witnesses_and_conflicts(circuit_data, pws,
                                                                        device)
        w_coeffs = _device_wires_coeffs_fn(values_t, cfg.zero_knowledge)   # (B, W, n) in
        w_vals, w_levels = _device_commit_fn(w_coeffs, cfg.rate_bits, cap_h)
        w_caps, pis_np, *counts = fetch_packed(
            [w_levels[-1], pis_dev] + ([] if conflicts is None else [conflicts]))
    if counts:
        wdev.raise_conflicts(counts[0])
    pis_l = [p.copy() for p in pis_np]
    pi_hashes = [pi_hash(p) for p in pis_l]

    chs, betas_l, gammas_l = [], [], []
    for b in range(B):
        ch = Challenger()
        ch.observe_hash(circuit_data.verifier_only.circuit_digest)
        ch.observe_hash(pi_hashes[b])
        ch.observe_cap(w_caps[b])
        betas_l.append(ch.get_n_challenges(cfg.num_challenges))
        gammas_l.append(ch.get_n_challenges(cfg.num_challenges))
        chs.append(ch)
    betas, gammas = challenges(betas_l), challenges(gammas_l)

    # ---- stage 2: permutation argument and its commit ----
    with stage_timer(f"{timers}/zs"):
        zs_coeffs, zs_finals = _zs_coeffs_body(common, po.sigmas_values, po.subgroup,
                                               w_coeffs, betas, gammas)
        zs_vals, zs_levels = _device_commit_fn(zs_coeffs, cfg.rate_bits, cap_h)
        zs_caps, finals = fetch_packed([zs_levels[-1], zs_finals])
    if check_witness and not np.all(finals == 1):
        raise ValueError(
            "invalid witness: permutation argument does not close "
            f"(final running products {finals.tolist()} != 1)")
    alphas_l = []
    for ch, cap in zip(chs, zs_caps):
        ch.observe_cap(cap)
        alphas_l.append(ch.get_n_challenges(cfg.num_challenges))

    # ---- stage 3: quotient, the circuit's constants/sigmas shared ----
    with stage_timer(f"{timers}/quotient"):
        cs_commit = po.constants_sigmas_commitment.ensure_device(device)
        q_coeffs, q_vals, q_levels = _quotient_commit_body(
            common, cfg.zero_knowledge, cs_commit.values_for_eval(), w_vals, zs_vals,
            gfd.from_u64(np.stack(pi_hashes).reshape(B, 1, 4), device),
            betas, gammas, challenges(alphas_l))
        (q_caps,) = fetch_packed([q_levels[-1]])
    for ch, cap in zip(chs, q_caps):
        ch.observe_cap(cap)

    # ---- stages 4-7: openings, FRI, PoW and query gathers ----
    commits = [BatchedCommit(w_coeffs, w_vals, w_levels),
               BatchedCommit(zs_coeffs, zs_vals, zs_levels),
               BatchedCommit(q_coeffs, q_vals, q_levels)]
    with stage_timer(f"{timers}/openings+fri"):
        results = open_and_fri_device_batch(common, cs_commit, commits, chs,
                                            "(batch)" if timers == "batch" else "")
    return [ProofWithPublicInputs(
        Proof(wires_cap=w_caps[b].copy(), zs_partial_products_cap=zs_caps[b].copy(),
              quotient_cap=q_caps[b].copy(), openings=openings,
              opening_proof=opening_proof),
        pis_l[b]) for b, (openings, opening_proof) in enumerate(results)]
