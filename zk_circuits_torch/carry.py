"""Carry a circuit built by the JAX package over to this port.

A prover's circuit data plays the part a model's weights play: the same
circuit must go through both provers for their proofs to be compared.
``circuit_data_from_reference`` reads a reference ``CircuitData`` by
attribute only (numpy arrays, ints, dicts and gate id strings; nothing of
the reference package is imported), rebuilds the gates from their ids and
redoes the constants/sigmas commitment on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import resolve_device
from .fri.oracle import PolynomialBatch
from .iop.gates import gate_from_id
from .plonk.circuit_data import (
    CircuitData,
    CommonCircuitData,
    ProverOnlyCircuitData,
    ScheduleBatch,
    VerifierOnlyCircuitData,
)
from .plonk.config import CircuitConfig, FriConfig


def _dataclass_from(cls, ref, **override):
    kwargs = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
    kwargs.update(override)
    return cls(**kwargs)


def _u64(a) -> np.ndarray:
    return np.array(a, dtype=np.uint64, copy=True)


def circuit_data_from_reference(ref_cd, device="cuda") -> CircuitData:
    """The port's CircuitData for the reference circuit ``ref_cd``."""
    device = resolve_device(device)
    rc, rp, rv = ref_cd.common, ref_cd.prover_only, ref_cd.verifier_only
    config = _dataclass_from(CircuitConfig, rc.config,
                             fri_config=_dataclass_from(FriConfig, rc.config.fri_config))
    gates = {g.id: gate_from_id(g.id) for g in rc.gate_types}
    common = CommonCircuitData(
        config=config,
        degree_bits=int(rc.degree_bits),
        gate_types=[gates[g.id] for g in rc.gate_types],
        selector_groups=[list(map(int, grp)) for grp in rc.selector_groups],
        gate_to_group=dict(rc.gate_to_group),
        gate_to_index=dict(rc.gate_to_index),
        num_gate_constraints=int(rc.num_gate_constraints),
        num_public_inputs=int(rc.num_public_inputs),
        k_is=_u64(rc.k_is),
        circuit_digest=_u64(rc.circuit_digest),
    )
    commitment = PolynomialBatch.from_coeffs(
        _u64(rp.constants_sigmas_commitment.coeffs), config.rate_bits,
        config.fri_config.cap_height, blinding=False, device=device)
    if not np.array_equal(commitment.cap, np.asarray(rv.constants_sigmas_cap,
                                                     dtype=np.uint64)):
        raise ValueError("constants/sigmas commitment differs from the reference cap")
    prover_only = ProverOnlyCircuitData(
        constants_sigmas_commitment=commitment,
        sigmas_values=_u64(rp.sigmas_values),
        selectors_values=_u64(rp.selectors_values),
        constants_values=_u64(rp.constants_values),
        gates_by_row=[gates[g.id] for g in rp.gates_by_row],
        rep_of_target=dict(rp.rep_of_target),
        num_reps=int(rp.num_reps),
        wire_cell_reps=np.array(rp.wire_cell_reps, dtype=np.int64, copy=True),
        schedule=[ScheduleBatch(b.kind, dict(b.data)) for b in rp.schedule],
        public_inputs=list(rp.public_inputs),
        subgroup=_u64(rp.subgroup),
    )
    verifier_only = VerifierOnlyCircuitData(
        constants_sigmas_cap=_u64(rv.constants_sigmas_cap),
        circuit_digest=_u64(rv.circuit_digest),
    )
    return CircuitData(common, prover_only, verifier_only)
