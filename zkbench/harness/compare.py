"""A proof as the layers it passed through, for the comparison with the
reference: the public inputs, the wires cap (the device witness seen
through its commit), the Z and partial-products cap, the quotient cap,
the openings at zeta and g zeta, each FRI round's cap, the final
polynomial, the PoW witness and the query paths."""

from __future__ import annotations

import dataclasses

import numpy as np

LAYERS = ("public_inputs", "wires_cap", "zs_cap", "quotient_cap", "openings",
          "fri_caps", "final_poly", "pow_witness", "query_paths")


def flatten(obj) -> list:
    """Every number of ``obj`` (dataclasses, lists, tuples, arrays and
    integers, in field order) as a list of u64 arrays."""
    if obj is None:
        return [np.array([], dtype=np.uint64)]
    if dataclasses.is_dataclass(obj):
        return [a for f in dataclasses.fields(obj) for a in flatten(getattr(obj, f.name))]
    if isinstance(obj, (list, tuple)):
        return [np.array([len(obj)], dtype=np.uint64)] + [a for x in obj for a in flatten(x)]
    return [np.asarray(obj, dtype=np.uint64).reshape(-1)]


def layers(pwpi) -> dict:
    """{layer: list of arrays} of a ProofWithPublicInputs of either side."""
    p = pwpi.proof
    fri = p.opening_proof
    return {"public_inputs": flatten(pwpi.public_inputs),
            "wires_cap": flatten(p.wires_cap),
            "zs_cap": flatten(p.zs_partial_products_cap),
            "quotient_cap": flatten(p.quotient_cap),
            "openings": flatten(p.openings),
            "fri_caps": flatten(list(fri.commit_phase_caps)),
            "final_poly": flatten(fri.final_poly),
            "pow_witness": flatten(int(fri.pow_witness)),
            "query_paths": flatten(list(fri.query_rounds))}


def differing(got, want) -> set:
    """The layers in which the program's proof ``got`` (None where it gave
    none) differs from the reference's ``want``."""
    if got is None:
        return set(LAYERS)
    try:
        a = layers(got)
    except (AttributeError, TypeError, ValueError, OverflowError):
        return set(LAYERS)
    b = layers(want)
    return {k for k in LAYERS if len(a[k]) != len(b[k])
            or not all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))}
