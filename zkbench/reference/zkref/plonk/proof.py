"""Proof structures (the analog of ProofWithPublicInputs et al.)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fri.fri import FriProof


@dataclass
class OpeningSet:
    """Claimed evaluations; each array is (num_polys, 2) extension values.

    Oracle order: constants_sigmas [selectors ‖ constants ‖ sigmas],
    wires [+salts], zs_partial_products [Zs ‖ partial products ‖ salts],
    quotient [+salts]; zs_next holds the Z polys at g*zeta."""

    constants_sigmas: np.ndarray
    wires: np.ndarray
    zs_partial_products: np.ndarray
    quotient: np.ndarray
    zs_next: np.ndarray

    def batch0_flat(self) -> np.ndarray:
        return np.concatenate(
            [self.constants_sigmas, self.wires, self.zs_partial_products, self.quotient],
            axis=0,
        )

    def batch1_flat(self) -> np.ndarray:
        return self.zs_next


@dataclass
class Proof:
    wires_cap: np.ndarray
    zs_partial_products_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: OpeningSet
    opening_proof: FriProof


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: np.ndarray  # (num_public_inputs,) u64

    def to_bytes(self) -> bytes:
        from ..utils.serialization import proof_to_bytes

        return proof_to_bytes(self)

    @staticmethod
    def from_bytes(data: bytes, common) -> "ProofWithPublicInputs":
        from ..utils.serialization import proof_from_bytes

        return proof_from_bytes(data, common)
