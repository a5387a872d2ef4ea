"""Polynomial commitment oracle: coefficients -> coset LDE -> Merkle cap.

The torch counterpart of the JAX package's fri/oracle.py.  A batch is
committed on its device: the LDE values stay there COLUMN-MAJOR
(num_polys, 8n) -- leaf row i is values[:, i] -- and are hashed in place by
the leaf kernel; the Merkle levels stay there too.  Only the cap (a few KB)
is fetched for the Fiat-Shamir challenger, and query rows plus sibling
paths are gathered on the device and fetched in one small transfer.

Leaf order is the natural coset order x_i = g * w_{8n}^i.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..hash import merkle as merklem
from ..host import gle
from ..ntt import ntt as nttm


def _device_commit_fn(coeffs: torch.Tensor, rate_bits: int, cap_height: int):
    """coeffs (num_polys, n) -> (values (num_polys, 8n), levels).  With a
    leading proof axis, coeffs (B, num_polys, n), it commits the B batches
    at once (the JAX package's ``_device_commit_batch_fn``): the LDE runs
    over the leading axis and K1 builds the B trees in one launch."""
    values = nttm.lde(coeffs, rate_bits)
    levels = merklem.device_merkle_levels_values(values, cap_height)
    return values, levels


@dataclass
class PolynomialBatch:
    """Committed polynomial batch, resident on one torch device."""

    coeffs: np.ndarray | None  # host copy of the coefficients, when known
    rate_bits: int
    blinding: bool
    cap_height: int
    levels_dev: Any = None   # list[tensor (m, 4)]
    coeffs_dev: Any = None   # tensor (num_polys, n)
    values_dev: Any = None   # tensor (num_polys, 8n), column-major leaves
    _cap: np.ndarray | None = field(default=None, repr=False)
    # this batch on other devices (ensure_device), one copy a device
    _copies: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.values_dev.device

    @property
    def num_polys(self) -> int:
        return self.coeffs_dev.shape[0]

    @property
    def degree(self) -> int:
        return self.coeffs_dev.shape[1]

    @property
    def lde_size(self) -> int:
        return self.degree << self.rate_bits

    @property
    def cap(self) -> np.ndarray:
        if self._cap is None:
            from ..utils.profiling import stage_timer

            with stage_timer("oracle/cap_fetch"):
                self._cap = gfd.to_u64(self.levels_dev[-1])
        return self._cap

    @property
    def levels(self) -> list:
        return [gfd.to_u64(lv) for lv in self.levels_dev]

    @property
    def leaves(self) -> np.ndarray:
        """Full LDE row matrix on the host (a large transfer)."""
        return np.ascontiguousarray(gfd.to_u64(self.values_dev).T)

    def values_for_eval(self) -> torch.Tensor:
        """Column-major LDE (num_polys, 8n) for the quotient program."""
        return self.values_dev

    def open_rows(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Gather query rows + Merkle sibling paths for all indices at once:
        (rows (Q, w), siblings (Q, L, 4))."""
        idx = torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(self.device)
        rows = self.values_dev[:, idx].t()
        sibs = []
        for lv in self.levels_dev[:-1]:
            sibs.append(lv[idx ^ 1])
            idx = idx >> 1
        if sibs:
            return gfd.to_u64(rows), gfd.to_u64(torch.stack(sibs, dim=1))
        return gfd.to_u64(rows), np.zeros((len(indices), 0, 4), np.uint64)

    def ensure_device(self, device) -> "PolynomialBatch":
        """This batch with its tensors on ``device``: itself, or its copy
        there, made at the first call for that device and kept."""
        device = torch.device(device)
        if self.values_dev.device == device:
            return self
        key = str(device)
        if key not in self._copies:
            self._copies[key] = PolynomialBatch(
                self.coeffs, self.rate_bits, self.blinding, self.cap_height,
                levels_dev=[lv.to(device) for lv in self.levels_dev],
                coeffs_dev=self.coeffs_dev.to(device),
                values_dev=self.values_dev.to(device), _cap=self._cap)
        return self._copies[key]

    @staticmethod
    def from_coeffs(coeffs: np.ndarray, rate_bits: int, cap_height: int,
                    blinding: bool = False, device="cuda") -> "PolynomialBatch":
        """Commit (num_polys, n) coefficients on ``device`` ("cuda" by
        default; it raises without CUDA unless ``device="cpu"``)."""
        from .. import resolve_device

        device = resolve_device(device)
        coeffs = np.asarray(coeffs, dtype=np.uint64)
        if blinding:
            # Salt *polynomials* (degree n), so every leaf column stays a
            # committed low-degree polynomial for FRI (deterministic).
            salts = _deterministic_salt_polys(coeffs.shape[1], 4)
            coeffs = np.concatenate([coeffs, salts], axis=0)
        dev = gfd.from_u64(coeffs, device)
        values, levels = _device_commit_fn(dev, rate_bits, cap_height)
        return PolynomialBatch(coeffs, rate_bits, blinding, cap_height,
                               levels_dev=levels, coeffs_dev=dev,
                               values_dev=values)

    @staticmethod
    def from_values(values: np.ndarray, rate_bits: int, cap_height: int,
                    blinding: bool = False, device="cuda") -> "PolynomialBatch":
        """values: (num_polys, n) evaluations over H (natural order)."""
        from .. import resolve_device

        device = resolve_device(device)
        coeffs = nttm.host_intt(np.asarray(values, dtype=np.uint64))
        return PolynomialBatch.from_coeffs(coeffs, rate_bits, cap_height,
                                           blinding, device)


def ext_powers(zeta: np.ndarray, n: int) -> np.ndarray:
    """[1, zeta, ..., zeta^(n-1)] in GF(p^2): (n, 2).

    Log-doubling: after k entries are filled, the next k are
    out[:k] * zeta^k -- log2(n) vectorized extension multiplies."""
    out = np.zeros((n, 2), dtype=np.uint64)
    out[0] = gle.ONE
    if n == 1:
        return out
    k = 1
    zk = np.asarray(zeta, dtype=np.uint64).reshape(1, 2)
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = gle.mul(out[:m], np.broadcast_to(zk, (m, 2)))
        zk = gle.mul(zk, zk)
        k *= 2
    return out


@lru_cache(maxsize=8)
def _deterministic_salt_polys(n: int, num_salts: int) -> np.ndarray:
    """Deterministic blinding salt polynomials, counter-mode Poseidon
    coefficients (the reference's `no_random` mode removes proving
    randomness; salts keep the commitment *shape* of the zk config).
    Cached -- every commit of the same degree shares the same salts."""
    from ..host import poseidon as hposeidon

    seed = np.zeros((num_salts * n, 8), dtype=np.uint64)
    seed[:, 0] = 0x5A17  # salt domain tag
    seed[:, 1] = np.arange(num_salts * n, dtype=np.uint64)
    out = hposeidon.batch_hash_no_pad(seed)[:, 0].reshape(num_salts, n)
    out.setflags(write=False)
    return out
