"""Radix-2 NTT / INTT and coset LDE over Goldilocks.

Semantics match the reference engine's polynomial ops (external qp-plonky2
crate): ``ntt(coeffs)[i] = p(w^i)`` in natural order with w the primitive
2^k-th root of unity derived from POWER_OF_TWO_GENERATOR; ``coset_lde``
evaluates on the coset ``shift * <w>`` after zero-padding by the rate
(rate_bits=3 for the standard configs, cf. SURVEY.md §0).

Two implementations, bit-identical:
- host_*: numpy arrays, in the host runtime (zk_circuits_torch.native);
  ``host_ntt_plain``/``host_intt_plain`` are the numpy golden model
  (zk_circuits_torch.host.gl) the tests hold it to.
- tensor functions (``ntt``, ``intt``, ``coset_ntt``, ``coset_intt``,
  ``lde``) on torch int64 tensors, routed by device: a CUDA tensor goes to
  the hand-written kernel K4 (ntt/ntt_cuda.py, csrc/ntt.cu), one call a
  transform with the coset scaling, padding, reversal and n^-1 inside it;
  a CPU tensor goes to the plain version (``*_plain``), a radix-2 stage
  loop of whole-tensor butterflies; any other device raises.  Unlike the
  JAX package's ``_use_mxu`` there is no switch and no size threshold:
  Hopper multiplies u64 natively, so the JAX package's matmul form
  (ntt_mxu.py) has no reason on the card, and every NTT there is K4's.

The NTT always runs along the LAST axis; leading axes are batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..host import gl

# ---------------------------------------------------------------------------
# Host (numpy) golden model
# ---------------------------------------------------------------------------


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _host_stage_twiddles(n: int) -> tuple:
    """Per-stage twiddle tables: stage s (half=2^s) uses w_{2^{s+1}}^j."""
    stages = []
    bits = n.bit_length() - 1
    for s in range(bits):
        stages.append(gl.powers(gl.primitive_root_of_unity(s + 1), 1 << s))
    return tuple(stages)


def host_ntt(coeffs: np.ndarray) -> np.ndarray:
    """values[i] = p(w^i); operates along the last axis (power-of-two len),
    in the host runtime (zk_circuits_torch.native)."""
    return host_ntt_plain(coeffs)


def host_intt(values: np.ndarray) -> np.ndarray:
    """The inverse of ``host_ntt``, in the host runtime."""
    return host_intt_plain(values)


def host_ntt_plain(coeffs: np.ndarray) -> np.ndarray:
    """``host_ntt`` in numpy alone (the field's ``_np`` bodies), for the
    tests: bit-reversal, then one vectorized butterfly stage per bit."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[-1]
    if n == 1:
        return coeffs.copy()
    assert n & (n - 1) == 0
    x = coeffs[..., _bit_reverse_indices(n)]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        tw = gl._powers_np(gl.primitive_root_of_unity(s + 1), half)
        shape = x.shape[:-1] + (n // (2 * half), 2, half)
        x = x.reshape(shape)
        a = x[..., 0, :]
        b = gl._mul_np(x[..., 1, :], tw)
        x = np.concatenate([gl._add_np(a, b)[..., None, :], gl._sub_np(a, b)[..., None, :]],
                           axis=-2)
        x = x.reshape(x.shape[:-3] + (n,))
    return x


def host_intt_plain(values: np.ndarray) -> np.ndarray:
    """``host_intt`` in numpy alone, for the tests."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[-1]
    if n == 1:
        return values.copy()
    # INTT(x)[k] = (1/n) * NTT(x)[-k mod n]
    y = host_ntt_plain(values)
    y = np.concatenate([y[..., :1], y[..., :0:-1]], axis=-1)
    return gl._mul_np(y, gl.inverse(np.uint64(n)))


def host_coset_ntt(coeffs: np.ndarray, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> np.ndarray:
    """values[i] = p(shift * w^i)."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[-1]
    powers = np.empty(n, dtype=np.uint64)
    acc = 1
    for k in range(n):
        powers[k] = acc
        acc = (acc * shift) % gl.P_INT
    return host_ntt(gl.mul(coeffs, powers))


def host_coset_intt(values: np.ndarray, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> np.ndarray:
    coeffs = host_intt(values)
    n = coeffs.shape[-1]
    inv_shift = pow(shift, gl.P_INT - 2, gl.P_INT)
    powers = np.empty(n, dtype=np.uint64)
    acc = 1
    for k in range(n):
        powers[k] = acc
        acc = (acc * inv_shift) % gl.P_INT
    return gl.mul(coeffs, powers)


def host_lde(coeffs: np.ndarray, rate_bits: int,
             shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> np.ndarray:
    """Zero-pad by 2^rate_bits then coset-NTT (the low-degree extension)."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[-1]
    padded = np.zeros(coeffs.shape[:-1] + (n << rate_bits,), dtype=np.uint64)
    padded[..., :n] = coeffs
    return host_coset_ntt(padded, shift)


# ---------------------------------------------------------------------------
# Tensor (torch) implementation
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def _cached(key, make):
    if key not in _TABLES:
        _TABLES[key] = make()
    return _TABLES[key]


def _stage_twiddles(n: int, device) -> tuple:
    return _cached(("tw", n, str(device)), lambda: tuple(
        gfd.from_u64(tw, device) for tw in _host_stage_twiddles(n)))


def _bit_reverse(n: int, device) -> torch.Tensor:
    return _cached(("rev", n, str(device)),
                   lambda: torch.from_numpy(_bit_reverse_indices(n)).to(device))


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] as a tensor on ``device`` (cached)."""
    return _cached(("pow", int(base) % gl.P_INT, n, str(device)),
                   lambda: gfd.from_u64(gl.powers(base, n), device))


def ntt_plain(coeffs: torch.Tensor) -> torch.Tensor:
    """``ntt``'s plain version: bit-reversal gather, then log2(n) radix-2
    butterfly stages over the whole tensor."""
    n = coeffs.shape[-1]
    if n == 1:
        return coeffs
    assert n & (n - 1) == 0
    batch = coeffs.shape[:-1]
    x = coeffs.index_select(-1, _bit_reverse(n, coeffs.device))
    for s, tw in enumerate(_stage_twiddles(n, coeffs.device)):
        half = 1 << s
        x = x.reshape(*batch, n // (2 * half), 2, half)
        a = x[..., 0, :]
        b = gfd.mul(x[..., 1, :], tw)
        x = torch.stack([gfd.add(a, b), gfd.sub(a, b)], dim=-2).reshape(*batch, n)
    return x


def intt_plain(values: torch.Tensor) -> torch.Tensor:
    n = values.shape[-1]
    if n == 1:
        return values
    # INTT(x)[k] = (1/n) * NTT(x)[-k mod n]
    y = ntt_plain(values)
    y = torch.cat([y[..., :1], y[..., 1:].flip(-1)], dim=-1)
    return gfd.mul_const(y, int(gl.inverse(np.uint64(n))))


def coset_ntt_plain(coeffs: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR,
                    size: int | None = None) -> torch.Tensor:
    n = coeffs.shape[-1]
    if size is not None and size != n:
        coeffs = torch.nn.functional.pad(coeffs, (0, size - n))
        n = size
    return ntt_plain(gfd.mul(coeffs, powers(shift, n, coeffs.device)))


def coset_intt_plain(values: torch.Tensor,
                     shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    coeffs = intt_plain(values)
    inv_shift = pow(shift, gl.P_INT - 2, gl.P_INT)
    return gfd.mul(coeffs, powers(inv_shift, coeffs.shape[-1], coeffs.device))


def lde_plain(coeffs: torch.Tensor, rate_bits: int,
              shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Zero-pad by 2^rate_bits then coset-NTT (the low-degree extension)."""
    return coset_ntt_plain(coeffs, shift, coeffs.shape[-1] << rate_bits)


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (K4), False for a CPU one (the plain version)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the NTT runs on CPU or CUDA tensors, got one on {x.device}")
    return False


def _k4(x: torch.Tensor, mode: str, **kw) -> torch.Tensor:
    raise AssertionError("the reference has no kernel")


def ntt(coeffs: torch.Tensor) -> torch.Tensor:
    """values[i] = p(w^i) along the last axis: K4 on the card, else the
    stage loop."""
    return _k4(coeffs, "ntt") if _on_card(coeffs) else ntt_plain(coeffs)


def intt(values: torch.Tensor) -> torch.Tensor:
    """The inverse of ``ntt``."""
    return _k4(values, "intt") if _on_card(values) else intt_plain(values)


def coset_ntt(coeffs: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR,
              size: int | None = None) -> torch.Tensor:
    """values[i] = p(shift * w^i) of the coefficients zero-padded to
    ``size`` points (default: their number)."""
    if _on_card(coeffs):
        return _k4(coeffs, "coset_ntt", shift=shift, size=size)
    return coset_ntt_plain(coeffs, shift, size)


def coset_intt(values: torch.Tensor,
               shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """The inverse of ``coset_ntt``."""
    if _on_card(values):
        return _k4(values, "coset_intt", shift=shift)
    return coset_intt_plain(values, shift)


def lde(coeffs: torch.Tensor, rate_bits: int,
        shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Zero-pad by 2^rate_bits then coset-NTT (the low-degree extension)."""
    if _on_card(coeffs):
        return _k4(coeffs, "lde", rate_bits=rate_bits, shift=shift)
    return lde_plain(coeffs, rate_bits, shift)
