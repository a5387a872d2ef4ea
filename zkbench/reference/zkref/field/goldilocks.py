"""Goldilocks field arithmetic on torch int64 tensors.

A field element is one ``torch.int64`` tensor entry holding the u64 bit
pattern of a canonical value in [0, p).  torch has no unsigned 64-bit
arithmetic on the CPU, so:

- add/sub/mul wrap modulo 2^64 in two's complement, as u64 would;
- an unsigned compare XORs both sides with 2^63 first (``ult``);
- a logical right shift masks after the arithmetic ``>>`` (``lsr``);
- the 64x64 -> 128-bit product is built from 32-bit halves.

The reduction uses 2^64 = 2^32 - 1 (mod p).  Golden model:
zk_circuits_torch.host.gl (numpy uint64).  Counterpart of the JAX
package's field/goldilocks.py, whose 2x32-bit limbs were a TPU workaround.
"""

from __future__ import annotations

import numpy as np
import torch

P_INT = 2**64 - 2**32 + 1
MASK32 = 0xFFFFFFFF
EPS = 0xFFFFFFFF  # 2^64 mod p


def _i64(x: int) -> int:
    """u64 bit pattern -> the Python int torch.int64 stores for it."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


P_I64 = _i64(P_INT)
_SIGN = _i64(1 << 63)
W = 7  # quadratic extension: x^2 = 7


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def lsr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def canon(a: torch.Tensor) -> torch.Tensor:
    """Any u64 -> [0, p): one conditional subtraction of p."""
    return torch.where(ult(a, P_I64), a, a - P_I64)


# ---------------------------------------------------------------------------
# host <-> tensor
# ---------------------------------------------------------------------------


def from_u64(x, device="cpu") -> torch.Tensor:
    """numpy uint64 (or ints) -> canonical int64 tensor on ``device``."""
    a = np.asarray(x, dtype=np.uint64)
    a = np.where(a >= np.uint64(P_INT), a - np.uint64(P_INT), a)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)


def to_u64(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().contiguous().numpy().view(np.uint64)


def zeros(shape, device="cpu") -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device="cpu") -> torch.Tensor:
    return torch.ones(shape, dtype=torch.int64, device=device)


def full(shape, value: int, device="cpu") -> torch.Tensor:
    return torch.full(shape, _i64(value % P_INT), dtype=torch.int64,
                      device=device)


def scalar(value: int, like: torch.Tensor) -> torch.Tensor:
    """A 0-d field constant on ``like``'s device (broadcasts anywhere)."""
    return torch.tensor(_i64(value % P_INT), dtype=torch.int64,
                        device=like.device)


# ---------------------------------------------------------------------------
# arithmetic (canonical in, canonical out)
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    # carry out of 2^64: the true sum minus p is s + EPS (mod 2^64)
    s = torch.where(ult(s, a), s + EPS, s)
    return canon(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(ult(a, b), d + P_I64, d)


def neg(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, P_I64 - a)


def mul128(a: torch.Tensor, b: torch.Tensor):
    """Exact 64x64 -> 128 product of any u64 patterns: (lo, hi).

    The low word is the wrapping int64 product.  The high word adds the
    32-bit halves' partial products, and the carry out of the middle
    column, a sum below 3 * 2^32, fits in int64 without a compare."""
    a0, a1 = a & MASK32, lsr(a, 32)
    b0, b1 = b & MASK32, lsr(b, 32)
    lh = a0 * b1
    hl = a1 * b0
    mid = lsr(a0 * b0, 32) + (lh & MASK32) + (hl & MASK32)
    hi = a1 * b1 + lsr(lh, 32) + lsr(hl, 32) + (mid >> 32)
    return a * b, hi


def square128(a: torch.Tensor):
    """Exact 128-bit square of any u64 patterns: (lo, hi), with the one
    cross product of mul128 doubled."""
    a0, a1 = a & MASK32, lsr(a, 32)
    lh = a0 * a1
    mid = lsr(a0 * a0, 32) + ((lh & MASK32) << 1)
    hi = a1 * a1 + (lsr(lh, 32) << 1) + (mid >> 32)
    return a * a, hi


def reduce128_nc(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo + 2^64 hi (mod p) as a u64 that may lie in [p, 2^64)."""
    hi_hi = lsr(hi, 32)
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = torch.where(ult(lo, hi_hi), t0 - EPS, t0)
    t1 = (hi_lo << 32) - hi_lo          # hi_lo * EPS, < 2^64
    t2 = t0 + t1
    return torch.where(ult(t2, t0), t2 + EPS, t2)


def reduce128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return canon(reduce128_nc(lo, hi))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce128(*mul128(a, b))


def square(a: torch.Tensor) -> torch.Tensor:
    return reduce128(*square128(a))


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a static constant."""
    c %= P_INT
    if c == 0:
        return torch.zeros_like(a)
    if c == 1:
        return a
    return mul(a, scalar(c, a))


def powmod(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent (square-and-multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2); inverse(0) == 0."""
    return powmod(a, P_INT - 2)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, a, b)


def equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a == b


def sum_mod(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Modular sum along an axis via pairwise folding (log2(n) add passes;
    the fold order does not matter, addition mod p is exact)."""
    x = torch.movedim(a, axis, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        folded = add(x[..., :h], x[..., h : 2 * h])
        x = torch.cat([folded, x[..., 2 * h :]], dim=-1) if n % 2 else folded
    return x[..., 0]


def prefix_prod(a: torch.Tensor) -> torch.Tensor:
    """Inclusive modular prefix product along the last axis (Hillis-Steele,
    log2(n) passes; the torch stand-in for lax.associative_scan)."""
    n = a.shape[-1]
    shift = 1
    while shift < n:
        a = torch.cat([a[..., :shift], mul(a[..., shift:], a[..., :-shift])],
                      dim=-1)
        shift *= 2
    return a


# ---------------------------------------------------------------------------
# quadratic extension GF(p^2) = GF(p)[x]/(x^2 - 7), component pairs
# ---------------------------------------------------------------------------


def emul(a0, a1, b0, b1):
    c0 = add(mul(a0, b0), mul_const(mul(a1, b1), W))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return c0, c1


def eadd(a0, a1, b0, b1):
    return add(a0, b0), add(a1, b1)


def ext_pair(arr, device="cpu"):
    """Host (..., 2) ext array -> tensor component pair."""
    arr = np.asarray(arr, dtype=np.uint64)
    return from_u64(arr[..., 0], device), from_u64(arr[..., 1], device)


def to_ext(c0: torch.Tensor, c1: torch.Tensor) -> np.ndarray:
    """Tensor component pair -> host (..., 2) ext array."""
    return np.stack([to_u64(c0), to_u64(c1)], axis=-1)
