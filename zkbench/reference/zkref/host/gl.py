"""Vectorized host-side Goldilocks field arithmetic (numpy, uint64).

Semantics match the reference engine's ``qp-plonky2-field`` GoldilocksField
(p = 2^64 - 2^32 + 1) with *canonical* representation: every array this
module returns holds values in [0, p).  Used for circuit building, witness
generation and the Fiat-Shamir transcript; the torch field layer
(zk_circuits_torch.field.goldilocks) is tested against it.  ``add``,
``sub``, ``mul`` and ``powers`` of 2^13 elements or more run in the host
runtime (zk_circuits_torch.native); the numpy bodies, ``_add_np`` and so
on, serve smaller arrays and the tests.  Both are exact for any u64
input.

Reference behavior: canonical/noncanonical conversions per
common/src/utils.rs:93-102 (32-bit limb checks) and the
external qp-plonky2-field crate (Cargo.lock).
"""

from __future__ import annotations

import numpy as np


# Unsigned wraparound is intentional throughout this module.  np.seterr is
# thread-local, so the import-time setting does NOT cover worker threads
# (prove_batch's host pool) — the wrapping functions below additionally use
# explicit np.errstate contexts.
_ERR = np.seterr(over="ignore")


def _ignore_overflow(fn):
    """Per-call errstate guard: u64 wraparound in this function is by design."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)

    return wrapped

P = np.uint64(2**64 - 2**32 + 1)
P_INT = 2**64 - 2**32 + 1
EPSILON = np.uint64(2**32 - 1)  # 2^64 mod p
MASK32 = np.uint64(0xFFFFFFFF)
_U32 = np.uint64(32)

# Multiplicative group generator and 2-adicity (two_adicity = 32).
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
# g s.t. g^(2^32) = 1, ord(g) = 2^32 (plonky2 POWER_OF_TWO_GENERATOR).
POWER_OF_TWO_GENERATOR = 1753635133440165772


def asfelt(x) -> np.ndarray:
    """Coerce ints / arrays to canonical uint64 field elements."""
    a = np.asarray(x, dtype=np.uint64)
    return np.where(a >= P, a - P, a)



def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _add_np(a, b)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _sub_np(a, b)


@_ignore_overflow
def _add_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    s = a + b  # wraps mod 2^64
    over = s < a
    # true sum >= 2^64  =>  subtract p (== add epsilon mod 2^64)
    s2 = np.where(over, s + EPSILON, s)
    # a second wrap, possible only when both inputs lie above p
    s2 = np.where(over & (s2 < EPSILON), s2 + EPSILON, s2)
    return np.where(s2 >= P, s2 - P, s2)


@_ignore_overflow
def _sub_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    under = a < b
    # true difference < 0  =>  add p (== subtract epsilon mod 2^64), twice
    # when d wrapped below epsilon (possible only for inputs above p)
    d2 = np.where(under, d - EPSILON, d)
    d2 = np.where(under & (d < EPSILON), d2 - EPSILON, d2)
    return np.where(d2 >= P, d2 - P, d2)


def neg(a: np.ndarray) -> np.ndarray:
    return np.where(a == 0, a, P - a)


@_ignore_overflow
def _reduce128(x_lo: np.ndarray, x_hi: np.ndarray) -> np.ndarray:
    """Reduce a 128-bit value (x_lo + x_hi * 2^64) mod p, canonical output."""
    x_hi_hi = x_hi >> _U32
    x_hi_lo = x_hi & MASK32
    t0 = x_lo - x_hi_hi
    borrow = x_lo < x_hi_hi
    t0 = np.where(borrow, t0 - EPSILON, t0)
    t1 = x_hi_lo * EPSILON
    t2 = t0 + t1
    over = t2 < t0
    t2 = np.where(over, t2 + EPSILON, t2)
    return np.where(t2 >= P, t2 - P, t2)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _mul_np(a, b)


@_ignore_overflow
def _mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a0 = a & MASK32
    a1 = a >> _U32
    b0 = b & MASK32
    b1 = b >> _U32
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl
    mid_carry = (mid < lh).astype(np.uint64)
    x_lo = ll + (mid << _U32)
    c1 = (x_lo < ll).astype(np.uint64)
    x_hi = hh + (mid >> _U32) + (mid_carry << _U32) + c1
    return _reduce128(x_lo, x_hi)


def square(a: np.ndarray) -> np.ndarray:
    return mul(a, a)


def powmod(a: np.ndarray, e: int) -> np.ndarray:
    """a^e for a static non-negative integer exponent."""
    result = np.ones_like(np.asarray(a, dtype=np.uint64))
    base = np.asarray(a, dtype=np.uint64)
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inverse(a: np.ndarray) -> np.ndarray:
    """Multiplicative inverse by Fermat (a^(p-2)); inverse(0) == 0."""
    return powmod(a, P_INT - 2)


def batch_inverse(a: np.ndarray) -> np.ndarray:
    """Montgomery batch inversion over the flattened array (3n muls + 1 inv)."""
    flat = np.ravel(a)
    n = flat.shape[0]
    if n == 0:
        return a
    prefix = np.empty_like(flat)
    acc = np.uint64(1)
    for i in range(n):
        prefix[i] = acc
        acc = mul(acc, flat[i])
    inv_acc = inverse(acc)
    out = np.empty_like(flat)
    for i in range(n - 1, -1, -1):
        out[i] = mul(inv_acc, prefix[i])
        inv_acc = mul(inv_acc, flat[i])
    return out.reshape(np.shape(a))


def exp_power_of_2(a: np.ndarray, power_log: int) -> np.ndarray:
    for _ in range(power_log):
        a = square(a)
    return a


def primitive_root_of_unity(n_log: int) -> int:
    """Primitive 2^n_log-th root of unity (matches plonky2's derivation from
    POWER_OF_TWO_GENERATOR by repeated squaring)."""
    assert 0 <= n_log <= TWO_ADICITY
    g = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - n_log):
        g = (g * g) % P_INT
    return g


def sum_mod(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Modular sum along an axis via pairwise folding (log passes)."""
    a = np.asarray(a, dtype=np.uint64)
    a = np.moveaxis(a, axis, -1)
    while a.shape[-1] > 1:
        n = a.shape[-1]
        if n % 2 == 1:
            extra = a[..., -1]
            a = a[..., :-1]
        else:
            extra = None
        a = add(a[..., 0::2], a[..., 1::2])
        if extra is not None:
            a = np.concatenate([a, extra[..., None]], axis=-1)
            a = np.ascontiguousarray(a)
    return a[..., 0]


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as canonical u64."""
    return _powers_np(base, n)


def _powers_np(base: int, n: int) -> np.ndarray:
    """Log-doubling: after k entries are filled, the next k are
    out[:k] * base^k — log2(n) vectorized multiplies, not an n-step loop."""
    b = int(base) % P_INT
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    out[0] = 1
    k = 1
    bk = b  # base^k
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = _mul_np(out[:m], np.uint64(bk))
        bk = (bk * bk) % P_INT
        k *= 2
    return out


def from_noncanonical_u64(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.uint64)
    return np.where(a >= P, a - P, a)


def to_canonical_u64(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64)
