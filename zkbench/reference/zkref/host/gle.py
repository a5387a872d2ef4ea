"""Host-side quadratic extension field GF(p^2) = GF(p)[x] / (x^2 - 7).

Matches the reference engine's degree-2 Goldilocks extension (D = 2,
W = 7; cf. common/src/circuit.rs:10-12 and the external
qp-plonky2-field crate).  Elements are numpy arrays with trailing dim 2.
"""

from __future__ import annotations

import numpy as np

from . import gl

W = np.uint64(7)
D = 2


def from_base(a: np.ndarray) -> np.ndarray:
    """Lift base-field array (...,) -> extension array (..., 2)."""
    a = np.asarray(a, dtype=np.uint64)
    out = np.zeros(a.shape + (2,), dtype=np.uint64)
    out[..., 0] = a
    return out


def ext(a0, a1) -> np.ndarray:
    return np.stack(
        [np.asarray(a0, dtype=np.uint64), np.asarray(a1, dtype=np.uint64)], axis=-1
    )


ZERO = np.zeros(2, dtype=np.uint64)
ONE = np.array([1, 0], dtype=np.uint64)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return gl.add(a, b)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return gl.sub(a, b)


def neg(a: np.ndarray) -> np.ndarray:
    return gl.neg(a)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = gl.add(gl.mul(a0, b0), gl.mul(W, gl.mul(a1, b1)))
    c1 = gl.add(gl.mul(a0, b1), gl.mul(a1, b0))
    return np.stack([c0, c1], axis=-1)


def mul_base(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Multiply extension element(s) by base-field scalar(s)."""
    s = np.asarray(s, dtype=np.uint64)
    return np.stack([gl.mul(a[..., 0], s), gl.mul(a[..., 1], s)], axis=-1)


def square(a: np.ndarray) -> np.ndarray:
    return mul(a, a)


def powmod(a: np.ndarray, e: int) -> np.ndarray:
    result = np.broadcast_to(ONE, np.shape(a)).copy()
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inverse(a: np.ndarray) -> np.ndarray:
    """(a0 - a1 x) / (a0^2 - 7 a1^2)."""
    a0, a1 = a[..., 0], a[..., 1]
    norm = gl.sub(gl.mul(a0, a0), gl.mul(W, gl.mul(a1, a1)))
    inv_norm = gl.inverse(norm)
    return np.stack([gl.mul(a0, inv_norm), gl.mul(gl.neg(a1), inv_norm)], axis=-1)


def exp_power_of_2(a: np.ndarray, k: int) -> np.ndarray:
    for _ in range(k):
        a = square(a)
    return a


def equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.all(a == b, axis=-1)


def scalar_mul_add(acc: np.ndarray, alpha: np.ndarray, term: np.ndarray) -> np.ndarray:
    """acc * alpha + term (Horner step for reducing with powers of alpha)."""
    return add(mul(acc, alpha), term)
