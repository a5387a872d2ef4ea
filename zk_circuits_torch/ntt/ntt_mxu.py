"""The four-step Goldilocks NTT, counterpart of the JAX package's
``ntt/ntt_mxu.py``.

The JAX module maps the NTT onto a TPU's MXU through the four-step
decomposition

    N = N1 * N2,  c[j1 + N1*j2]  (j1 in [N1], j2 in [N2])
    X[k2 + N2*k1] = sum_{j1} w_N^{j1*k2} * w_{N1}^{j1*k1}
                     * sum_{j2} c[j1 + N1*j2] w_{N2}^{j2*k2}

(inner NTT_{N2}, twiddle, outer DFT_{N1} as an exact bf16 limb matmul).
Hopper multiplies u64 natively, so here there are no limb planes and no
matmul form: on a CUDA tensor ``ntt_mxu``/``intt_mxu`` are ``ntt.ntt``/
``ntt.intt``, one call of K4 (ntt/ntt_cuda.py) that takes its own path for
the size (the row path to 2^13 points, its four-step above).  On a CPU
tensor they are the plain four-step below, with the JAX module's factors
(``_split``): the inner transform recursively, the twiddle
(``_twiddle_table``) and the outer DFT_{N1} as a direct sum of field
products over the u64 DFT matrix (``_dft_matrix``), the eager counterpart
of ``_gf_dot_matrix``; it is for the tests and the CPU.  Both are
bit-exact with ``ntt.ntt``/``ntt.intt``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..host import gl
from . import ntt as nttm

P = gl.P_INT
DIRECT_MAX = 128   # the outer DFT's largest size, and the direct transform's


# ---------------------------------------------------------------------------
# host-side tables (numpy u64, cached)
# ---------------------------------------------------------------------------


def _geometric_row(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^(n-1)] as uint64 (vector doubling: O(log n) gl.mul)."""
    row = np.ones(1, dtype=np.uint64)
    b = base % P
    length = 1
    while length < n:
        step = min(length, n - length)
        row = np.concatenate(
            [row, gl.mul(row[:step], np.uint64(pow(b, length, P)))])
        length += step
    return row


def _vandermonde(base_row: np.ndarray, rows: int) -> np.ndarray:
    """(rows, len) table t[j] = base_row ** j (elementwise), via the row
    recurrence t[j] = t[j-1] * base_row."""
    out = np.empty((rows, base_row.shape[0]), dtype=np.uint64)
    out[0] = 1
    for j in range(1, rows):
        out[j] = gl.mul(out[j - 1], base_row)
    return out


@functools.lru_cache(maxsize=None)
def _dft_matrix(n: int) -> np.ndarray:
    """(n, n) u64 DFT matrix M[j, k] = w_n^{jk}, laid out for
    right-multiplication: out[.., k] = sum_j x[.., j] M[j, k]."""
    w = gl.primitive_root_of_unity(n.bit_length() - 1)
    return _vandermonde(_geometric_row(w, n), n)


@functools.lru_cache(maxsize=None)
def _twiddle_table(n1: int, n2: int) -> np.ndarray:
    """w_{n1*n2}^{j1*k2} as an (n1, n2) u64 table."""
    n = n1 * n2
    w = gl.primitive_root_of_unity(n.bit_length() - 1)
    return _vandermonde(_geometric_row(w, n2), n1)


# ---------------------------------------------------------------------------
# the plain four-step (CPU)
# ---------------------------------------------------------------------------


def _gf_dot_matrix(x: torch.Tensor, n: int) -> torch.Tensor:
    """Exact out[..., k] = sum_j x[..., j] * M[j, k] (mod p), contraction
    size n <= 128, as a direct sum of field products."""
    m = gfd.from_u64(_dft_matrix(n), x.device)
    acc = gfd.mul(x[..., :1], m[0])
    for j in range(1, n):
        acc = gfd.add(acc, gfd.mul(x[..., j:j + 1], m[j]))
    return acc


def _split(n: int) -> tuple[int, int]:
    """n = n1 * n2 with the outer (direct-sum) factor n1 <= 128."""
    if n >= DIRECT_MAX * DIRECT_MAX:
        return DIRECT_MAX, n // DIRECT_MAX
    return n // DIRECT_MAX, DIRECT_MAX


def _ntt_plain(coeffs: torch.Tensor) -> torch.Tensor:
    n = coeffs.shape[-1]
    if n <= DIRECT_MAX:
        return _gf_dot_matrix(coeffs, n)
    n1, n2 = _split(n)
    batch = coeffs.shape[:-1]
    # c[j1 + n1*j2]: (j2, j1) -> (j1, j2); inner NTT over j2, batched over j1
    y = _ntt_plain(coeffs.reshape(*batch, n2, n1).transpose(-1, -2))   # (..., j1, k2)
    y = gfd.mul(y, gfd.from_u64(_twiddle_table(n1, n2), coeffs.device))
    # outer DFT over j1: out[k1, k2] = sum_j1 M[j1, k1] y[j1, k2]
    out_t = _gf_dot_matrix(y.transpose(-1, -2), n1)                    # (..., k2, k1)
    return out_t.transpose(-1, -2).reshape(*batch, n)                  # k = k2 + n2*k1


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def ntt_mxu(coeffs: torch.Tensor) -> torch.Tensor:
    """NTT along the last axis; bit-exact with ntt.host_ntt/ntt.ntt."""
    n = coeffs.shape[-1]
    if n == 1:
        return coeffs
    assert n & (n - 1) == 0
    if nttm._on_card(coeffs):
        return nttm.ntt(coeffs)
    return _ntt_plain(coeffs)


def intt_mxu(values: torch.Tensor) -> torch.Tensor:
    """The inverse of ``ntt_mxu``; bit-exact with ntt.intt."""
    n = values.shape[-1]
    if n == 1:
        return values
    if nttm._on_card(values):
        return nttm.intt(values)
    y = ntt_mxu(values)
    y = torch.cat([y[..., :1], y[..., 1:].flip(-1)], dim=-1)
    return gfd.mul_const(y, int(gl.inverse(np.uint64(n))))
