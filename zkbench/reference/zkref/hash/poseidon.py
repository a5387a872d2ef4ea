"""Poseidon permutation over Goldilocks on torch tensors, batched.

The state is an int64 tensor with trailing dimension 12.  This is the
plain PyTorch version of the leaf-hash kernel (csrc/poseidon_leaf.cu):
the tests hold it against zk_circuits_torch.host.poseidon and the JAX
sponge, and the chip smoke run holds the CUDA kernel against it.

The MDS layer splits every lane into 32-bit halves, so the circulant
multiply-accumulate with the small coefficients is exact as a float64
matmul (sums < 264 * 2^32 < 2^53); the 2^32-weighted recombination is
then one 128-bit reduction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gf
from .constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    RATE,
    WIDTH,
)

_RC_NP = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, WIDTH)
# M[r, i]: coefficient of state[i] in output lane r.
_MDS_NP = np.zeros((WIDTH, WIDTH), dtype=np.int64)
for _r in range(WIDTH):
    for _i in range(WIDTH):
        _MDS_NP[_r, _i] = MDS_MATRIX_CIRC[(_i - _r) % WIDTH]
    _MDS_NP[_r, _r] += MDS_MATRIX_DIAG[_r]

_TABLES: dict = {}


def _tables(device):
    """Round constants (30, 12) and the MDS matrix as float64 (12 inputs,
    12 outputs) on ``device``, built once per device (module import stays
    tensor-free)."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (gf.from_u64(_RC_NP, device),
                        torch.from_numpy(_MDS_NP.T.astype(np.float64)).to(device))
    return _TABLES[key]


def _sbox(x: torch.Tensor) -> torch.Tensor:
    """x^7 of any u64 patterns, reduced mod p but not canonicalised: a u64
    that may lie in [p, 2^64), which the MDS layer takes as it is."""
    x2 = gf.reduce128_nc(*gf.square128(x))
    x3 = gf.reduce128_nc(*gf.mul128(x2, x))
    x6 = gf.reduce128_nc(*gf.square128(x3))
    return gf.reduce128_nc(*gf.mul128(x6, x))


def _add_rc(state: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """state + rc (mod p) of canonical operands, not canonicalised: the
    S-box and the MDS layer take any u64."""
    s = state + rc
    return torch.where(gf.ult(s, rc), s + gf.EPS, s)


def mds_layer(state: torch.Tensor) -> torch.Tensor:
    """Exact MDS multiply of (..., 12) states (any u64 patterns).

    The 32-bit halves of every lane go through one float64 matmul: each
    product and partial sum is an integer below 264 * 2^32 < 2^53, so the
    float64 result is exact whatever order the BLAS sums in."""
    mds_t = _tables(state.device)[1]
    halves = torch.stack([state & gf.MASK32, gf.lsr(state, 32)], dim=-2)
    sums = (halves.to(torch.float64) @ mds_t).to(torch.int64)
    s_lo, s_hi = sums[..., 0, :], sums[..., 1, :]
    # value = s_lo + s_hi * 2^32, below 2^74
    x_lo = s_lo + ((s_hi & gf.MASK32) << 32)
    carry = gf.ult(x_lo, s_lo).to(torch.int64)
    x_hi = gf.lsr(s_hi, 32) + carry
    return gf.reduce128(x_lo, x_hi)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation on a (..., 12) tensor: 4 full rounds, 22
    partial rounds (S-box on lane 0 only), 4 full rounds."""
    rc = _tables(state.device)[0]
    h, p = HALF_N_FULL_ROUNDS, N_PARTIAL_ROUNDS
    for r in range(h):
        state = mds_layer(_sbox(_add_rc(state, rc[r])))
    for r in range(h, h + p):
        state = _add_rc(state, rc[r])
        state = torch.cat([_sbox(state[..., :1]), state[..., 1:]], dim=-1)
        state = mds_layer(state)
    for r in range(h + p, 2 * h + p):
        state = mds_layer(_sbox(_add_rc(state, rc[r])))
    return state


def batch_hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    """hash_no_pad over a batch: inputs (..., n) -> (..., 4).  Each chunk
    of up to 8 columns overwrites lanes 0..len-1, then one permutation."""
    *lead, n = inputs.shape
    state = torch.zeros((*lead, WIDTH), dtype=torch.int64, device=inputs.device)
    for off in range(0, n, RATE):
        chunk = inputs[..., off : off + RATE]
        state = torch.cat([chunk, state[..., chunk.shape[-1]:]], dim=-1)
        state = permute(state)
    return state[..., :4].contiguous()


def batch_compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one compression, batched: (batch, 4) x (batch, 4) -> (batch, 4)."""
    zeros = torch.zeros_like(left)
    return permute(torch.cat([left, right, zeros], dim=1))[:, :4].contiguous()


def batch_hash_or_noop(inputs: torch.Tensor) -> torch.Tensor:
    """hash_or_noop over a batch: (..., n) -> (..., 4)."""
    *lead, n = inputs.shape
    if n <= 4:
        pad = torch.zeros((*lead, 4 - n), dtype=torch.int64, device=inputs.device)
        return torch.cat([inputs, pad], dim=-1)
    return batch_hash_no_pad(inputs)
