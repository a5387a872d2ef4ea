"""Poseidon permutation over Goldilocks on torch tensors, batched.

The state is an int64 tensor with trailing dimension 12.  This is the
plain PyTorch version of the leaf-hash kernel (csrc/poseidon_leaf.cu):
the tests hold it against zk_circuits_torch.host.poseidon and the JAX
sponge, and the chip smoke run holds the CUDA kernel against it.

The MDS layer splits every lane into 32-bit halves, so the circulant
multiply-accumulate with the small coefficients is exact in int64
(sums < 12 * 49 * 2^32 < 2^42); the 2^32-weighted recombination is then
one 128-bit reduction.
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
    """Round constants (30, 12) and MDS columns (12 inputs, 12 outputs) on
    ``device``, built once per device (module import stays tensor-free)."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (gf.from_u64(_RC_NP, device),
                        torch.from_numpy(_MDS_NP.T.copy()).to(device))
    return _TABLES[key]


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = gf.square(x)
    x3 = gf.mul(x2, x)
    x6 = gf.square(x3)
    return gf.mul(x6, x)


def mds_layer(state: torch.Tensor) -> torch.Tensor:
    """Exact MDS multiply of (..., 12) canonical states."""
    mds_t = _tables(state.device)[1]
    lo = state & gf.MASK32
    hi = gf.lsr(state, 32)
    s_lo = torch.zeros_like(state)
    s_hi = torch.zeros_like(state)
    for i in range(WIDTH):
        s_lo = s_lo + lo[..., i : i + 1] * mds_t[i]
        s_hi = s_hi + hi[..., i : i + 1] * mds_t[i]
    # value = s_lo + s_hi * 2^32, below 2^75
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
        state = mds_layer(_sbox(gf.add(state, rc[r])))
    for r in range(h, h + p):
        state = gf.add(state, rc[r])
        state = torch.cat([_sbox(state[..., :1]), state[..., 1:]], dim=-1)
        state = mds_layer(state)
    for r in range(h + p, 2 * h + p):
        state = mds_layer(_sbox(gf.add(state, rc[r])))
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
