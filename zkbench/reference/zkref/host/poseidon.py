"""Host-side (numpy) Poseidon over Goldilocks — batched golden model.

Matches the reference engine's ``PoseidonHash`` semantics exactly
(``hash_no_pad`` / ``hash_or_noop`` / two-to-one compression), as used by
e.g. wormhole/circuit/src/unspendable_account.rs:38-63 and
voting/src/lib.rs:277-283.

All entry points accept a leading batch dimension: ``state`` has shape
(..., 12).  The permutation runs in the host runtime
(zk_circuits_torch.native); ``permute_plain`` and
``batch_hash_no_pad_plain`` are the numpy bodies, which the tests hold it
to.  Witness generation and Merkle golden checks run through here; the
torch sponge (zk_circuits_torch.hash.poseidon) and the CUDA leaf kernel
are tested against this model.
"""

from __future__ import annotations

import numpy as np

from ..hash.constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    RATE,
    WIDTH,
)
from . import gl

_RC = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, WIDTH)
# Dense MDS matrix: M[r, i] = CIRC[(i - r) mod 12] + (r == i) * DIAG[r]
_MDS = np.zeros((WIDTH, WIDTH), dtype=np.uint64)
for _r in range(WIDTH):
    for _i in range(WIDTH):
        _MDS[_r, _i] = MDS_MATRIX_CIRC[(_i - _r) % WIDTH]
    _MDS[_r, _r] += MDS_MATRIX_DIAG[_r]
_MDS_T = _MDS.T.copy()


def _sbox(x: np.ndarray, mul=gl.mul) -> np.ndarray:
    x2 = mul(x, x)
    x3 = mul(x2, x)
    x6 = mul(x3, x3)
    return mul(x6, x)


def _mds_layer(state: np.ndarray) -> np.ndarray:
    # state: (..., 12) canonical u64.  Split into 32-bit halves so the
    # integer matmul is exact in u64 (sum < 12*41*2^32 < 2^41).
    lo = state & gl.MASK32
    hi = state >> np.uint64(32)
    s_lo = lo @ _MDS_T  # (..., 12), < 2^41
    s_hi = hi @ _MDS_T
    # value = s_lo + s_hi * 2^32  (~73 bits) -> reduce via 128-bit path.
    t_lo32 = s_hi & gl.MASK32
    t_hi32 = s_hi >> np.uint64(32)
    x_lo = s_lo + (t_lo32 << np.uint64(32))
    carry = (x_lo < s_lo).astype(np.uint64)
    x_hi = t_hi32 + carry
    return gl._reduce128(x_lo, x_hi)


def permute(state: np.ndarray) -> np.ndarray:
    """Full Poseidon permutation on shape (..., 12) u64 arrays, in the host
    runtime (zk_circuits_torch.native): the numpy body costs milliseconds
    a permutation, and the Fiat-Shamir challenger runs 100+ of them one
    after another in every proof."""
    state = np.asarray(state, dtype=np.uint64)
    if state.size > 16 * WIDTH:
        return permute_plain(state)
    rows = state.reshape(-1, WIDTH)
    out = np.array([_permute_int([int(v) for v in r]) for r in rows], dtype=np.uint64)
    return out.reshape(state.shape)


_P = (1 << 64) - (1 << 32) + 1
_RC_INT = [[int(v) for v in row] for row in _RC]
_MDS_INT = [[int(v) for v in row] for row in _MDS]


def _permute_int(s: list) -> list:
    """One state's permutation in Python integers."""
    rounds = ([True] * HALF_N_FULL_ROUNDS + [False] * N_PARTIAL_ROUNDS
              + [True] * HALF_N_FULL_ROUNDS)
    for rc, full in enumerate(rounds):
        s = [(x + c) % _P for x, c in zip(s, _RC_INT[rc])]
        if full:
            s = [pow(x, 7, _P) for x in s]
        else:
            s[0] = pow(s[0], 7, _P)
        s = [sum(m * x for m, x in zip(row, s)) % _P for row in _MDS_INT]
    return s


def permute_plain(state: np.ndarray) -> np.ndarray:
    """The permutation in numpy alone (the field's ``_np`` bodies), for
    the tests."""
    state = np.asarray(state, dtype=np.uint64)
    rc = 0
    for _ in range(HALF_N_FULL_ROUNDS):
        state = gl._add_np(state, _RC[rc])
        state = _sbox(state, gl._mul_np)
        state = _mds_layer(state)
        rc += 1
    for _ in range(N_PARTIAL_ROUNDS):
        state = gl._add_np(state, _RC[rc])
        state0 = _sbox(state[..., 0], gl._mul_np)
        state = np.concatenate([state0[..., None], state[..., 1:]], axis=-1)
        state = _mds_layer(state)
        rc += 1
    for _ in range(HALF_N_FULL_ROUNDS):
        state = gl._add_np(state, _RC[rc])
        state = _sbox(state, gl._mul_np)
        state = _mds_layer(state)
        rc += 1
    return state


def hash_n_to_m_no_pad(inputs: np.ndarray, num_outputs: int) -> np.ndarray:
    """Sponge with no padding: absorb in chunks of RATE by overwriting the
    first len(chunk) state elements, permuting after each chunk."""
    inputs = np.asarray(inputs, dtype=np.uint64)
    assert inputs.ndim == 1
    state = np.zeros(WIDTH, dtype=np.uint64)
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i : i + RATE]
        state[: len(chunk)] = chunk
        state = permute(state)
    outputs: list[np.ndarray] = []
    while True:
        for j in range(RATE):
            outputs.append(state[j])
            if len(outputs) == num_outputs:
                return np.array(outputs, dtype=np.uint64)
        state = permute(state)


def hash_no_pad(inputs: np.ndarray) -> np.ndarray:
    return hash_n_to_m_no_pad(inputs, 4)


def hash_or_noop(inputs: np.ndarray) -> np.ndarray:
    """HashOut of a leaf vector: identity-pad if <= 4 felts, else hash."""
    inputs = np.asarray(inputs, dtype=np.uint64)
    if len(inputs) <= 4:
        out = np.zeros(4, dtype=np.uint64)
        out[: len(inputs)] = inputs
        return out
    return hash_no_pad(inputs)


def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Two-to-one compression: permute([left, right, 0^4])[:4].

    Batched: left/right shape (..., 4)."""
    left = np.asarray(left, dtype=np.uint64)
    right = np.asarray(right, dtype=np.uint64)
    zeros = np.zeros(left.shape[:-1] + (4,), dtype=np.uint64)
    state = np.concatenate([left, right, zeros], axis=-1)
    return permute(state)[..., :4]


def batch_hash_no_pad(inputs: np.ndarray) -> np.ndarray:
    """hash_no_pad over a batch: inputs (batch, n) -> (batch, 4); a batch
    of more than 8 in one call of the host runtime."""
    inputs = np.asarray(inputs, dtype=np.uint64)
    return _sponge(inputs, permute)


def batch_hash_no_pad_plain(inputs: np.ndarray) -> np.ndarray:
    """``batch_hash_no_pad`` in numpy alone, for the tests."""
    return _sponge(np.asarray(inputs, dtype=np.uint64), permute_plain)


def _sponge(inputs: np.ndarray, perm) -> np.ndarray:
    batch, n = inputs.shape
    state = np.zeros((batch, WIDTH), dtype=np.uint64)
    for i in range(0, n, RATE):
        chunk = inputs[:, i : i + RATE]
        state[:, : chunk.shape[1]] = chunk
        state = perm(state)
    return state[:, :4]
