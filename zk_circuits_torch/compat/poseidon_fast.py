"""Optimized ("fast") Poseidon partial-round tables, derived at import.

The reference engine's Poseidon gate evaluates partial rounds in the
optimized sparse-matrix form of the Poseidon paper (Appendix B / the
HadesHash `poseidonperm_x5_..._optimized.sage` reference): the dense MDS
multiply of each partial round is decomposed as M = M'' · M' with M''
sparse (only the first row/column differ from identity), all M' factors
pulled ahead of the partial rounds into one "initial matrix", and the
partial-round constants folded back through the matrices.  The tables here
must therefore match the engine's precomputed ones for its in-circuit
Poseidon witness values to satisfy our re-implementation of the gate
constraints — validated end-to-end by tests/test_compat.py, which verifies
the reference's own proof bytes (bench-data/proof.bin).

Everything is derived from the canonical width-12 Goldilocks parameters in
zk_circuits_torch.hash.constants; correctness is self-checked at import by
asserting fast == naive permutation (zk_circuits_torch.host.poseidon) on a
fixed input.
"""

from __future__ import annotations

import numpy as np

from ..hash.constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    WIDTH,
)
from ..host import gl

P = gl.P_INT
T = WIDTH


def _mds_matrix() -> list[list[int]]:
    """M[r][c]: coefficient of state[c] in output row r (engine convention:
    row r = Σ_i CIRC[i]·state[(r+i) mod 12] + DIAG[r]·state[r])."""
    m = [[0] * T for _ in range(T)]
    for r in range(T):
        for i in range(T):
            m[r][(r + i) % T] += MDS_MATRIX_CIRC[i]
        m[r][r] += MDS_MATRIX_DIAG[r]
    return [[v % P for v in row] for row in m]


def _mat_inv(m: list[list[int]]) -> list[list[int]]:
    """Matrix inverse mod p by Gauss-Jordan (exact python ints)."""
    n = len(m)
    a = [row[:] + [1 if i == j else 0 for j in range(n)] for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % P != 0)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], P - 2, P)
        a[col] = [(v * inv) % P for v in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(v - f * w) % P for v, w in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _mat_vec(m, v):
    return [sum(mi * vi for mi, vi in zip(row, v)) % P for row in m]


def _mat_mul(a, b):
    n = len(a)
    return [[sum(a[i][k] * b[k][j] for k in range(n)) % P for j in range(n)]
            for i in range(n)]


def _transpose(m):
    return [list(col) for col in zip(*m)]


def _derive_matrices(m: list[list[int]]):
    """Decompose the chain of partial-round MDS multiplies into one initial
    dense matrix plus a sparse matrix per round.

    Column convention (state' = M·state, matching the engine's mds_layer):
    iterating backward from the last partial round, each M_mul factors as
    M'' · M' with M'' = [[M00, ŵ],[v, I]] (ŵ solving ŵ·M̂ = M_mul[0,1:])
    and M' = [[1,0],[0,M̂]]; the residual M' composes into the next round's
    matrix via M_mul ← M' · M, and the final residual's M̂ is the initial
    matrix applied once before the rounds (stored transposed, as consumed
    by mds_partial_layer_init)."""
    w_hats: list[list[int]] = []
    vs: list[list[int]] = []
    m_mul = m
    m_hat = None
    for _ in range(N_PARTIAL_ROUNDS):
        m_hat = [row[1:] for row in m_mul[1:]]
        v = [row[0] for row in m_mul[1:]]          # first column below diag
        w_row = m_mul[0][1:]                        # top row right of diag
        # ŵ · M̂ = w_row  ⇒  ŵ = (M̂^T)^{-1} · w_row
        w_hat = _mat_vec(_mat_inv(_transpose(m_hat)), w_row)
        w_hats.append(w_hat)
        vs.append(v)
        m_prime = [[1 if i == j else 0 for j in range(T)] for i in range(T)]
        for i in range(T - 1):
            for j in range(T - 1):
                m_prime[i + 1][j + 1] = m_hat[i][j]
        m_mul = _mat_mul(m_prime, m)
    # derivation ran last-round-first; application order is forward
    w_hats.reverse()
    vs.reverse()
    initial_matrix = _transpose(m_hat)  # (t-1)x(t-1), stored transposed
    return initial_matrix, w_hats, vs


def _derive_constants(m: list[list[int]]):
    """Fold each partial round's dense constant vector backward through
    M^{-1}: the first component stays as that round's post-sbox scalar, the
    rest merges into the previous round's constants; the first partial
    round keeps a dense vector (applied pre-sbox once)."""
    consts = [list(ALL_ROUND_CONSTANTS[r * T : (r + 1) * T])
              for r in range(len(ALL_ROUND_CONSTANTS) // T)]
    m_inv = _mat_inv(m)
    i = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS - 2
    while i > HALF_N_FULL_ROUNDS - 1:
        inv_cip1 = _mat_vec(m_inv, consts[i + 1])
        consts[i] = [(a + b) % P
                     for a, b in zip(consts[i], [0] + inv_cip1[1:])]
        consts[i + 1] = [inv_cip1[0]] + [0] * (T - 1)
        i -= 1
    first_round_constant = consts[HALF_N_FULL_ROUNDS]
    partial_round_constants = [
        consts[HALF_N_FULL_ROUNDS + 1 + r][0] for r in range(N_PARTIAL_ROUNDS - 1)
    ] + [0]
    return first_round_constant, partial_round_constants


def _derive():
    mds = _mds_matrix()
    initial_matrix, w_hats, vs = _derive_matrices(mds)
    first_rc, partial_rcs = _derive_constants(mds)
    return (
        np.array(first_rc, dtype=np.uint64),
        np.array(partial_rcs, dtype=np.uint64),
        np.array(initial_matrix, dtype=np.uint64),
        np.array(w_hats, dtype=np.uint64),
        np.array(vs, dtype=np.uint64),
    )


(
    FAST_PARTIAL_FIRST_ROUND_CONSTANT,
    FAST_PARTIAL_ROUND_CONSTANTS,
    FAST_PARTIAL_ROUND_INITIAL_MATRIX,
    FAST_PARTIAL_ROUND_W_HATS,
    FAST_PARTIAL_ROUND_VS,
) = _derive()

MDS0TO0 = (MDS_MATRIX_CIRC[0] + MDS_MATRIX_DIAG[0]) % P


# ---------------------------------------------------------------------------
# Generic fast-permutation pieces, parameterized over a field interface so
# the same code runs on host u64 (self-check, witness generation) and on
# quadratic-extension elements (the in-circuit gate evaluation in
# compat/gates.py).  `alg` provides: add(a,b), mul(a,b), from_int(i)->elem.
# ---------------------------------------------------------------------------

def constant_layer(alg, state, round_ctr):
    return [alg.add(state[i], alg.from_int(int(ALL_ROUND_CONSTANTS[round_ctr * T + i])))
            for i in range(T)]


def sbox(alg, x):
    x2 = alg.mul(x, x)
    x3 = alg.mul(x2, x)
    return alg.mul(alg.mul(x3, x3), x)


def mds_layer(alg, state):
    mds = _MDS_CACHE
    out = []
    for r in range(T):
        acc = alg.from_int(0)
        for c in range(T):
            if mds[r][c]:
                acc = alg.add(acc, alg.mul(state[c], alg.from_int(mds[r][c])))
        out.append(acc)
    return out


def partial_first_constant_layer(alg, state):
    return [alg.add(state[i], alg.from_int(int(FAST_PARTIAL_FIRST_ROUND_CONSTANT[i])))
            for i in range(T)]


def mds_partial_layer_init(alg, state):
    out = [state[0]] + [alg.from_int(0)] * (T - 1)
    for r in range(1, T):
        for c in range(1, T):
            coeff = int(FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1])
            if coeff:
                out[c] = alg.add(out[c], alg.mul(state[r], alg.from_int(coeff)))
    return out


def mds_partial_layer_fast(alg, state, r):
    d = alg.mul(state[0], alg.from_int(MDS0TO0))
    for i in range(1, T):
        d = alg.add(d, alg.mul(state[i], alg.from_int(int(FAST_PARTIAL_ROUND_W_HATS[r][i - 1]))))
    out = [d]
    for i in range(1, T):
        out.append(alg.add(state[i], alg.mul(state[0], alg.from_int(int(FAST_PARTIAL_ROUND_VS[r][i - 1])))))
    return out


_MDS_CACHE = _mds_matrix()


def fast_permute(alg, state):
    """The engine's optimized permutation; bit-identical to the naive one."""
    state = list(state)
    round_ctr = 0
    for _ in range(HALF_N_FULL_ROUNDS):
        state = constant_layer(alg, state, round_ctr)
        state = [sbox(alg, x) for x in state]
        state = mds_layer(alg, state)
        round_ctr += 1
    state = partial_first_constant_layer(alg, state)
    state = mds_partial_layer_init(alg, state)
    for r in range(N_PARTIAL_ROUNDS):
        state[0] = sbox(alg, state[0])
        state[0] = alg.add(state[0], alg.from_int(int(FAST_PARTIAL_ROUND_CONSTANTS[r])))
        state = mds_partial_layer_fast(alg, state, r)
    round_ctr += N_PARTIAL_ROUNDS
    for _ in range(HALF_N_FULL_ROUNDS):
        state = constant_layer(alg, state, round_ctr)
        state = [sbox(alg, x) for x in state]
        state = mds_layer(alg, state)
        round_ctr += 1
    return state


class _HostAlg:
    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def mul(a, b):
        return (a * b) % P

    @staticmethod
    def from_int(i):
        return i % P


HOST_ALG = _HostAlg()


def _self_check():
    from ..host import poseidon as hp

    x = np.arange(12, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    x %= np.uint64(P)
    naive = hp.permute(x.copy())
    fast = fast_permute(HOST_ALG, [int(v) for v in x])
    assert [int(v) for v in naive] == fast, (
        "fast Poseidon derivation does not match the naive permutation"
    )


_self_check()
