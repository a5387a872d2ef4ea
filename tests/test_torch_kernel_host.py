"""The arithmetic the CUDA leaf kernel runs, built for the host.

csrc/goldilocks.cuh and csrc/poseidon.cuh are __host__ __device__ code;
here they are compiled with g++ behind a small C shim and checked against
the numpy golden models (host/gl.py, host/poseidon.py) of both packages,
so the field and permutation code is tested before any card runs it: both
forms of the MDS layer, the thread-team permutation (the T threads of a
team run in turn, arrays in place of the warp shuffles) and the Merkle
subtree index arithmetic (the tree kernel's blocks run one at a time).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.utils import nvcc
from zk_circuits_tpu.hash.merkle import MerkleTree
from zk_circuits_tpu.host import gl as jgl
from zk_circuits_tpu.host import poseidon as jpos

SHIM = r"""
#include "poseidon.cuh"
static const uint64_t RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;
extern "C" {
void shim_mul(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_mul(a[i], b[i]);
}
void shim_add(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_add(a[i], b[i]);
}
void shim_reduce(const uint64_t* lo, const uint64_t* hi, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_reduce128(lo[i], hi[i]);
}
void shim_canon(const uint64_t* a, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_canon(a[i]);
}
void shim_permute(uint64_t* states, long n) {
  for (long i = 0; i < n; i++) poseidon_permute(states + 12 * i, RC);
}
void shim_mds_freq(uint64_t* states, long n) {
  for (long i = 0; i < n; i++) poseidon_mds_freq(states + 12 * i);
}
}

// One row by a team of T threads, run in turn: thread j's lanes are
// lanes[j][k] = state lane j + k*T; `rounds` of the permutation, or (with
// rounds < 0) a bare MDS layer.
template <int T>
static void team_row(uint64_t* state, int rounds) {
  constexpr int L = 12 / T;
  uint64_t lanes[T][L], g[T][12];
  for (int j = 0; j < T; j++)
    for (int k = 0; k < L; k++) lanes[j][k] = state[j + k * T];
  for (int r = 0; r < (rounds < 0 ? 1 : rounds); r++) {
    for (int j = 0; j < T && rounds >= 0; j++) {
      if (poseidon_full_round(r))
        poseidon_team_sboxes<T, true>(lanes[j], j, r, RC);
      else
        poseidon_team_sboxes<T, false>(lanes[j], j, r, RC);
    }
    for (int j = 0; j < T; j++) {
      for (int e = 0; e < L; e++) g[j][e * T] = lanes[j][e];
      for (int d = 1; d < T; d++) {
        int src = (j + d) % T;  // the shuffle's source thread
        for (int e = 0; e < L; e++) g[j][d + e * T] = team_provide<T>(lanes[src], src, d, e);
      }
    }
    for (int j = 0; j < T; j++) poseidon_mds_rows<T>(j, g[j], lanes[j]);
  }
  for (int j = 0; j < T; j++)
    for (int k = 0; k < L; k++) state[j + k * T] = lanes[j][k];
}

extern "C" int shim_team(uint64_t* states, long n, int team, int rounds) {
  for (long i = 0; i < n; i++) {
    uint64_t* st = states + 12 * i;
    switch (team) {
      case 1: team_row<1>(st, rounds); break;
      case 4: team_row<4>(st, rounds); break;
      case 12: team_row<12>(st, rounds); break;
      default: return -1;
    }
  }
  return 0;
}

static void hash_row(const uint64_t* row, int cols, uint64_t digest[4]) {
  uint64_t s[12] = {0};
  for (int off = 0; off < cols; off += 8) {
    for (int j = 0; j < 8 && off + j < cols; j++) s[j] = row[off + j];
    poseidon_permute(s, RC);
  }
  for (int j = 0; j < 4; j++) digest[j] = gl_canon(s[j]);
}

// The tree launch's blocks of `rows` leaves one at a time (leaf digests
// and `in_block` levels of each subtree, through a block-local digest
// array), then the top launch's levels in_block+1 .. depth, with the
// kernel's index arithmetic; over a batch of `batch` trees, matrix b's
// leaves at leaves + b * in_bstride and its tree at out + b * out_bstride.
extern "C" void shim_tree(const uint64_t* all_leaves, long long n, int cols, int rows,
                          int in_block, int depth, int batch, long long in_bstride,
                          long long out_bstride, uint64_t* all_out) {
  uint64_t dig[256 * 4];
  for (long long proof = 0; proof < batch; proof++)  // the grid's y: the matrix
  for (long long row0 = 0; row0 < n; row0 += rows) {
    const uint64_t* leaves = all_leaves + proof * in_bstride;
    uint64_t* out = all_out + proof * out_bstride;
    long long nrows = n - row0 < rows ? n - row0 : rows;
    for (long long t = 0; t < nrows; t++) {
      hash_row(leaves + (row0 + t) * cols, cols, dig + 4 * t);
      for (int lane = 0; lane < 4; lane++) out[merkle_node_elem(n, 0, row0, t, lane)] = dig[4 * t + lane];
    }
    for (int l = 1; l <= in_block; l++)
      for (long long t = 0; t < (nrows >> l); t++) {
        uint64_t d[4];
        hash_row(dig + 8 * t, 8, d);  // reads nodes 2t, 2t+1 before node t is written
        for (int lane = 0; lane < 4; lane++) {
          dig[4 * t + lane] = d[lane];
          out[merkle_node_elem(n, l, row0, t, lane)] = d[lane];
        }
      }
  }
  for (int b = 0; b < batch; b++) {  // the top launch's block b
    uint64_t* out = all_out + b * out_bstride;
    for (int l = in_block + 1; l <= depth; l++)
      for (long long k = 0; k < (n >> l); k++)
        hash_row(out + merkle_level_offset(n, l - 1) + 8 * k, 8,
                 out + merkle_level_offset(n, l) + 4 * k);
  }
}
"""

P = jgl.P_INT
U64 = np.uint64


@pytest.fixture(scope="module")
def lib():
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"host_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    poseidon_cuda.write_constants_header(build)
    src = build / "shim.cc"
    src.write_text(SHIM)
    so = build / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(nvcc.CSRC), "-I", str(build),
                    "-o", str(so), str(src)], check=True)
    yield ctypes.CDLL(str(so))
    shutil.rmtree(build, ignore_errors=True)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _edge_and_random(rng, n):
    edge = np.array([0, 1, 2, P - 1, P - 2, P, P + 1, 2**32 - 1, 2**32,
                     2**63, 2**64 - 1, 2**64 - 2], dtype=U64)
    return np.concatenate([edge, rng.integers(0, 2**64 - 1, n, dtype=U64,
                                              endpoint=True)])


def _ref_mod(x):
    return np.array([int(v) % P for v in np.ravel(x)], dtype=U64).reshape(np.shape(x))


def test_mul_and_reduce_match_host(lib):
    rng = np.random.default_rng(11)
    a = _edge_and_random(rng, 2000)
    b = np.roll(_edge_and_random(rng, 2000), 5)
    out = np.empty_like(a)
    lib.shim_mul(_ptr(a), _ptr(b), _ptr(out), ctypes.c_long(a.size))
    # gl_mul is non-canonical and exact for any u64 inputs
    want = np.array([int(x) * int(y) % P for x, y in zip(a, b)], dtype=U64)
    assert np.array_equal(_ref_mod(out), want)
    ca, cb = _ref_mod(a), _ref_mod(b)
    lib.shim_mul(_ptr(ca), _ptr(cb), _ptr(out), ctypes.c_long(a.size))
    assert np.array_equal(_ref_mod(out), jgl.mul(ca, cb))

    lo = _edge_and_random(rng, 2000)
    hi = np.roll(_edge_and_random(rng, 2000), 3)
    lib.shim_reduce(_ptr(lo), _ptr(hi), _ptr(out), ctypes.c_long(lo.size))
    want = np.array([(int(x) + (int(y) << 64)) % P for x, y in zip(lo, hi)],
                    dtype=U64)
    assert np.array_equal(_ref_mod(out), want)


def test_add_and_canon_match_host(lib):
    rng = np.random.default_rng(12)
    a = _ref_mod(_edge_and_random(rng, 2000))
    b = np.roll(a, 7)
    out = np.empty_like(a)
    lib.shim_add(_ptr(a), _ptr(b), _ptr(out), ctypes.c_long(a.size))
    assert np.array_equal(out, jgl.add(a, b))
    x = _edge_and_random(rng, 2000)
    lib.shim_canon(_ptr(x), _ptr(out), ctypes.c_long(x.size))
    assert np.array_equal(out, _ref_mod(x))
    assert (out < U64(P)).all()


def test_permutation_matches_host(lib):
    rng = np.random.default_rng(13)
    states = rng.integers(0, P, (64, 12), dtype=U64)
    states[0] = 0
    states[1] = P - 1
    want = jpos.permute(states.copy())
    got = np.ascontiguousarray(states.copy())
    lib.shim_permute(_ptr(got), ctypes.c_long(states.shape[0]))
    assert np.array_equal(_ref_mod(got), want)
    # non-canonical lanes (2^64 - 1 = 2^32 - 2 mod p) hash like their residue
    nc = np.full((1, 12), 2**64 - 1, dtype=U64)
    lib.shim_permute(_ptr(nc), ctypes.c_long(1))
    assert np.array_equal(_ref_mod(nc[0]),
                          jpos.permute(np.full(12, 2**32 - 2, dtype=U64)))


EDGE = np.array([0, 1, P - 1, P, 2**64 - 1], dtype=U64)


def _states(rng, n):
    """n random 12-lane states, then every lane at each edge value, then the
    edge values mixed across the lanes."""
    st = rng.integers(0, 2**64 - 1, (n, 12), dtype=U64, endpoint=True)
    edge_rows = np.repeat(EDGE[:, None], 12, axis=1)
    mixed = EDGE[(np.arange(12)[None, :] + np.arange(5)[:, None]) % 5]
    return np.ascontiguousarray(np.concatenate([st, edge_rows, mixed]))


def test_mds_freq_matches_host(lib):
    st = _states(np.random.default_rng(14), 500)
    got = st.copy()
    lib.shim_mds_freq(_ptr(got), ctypes.c_long(st.shape[0]))
    assert np.array_equal(_ref_mod(got), jpos._mds_layer(_ref_mod(st)))


# the team sizes the kernel runs: 1 and 4 in the sponge, 4 and 12 in the
# tree levels above a block's first
@pytest.mark.parametrize("team", [1, 4, 12])
def test_team_mds_and_permutation_match_host(lib, team):
    st = _states(np.random.default_rng(15 + team), 200)
    got = st.copy()
    assert lib.shim_team(_ptr(got), ctypes.c_long(st.shape[0]), team, -1) == 0
    assert np.array_equal(_ref_mod(got), jpos._mds_layer(_ref_mod(st)))
    got = st.copy()
    assert lib.shim_team(_ptr(got), ctypes.c_long(st.shape[0]), team, 30) == 0
    assert np.array_equal(_ref_mod(got), jpos.permute(_ref_mod(st)))


def test_freq_blocks_are_small_shifts():
    """The frequency-domain coefficients are 0 or +-2^k with |c| <= 32, so
    the MDS in poseidon_mds_freq needs no multiplies."""
    for vals in poseidon_cuda.freq_blocks().values():
        for v in vals:
            assert v == 0 or (abs(v) <= 32 and abs(v) & (abs(v) - 1) == 0), v


@pytest.mark.parametrize("log_n,cap_height,rows,cols", [
    (8, 0, 64, 5), (8, 2, 128, 8), (8, 4, 256, 32), (8, 4, 16, 9),
    (10, 0, 128, 139), (10, 2, 32, 8), (10, 4, 128, 24), (10, 4, 1024 // 4, 5)])
def test_subtree_index_arithmetic_matches_merkle_build(lib, log_n, cap_height, rows, cols):
    n = 1 << log_n
    rng = np.random.default_rng(log_n * 100 + cap_height * 10 + cols)
    leaves = np.ascontiguousarray(rng.integers(0, P, (n, cols), dtype=U64))
    plan = poseidon_cuda.tree_plan(n, cap_height, rows=rows)
    out = np.zeros((sum(plan["sizes"]), 4), dtype=U64)
    lib.shim_tree(_ptr(leaves), ctypes.c_longlong(n), cols, rows, plan["in_block"],
                  plan["depth"], 1, ctypes.c_longlong(0), ctypes.c_longlong(0), _ptr(out))
    want = MerkleTree.build(leaves, cap_height).levels
    got = np.split(out, np.cumsum(plan["sizes"])[:-1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("batch,log_n,cap_height,rows,cols", [
    (3, 6, 2, 16, 12), (4, 8, 4, 128, 9), (2, 8, 0, 256, 32), (5, 5, 1, 64, 139),
    (4, 12, 4, 128, 32)])
def test_batched_subtree_index_arithmetic_matches_merkle_builds(lib, batch, log_n,
                                                                cap_height, rows, cols):
    """B trees in one tree launch and one top launch, the blocks run one at
    a time: tree b equals MerkleTree.build of matrix b.  The matrices sit
    a padded stride apart, as a strided batch does; rows per block at most
    n (the wrapper's clamp), or above it (each matrix then one block)."""
    n = 1 << log_n
    rng = np.random.default_rng(batch * 1000 + log_n * 10 + cols)
    in_bstride = n * cols + 3
    buf = np.ascontiguousarray(rng.integers(0, P, batch * in_bstride, dtype=U64))
    leaves = [buf[b * in_bstride : b * in_bstride + n * cols].reshape(n, cols)
              for b in range(batch)]
    plan = poseidon_cuda.tree_plan(n, cap_height, rows=rows)
    out_bstride = 4 * sum(plan["sizes"])
    out = np.zeros(batch * out_bstride, dtype=U64)
    lib.shim_tree(_ptr(buf), ctypes.c_longlong(n), cols, rows, plan["in_block"],
                  plan["depth"], batch, ctypes.c_longlong(in_bstride),
                  ctypes.c_longlong(out_bstride), _ptr(out))
    for b in range(batch):
        tree = out[b * out_bstride : (b + 1) * out_bstride].reshape(-1, 4)
        got = np.split(tree, np.cumsum(plan["sizes"])[:-1])
        want = MerkleTree.build(leaves[b], cap_height).levels
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
