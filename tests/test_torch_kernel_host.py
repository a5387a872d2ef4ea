"""The arithmetic the CUDA kernels run, built for the host.

csrc/goldilocks.cuh, csrc/poseidon.cuh and csrc/block_exchange.cuh are
__host__ __device__ code; here they are compiled with g++ behind small C
shims and checked against the numpy golden models (host/gl.py,
host/poseidon.py) of both packages, so the field, permutation and index
code is tested before any card runs it.  K1: both forms of the MDS layer,
the thread-team permutation (the T threads of a team run in turn, arrays
in place of the warp shuffles) and the Merkle subtree index arithmetic
(the tree kernel's blocks run one at a time).  K2: the shift-form DFT,
the twiddle and interleave index maps, and the copy's tile walk (its
blocks run one at a time).  K3: the witness walk (see K3_SHIM).  K4
(csrc/ntt.cuh behind ntt.cu's C interface): the row path's blocks and
both four-step passes tile by tile, every mode, through the wrapper's
``ntt_cuda.transform``, against both packages' host NTTs; its leaf mode
(``ntt_cuda.coset_leaves``: two components in, fiber leaves out) against
``fri/fri_device.py``'s ``_fiber_leaves(*_ext_coset_ntt_dev(...))``.
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


# --- K2: the block exchange's index and field code (csrc/block_exchange.cuh) ---

BX_SHIM = r"""
#include <stddef.h>
#include "block_exchange.cuh"
// Every column (element, output) of every destination, as the kernel's
// threads run them (EC: the shard count as a template argument, or 0 at
// run time).
template <int EC>
static void bx_fused(const BxCall* c) {
  for (int j = 0; j < c->n_dst; j++) {
    const int d = c->dst_index[j];
    const uint64_t* lo = bx_twiddle_table(*c, d);
    for (long long i = 0; i < c->bm; i++) {
      if (c->mode == BX_DFT) {
        bx_dft_column<EC>(*c, j, i);
      } else if (c->mode == BX_TWIDDLE) {
        for (int s = 0; s < c->n_src; s++)
          c->dst[j][s * c->bm + i] = bx_twiddle_apply(*c, lo, s, i, c->src[s][d * c->bm + i]);
      } else {
        for (int t1 = 0; t1 < c->n_src; t1++) {
          const long long o = i * c->n_src + t1;
          c->dst[j][o] = bx_interleave_value(*c, *bx_interleave_from<EC>(*c, d, o));
        }
      }
    }
  }
}
// The copy's tile walk at tiles of TILE elements, block by block (one block
// a tile, as the kernel launches): each tile's body in 16-byte units (the
// kernel's ulonglong2 loads and stores, which need 16-byte aligned ends),
// head and tail element by element.
template <int TILE>
static int bx_copy(const BxCall* c) {
  const long long n = bx_num_tiles<TILE>(*c);
  for (long long b = 0; b < n; b++) {
    const BxTile tile = bx_tile<TILE>(*c, (unsigned)b);
    if (tile.body) {
      if (((unsigned long long)(tile.src + tile.head) & 15) ||
          ((unsigned long long)(tile.dst + tile.head) & 15) || tile.body % 2)
        return -1;
      for (long long k = tile.head; k < tile.head + tile.body; k += 2) {
        tile.dst[k] = tile.src[k];
        tile.dst[k + 1] = tile.src[k + 1];
      }
    }
    for (long long k = 0; k < tile.head; k++) tile.dst[k] = tile.src[k];
    for (long long k = tile.head + tile.body; k < tile.len; k++) tile.dst[k] = tile.src[k];
  }
  return 0;
}
extern "C" {
long shim_bx_layout(long* out) {
  out[0] = offsetof(BxCall, table);
  out[1] = offsetof(BxCall, scale);
  out[2] = offsetof(BxCall, dst_index);
  out[3] = offsetof(BxCall, tw_log);
  out[4] = offsetof(BxCall, wshift);
  return (long)sizeof(BxCall);
}
void shim_mul_pow2(const uint64_t* x, const int* k, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_mul_pow2(x[i], k[i]);
}
int shim_bx_fused(const BxCall* c, int ec) {
  if (c->mode < BX_DFT || c->mode > BX_INTERLEAVE) return -1;
  switch (ec) {
    case 0: bx_fused<0>(c); return 0;
    case 2: bx_fused<2>(c); return 0;
    case 4: bx_fused<4>(c); return 0;
    case 8: bx_fused<8>(c); return 0;
    default: return -1;
  }
}
int shim_bx_copy(const BxCall* c, int tile) {
  switch (tile) {
    case 2048: return bx_copy<2048>(c);
    case 6: return bx_copy<6>(c);
    case 8: return bx_copy<8>(c);
    case 2: return bx_copy<2>(c);
    default: return -2;
  }
}
}
"""


@pytest.fixture(scope="module")
def bx_lib():
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"bx_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "bx_shim.cc"
    src.write_text(BX_SHIM)
    so = build / "libbxshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(nvcc.CSRC),
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.shim_bx_layout.restype = ctypes.c_long
    lib.shim_bx_fused.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.shim_bx_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    yield lib
    shutil.rmtree(build, ignore_errors=True)


def test_bx_call_mirror_matches_header(bx_lib):
    """The wrapper's ctypes BxCall has the header's size and offsets."""
    from zk_circuits_torch.parallel.exchange_cuda import _Call

    offsets = np.zeros(5, dtype=np.int64)
    size = bx_lib.shim_bx_layout(_ptr(offsets))
    assert size == ctypes.sizeof(_Call)
    assert offsets.tolist() == [getattr(_Call, f).offset for f in
                                ("table", "scale", "dst_index", "tw_log", "wshift")]


def test_mul_pow2_matches_host(bx_lib):
    """x * 2^k for every k < 192 (the DFT's shift form), edge inputs
    non-canonical ones included, against host/gl.py's product."""
    x = _edge_and_random(np.random.default_rng(21), 200)
    xs = np.repeat(x, 192)
    ks = np.tile(np.arange(192, dtype=np.int32), x.size)
    out = np.empty_like(xs)
    bx_lib.shim_mul_pow2(_ptr(xs), _ptr(ks), _ptr(out), ctypes.c_long(xs.size))
    pows = np.array([pow(2, int(k), P) for k in range(192)], dtype=U64)
    assert np.array_equal(out, jgl.mul(_ref_mod(xs), pows[ks]))


def _bx_call(mode, srcs, dsts, **fields):
    """A BxCall over numpy sources/destinations (every destination served,
    j = d)."""
    from zk_circuits_torch.parallel import exchange_cuda as xc

    c = xc._Call()
    c.mode, c.n_src, c.n_dst = xc.MODES.index(mode), len(srcs), len(dsts)
    for s, a in enumerate(srcs):
        c.src[s] = a.ctypes.data
    for d, a in enumerate(dsts):
        c.dst[d], c.dst_index[d] = a.ctypes.data, d
    for k, v in fields.items():
        if k == "wshift":
            ctypes.memmove(c.wshift, v, len(v))
        else:
            setattr(c, k, v)
    return c


def _fused_inputs(e, bm, seed, canonical=False):
    x = np.random.default_rng(seed).integers(0, 2**64 - 1, (e, e * bm), dtype=U64,
                                             endpoint=True)
    x[:, :4] = np.array([0, 1, P - 1, 2**64 - 1], dtype=U64)[: min(4, e * bm)]
    return _ref_mod(x) if canonical else x


@pytest.mark.parametrize("e,bm", [(2, 5), (4, 8), (4, 3), (8, 2), (16, 2), (32, 1)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_dft_mode_matches_host_products(bx_lib, e, bm, inverse):
    """dft's shift form, as the FFT (E <= 8) and as the direct sum over W, against
    the DFT of host/gl.py products over the exchanged blocks, inputs with
    p-1 and 2^64-1 (a non-canonical input counts as its residue)."""
    from zk_circuits_torch.parallel import exchange_cuda as xc
    from zk_circuits_tpu.parallel.ntt_sharded import _dft_matrix_e as jdft

    x = _fused_inputs(e, bm, e * 10 + bm + inverse)
    shifts = xc._dft_shifts(e, inverse)
    w = jdft(e, inverse)
    assert np.array_equal(np.array([pow(2, k, P) for k in shifts], dtype=U64).reshape(e, e), w)
    out = [np.zeros((e, bm), dtype=U64) for _ in range(e)]
    c = _bx_call("dft", list(x), out, bm=bm, inverse=int(inverse), wshift=shifts)
    for ec in (0, e) if e <= 8 else (0,):   # the direct sum over W, the FFT
        for o in out:
            o[:] = 0
        assert bx_lib.shim_bx_fused(ctypes.byref(c), ec) == 0
        xm = _ref_mod(x)
        for d in range(e):
            for t1 in range(e):
                want = np.zeros(bm, dtype=U64)
                for s in range(e):
                    want = jgl.add(want, jgl.mul(xm[s, d * bm:(d + 1) * bm], w[s, t1]))
                assert np.array_equal(out[d][t1], want), (d, t1, ec)


@pytest.mark.parametrize("e,m", [(2, 8), (4, 16), (4, 64), (8, 64)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_twiddle_and_interleave_maps_match_host(bx_lib, e, m, inverse):
    """twiddle: out_d[s bm + i] = y_s[d, i] * T[d, s bm + i] with T the JAX
    package's twiddle matrix (the kernel's two-table factor); interleave:
    out_d[i E + t1] = z_t1[d bm + i], the inverse reversed and times n^-1."""
    from zk_circuits_torch.parallel import exchange_cuda as xc
    from zk_circuits_tpu.parallel.ntt_sharded import _twiddle_matrix as jtw

    n, bm = e * m, m // e
    y = _fused_inputs(e, bm, n + inverse, canonical=True)
    log, table = xc._twiddle_tables(n, e, inverse, "cpu")
    tab = table.numpy()
    out = [np.zeros(m, dtype=U64) for _ in range(e)]
    c = _bx_call("twiddle", list(y), out, bm=bm, inverse=int(inverse), tw_log=log,
                 table=tab.ctypes.data)
    assert bx_lib.shim_bx_fused(ctypes.byref(c), 0) == 0
    t = jtw(n, e, inverse)
    for d in range(e):
        got = np.concatenate([y[s, d * bm:(d + 1) * bm] for s in range(e)])
        assert np.array_equal(out[d], jgl.mul(got, t[d])), d

    z = _fused_inputs(e, bm, n + 7 + inverse, canonical=True)
    n_inv = int(jgl.inverse(U64(n)))
    for ec in (0, e):
        out = [np.zeros(m, dtype=U64) for _ in range(e)]
        c = _bx_call("interleave", list(z), out, bm=bm, inverse=int(inverse),
                     scale=n_inv if inverse else 1)
        assert bx_lib.shim_bx_fused(ctypes.byref(c), ec) == 0
        for d in range(e):
            for i in range(bm):
                k = d * bm + i
                src = (m - k) % m if inverse else k
                want = z[:, src]
                if inverse:
                    want = jgl.mul(want, U64(n_inv))
                assert np.array_equal(out[d][i * e:(i + 1) * e], want), (d, i, ec)


def _aligned(n, offset):
    """n u64 starting ``offset`` elements past a 16-byte boundary."""
    buf = np.zeros(n + 4, dtype=U64)
    start = (-(buf.ctypes.data // 8)) % 2 + offset
    return buf[start:start + n]


COPY_LAYOUTS = ["blocks-even", "blocks-odd", "reshard", "fibers", "odd-rows", "offset-source"]


@pytest.mark.parametrize("layout", COPY_LAYOUTS)
@pytest.mark.parametrize("tile", [2048, 6, 8, 2])
def test_copy_tile_walk_matches_exchange_plain(bx_lib, layout, tile):
    """The copy's tiles run block by block on the host (bodies in 16-byte
    units as the kernel moves them, ragged ends element by element) against
    exchange_plain: contiguous blocks with B even and odd, the strided
    views of a commit re-shard and a fiber regroup, odd rows, and a source
    8 bytes off a 16-byte boundary."""
    import torch

    from zk_circuits_torch.parallel import exchange_cuda as xc

    e = 4
    rng = np.random.default_rng(COPY_LAYOUTS.index(layout) * 100 + tile)
    shapes = {"blocks-even": (e, 1, 26), "blocks-odd": (e, 1, 27), "reshard": (3, e * 10),
              "fibers": (2, e, 6), "odd-rows": (3, e * 7), "offset-source": (e, 1, 20)}
    shape = shapes[layout]
    size = int(np.prod(shape))
    bases = [_aligned(size, 1 if layout == "offset-source" else 0) for _ in range(e)]
    views = []
    for b in bases:
        b[:] = rng.integers(0, 2**64 - 1, size, dtype=U64, endpoint=True)
        t = torch.from_numpy(b.view(np.int64)).reshape(shape)
        if layout in ("reshard", "odd-rows"):
            t = t.reshape(shape[0], e, -1).permute(1, 0, 2)
        elif layout == "fibers":
            t = t.permute(1, 0, 2)
        views.append(t)
    want = xc.exchange_plain(views)
    _, rows, row_len = views[0].shape
    outs = [_aligned(e * rows * row_len, 0) for _ in range(e)]
    st = views[0].stride()
    c = _bx_call("copy", [b for b in bases], outs, blk_stride=st[0], row_stride=st[1],
                 rows=rows, row_len=row_len)
    assert bx_lib.shim_bx_copy(ctypes.byref(c), tile) == 0
    for d in range(e):
        assert np.array_equal(outs[d], want[d].numpy().view(U64).ravel()), d


# ---------------------------------------------------------------------------
# K3: csrc/witness.cuh behind a shim with witness.cu's C interface, the
# walk's blocks run one at a time, a level's threads in turn and a
# Poseidon level's team threads round by round
# ---------------------------------------------------------------------------

K3_SHIM = r"""
#include <vector>
#include "witness.cuh"
static const uint64_t RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;

static const int THREADS = 256;  // a walk block (witness.cu, K3_WALK_THREADS)

// A Poseidon level by teams of T of a walk block, numbered as on the card
// (warp by warp, 32 / T teams a warp): each team's T threads run in turn,
// round by round, with arrays in place of the warp shuffles.
template <int T>
static void walk_poseidon(const K3Level& d, uint64_t* v, uint64_t* w, long long n) {
  constexpr int L = POSEIDON_WIDTH / T, H = POSEIDON_HALF_FULL, R = POSEIDON_ROUNDS;
  constexpr int PER_WARP = 32 / T;
  for (long long g0 = 0; g0 < d.m; g0 += THREADS / 32 * PER_WARP)
    for (int warp = 0; warp < THREADS / 32; warp++)
      for (int q = 0; q < PER_WARP; q++) {  // the team of threads tid .. tid + T - 1
        const int tid = warp * 32 + q * T;
        const long long g = g0 + k3_team_index(tid, T);
        const bool act = g < d.m;
        uint64_t* trace = act ? w + K3_START_DELTA * n + d.rows[g] : w;
        uint64_t s[T][L], x[T][POSEIDON_WIDTH];
        for (int j = 0; j < T; j++) k3_gate_start<T>(d, g, j, act, v, s[j], trace, n);
        for (int r = 0; r < R; r++) {
          for (int j = 0; j < T; j++) {
            if (r < H || r >= R - H)
              k3_gate_round<T, true>(s[j], j, r, RC, act, trace, n);
            else
              k3_gate_round<T, false>(s[j], j, r, RC, act, trace, n);
          }
          for (int j = 0; j < T; j++) {
            for (int e = 0; e < L; e++) x[j][e * T] = s[j][e];
            for (int dd = 1; dd < T; dd++) {
              int src = (j + dd) % T;  // the shuffle's source thread
              for (int e = 0; e < L; e++) x[j][dd + e * T] = team_provide<T>(s[src], src, dd, e);
            }
          }
          for (int j = 0; j < T; j++) poseidon_mds_rows<T>(j, x[j], s[j]);
        }
        for (int j = 0; j < T; j++) k3_gate_end<T>(d, g, j, act, s[j], v);
      }
}

static int team = 4;  // the card's team size; the tests also run the header's others

extern "C" {
void shim_k3_set_team(int t) { team = t; }
void shim_k3_inverse(const uint64_t* a, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = k3_inverse(a[i]);
}
int k3_walk(const int64_t* blob, long long levels, int first, int last, uint64_t* values,
            long long vstride, uint64_t* wires, long long wstride, long long n, int batch,
            void*) {
  if (team != 1 && team != 4 && team != 12) return 1;
  std::vector<K3Fetch> f(THREADS), fnext(THREADS);
  const int64_t* recs = blob + levels;
  for (int b = 0; b < batch; b++) {  // the grid: block b on proof b
    uint64_t* v = values + b * vstride;
    uint64_t* w = wires + b * wstride;
    K3Level d, next;
    for (int t = 0; t < THREADS; t++)
      k3_prefetch(blob, recs + first * K3_LEVEL_FIELDS, first, last, t, d, f[t]);
    for (int l = first; l < last; l++) {
      for (int t = 0; t < THREADS; t++)  // the next level's rows, before this level's work
        k3_prefetch(blob, recs + (l + 1) * K3_LEVEL_FIELDS, l + 1, last, t, next, fnext[t]);
      if (d.kind == K3_POSEIDON) {
        if (team == 12)
          walk_poseidon<12>(d, v, w, n);
        else if (team == 4)
          walk_poseidon<4>(d, v, w, n);
        else
          walk_poseidon<1>(d, v, w, n);
      } else {
        for (int t = 0; t < THREADS; t++) k3_level_ops(d, t, THREADS, f[t], v);
      }
      d = next;  // the barrier
      f.swap(fnext);
    }
  }
  return 0;
}
int k3_ops(const int64_t* blob, long long rec, long long m, uint64_t* values, long long vstride,
           int batch, void*) {
  const K3Level d = k3_level(blob, blob + rec);
  for (int b = 0; b < batch; b++)  // the grid's y, then its threads
    for (long long i = 0; i < m; i++) {
      K3Fetch f;
      k3_fetch(d, i, f);
      k3_apply(d, i, f, values + b * vstride);
    }
  return 0;
}
int k3_cells(long long ncells, const int64_t* cell_pos, const int64_t* cell_rep, long long npis,
             const int64_t* pi_rep, const uint64_t* values, long long vstride, uint64_t* wires,
             long long wstride, uint64_t* pis, int batch, void*) {
  for (int b = 0; b < batch; b++)
    for (long long t = 0; t < ncells + npis; t++)
      k3_cell(t, ncells, cell_pos, cell_rep, npis, pi_rep, values + b * vstride,
              wires + b * wstride, pis + b * npis);
  return 0;
}
}
"""

# The walk's team of 4 threads a Poseidon gate (csrc/witness.cu), and
# the header's other team sizes.
K3_TEAMS = (1, 4, 12)


@pytest.fixture(scope="module")
def k3_lib():
    from zk_circuits_torch.iop import witness_cuda

    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"k3_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    poseidon_cuda.write_constants_header(build)
    src = build / "k3_shim.cc"
    src.write_text(K3_SHIM)
    so = build / "libk3shim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(nvcc.CSRC),
                    "-I", str(build), "-o", str(so), str(src)], check=True)
    lib = witness_cuda.bind(ctypes.CDLL(str(so)))   # the wrapper's declarations
    yield lib
    shutil.rmtree(build, ignore_errors=True)


def _canonical_edges(rng, n):
    edge = np.array([0, 1, 2, 7, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P - 2**32],
                    dtype=U64)
    return np.concatenate([edge, rng.integers(0, P, n, dtype=U64)])


def test_k3_inverse_matches_host(k3_lib):
    """The Fermat inverse, 0 to 0, against host/gl.py."""
    a = _canonical_edges(np.random.default_rng(31), 500)
    out = np.empty_like(a)
    k3_lib.shim_k3_inverse(_ptr(a), _ptr(out), ctypes.c_long(a.size))
    assert np.array_equal(out, jgl.inverse(a))
    assert out[0] == 0 and out[1] == 1 and out[4] == P - 1
    assert np.array_equal(jgl.mul(out[1:], a[1:]), np.ones(a.size - 1, dtype=U64))


def _level_blob(kind, ins, outs, consts=(), nbits=0, rows=()):
    """One schedule level as WitnessTable lays it out for the walk: its
    arrays, then its record (witness_device.LEVEL_FIELDS).  Returns the
    blob and the record's offset."""
    from zk_circuits_torch.iop import witness_device as wdev

    parts, offs = [], []
    for a in (ins, outs, consts, rows):
        offs.append(sum(p.size for p in parts))
        parts.append(np.asarray(a).astype(U64).view(np.int64).ravel())
    ins, outs = np.asarray(ins), np.asarray(outs)
    record = [wdev.KINDS[kind], ins.shape[0], nbits, ins.shape[1], outs.shape[1], *offs]
    assert len(record) == len(wdev.LEVEL_FIELDS)
    blob = np.concatenate([*parts, np.array(record, np.int64)])
    return np.ascontiguousarray(blob), blob.size - len(record)


def _walk(k3_lib, blob, levels_off, nlevels, values, wires, n, team=4):
    """k3_walk over levels [0, nlevels) of every value table of ``values``
    (B, R), into ``wires`` (B, W * n), a Poseidon gate on a team of
    ``team``; returns the updated tables."""
    v = values.copy()
    k3_lib.shim_k3_set_team(team)
    try:
        assert k3_lib.k3_walk(_ptr(blob), levels_off, 0, nlevels, _ptr(v), v.shape[1],
                              _ptr(wires), wires.shape[1], n, v.shape[0], None) == 0
    finally:
        k3_lib.shim_k3_set_team(4)
    return v


@pytest.mark.parametrize("kind", ["const", "arith", "arith_ext", "eq_inv", "ext_inv",
                                  "base_sum", "random_access"])
def test_k3_op_kinds_match_host(k3_lib, kind):
    """The walk over one level of each op kind, on two value tables (edge
    values first), and the level as one k3_ops launch, against host/gl.py
    and host/gle.py: inputs read from reps below 100, outputs written to
    reps 100 and up.  600 ops, so that a walk block of 256 threads runs
    three passes, the last one part idle."""
    from zk_circuits_tpu.host import gle as jgle

    rng = np.random.default_rng(list(KINDS_K3).index(kind))
    m = 600
    values = np.zeros((2, 100 + m * 64), dtype=U64)
    values[0, :100] = _canonical_edges(rng, 90)
    values[1, :100] = rng.integers(0, P, 100, dtype=U64)
    k_in, k_out, nbits = KINDS_K3[kind]
    ins = rng.integers(0, 100, (m, k_in))
    ins[:10] = np.arange(10 * k_in).reshape(10, k_in) % 10      # edge operands
    outs = 100 + np.arange(m * k_out).reshape(m, k_out)
    consts = np.zeros(0, U64)
    if kind == "random_access":
        values[:, :4] = [0, 1, 2, 3]
        ins[:, 0] = rng.integers(0, 4, m)
    if kind in ("arith", "arith_ext"):
        consts = np.stack([_canonical_edges(rng, m - 10), _canonical_edges(rng, m - 10)])
    elif kind == "const":
        consts = rng.integers(0, P, (m, k_out), dtype=U64)
    blob, off = _level_blob(kind, ins, outs, consts, nbits)
    for b in range(2):
        g = values[b][ins]
        if kind == "const":
            want = consts
        elif kind == "arith":
            want = jgl.add(jgl.mul(consts[0], jgl.mul(g[:, 0], g[:, 1])),
                           jgl.mul(consts[1], g[:, 2]))[:, None]
        elif kind == "arith_ext":
            want = jgle.add(jgle.mul_base(jgle.mul(g[:, 0:2], g[:, 2:4]), consts[0]),
                            jgle.mul_base(g[:, 4:6], consts[1]))
        elif kind == "eq_inv":
            want = jgl.inverse(g)
        elif kind == "ext_inv":
            want = jgle.inverse(g)
        elif kind == "base_sum":
            want = (g >> np.arange(nbits, dtype=U64)) & U64(1)
        else:
            idx = g[:, 0].astype(np.int64)
            want = np.concatenate([g[np.arange(m), 1 + idx][:, None],
                                   (g[:, :1] >> np.arange(nbits, dtype=U64)) & U64(1)], axis=1)
        got = _walk(k3_lib, blob, off, 1, values, np.zeros((2, 1), U64), 0)
        assert np.array_equal(got[b][outs], want), b
        assert np.array_equal(got[b][:100], values[b][:100])
        got = values.copy()                  # the same level as one k3_ops launch
        assert k3_lib.k3_ops(_ptr(blob), off, m, _ptr(got), got.shape[1], 2, None) == 0
        assert np.array_equal(got[b][outs], want), b
        assert np.array_equal(got[b][:100], values[b][:100])


# (inputs, outputs, bits) an op of each kind; base_sum takes all 64 bits
KINDS_K3 = {"const": (0, 3, 0), "arith": (3, 1, 0), "arith_ext": (6, 2, 0),
            "eq_inv": (1, 1, 0), "ext_inv": (2, 2, 0), "base_sum": (1, 64, 64),
            "random_access": (5, 3, 2)}


@pytest.mark.parametrize("team", K3_TEAMS)
def test_k3_poseidon_trace_matches_host(k3_lib, team):
    """The walk over one Poseidon level, a team of ``team`` threads a
    gate: each gate's trace column by column (deltas, full rounds 1-3,
    the partial rounds' lane 0, the last four full rounds) at its row of
    the wire matrix, and its outputs, with edge inputs and both swap
    values, against the JAX package's host trace
    (iop/witness.py::_poseidon_trace).  300 gates in blocks of 256 threads:
    every team runs more than one pass, the last one part idle."""
    from zk_circuits_tpu.iop.witness import _poseidon_trace

    rng = np.random.default_rng(41 + team)
    m = 300
    inputs = _canonical_edges(rng, 12 * m - 10).reshape(m, 12)
    inputs[-1] = 0
    inputs[-2] = P - 1
    swap = (np.arange(m) % 2).astype(U64)
    values = np.concatenate([inputs, swap[:, None]], axis=1).reshape(1, -1)
    values = np.concatenate([values, np.zeros((1, 12 * m), U64)], axis=1)
    ins = np.arange(13 * m).reshape(m, 13)
    outs = 13 * m + np.arange(12 * m).reshape(m, 12)
    rows = rng.permutation(m)            # gate i's row of the wire matrix
    n, num_wires = m, 25 + 110
    blob, off = _level_blob("poseidon", ins, outs, rows=rows)
    wires = np.zeros((1, num_wires * n), U64)
    got = _walk(k3_lib, blob, off, 1, values, wires, n, team)
    outputs, *blocks = _poseidon_trace(inputs, swap)
    assert np.array_equal(got[0, 13 * m:].reshape(m, 12), outputs)
    trace = wires.reshape(num_wires, n)[25:, rows].T
    assert np.array_equal(trace, np.concatenate(blocks, axis=1))
    assert not wires.reshape(num_wires, n)[:25].any()


def _k3_small(name):
    """The kinds or chain circuit built by the port on the CPU, its table
    and seeded value tables (a batch of distinct witnesses)."""
    import chip_smoke

    from zk_circuits_torch.iop import builder as t_builder
    from zk_circuits_torch.iop import witness as t_witness
    from zk_circuits_torch.iop import witness_device as wdev
    from zk_circuits_torch.plonk.config import CircuitConfig

    b = t_builder.CircuitBuilder(CircuitConfig.standard_recursion_config())
    if name == "kinds":
        targets, seeds = chip_smoke.kinds_circuit(b, t_builder.GeneratorOp), chip_smoke.KINDS_SEEDS
    else:
        targets, seeds = chip_smoke.chain_circuit(b), ((12345, 67890), (1, P - 1))
    data = b.build(device="cpu")
    pws = [chip_smoke.seed(t_witness.PartialWitness, targets, v) for v in seeds]
    table = wdev.WitnessTable(data, "cpu")
    return data, pws, table, table.seeded_values(*wdev.seed_batch(data, pws))


def _k3_outputs(table, values):
    import torch

    b = values.shape[0]
    return (torch.zeros((b, table.num_wires, table.n), dtype=torch.int64),
            torch.empty((b, table.pi_reps.numel()), dtype=torch.int64))


@pytest.mark.parametrize("name", ["kinds", "chain"])
def test_k3_schedule_matches_host_witness(k3_lib, name, monkeypatch):
    """witness_cuda.launch_schedule (one walk over the device table's
    level records, the folded cell scatter) through the host build of
    K3, for a batch of witnesses, and with every level but the Poseidon
    ones split out as k3_ops launches (WIDE_OPS patched to 0; the small
    circuits' levels are a few ops each): each wire matrix and public
    input vector equal to the host witness's and the plain version's."""
    import torch

    from zk_circuits_torch.iop import witness as t_witness
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop import witness_device as wdev

    data, pws, table, values = _k3_small(name)
    plain_w, plain_p = wdev.witness_plain(table, values.clone())
    for wide_ops in (witness_cuda.WIDE_OPS, 0):
        monkeypatch.setattr(witness_cuda, "WIDE_OPS", wide_ops)
        table.launch_plans.clear()
        v = values.clone()
        wires, pis = _k3_outputs(table, v)
        done = witness_cuda.launch_schedule(k3_lib, table, v, wires, pis, None)
        levels = [(st.kind, st.m) for st in table.steps]
        launches = witness_cuda.plan(levels, 0, len(levels))
        assert done == [(k, 0) for k, _, _ in launches] + [("cells", 0)]
        assert ("ops", 0) in done if wide_ops == 0 else len(done) == 2
        assert torch.equal(wires, plain_w) and torch.equal(pis, plain_p), wide_ops
    for i, pw in enumerate(pws):
        host_w, host_p = t_witness.generate_witness(data, pw)
        assert np.array_equal(wires[i].numpy().view(U64), host_w.T), i
        assert np.array_equal(pis[i].numpy().view(U64), host_p), i


def test_k3_walk_split_at_every_level_matches_whole(k3_lib):
    """The walk over [0, i) and then [i, L) (and the cells) equals the
    walk over [0, L) at every split i of the chain circuit's schedule; an
    empty range launches nothing, and a range past the schedule raises."""
    import torch

    from zk_circuits_torch.iop import witness_cuda

    _, _, table, values = _k3_small("chain")
    nlevels = len(table.steps)
    kinds = {st.kind for st in table.steps}
    assert nlevels > 10 and {"poseidon", "arith_ext"} <= kinds
    whole_w, whole_p = _k3_outputs(table, values)
    whole_v = values.clone()
    witness_cuda.launch_schedule(k3_lib, table, whole_v, whole_w, whole_p, None)
    for i in range(nlevels + 1):
        v = values.clone()
        wires, pis = _k3_outputs(table, v)
        head = witness_cuda.launch_schedule(k3_lib, table, v, wires, pis, None, 0, i,
                                            cells=False)
        tail = witness_cuda.launch_schedule(k3_lib, table, v, wires, pis, None, i)
        assert [k for k, _ in head + tail] == ["walk"] * (0 < i) + ["walk"] * (i < nlevels) \
            + ["cells"]
        assert torch.equal(v, whole_v) and torch.equal(wires, whole_w), i
        assert torch.equal(pis, whole_p), i
    with pytest.raises(ValueError, match="outside the schedule"):
        witness_cuda.launch_schedule(k3_lib, table, values.clone(), wires, pis, None, 0,
                                     nlevels + 1)


def test_k3_plan_splits_out_wide_levels():
    """A level of more than WIDE_OPS (1024) ops, not a Poseidon level, is
    an ops launch of its own, and each run of levels between them one
    walk."""
    from zk_circuits_torch.iop.witness_cuda import WIDE_OPS, plan

    assert WIDE_OPS == 1024
    levels = [("base_sum", 3776), ("const", 93), ("arith", 18320), ("poseidon", 2000),
              ("arith", 80), ("eq_inv", 1025), ("arith", 1024)]
    assert plan(levels, 0, 7) == [("ops", 0, 1), ("walk", 1, 2), ("ops", 2, 3),
                                  ("walk", 3, 5), ("ops", 5, 6), ("walk", 6, 7)]
    assert plan(levels, 1, 5) == [("walk", 1, 2), ("ops", 2, 3), ("walk", 3, 5)]
    assert plan(levels, 3, 7) == [("walk", 3, 5), ("ops", 5, 6), ("walk", 6, 7)]
    assert plan(levels, 3, 3) == []


@pytest.mark.parametrize("name", ["kinds", "chain"])
def test_k3_level_records_match_steps(name):
    """Each level record of the device table holds its Step's kind, op
    count, bit count, row widths and the blob offsets of its views."""
    from zk_circuits_torch.iop import witness_device as wdev

    _, _, table, _ = _k3_small(name)
    assert table.levels.shape == (len(table.steps), len(wdev.LEVEL_FIELDS))
    assert table.levels.storage_offset() == table.levels_off
    for rec, st in zip(table.levels.tolist(), table.steps, strict=True):
        rec = dict(zip(wdev.LEVEL_FIELDS, rec, strict=True))
        assert (rec["kind"], rec["m"], rec["nbits"]) == (wdev.KINDS[st.kind], st.m, st.nbits)
        assert (rec["k_in"], rec["k_out"]) == (st.ins.shape[1], st.outs.shape[1])
        for field in ("ins", "outs", "consts", "rows"):
            view = getattr(st, field)
            assert rec[field] == view.storage_offset(), field
            flat = table.blob[rec[field] : rec[field] + view.numel()]
            assert flat.data_ptr() == view.data_ptr() or view.numel() == 0
            assert flat.tolist() == view.reshape(-1).tolist(), field


# ---------------------------------------------------------------------------
# K4: the NTT kernel (csrc/ntt.cuh behind ntt.cu's C interface)
# ---------------------------------------------------------------------------

K4_SHIM = r"""
#include <vector>
#include "ntt.cuh"

static int shim_sms = 4;   // the SM count the wrapper's tile plan reads

// One block on the host: its threads one after another in each phase, each
// thread's K4_V values kept between the phases (k4_block runs them in the
// kernel's order; a barrier is the end of a phase).
struct ShimBlock {
  const K4Call& c;
  int pass;
  K4Tile t;
  uint64_t* sm;
  int nthr;
  std::vector<uint64_t> regs;

  uint64_t* v(int tid) { return regs.data() + (std::size_t)tid * K4_V; }
  template <int B>
  void begin() {
    for (int tid = 0; tid < nthr; tid++) k4_begin_r<B>(c, pass, t, v(tid), tid, nthr);
  }
  template <int B>
  void put(int r) {
    for (int tid = 0; tid < nthr; tid++) k4_put_r<B>(c, pass, t, sm, r, v(tid), tid, nthr);
  }
  template <int B>
  void get(int r) {
    for (int tid = 0; tid < nthr; tid++) k4_get_r<B>(c, pass, t, sm, r, v(tid), tid, nthr);
  }
  template <int B>
  void store() {
    for (int tid = 0; tid < nthr; tid++) k4_store_r<B>(c, pass, t, sm, v(tid), tid, nthr);
  }
  void flush() {
    for (int tid = 0; tid < nthr; tid++) k4_flush(c, pass, t, sm, v(tid), tid, nthr);
  }
  void sync() {}
};

template <int L>
static void shim_block(const K4Call& c, int pass, const K4Tile& t, uint64_t* sm, int nthr) {
  ShimBlock blk{c, pass, t, sm, nthr,
                std::vector<uint64_t>((std::size_t)nthr * K4_V, 0xA5A5A5A5A5A5A5A5ULL)};
  k4_block<L>(blk);
}

// One pass of a call: its blocks one at a time over a shared-memory buffer
// of the size the launch asks for, with a guard band after it that must
// stay untouched.
static int run_pass(const K4Call& c, int pass) {
  const long long elems = k4_smem_elems(c, pass), guard = 64;
  if (elems > K4_SMEM_MAX_ELEMS) return 701;   // more than the launch's opt-in
  std::vector<uint64_t> sm(elems + guard, 0x5A5A5A5A5A5A5A5AULL);
  for (long long b = 0; b < k4_blocks(c, pass); b++) {
    const K4Tile t = k4_tile(c, pass, b);
    const int nthr = k4_threads(t.l, t.lc);
    if (nthr > K4_MAX_THREADS) return 702;
    K4_BY_LEN(t.l, shim_block, c, pass, t, sm.data(), nthr)
    for (long long i = elems; i < elems + guard; i++)
      if (sm[i] != 0x5A5A5A5A5A5A5A5AULL) return 700;   // out of the block's shared memory
  }
  return 0;
}

extern "C" {
int k4_ntt(int, const K4Call* call, void*) {
  const K4Call& c = *call;
  if (!k4_valid(c)) return 1;   // cudaErrorInvalidValue
  if (c.rows == 0) return 0;
  if (c.log_n1 == 0) return run_pass(c, K4_PASS_ROW);
  const int err = run_pass(c, K4_PASS_A);
  return err ? err : run_pass(c, K4_PASS_B);
}
int k4_call_size(void) { return (int)sizeof(K4Call); }
int k4_sm_count(int) { return shim_sms; }
void shim_k4_set_sms(int sms) { shim_sms = sms; }
// Per pass of the call: blocks, threads a block, shared bytes a block.
void shim_k4_launch(const K4Call* c, long long* out) {
  for (int p = 0; p < 3; p++) {
    const int l = k4_log_len(*c, p);
    out[3 * p] = k4_blocks(*c, p);
    out[3 * p + 1] = k4_threads(l, c->log_cols[p]);
    out[3 * p + 2] = 8 * k4_smem_elems(*c, p);
  }
}
// The four-step's twiddle w_n^(j1 k2) for every (j1, k2) of (n1, n2), from
// lo and hi (k4_twiddle), canonical.
void shim_k4_twiddles(const K4Call* c, long long n1, long long n2, uint64_t* out) {
  for (long long j1 = 0; j1 < n1; j1++)
    for (long long k2 = 0; k2 < n2; k2++) out[j1 * n2 + k2] = gl_canon(k4_twiddle(*c, j1 * k2));
}
// The same as pass A's store computes them: for each j1 and d < 2^ls, the
// running powers over k2 = d + k 2^ls.
void shim_k4_twiddle_runs(const K4Call* c, long long n1, long long n2, int ls, uint64_t* out) {
  for (long long j1 = 0; j1 < n1; j1++)
    for (long long d = 0; d < (1LL << ls); d++) {
      K4Run run = k4_run(*c, j1, d, ls);
      for (long long k2 = d; k2 < n2; k2 += 1LL << ls) out[j1 * n2 + k2] = gl_canon(k4_next(run));
    }
}
// The DFT of one task of a round of radix 2^b on `count` rows of 2^b
// values of any u64, the first 2^z of each nonzero (k4_dft<b, z>).
void shim_k4_dft(uint64_t* a, int b, int z, long long count) {
  for (long long i = 0; i < count; i++) {
    uint64_t* row = a + (i << b);
#define K4_SHIM_DFT(bb)                                          \
  if (b == bb) {                                                 \
    switch (z) {                                                 \
      case 0: k4_dft<bb, 0>(row); break;                         \
      case 1: k4_dft<bb, (bb < 1 ? bb : 1)>(row); break;         \
      case 2: k4_dft<bb, (bb < 2 ? bb : 2)>(row); break;         \
      case 3: k4_dft<bb, (bb < 3 ? bb : 3)>(row); break;         \
      default: k4_dft<bb, bb>(row); break;                       \
    }                                                            \
  }
    K4_SHIM_DFT(1) K4_SHIM_DFT(2) K4_SHIM_DFT(3) K4_SHIM_DFT(4)
  }
}
void shim_add_lazy(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_add_lazy(a[i], b[i]);
}
void shim_sub_lazy(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_sub_lazy(a[i], b[i]);
}
}
"""

K4_MODES = ("ntt", "intt", "coset_ntt", "coset_intt", "lde1", "lde2", "lde3")


@pytest.fixture(scope="module")
def k4_lib():
    from zk_circuits_torch.ntt import ntt_cuda

    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"k4_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "k4_shim.cc"
    src.write_text(K4_SHIM)
    so = build / "libk4shim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(nvcc.CSRC),
                    "-o", str(so), str(src)], check=True)
    lib = ntt_cuda.bind(ctypes.CDLL(str(so)))   # the wrapper's declarations and mirror check
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.shim_k4_twiddles.argtypes = [vp, ll, ll, vp]
    lib.shim_k4_twiddle_runs.argtypes = [vp, ll, ll, ctypes.c_int, vp]
    lib.shim_k4_launch.argtypes = [vp, vp]
    lib.shim_k4_dft.argtypes = [vp, ctypes.c_int, ctypes.c_int, ll]
    lib.shim_k4_set_sms.argtypes = [ctypes.c_int]
    for name in ("shim_add_lazy", "shim_sub_lazy"):
        getattr(lib, name).argtypes = [vp, vp, vp, ctypes.c_long]
    yield lib
    shutil.rmtree(build, ignore_errors=True)


def _k4_inputs(rng, lead, n):
    """Canonical (*lead, n) inputs: random, with 0, 1 and p - 1 in the
    first row and a row of p - 1 (when there are two rows or more)."""
    x = rng.integers(0, P, (*lead, n), dtype=U64).reshape(-1, n)
    x[0, : min(n, 3)] = np.array([0, 1, P - 1], dtype=U64)[: min(n, 3)]
    if x.shape[0] > 1:
        x[-1] = P - 1
    return x.reshape(*lead, n)


def _k4_run(k4_lib, mode, x, log_n1=None):
    """K4's result on the host shim for one of K4_MODES, through the
    wrapper's ``transform``, and the JAX package's host result."""
    import torch

    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_tpu.ntt import ntt as jntt

    t = torch.from_numpy(np.ascontiguousarray(x).view(np.int64))
    if mode.startswith("lde"):
        rate = int(mode[3:])
        got = ntt_cuda.transform(t, "lde", rate_bits=rate, log_n1=log_n1, lib=k4_lib)
        want = jntt.host_lde(x, rate)
    else:
        got = ntt_cuda.transform(t, mode, log_n1=log_n1, lib=k4_lib)
        want = getattr(jntt, f"host_{mode}")(x)
    return got.numpy().view(U64), want


def _k4_check(k4_lib, mode, x, log_n1=None):
    from zk_circuits_torch.ntt import ntt as tntt

    got, want = _k4_run(k4_lib, mode, x, log_n1)
    assert np.array_equal(got, want), (mode, x.shape, log_n1)
    if mode == "ntt":
        assert np.array_equal(got, tntt.host_ntt_plain(x))
    if mode == "intt":
        assert np.array_equal(got, tntt.host_intt_plain(x))


@pytest.mark.parametrize("log_n", range(0, 14))
def test_k4_row_path_every_mode_matches_host(k4_lib, log_n):
    """The row path at n = 2^log_n, which ``plan`` picks up to
    2^ROW_MAX_LOG and the kernel takes up to 2^13 (the LDE's outputs above
    2^13 take the four-step), a tile of several whole rows or one, every
    mode, over leading axes (2, 3)."""
    from zk_circuits_torch.ntt import ntt_cuda

    n = 1 << log_n
    assert (ntt_cuda.plan(n) == 0) == (log_n <= ntt_cuda.ROW_MAX_LOG)
    x = _k4_inputs(np.random.default_rng(400 + log_n), (2, 3), n)
    for mode in K4_MODES:
        points = n << int(mode[3:]) if mode.startswith("lde") else n
        _k4_check(k4_lib, mode, x, 0 if points <= 1 << 13 else None)


@pytest.mark.parametrize("log_n", [9, 14, 16])
@pytest.mark.parametrize("factors", ["k4", "jax_split"])
def test_k4_four_step_every_mode_matches_host(k4_lib, log_n, factors, monkeypatch):
    """Both four-step passes, tile by tile, with the row path's threshold
    patched down so that 2^9 takes them too: K4's own factors
    (``ntt_cuda.split``) and the JAX package's ``ntt_mxu._split``."""
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_tpu.ntt import ntt_mxu as jmxu

    monkeypatch.setattr(ntt_cuda, "ROW_MAX_LOG", 4)
    n = 1 << log_n
    log_n1 = None if factors == "k4" else jmxu._split(n)[0].bit_length() - 1
    lead = (2,) if log_n == 16 else (2, 3)
    x = _k4_inputs(np.random.default_rng(500 + log_n), lead, n)
    modes = K4_MODES if log_n < 16 else ("ntt", "intt", "coset_ntt", "coset_intt")
    for mode in modes:
        _k4_check(k4_lib, mode, x, log_n1)
    if log_n < 16:   # an LDE whose output (2^17, 2^19) takes the four-step
        _k4_check(k4_lib, "lde3", x[:1])


@pytest.mark.parametrize("value", [0, 1, P - 1])
def test_k4_constant_rows_match_host(k4_lib, value):
    """Rows of one value (0, 1, p - 1) on both paths, every mode."""
    for n, log_n1 in ((32, 0), (1024, 5)):
        x = np.full((3, n), value, dtype=U64)
        for mode in K4_MODES:
            _k4_check(k4_lib, mode, x, log_n1)


def test_k4_padded_coset_ntt_matches_host(k4_lib):
    """``coset_ntt`` zero-padded to a larger size (FRI's extension coset
    NTT: N - 1 coefficients to N points), on both paths."""
    import torch

    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_tpu.ntt import ntt as jntt

    rng = np.random.default_rng(61)
    for n_in, size in ((1023, 1024), (5, 1 << 14), (4095, 1 << 16)):
        x = _k4_inputs(rng, (2,), n_in)
        got = ntt_cuda.transform(torch.from_numpy(x.view(np.int64)), "coset_ntt",
                                 size=size, lib=k4_lib)
        padded = np.zeros((2, size), dtype=U64)
        padded[:, :n_in] = x
        assert np.array_equal(got.numpy().view(U64), jntt.host_coset_ntt(padded)), (n_in, size)


def test_k4_split_and_twiddles_match_jax(k4_lib):
    """The port's ``ntt_mxu._split`` and ``_twiddle_table`` are the JAX
    package's; the kernel's four-step twiddle w_n^(j1 k2), from lo and hi
    (``k4_twiddle``) and as pass A's running powers along k2 (``k4_run``
    at every stride its last round takes), equals ``_twiddle_table`` at
    ``_split``'s factors and at K4's; every round table holds
    w_(L_r)^(j k) of the JAX package's roots; K4's factors fit a pass up to
    2^26."""
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_torch.ntt import ntt_mxu as tmxu
    from zk_circuits_tpu.ntt import ntt_mxu as jmxu

    for log_n in range(1, 27):
        n = 1 << log_n
        if log_n >= 8:
            assert tmxu._split(n) == jmxu._split(n)
        n1, n2 = ntt_cuda.split(n)
        assert n1 * n2 == n and n1 <= n2 <= 2 * n1 and n2 <= 1 << 13
    for n1, n2 in (jmxu._split(1 << 9), jmxu._split(1 << 14), ntt_cuda.split(1 << 16),
                   ntt_cuda.split(1 << 17)):
        lo, hi = jmxu._twiddle_table(n1, n2)
        want = lo.astype(U64) | (hi.astype(U64) << U64(32))
        assert np.array_equal(tmxu._twiddle_table(n1, n2), want)
        n, log_n1 = n1 * n2, n1.bit_length() - 1
        tw = ntt_cuda.tables(n, log_n1)
        call = ntt_cuda._Call(tw=tw.ctypes.data, log_n=n.bit_length() - 1, log_n1=log_n1, scale=1)
        got = np.empty((n1, n2), dtype=U64)
        k4_lib.shim_k4_twiddles(ctypes.byref(call), n1, n2, _ptr(got))
        assert np.array_equal(got, want), (n1, n2)
        for ls in range(0, n2.bit_length() - 1, 4):   # S of a last round: 16^(rounds - 1)
            got[:] = 0
            k4_lib.shim_k4_twiddle_runs(ctypes.byref(call), n1, n2, ls, _ptr(got))
            assert np.array_equal(got, want), (n1, n2, ls)
    for log_len in range(0, 14):
        tab, at, lr = ntt_cuda.round_tables(log_len), 0, log_len
        assert sum(ntt_cuda.radix_logs(log_len)) == log_len
        for b in ntt_cuda.radix_logs(log_len)[:-1]:
            w = jgl.primitive_root_of_unity(lr)
            seg = tab[at: at + (1 << lr)].reshape(1 << b, 1 << (lr - b))
            assert all(int(seg[k, j]) == pow(w, j * k, P)
                       for k in range(1 << b) for j in range(0, 1 << (lr - b), 7)), (log_len, b)
            at, lr = at + (1 << lr), lr - b
        assert at == len(tab)
    dft = tmxu._dft_matrix(8)
    w = jgl.primitive_root_of_unity(3)
    assert all(int(dft[j, k]) == pow(w, j * k, P) for j in range(8) for k in range(8))


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_k4_register_dft_matches_direct_sum(k4_lib, b):
    """A round's DFT in registers (``k4_dft<b, z>``) against the direct
    sum over the JAX package's root, on values of any u64: lanes in
    [p, 2^64) built on purpose (2^64 - 1, p, p + 1, random ones), so that
    the lazy add and sub carry and borrow twice, and with only the first
    2^z inputs nonzero (the stages over an LDE's zeros skipped: z = b - 1,
    b - 2, b - 3 are rates 1, 2, 3)."""
    r, count = 1 << b, 64
    w = jgl.primitive_root_of_unity(b)
    rng = np.random.default_rng(90 + b)
    edge = np.array([0, 1, P - 1, P, P + 1, (1 << 64) - 1, (1 << 64) - 2, 1 << 63,
                     (1 << 32) - 1], dtype=U64)
    for z in range(b + 1):
        a = rng.integers(P, 1 << 64, (count, r), dtype=U64, endpoint=False)
        a[: count // 2] = rng.choice(edge, (count // 2, r))
        a[:, 1 << z:] = 0
        got = a.copy()
        k4_lib.shim_k4_dft(_ptr(got), b, z, count)
        for i in range(count):
            want = [sum(int(a[i, m]) * pow(w, m * k, P) for m in range(1 << z)) % P
                    for k in range(r)]
            assert [int(v) % P for v in got[i]] == want, (b, z, i)


def test_k4_lazy_add_and_sub_carry_twice(k4_lib):
    """gl_add_lazy and gl_sub_lazy take any u64 on both sides: every pair
    of edge values, among them pairs whose sum carries twice (a + b - 2^64
    >= p) and whose difference borrows twice (a - b + 2^64 < EPS), and
    random lanes in [p, 2^64); each result is congruent to the true one."""
    eps = (1 << 32) - 1
    edge = [0, 1, 2, eps - 1, eps, eps + 1, P - 1, P, P + 1, (1 << 63), (1 << 64) - eps - 1,
            (1 << 64) - eps, (1 << 64) - 2, (1 << 64) - 1]
    rng = np.random.default_rng(77)
    lanes = edge + [int(v) for v in rng.integers(P, 1 << 64, 32, dtype=U64, endpoint=False)]
    a = np.array([x for x in lanes for _ in lanes], dtype=U64)
    b = np.array([y for _ in lanes for y in lanes], dtype=U64)
    add, sub = np.empty_like(a), np.empty_like(a)
    k4_lib.shim_add_lazy(_ptr(a), _ptr(b), _ptr(add), len(a))
    k4_lib.shim_sub_lazy(_ptr(a), _ptr(b), _ptr(sub), len(a))
    pairs = list(zip(a.tolist(), b.tolist()))
    assert any(x + y - (1 << 64) >= P for x, y in pairs)     # carries twice
    assert any(0 <= x - y + (1 << 64) < eps for x, y in pairs)   # borrows twice
    for (x, y), s, d in zip(pairs, add.tolist(), sub.tolist()):
        assert s % P == (x + y) % P and d % P == (x - y) % P, (x, y)


# Tile plans the main path's shapes get on an H100 (132 SMs): (rows, n) ->
# per pass (blocks, threads, shared bytes).  The wires LDE and its batch of
# 4, the wires INTT, the zs stage's NTT and INTT, one 2^16 row (the
# quotient's coset INTT, FRI's first coset NTT: two rows since one call
# takes both), the level-1 LDE, the sharded path's 2^20 row and FRI's
# second coset NTT (two rows of 2^12 on the row path).
K4_MAIN_PLANS = {
    (139, 1 << 16): [(2224, 256, 34944), (2224, 256, 34944)],
    (556, 1 << 16): [(8896, 256, 34944), (8896, 256, 34944)],
    (135, 1 << 13): [(540, 128, 17536), (540, 128, 17664)],
    (80, 1 << 13): [(640, 64, 8768), (640, 64, 8832)],
    (20, 1 << 13): [(320, 32, 4384), (320, 32, 4416)],
    (2, 1 << 16): [(128, 64, 8736), (128, 64, 8736)],
    (1, 1 << 16): [(64, 64, 8736), (64, 64, 8736)],
    (139, 1 << 17): [(4448, 256, 34880), (4448, 256, 34944)],
    (1, 1 << 20): [(256, 256, 34848), (256, 256, 34848)],
    (2, 1 << 12): [(2, 256, 34816)],
}


@pytest.mark.parametrize("shape", sorted(K4_MAIN_PLANS))
def test_k4_tile_plans_at_main_path_shapes(k4_lib, shape):
    """``tiles`` fills an H100's 132 SMs (four blocks an SM where the call
    has the columns, the four-step's tiles at least 4 columns wide) at the
    main path's shapes, and ``launch_shape`` gives what the header launches
    for that plan."""
    from zk_circuits_torch.ntt import ntt_cuda

    rows, n = shape
    log_n1 = ntt_cuda.plan(n)
    cols = ntt_cuda.tiles(rows, n, log_n1, 132)
    got = ntt_cuda.launch_shape(rows, n, log_n1, cols)
    assert got == K4_MAIN_PLANS[shape], (shape, cols, got)
    call = ntt_cuda._Call(rows=rows, log_n=n.bit_length() - 1, log_n1=log_n1,
                          log_cols=(ctypes.c_int * 3)(*cols))
    out = np.zeros(9, dtype=np.int64)
    k4_lib.shim_k4_launch(ctypes.byref(call), _ptr(out))
    passes = [0] if log_n1 == 0 else [1, 2]
    assert [tuple(out[3 * p: 3 * p + 3]) for p in passes] == got
    for blocks, threads, smem in got:
        assert smem <= 36 * 1024 and threads <= 256
        assert blocks >= 4 * 132 or threads <= 64 or rows * n <= 1 << 13 or n >= 1 << 20


@pytest.mark.parametrize("rows", [1, 3, 40])
@pytest.mark.parametrize("log_n", [5, 9, 10, 11])
def test_k4_tile_plans_small_scale_match_host(k4_lib, rows, log_n, monkeypatch):
    """The main path's tile plans at small scale: the row path's threshold
    and the tile's bounds patched down (a row path of 2^5, four-steps of
    2^9 to 2^11, passes of one round and two) and the SM count stepped up,
    so that one row, a few rows and many rows shrink the tile to plans of
    their own; every mode against the host."""
    from zk_circuits_torch.ntt import ntt_cuda

    monkeypatch.setattr(ntt_cuda, "ROW_MAX_LOG", 5)
    monkeypatch.setattr(ntt_cuda, "TILE_LOG", 8)
    monkeypatch.setattr(ntt_cuda, "TILE_MIN_LOG", 6)
    n, seen = 1 << log_n, set()
    x = _k4_inputs(np.random.default_rng(600 + log_n + rows), (rows,), n)
    for sms in (1, 4, 16, 256):
        k4_lib.shim_k4_set_sms(sms)
        try:
            cols = ntt_cuda.tiles(rows, n, ntt_cuda.plan(n), sms)
            seen.add(cols)
            for mode in K4_MODES:
                _k4_check(k4_lib, mode, x)
        finally:
            k4_lib.shim_k4_set_sms(4)
    assert len(seen) > 1 or (log_n == 5 and rows < 40), seen


def test_k4_views_and_refusals(k4_lib):
    """A view whose rows share one stride is read in place; one whose last
    axis is strided, or whose rows share no stride, is copied once
    (``copies``); a call the kernel does not take raises."""
    import torch

    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_tpu.ntt import ntt as jntt

    x = _k4_inputs(np.random.default_rng(71), (4, 6), 64)
    t = torch.from_numpy(x.view(np.int64))
    cases = [(t[:, ::2], 0), (t[1], 0), (t.transpose(0, 1), 1), (t[:, :3], 1),
             (t.transpose(1, 2).contiguous().transpose(1, 2)[..., :64], 1)]
    for view, copied in cases:
        before = ntt_cuda.copies
        got = ntt_cuda.transform(view, "ntt", lib=k4_lib).numpy().view(U64)
        assert np.array_equal(got, jntt.host_ntt(view.contiguous().numpy().view(U64)))
        assert ntt_cuda.copies == before + copied, view.stride()
    with pytest.raises(RuntimeError, match="k4_ntt"):
        ntt_cuda.transform(t, "ntt", log_n1=6, lib=k4_lib)   # n1 = n: no n2
    with pytest.raises(RuntimeError, match="k4_ntt"):
        ntt_cuda.transform(torch.zeros(1 << 14, dtype=torch.int64), "ntt", log_n1=0,
                           lib=k4_lib)   # more than a tile on the row path
    with pytest.raises(ValueError):
        ntt_cuda.transform(t, "coset_ntt", size=32, lib=k4_lib)   # size below n_in
    with pytest.raises(ValueError):
        ntt_cuda.transform(t, "ntt")   # a CPU tensor without a host library


def _leaf_inputs(rng, batch, n_in, layout):
    """An extension polynomial's two (B, n_in) components as CPU tensors:
    "stacked", views of one (2, B, n_in) buffer (K8's scan's output);
    "apart", tensors of their own; "strided", every other row of wider
    buffers, read in place; "mixed", row strides that differ (copied)."""
    import torch

    x = _k4_inputs(rng, (2, 2 * batch), n_in)
    t = torch.from_numpy(x.view(np.int64))
    if layout == "stacked":
        f = t[:, :batch].contiguous()
        return f[0], f[1]
    if layout == "apart":
        return t[0, :batch].clone(), t[1, :batch].clone()
    if layout == "strided":
        return t[0, ::2], t[1, ::2]
    return t[0, ::2], t[1, :batch].clone()


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arity_bits", [1, 2, 3, 4, 5])
def test_k4_leaf_mode_matches_fiber_leaves(k4_lib, arity_bits, batch, monkeypatch):
    """K4's leaf mode (``ntt_cuda.coset_leaves``) at FRI arity 2^1 to 2^5:
    the coset NTT of both components zero-padded to 2^rate times their
    length, each value at its fiber-leaf slot, on the row path and on the
    four-step (the row path's threshold patched down, so that 2^9 and 2^12
    take it, with K4's factors and others), from components stacked, apart,
    strided or of different strides; equal integers against the plain
    version ``fri_device._commit_codeword_plain`` (``_fiber_leaves`` of
    ``_ext_coset_ntt_dev``), which the CPU path of FRI's commit takes, and
    against the JAX package's ``_fiber_leaves(*_ext_coset_ntt_dev(...))``
    (``fri/fri_device.py``'s round-0 leaves) proof by proof."""
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_tpu.field import goldilocks as jgf
    from zk_circuits_tpu.fri import fri_device as jfd

    monkeypatch.setattr(ntt_cuda, "ROW_MAX_LOG", 4)
    rng = np.random.default_rng(800 + 10 * arity_bits + batch)
    shift = pow(7, 1 << arity_bits, P)
    for n_in, size, log_n1, layout in ((32, 256, 0, "stacked"), (32, 256, None, "apart"),
                                       (64, 512, 3, "strided"), (512, 4096, None, "stacked"),
                                       (16, 512, 0, "mixed")):
        c0, c1 = _leaf_inputs(rng, batch, n_in, layout)
        before = ntt_cuda.copies
        got = ntt_cuda.coset_leaves(c0, c1, shift, size, arity_bits, log_n1=log_n1,
                                    lib=k4_lib)
        want = fd._commit_codeword_plain(c0, c1, shift, size, arity_bits)
        assert got.shape == want.shape == (batch, size >> arity_bits, 2 << arity_bits)
        assert np.array_equal(got.numpy(), want.numpy()), (n_in, size, log_n1, layout)
        assert ntt_cuda.copies - before == (layout == "mixed" and batch > 1)
        for b in range(batch):
            comps = [jgf.from_u64(np.ascontiguousarray(c[b].numpy()).view(U64)) for c in (c0, c1)]
            ref = jgf.to_u64(jfd._fiber_leaves(*jfd._ext_coset_ntt_dev(*comps, shift, size),
                                               1 << arity_bits))
            assert np.array_equal(got[b].numpy().view(U64), ref), (n_in, size, layout, b)


def test_k4_leaf_mode_edges_and_refusals(k4_lib):
    """The leaf mode on constant rows (0, 1, p - 1), one component given
    as a 1-D polynomial, the arity the whole codeword (one leaf), and the
    calls it refuses."""
    import torch

    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.ntt import ntt_cuda

    for value in (0, 1, P - 1):
        c = torch.from_numpy(np.full((2, 64), value, dtype=U64).view(np.int64))
        got = ntt_cuda.coset_leaves(c[0], c[1], 7, 512, 3, lib=k4_lib)
        want = fd._commit_codeword_plain(c[0][None], c[1][None], 7, 512, 3)
        assert np.array_equal(got.numpy(), want.numpy()), value
    x = torch.from_numpy(_k4_inputs(np.random.default_rng(81), (2,), 16).view(np.int64))
    got = ntt_cuda.coset_leaves(x[0], x[1], 7, 64, 6, lib=k4_lib)   # one leaf of 128 words
    assert got.shape == (1, 1, 128)
    assert np.array_equal(got.numpy(),
                          fd._commit_codeword_plain(x[:1], x[1:], 7, 64, 6).numpy())
    for bad in (dict(size=48), dict(size=8), dict(arity_bits=0), dict(arity_bits=7)):
        kw = dict(size=64, arity_bits=2) | bad
        with pytest.raises(ValueError):
            ntt_cuda.coset_leaves(x[0], x[1], 7, kw["size"], kw["arity_bits"], lib=k4_lib)
    with pytest.raises(ValueError):
        ntt_cuda.coset_leaves(x[0], x[1][:8], 7, 64, 2, lib=k4_lib)   # shapes differ
    # The kernel takes a second component only in the leaf mode, and the
    # leaf mode only with one: calls the header's k4_valid refuses.
    log_cols = (ctypes.c_int * 3)(*ntt_cuda.tiles(2, 64, 0, 132))
    for leaf_log, x1, half in ((0, x[1].data_ptr(), 1), (0, x[1].data_ptr(), 0), (0, None, 1),
                               (2, None, 1), (2, x[1].data_ptr(), 0), (2, x[1].data_ptr(), 2)):
        call = ntt_cuda._Call(x=x[0].data_ptr(), rows=2, in_stride=16, n_in=16, log_n=6,
                              log_cols=log_cols, scale=1, leaf_log=leaf_log, x1=x1, half=half)
        assert k4_lib.k4_ntt(0, ctypes.byref(call), None) != 0, (leaf_log, x1, half)
    with pytest.raises(ValueError):
        ntt_cuda.coset_leaves(x[0], x[1], 7, 64, 2)   # a CPU tensor without a host library


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("arity_bits", [1, 2, 3, 4])
def test_k4_leaf_mode_stores_whole_leaves(k4_lib, arity_bits, batch, monkeypatch):
    """The leaf mode's staged store (tiles of both component rows, whole
    leaves from shared memory) at the FRI arities the main path runs,
    B = 1 and 3, the second component in a buffer of its own: on the row
    path (2^8), on small four-steps (2^9 with the row path's threshold
    patched down; 2^12, past the row path's leaf tiles) and with every SM
    count from 1 to 256 shrinking the tiles; equal integers against
    ``fri_device._commit_codeword_plain``."""
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.ntt import ntt_cuda

    rng = np.random.default_rng(900 + 10 * arity_bits + batch)
    shift = pow(7, 1 << arity_bits, P)
    plans = set()
    for n_in, size, row_max_log in ((32, 256, 12), (64, 512, 4), (512, 4096, 12)):
        monkeypatch.setattr(ntt_cuda, "ROW_MAX_LOG", row_max_log)
        c0, c1 = _leaf_inputs(rng, batch, n_in, "apart")
        want = fd._commit_codeword_plain(c0, c1, shift, size, arity_bits)
        for sms in (1, 4, 256):
            k4_lib.shim_k4_set_sms(sms)
            try:
                got = ntt_cuda.coset_leaves(c0, c1, shift, size, arity_bits, lib=k4_lib)
            finally:
                k4_lib.shim_k4_set_sms(4)
            log_n1 = ntt_cuda.leaf_plan(size)
            plans.add((size, ntt_cuda.tiles(2 * batch, size, log_n1, sms, leaf=True)))
            assert np.array_equal(got.numpy(), want.numpy()), (n_in, size, sms)
        assert (ntt_cuda.leaf_plan(size) == 0) == (size == 256), size
    assert len(plans) > 3, plans   # some SM counts shrank a tile


# K4's leaf mode at the main path's round-0 codewords (B proofs, points):
# one wormhole proof, a batch of 4 and the level-1 aggregation batch; its
# launches are those of the coset NTT of the same 2 B rows.
K4_LEAF_PLANS = {(1, 1 << 16): (2, 1 << 16), (4, 1 << 16): (8, 1 << 16),
                 (4, 1 << 17): (8, 1 << 17)}


@pytest.mark.parametrize("shape", sorted(K4_LEAF_PLANS))
def test_k4_leaf_mode_tile_plans_at_main_path_shapes(k4_lib, shape):
    """``tiles(..., leaf=True)`` on 132 SMs at the main path's leaf-mode
    shapes: the header launches what ``launch_shape(..., leaf=True)``
    says, with the blocks, threads and shared bytes of the coset NTT of
    the same rows (``K4_MAIN_PLANS``'s plan for them)."""
    from zk_circuits_torch.ntt import ntt_cuda

    batch, n = shape
    rows = 2 * batch
    log_n1 = ntt_cuda.leaf_plan(n)
    cols = ntt_cuda.tiles(rows, n, log_n1, 132, leaf=True)
    got = ntt_cuda.launch_shape(rows, n, log_n1, cols, leaf=True)
    plain_cols = ntt_cuda.tiles(rows, n, log_n1, 132)
    assert got == ntt_cuda.launch_shape(rows, n, log_n1, plain_cols), (cols, plain_cols)
    call = ntt_cuda._Call(rows=rows, log_n=n.bit_length() - 1, log_n1=log_n1,
                          log_cols=(ctypes.c_int * 3)(*cols), leaf_log=4, x1=1, half=batch)
    out = np.zeros(9, dtype=np.int64)
    k4_lib.shim_k4_launch(ctypes.byref(call), _ptr(out))
    assert [tuple(out[3 * p: 3 * p + 3]) for p in (1, 2)] == got


@pytest.mark.parametrize("row_max_log", [12, 4])
def test_k4_leaf_mode_in_a_zk_batch_proof(k4_lib, row_max_log, monkeypatch):
    """A zk square circuit with FRI fold rounds, a batch of 2, whose round-0
    codeword goes through K4's leaf mode on the host build (the row path,
    and the four-step with the row path's threshold patched down) in place
    of ``_commit_codeword_plain``: byte-equal to the JAX host path's
    proofs."""
    from test_torch_batch import FRI_ROUNDS, TORCH, _reference_bytes, _square
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes

    sizes = []

    def via_k4(f0, f1, shift, size, arity_bits):
        sizes.append(size)
        return ntt_cuda.coset_leaves(f0, f1, shift, size, arity_bits, lib=k4_lib)

    monkeypatch.setattr(fd, "_commit_codeword_plain", via_k4)
    monkeypatch.setattr(ntt_cuda, "ROW_MAX_LOG", row_max_log)
    want = _reference_bytes(True, FRI_ROUNDS, (3, 7))
    data, witness = _square(TORCH, True, FRI_ROUNDS, device="cpu")
    proofs = prove_batch(data, [witness(3), witness(7)], device="cpu")
    assert [t_bytes(p) for p in proofs] == [want[3], want[7]]
    assert len(sizes) == 1 and (ntt_cuda.plan(sizes[0]) == 0) == (row_max_log == 12), sizes
