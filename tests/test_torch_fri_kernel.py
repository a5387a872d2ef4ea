"""K7 (the openings), K8 (the alpha reduction and the composition) and K9
(the fold, and a fold round), built for the host.

csrc/fri.cuh (and csrc/ntt.cuh under K9's round mode) is __host__
__device__ code; here it is compiled with g++ behind a host copy of
fri.cu's C interface (k7_openings, k8_reduce, k8_scan, k9_fold, k9_round,
fri_sm_count and fri_call_size) and driven through the wrapper's own
``fri_cuda`` functions on CPU tensors.  A K7 call runs each (proof, row
group, tile) block, the tiles of a group in one order or the other, with
its threads in turn between the barriers and a warp's lanes summed in turn
for its shuffles; K8's point kernel and its scan's two kernels run their
blocks the same way (``shim_fri_set_threads`` picks K7's block size and
the scan's segment, 256 and 256 on the card; ``shim_fri_set_sms`` the SM
count K7's tiles are sized from, 132).  K9's fold mode runs its blocks so,
a group of lanes summed in turn; its round mode runs a group of cosets
(a cluster on the card) as every block's fold, then each block's gather
and K4's rounds (k4_block, each thread's 16 values kept between the
phases), each block over its own shared memory with a guard band after it
(``shim_k9_set_threads``: 128 and the round's 256, 512 at 2^13 points, on
the card).  Equal integers are
required against the port's plain versions (``fri/fri_device.py``'s
``_openings_plain``, ``_reduce_alpha_plain``, ``_compose_plain``,
``_fold_plain``, ``_fold_round_plain``) and the JAX package's programs on
the CPU (``_make_openings_run``, ``_make_compose_run(num_zs, None)``,
``_fold_dev`` and ``_make_fold_commit_run``, jitted), and whole proofs
through the shim against the JAX host path's bytes.
"""

import ctypes
import os
import shutil
import subprocess
import types

import jax
import numpy as np
import pytest
import torch

import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.field import goldilocks as gfd
from zk_circuits_torch.fri import fri_cuda
from zk_circuits_torch.fri import fri_device as fd
from zk_circuits_torch.parallel.mesh import make_mesh
from zk_circuits_torch.plonk.prover import prove_batch
from zk_circuits_torch.plonk.prover_sharded import prove_sharded
from zk_circuits_torch.utils import nvcc
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.fri import fri_device as jfd
from zk_circuits_tpu.plonk.prover import prove as j_prove
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

P = 2**64 - 2**32 + 1
U64 = np.uint64
EDGES = np.array([0, 1, P - 1], dtype=U64)

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

SHIM = r"""
#include <vector>
#include "fri.cuh"

static int k7_threads = 256, scan_logs = K8_LOG_SEG;   // the blocks' threads, as on the card
static int shim_sms = 132;

// A block on the host: each phase runs the block's threads in turn; a
// warp's sums add its lanes' values in turn.
struct ShimBlock {
  int n;
  std::vector<uint64_t> r = {};   // each thread's registers across the phases
  int threads() const { return n; }
  uint64_t* regs(int tid) {
    if (r.size() < (std::size_t)n * K9_REGS) r.assign((std::size_t)n * K9_REGS, 0xA5A5A5A5A5A5A5A5ULL);
    return r.data() + (std::size_t)tid * K9_REGS;
  }
  template <class F>
  void each(F f) const {
    for (int t = 0; t < n; t++) f(t);
  }
  void sync() const {}
  template <int K, class F, class G>
  void warp_sum(F f, G g) const {
    group_sum<K>(5, f, g);
  }
  template <int K, class F, class G>
  void group_sum(int lb, F f, G g) const {
    for (int w0 = 0; w0 < n; w0 += 1 << lb) {
      uint64_t s[K] = {}, v[K];
      for (int t = w0; t < w0 + (1 << lb) && t < n; t++) {
        f(t, v);
        for (int k = 0; k < K; k++) s[k] = gl_add_lazy(s[k], v[k]);
      }
      g(w0, s);
    }
  }
};

static int k9_fold_threads = K9_FOLD_THREADS, k9_round_shim_threads = 0;   // 0: the card's
static const uint64_t K9_FILL = 0x5A5A5A5A5A5A5A5AULL;

template <int L>
static void shim_k9_ntt(ShimBlock& blk, const K9RoundCall& c, uint64_t* sm, int b, int y,
                        int coset) {
  k9_ntt<L, 0>(blk, c, sm, b, y, coset);
}

// The scan's two launches at segments of 2^L points: every block of the
// first, then every block of the second.
template <int L>
static void k8_scan_host(const K8ScanCall& c) {
  ShimBlock blk{1 << L};
  std::vector<uint64_t> sm(12 * (1 << L) + 4 * K8_ZTAB);
  const long long nseg = k8_segs(c.n, L);
  for (int b = 0; b < c.batch; b++)
    for (long long g = 0; g < nseg; g++) k8_seg_block<L>(blk, c, b, g, sm.data());
  for (int b = 0; b < c.batch; b++)
    for (long long g = 0; g < nseg; g++) k8_finish_block<L>(blk, c, b, g, sm.data());
}

extern "C" {
int k7_openings(int, const K7Call* call, void*) {
  const K7Call& c = *call;
  if (k7_valid(c)) return 1;
  ShimBlock blk{k7_threads};
  std::vector<uint64_t> sm(k7_smem(c.tile, c.group));
  const long long tiles = k7_tiles(c);
  for (int b = 0; b < c.r.batch; b++)
    for (int g = 0; g < k7_groups(c); g++)
      for (long long t = 0; t < tiles; t++)   // odd groups' tiles last to first
        k7_block(blk, c, b, (b + g) % 2 ? tiles - 1 - t : t, g, sm.data());
  return 0;
}

int k8_reduce(int, const K8Call* call, void*) {
  const K8Call& c = *call;
  if (k8_valid(c)) return 1;
  ShimBlock blk{K8_PT_THREADS};
  std::vector<uint64_t> sm(K8_PT_SMEM);
  for (int b = 0; b < c.r.batch; b++)
    for (long long t = 0; t * K8_PT_TILE < c.r.n; t++) k8_point_block(blk, c, b, t, sm.data());
  return 0;
}

int k8_scan(int, const K8ScanCall* call, void*) {
  const K8ScanCall& c = *call;
  if (k8_scan_valid(c)) return 1;
  switch (scan_logs) {
    case 1: k8_scan_host<1>(c); break;
    case 2: k8_scan_host<2>(c); break;
    case 5: k8_scan_host<5>(c); break;
    default: k8_scan_host<K8_LOG_SEG>(c); break;
  }
  return 0;
}

long long k8_scan_scratch(long long n, int batch) {
  return k8_scratch_words(n, batch, scan_logs);
}

int k9_fold(int, const K9Call* call, void*) {
  const K9Call& c = *call;
  if (k9_valid(c)) return 1;
  ShimBlock blk{k9_fold_threads};
  for (int b = 0; b < c.batch; b++)
    for (long long x = 0; x < k9_fold_blocks(c, k9_fold_threads); x++)
      k9_fold_block(blk, c, b, x);
  return 0;
}

// A group's blocks: every rank's fold, then each rank's gather and NTT
// (last rank first), each over its own shared memory with a guard band
// after it that must stay untouched.
int k9_round(int, const K9RoundCall* call, void*) {
  const K9RoundCall& c = *call;
  const long long elems = k9_round_smem(c), guard = 64;
  if (k9_round_valid(c) || elems * 8 > 227 * 1024) return 1;
  const int nthr = k9_round_shim_threads ? k9_round_shim_threads : k9_round_threads(c.log_m);
  if ((long long)nthr * K9_REGS < (1LL << c.log_m)) return 703;   // a thread's NTT values
  ShimBlock blk{nthr};
  const int G = 1 << c.group_log;
  std::vector<std::vector<uint64_t>> sm(G);
  const uint64_t* shares[1 << K9_MAX_GROUP_LOG];
  for (int b = 0; b < c.batch; b++)
    for (int y = 0; y < 2; y++)
      for (int g0 = 0; g0 < (1 << c.rate_bits); g0 += G) {
        for (int r = 0; r < G; r++) {
          sm[r].assign(elems + guard, K9_FILL);
          k9_round_prefetch(blk, c, g0 + r, sm[r].data());
          k9_round_fold(blk, c, b, y, g0 + r, sm[r].data());
          shares[r] = sm[r].data();
        }
        for (int r = G - 1; r >= 0; r--) {
          k9_round_gather(blk, c, shares, sm[r].data());
          K4_BY_LEN(c.log_m, shim_k9_ntt, blk, c, sm[r].data(), b, y, g0 + r)
        }
        for (int r = 0; r < G; r++)
          for (long long i = elems; i < elems + guard; i++)
            if (sm[r][i] != K9_FILL) return 700;   // out of the block's shared memory
      }
  return 0;
}

int fri_call_size(int kind) {
  switch (kind) {
    case 0: return (int)sizeof(K7Call);
    case 1: return (int)sizeof(K8Call);
    case 2: return (int)sizeof(K8ScanCall);
    case 3: return (int)sizeof(K9Call);
    case 4: return (int)sizeof(K9RoundCall);
    default: return -1;
  }
}

int fri_sm_count(int) { return shim_sms; }
int k7_row_groups(const K7Call* call) { return k7_groups(*call); }

// x^2 by fri_esqr (its 7 b^2 by gl_mul7) and by fri_emul, each point's
// components at out[4 i ...]
void shim_fri_squares(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) {
    const FriExt s = fri_esqr({a[i], b[i]}), m = fri_emul({a[i], b[i]}, {a[i], b[i]});
    out[4 * i] = s.a;
    out[4 * i + 1] = s.b;
    out[4 * i + 2] = m.a;
    out[4 * i + 3] = m.b;
  }
}
void shim_fri_set_sms(int sms) { shim_sms = sms; }
long long shim_k9_round_smem(const K9RoundCall* c) { return k9_round_smem(*c); }
void shim_k9_set_threads(int fold, int round) {
  k9_fold_threads = fold;
  k9_round_shim_threads = round;
}

// K7's block size (a multiple of 32) and the scan's segment (2, 4, 32 or
// 256 points)
void shim_fri_set_threads(int k7, int scan) {
  k7_threads = k7;
  scan_logs = 0;
  while ((2 << scan_logs) <= scan) scan_logs++;
}
}
"""


@pytest.fixture(scope="module")
def flib():
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"fri_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "fri_shim.cc"
    src.write_text(SHIM)
    so = build / "libfrishim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(nvcc.CSRC),
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    fri_cuda.bind(lib)          # the wrapper's declarations and size checks
    lib.shim_fri_set_threads.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.shim_fri_set_sms.argtypes = [ctypes.c_int]
    lib.shim_k9_set_threads.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.shim_k9_round_smem.argtypes = [ctypes.c_void_p]
    lib.shim_k9_round_smem.restype = ctypes.c_longlong
    lib.shim_fri_squares.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
    yield lib
    shutil.rmtree(build, ignore_errors=True)


@pytest.fixture
def threads(flib):
    """Set the shim's block sizes for one test; the card's afterwards."""
    yield flib.shim_fri_set_threads
    flib.shim_fri_set_threads(256, 256)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=U64).view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(U64)


def _rand(rng, *shape, edges=False) -> np.ndarray:
    """Canonical field elements; with ``edges`` the first entries of the
    last axis are 0, 1 and p - 1."""
    x = rng.integers(0, P, shape, dtype=U64)
    if edges:
        x[..., : len(EDGES)] = EDGES[: x.shape[-1]]
    return x


def _ext(rng, *shape, edges=False) -> np.ndarray:
    """(*shape, 2) extension elements; with ``edges`` the first points of
    the last axis of ``shape`` have components (0, p - 1), (1, 1), (p - 1,
    0)."""
    x = rng.integers(0, P, (*shape, 2), dtype=U64)
    if edges:
        k = min(len(EDGES), shape[-1])
        x[..., :k, 0], x[..., :k, 1] = EDGES[:k], EDGES[::-1][:k]
    return x


def _pair(a: np.ndarray) -> tuple:
    """A (..., 2) host ext array as a CPU tensor pair."""
    return _t(a[..., 0]), _t(a[..., 1])


# Points whose powers hit the edges: 0 (powers 1, 0, 0, ...; its inverse
# is 0 on both sides), 1, -1 (powers +-1: lanes of p - 1), x (x^2 = 7) and
# -1 - x.
EDGE_POINTS = np.array([[0, 0], [1, 0], [P - 1, 0], [0, 1], [P - 1, P - 1]], dtype=U64)


def _zs(rng, batch, edge=0) -> np.ndarray:
    """Each proof's point (B, 2): proof 0's an edge point, the others
    seeded."""
    z = _ext(rng, batch)
    z[0] = EDGE_POINTS[edge % len(EDGE_POINTS)]
    return z


def _pts(*points) -> torch.Tensor:
    """Host (B, 2) points -> the kernels' (T, 2, B) tensor."""
    return fd._points(list(points), "cpu")


def _equal(got, want) -> bool:
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def _oracles(rng, widths, n, batch):
    """The four oracles' coefficients as the prover holds them: the
    circuit's (k0, n), shared by the batch, and (B, k_i, n) for the
    others, with rows of 0, 1 and p - 1 (whole rows and edge lanes)."""
    out = []
    for o, k in enumerate(widths):
        x = _rand(rng, *((k, n) if o == 0 else (batch, k, n)), edges=True)
        x[..., 0, :] = EDGES[o % 3]     # a constant row of 0, 1 or p - 1
        out.append(x)
    return out


def _rows(oracles, num_zs):
    """The prover's row list: every row at zeta (row r of them taking
    alpha^r), then the Z rows at g*zeta (alpha^0, ...)."""
    ts = [_t(x) for x in oracles]
    first = np.cumsum([0] + [x.shape[-2] for x in ts[:-1]])
    return [(x, 0, int(e)) for x, e in zip(ts, first)] + [(ts[2][:, :num_zs], 1, 0)]


# The JAX package's fold, jitted where XLA's compile of its unrolled
# Horner stays short (arity bits 1-2) and op by op above, where the
# compile on a CPU grows to tens of seconds.
_JAX_FOLD = jax.jit(jfd._fold_dev, static_argnums=4)
JIT_FOLD_MAX_BITS = 2


def _gf(x: np.ndarray):
    return jgf.from_u64(x)


def _jax_u64(*gfs) -> list:
    return [jgf.to_u64(g) for g in gfs]


# --- the call mirrors ------------------------------------------------------------


def test_call_sizes_match_the_header(flib):
    """fri_call_size of each kind is its ctypes mirror's size (bind checks
    the same); an unknown kind is -1."""
    for kind, (_, mirror) in enumerate(fri_cuda.CALLS):
        assert flib.fri_call_size(kind) == ctypes.sizeof(mirror)
    assert flib.fri_call_size(len(fri_cuda.CALLS)) == -1
    assert ctypes.sizeof(fri_cuda._Set) == 40   # 36 bytes of fields, 8-aligned


# --- K7 ----------------------------------------------------------------------------


@pytest.mark.parametrize("log_n,widths,batch", [
    (5, (3, 4, 3, 2), 1), (6, (2, 3, 4, 1), 2), (7, (4, 2, 2, 4), 3), (8, (1, 2, 2, 1), 2)])
def test_k7_matches_plain(flib, log_n, widths, batch):
    """K7 through the shim == _openings_plain: a shared constants oracle,
    rows and lanes of 0, 1, p - 1, and edge points (powers at p - 1)."""
    rng = np.random.default_rng(log_n * 10 + batch)
    n, num_zs = 1 << log_n, 2
    rows = _rows(_oracles(rng, widths, n, batch), num_zs)
    pts = _pts(_zs(rng, batch, log_n), _zs(rng, batch, log_n + 1))
    got = fri_cuda.openings(rows, pts, lib=flib)
    assert got[0].shape == (batch, sum(widths) + num_zs)
    assert _equal(got, fd._openings_plain(rows, pts))


@pytest.mark.parametrize("k7,tile", [(32, 32), (64, 256), (256, 2048)])
def test_k7_block_sizes(flib, threads, monkeypatch, k7, tile):
    """Blocks of 1, 2 and 8 warps over tiles of 32 (a lane's one
    coefficient, 8 tiles), 256 (one tile) and 2048 coefficients (more than
    n): each row's tile sum by a warp's lanes, the last block's sum over
    the tiles."""
    monkeypatch.setattr(fri_cuda, "K7_MIN_TILE", tile)
    monkeypatch.setattr(fri_cuda, "K7_MAX_TILE", tile)
    rng = np.random.default_rng(5)
    rows = _rows(_oracles(rng, (2, 3, 3, 1), 256, 2), 2)
    pts = _pts(_zs(rng, 2, 2), _zs(rng, 2, 3))
    threads(k7, 256)
    assert _equal(fri_cuda.openings(rows, pts, lib=flib), fd._openings_plain(rows, pts))


# (name, log n, oracle widths, B, rows a group, K7's threads, SMs, row groups)
K7_CASES = [
    ("group_ends_inside_a_set", 7, (5, 7, 6, 4), 2, 4, 64, 132, 6 + 1),
    ("zeta_next_rows_alone", 6, (3, 4, 3, 2), 1, 32, 256, 132, 1 + 1),
    ("rows_fewer_than_a_group", 6, (1, 2, 2, 1), 3, 32, 256, 132, 2),
    ("n_below_one_tile", 5, (4, 3, 5, 2), 2, 32, 256, 1, 2),
    ("batch_4_shared_constants", 9, (6, 5, 4, 3), 4, 8, 256, 4, 3 + 1),
    ("many_tiles", 10, (3, 4, 3, 2), 2, 32, 128, 132, 2),
]


@pytest.mark.parametrize("name,log_n,widths,batch,group,k7,sms,groups", K7_CASES,
                         ids=[c[0] for c in K7_CASES])
def test_k7_row_groups_and_tiles(flib, threads, monkeypatch, name, log_n, widths, batch,
                                 group, k7, sms, groups):
    """K7 == _openings_plain for row groups that end inside a set, the g*zeta
    rows in a group of their own, fewer rows than a group, n below one tile,
    B = 4 with the constants/sigmas oracle shared by the proofs (and the
    JAX package's _make_openings_run, jitted, proof by proof), and many
    tiles a group (n = 2^10 in tiles of 256); every block counter is back
    at 0 after the call."""
    monkeypatch.setattr(fri_cuda, "K7_GROUP", group)
    flib.shim_fri_set_sms(sms)
    threads(k7, 256)
    try:
        rng = np.random.default_rng(log_n * 7 + batch)
        n, num_zs = 1 << log_n, 2
        oracles = _oracles(rng, widths, n, batch)
        rows = _rows(oracles, num_zs)
        zeta, zeta_next = _zs(rng, batch, log_n), _zs(rng, batch, log_n + 1)
        pts = _pts(zeta, zeta_next)
        got = fri_cuda.openings(rows, pts, lib=flib)
        assert _row_groups(flib, rows, batch) == groups
    finally:
        flib.shim_fri_set_sms(132)
    assert _equal(got, fd._openings_plain(rows, pts))
    assert not fri_cuda._COUNTS["cpu"].any()
    if name != "batch_4_shared_constants":
        return
    zp, znp = fd.ext_powers_each(zeta, n), fd.ext_powers_each(zeta_next, n)
    run = jax.jit(jfd._make_openings_run(num_zs))
    k = sum(widths)
    for b in range(batch):
        sets = tuple(_gf(o if i == 0 else o[b]) for i, o in enumerate(oracles))
        je0, je1, jz0, jz1 = _jax_u64(*run(sets, _gf(zp[b, :, 0]), _gf(zp[b, :, 1]),
                                           _gf(znp[b, :, 0]), _gf(znp[b, :, 1])))
        assert np.array_equal(_u(got[0][b, :k]), je0) and np.array_equal(_u(got[1][b, :k]), je1)
        assert np.array_equal(_u(got[0][b, k:]), jz0) and np.array_equal(_u(got[1][b, k:]), jz1)


@pytest.mark.parametrize("group", [1, 3, 32])
def test_k7_edge_points_in_groups(flib, monkeypatch, group):
    """Each proof of a batch of 5 at one of EDGE_POINTS (0, 1, p - 1, x,
    -1 - x) at zeta and g*zeta, the rows in groups of 1, 3 and 32: K7 ==
    _openings_plain."""
    monkeypatch.setattr(fri_cuda, "K7_GROUP", group)
    rng = np.random.default_rng(group)
    rows = _rows(_oracles(rng, (2, 2, 3, 1), 64, len(EDGE_POINTS)), 2)
    pts = _pts(EDGE_POINTS, EDGE_POINTS[::-1])
    assert _equal(fri_cuda.openings(rows, pts, lib=flib), fd._openings_plain(rows, pts))


def test_fri_esqr_takes_any_u64(flib):
    """fri_esqr ((a^2 + 7 b^2) + 2 a b x, its 7 y as 8 y - y by a shift)
    on edge lanes and lanes in [p, 2^64): congruent to fri_emul(x, x) and
    to the square taken here."""
    eps = (1 << 32) - 1
    lanes = [0, 1, 2, eps, eps + 1, P - 1, P, P + 1, (1 << 61) - 1, 1 << 61, 1 << 63,
             (1 << 64) - eps, (1 << 64) - 1]
    rng = np.random.default_rng(7)
    a = np.array(lanes + [int(v) for v in rng.integers(0, 1 << 64, 64, dtype=U64,
                                                        endpoint=False)], dtype=U64)
    b = np.concatenate([a[::-1][: len(lanes)], rng.integers(0, 1 << 64, 64, dtype=U64,
                                                            endpoint=False)])
    out = np.empty(4 * len(a), dtype=U64)
    flib.shim_fri_squares(a.ctypes.data_as(ctypes.c_void_p), b.ctypes.data_as(ctypes.c_void_p),
                          out.ctypes.data_as(ctypes.c_void_p), len(a))
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        want = ((x * x + 7 * y * y) % P, 2 * x * y % P)
        got = [int(v) % P for v in out[4 * i: 4 * i + 4]]
        assert (got[0], got[1]) == want and (got[2], got[3]) == want, (x, y)


def _row_groups(flib, sets, batch: int = 1) -> int:
    """K7's row groups over ``sets`` of ``batch`` proofs (csrc/fri.cuh
    k7_groups)."""
    rows, _, _ = fri_cuda._rows(sets, batch)
    return flib.k7_row_groups(ctypes.byref(fri_cuda._K7Call(r=rows, group=fri_cuda.K7_GROUP)))


def test_k7_openings_shape(flib):
    """K7's coefficients a block at the main path's shapes on 132 SMs: 256
    at one wormhole proof (320 blocks), 1024 at B = 4 (320), 2048 for the
    level-1 batch; K7_MIN_TILE below two blocks an SM, K7_MAX_TILE at
    most."""
    wormhole = [(torch.zeros((k, 1), dtype=torch.int64), 0) for k in (84, 139, 24, 20)] + \
        [(torch.zeros((2, 1), dtype=torch.int64), 1)]
    groups = _row_groups(flib, wormhole)
    assert groups == 9 + 1
    assert fri_cuda.openings_shape(1 << 13, groups, 1, 132) == 256
    assert fri_cuda.openings_shape(1 << 13, groups, 4, 132) == 1024
    assert fri_cuda.openings_shape(1 << 14, groups, 4, 132) == 2048
    assert fri_cuda.openings_shape(1 << 5, 1, 1, 132) == 256
    assert fri_cuda.openings_shape(1 << 20, 1, 1, 1) == 2048


def test_k7_and_k8_at_every_edge_point(flib):
    """Each proof of a batch of 5 at one of EDGE_POINTS (zeta, g*zeta,
    alpha and s = alpha^num_zs alike): K7 and K8's two kernels == their
    plain versions."""
    rng = np.random.default_rng(11)
    n, batch = 64, len(EDGE_POINTS)
    rows = _rows(_oracles(rng, (2, 2, 3, 1), n, batch), 2)
    pts = _pts(EDGE_POINTS, EDGE_POINTS[::-1])
    assert _equal(fri_cuda.openings(rows, pts, lib=flib), fd._openings_plain(rows, pts))
    alpha = _pts(EDGE_POINTS)
    got, want = fri_cuda.reduce_alpha(rows, alpha, lib=flib), fd._reduce_alpha_plain(rows, alpha)
    assert all(_equal(g, w) for g, w in zip(got, want, strict=True))
    comps = [_pair(_ext(rng, batch, n, edges=True)) for _ in range(2)]
    pts = _pts(EDGE_POINTS, EDGE_POINTS[::-1], EDGE_POINTS)
    assert _equal(fri_cuda.compose(*comps, pts, lib=flib), fd._compose_plain(*comps, pts))


def test_k7_matches_the_jax_openings_program(flib):
    """K7 == the JAX package's _make_openings_run(num_zs), jitted, proof by
    proof of a batch of 2 with the constants oracle shared."""
    rng = np.random.default_rng(7)
    n, num_zs, widths, batch = 64, 2, (3, 4, 3, 2), 2
    oracles = _oracles(rng, widths, n, batch)
    zeta, zeta_next = _zs(rng, batch, 2), _zs(rng, batch, 3)
    e0, e1 = fri_cuda.openings(_rows(oracles, num_zs), _pts(zeta, zeta_next), lib=flib)
    zp, znp = fd.ext_powers_each(zeta, n), fd.ext_powers_each(zeta_next, n)
    run = jax.jit(jfd._make_openings_run(num_zs))
    k = sum(widths)
    for b in range(batch):
        sets = tuple(_gf(o if i == 0 else o[b]) for i, o in enumerate(oracles))
        je0, je1, jz0, jz1 = _jax_u64(*run(sets, _gf(zp[b, :, 0]), _gf(zp[b, :, 1]),
                                           _gf(znp[b, :, 0]), _gf(znp[b, :, 1])))
        assert np.array_equal(_u(e0[b, :k]), je0) and np.array_equal(_u(e1[b, :k]), je1)
        assert np.array_equal(_u(e0[b, k:]), jz0) and np.array_equal(_u(e1[b, k:]), jz1)


# --- K8 ----------------------------------------------------------------------------


def _compose_inputs(rng, batch, n, edge=0):
    """comp0 and comp1, (B, n) pairs with lanes of 0, 1 and p - 1, and the
    (3, 2, B) points: zeta, g*zeta (proof 0's edge points) and s."""
    comps = [_pair(_ext(rng, batch, n, edges=True)) for _ in range(2)]
    return comps, _pts(_zs(rng, batch, edge), _zs(rng, batch, edge + 1), _ext(rng, batch))


@pytest.mark.parametrize("log_n,widths,batch", [
    (5, (3, 4, 3, 2), 1), (6, (2, 3, 4, 1), 3), (8, (4, 2, 3, 3), 2)])
def test_k8_point_matches_plain(flib, log_n, widths, batch):
    """K8's point kernel == _reduce_alpha_plain over the prover's rows (two
    tables), and over one table of pieces at their own powers (a shard's
    call), proof 0's alpha an edge point."""
    rng = np.random.default_rng(80 + log_n)
    n, num_zs = 1 << log_n, 2
    rows = _rows(_oracles(rng, widths, n, batch), num_zs)
    alpha = _pts(_zs(rng, batch, log_n))
    got = fri_cuda.reduce_alpha(rows, alpha, lib=flib)
    want = fd._reduce_alpha_plain(rows, alpha)
    assert len(got) == 2 and all(_equal(g, w) for g, w in zip(got, want))
    # a shard's call: pieces of the oracles at their own powers of alpha
    one = [(x[..., :2, :], 0, e + 5) for x, _, e in rows[:4]]
    got = fri_cuda.reduce_alpha(one, alpha, lib=flib)
    assert len(got) == 1 and _equal(got[0], fd._reduce_alpha_plain(one, alpha)[0])


@pytest.mark.parametrize("log_n,batch,scan", [(5, 1, 256), (6, 3, 256), (7, 2, 256),
                                              (8, 2, 256), (8, 2, 4), (7, 1, 2),
                                              (13, 1, 256)])
def test_k8_scan_matches_plain(flib, threads, log_n, batch, scan):
    """K8's scan == _compose_plain; segments of 4 and 2 points give many
    segments (more than a block's threads: the later segments' Horner
    stride), and one 2^13 scan is the wormhole's shape."""
    rng = np.random.default_rng(log_n * 7 + scan)
    threads(256, scan)
    comps, pts = _compose_inputs(rng, batch, 1 << log_n, log_n)
    got = fri_cuda.compose(*comps, pts, lib=flib)
    want = fd._compose_plain(*comps, pts)
    assert got[0].shape == (batch, 1 << log_n) and _equal(got, want)
    assert int(got[0][0, -1]) == 0 and int(got[1][0, -1]) == 0


@pytest.mark.parametrize("n,batch,scan", [(300, 3, 256), (1000, 2, 4), (1 << 14, 1, 256),
                                          (37, 3, 32), (1, 2, 256), (4 * 33 + 3, 1, 4)])
def test_k8_scan_segments(flib, threads, n, batch, scan):
    """K8's scan over segments of 256 (the card's), 32 and 4 points: n not a
    multiple of the segment, one short segment, a lone point, more
    segments than a block's threads (the Horner stride over the later
    segments), 2^14 points (the level circuits'), B = 3; == _compose_plain."""
    rng = np.random.default_rng(n + scan)
    threads(256, scan)
    comps, pts = _compose_inputs(rng, batch, n, n % 5)
    got = fri_cuda.compose(*comps, pts, lib=flib)
    assert got[0].shape == (batch, n) and _equal(got, fd._compose_plain(*comps, pts))


@pytest.mark.parametrize("value", [0, 1, P - 1])
def test_k8_constant_inputs(flib, value):
    """Every input of K8's two kernels (rows, alpha, comps, points) 0, 1 or
    p - 1, over several tiles and segments."""
    n, batch = 600, 2
    rows = [(_t(np.full((3, n), value, dtype=U64)), 0, 0),
            (_t(np.full((batch, 4, n), value, dtype=U64)), 0, 3),
            (_t(np.full((batch, 2, n), value, dtype=U64)), 1, 0)]
    ext = np.full((batch, 2), value, dtype=U64)
    alpha = _pts(ext)
    got, want = fri_cuda.reduce_alpha(rows, alpha, lib=flib), fd._reduce_alpha_plain(rows, alpha)
    assert all(_equal(g, w) for g, w in zip(got, want, strict=True))
    comps = [_pair(np.full((batch, n, 2), value, dtype=U64)) for _ in range(2)]
    pts = _pts(ext, ext, ext)
    assert _equal(fri_cuda.compose(*comps, pts, lib=flib), fd._compose_plain(*comps, pts))


@pytest.mark.parametrize("n,batch,widths", [(100, 3, (3, 5, 4, 2)), (32 * 5 + 17, 2, (3, 5, 4, 2)),
                                            (1 << 14, 1, (3, 5, 4, 2)),
                                            (40, 2, (84, 139, 24, 20))])
def test_k8_point_tiles(flib, n, batch, widths):
    """K8's point kernel over tiles of 32 points with a short last tile (n
    not a multiple), B = 3, 2^14 points, and the wormhole's oracle widths
    (a warp's rows in batches of 8 loads, then the rest); ==
    _reduce_alpha_plain."""
    rng = np.random.default_rng(n)
    rows = _rows(_oracles(rng, widths, n, batch), 2)
    alpha = _pts(_zs(rng, batch, n))
    got, want = fri_cuda.reduce_alpha(rows, alpha, lib=flib), fd._reduce_alpha_plain(rows, alpha)
    assert all(_equal(g, w) for g, w in zip(got, want, strict=True))


def test_k8_matches_the_jax_compose_program(flib):
    """K8's two launches == the JAX package's _make_compose_run(num_zs,
    None), jitted (the composition without its round-0 commit), proof by
    proof of a batch of 2, with the powers of zeta, g*zeta, their inverses
    and alpha from the host for the JAX program."""
    from zk_circuits_torch.host import gle

    rng = np.random.default_rng(8)
    n, num_zs, widths, batch = 64, 2, (3, 4, 3, 2), 2
    oracles = _oracles(rng, widths, n, batch)
    k = sum(widths)
    zeta, alpha = _ext(rng, batch), _ext(rng, batch)
    zeta_next = gle.mul(zeta, np.array([5, 0], dtype=U64))
    zp, znp = fd.ext_powers_each(zeta, n), fd.ext_powers_each(zeta_next, n)
    zi = fd.ext_powers_each(gle.inverse(zeta), n)
    zni = fd.ext_powers_each(gle.inverse(zeta_next), n)
    apow = fd.ext_powers_each(alpha, k)
    s = gle.powmod(alpha, num_zs)
    rows = _rows(oracles, num_zs)
    comp = fri_cuda.reduce_alpha(rows, _pts(alpha), lib=flib)
    f0, f1 = fri_cuda.compose(*comp, _pts(zeta, zeta_next, s), lib=flib)
    run = jax.jit(jfd._make_compose_run(num_zs, None))
    for b in range(batch):
        sets = tuple(_gf(o if i == 0 else o[b]) for i, o in enumerate(oracles))
        args = [a[b] for a in (apow, zp, zi)] + [apow[b, :num_zs]] + \
            [a[b] for a in (znp, zni, s)]
        flat = [g for a in args for g in (_gf(a[..., 0]), _gf(a[..., 1]))]
        jf0, jf1 = _jax_u64(*run(sets, *flat))
        assert np.array_equal(_u(f0[b]), jf0) and np.array_equal(_u(f1[b]), jf1)


# --- K9 ----------------------------------------------------------------------------


@pytest.mark.parametrize("arity_bits", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("batch", [1, 3])
def test_k9_matches_plain_and_the_jax_fold(flib, arity_bits, batch):
    """K9's fold mode == _fold_plain and the JAX package's _fold_dev
    (jitted up to JIT_FOLD_MAX_BITS, op by op above) at every arity, lanes
    of 0, 1 and p - 1, betas at p - 1, the betas on the host."""
    rng = np.random.default_rng(90 + arity_bits + batch)
    size = 64
    c = _ext(rng, batch, size, edges=True)
    c[0, -(1 << arity_bits):] = P - 1       # a whole fiber at p - 1
    beta = _ext(rng, batch)
    beta[0] = P - 1
    c0, c1 = _pair(c)
    got = fri_cuda.fold(c0, c1, beta, arity_bits, lib=flib)
    assert got[0].shape == (batch, size >> arity_bits)
    assert _equal(got, fd._fold_plain(c0, c1, *_pair(beta), arity_bits))
    run = _JAX_FOLD if arity_bits <= JIT_FOLD_MAX_BITS else jfd._fold_dev
    for b in range(batch):
        j0, j1 = _jax_u64(*run(_gf(c[b, :, 0]), _gf(c[b, :, 1]), _gf(beta[b, 0]),
                               _gf(beta[b, 1]), arity_bits))
        assert np.array_equal(_u(got[0][b]), j0) and np.array_equal(_u(got[1][b]), j1)


def test_k9_shard_form_and_strides(flib):
    """The sharded path's call, a 1-D piece with one beta, and a strided
    batch (a view of every other row): equal to _fold_plain."""
    rng = np.random.default_rng(99)
    c = _ext(rng, 4, 256, edges=True)
    beta = _ext(rng, 4)
    c0, c1 = _pair(c)
    b0, b1 = _pair(beta)
    got = fri_cuda.fold(c0[1], c1[1], beta[1], 4, lib=flib)
    assert got[0].shape == (16,)
    assert _equal(got, fd._fold_plain(c0[1], c1[1], b0[1], b1[1], 4))
    got = fri_cuda.fold(c0[::2], c1[::2], beta[::2], 2, lib=flib)
    assert _equal(got, fd._fold_plain(c0[::2], c1[::2], b0[::2], b1[::2], 2))


@pytest.mark.parametrize("arity_bits,lanes_threads", [(1, 32), (4, 64), (6, 128), (8, 32)])
def test_k9_fold_lanes_and_blocks(flib, arity_bits, lanes_threads):
    """The fold mode's lanes: blocks of 32-128 threads (outputs split over
    blocks), arity 2^8 (each lane's Horner over 8 coefficients with
    gamma = beta^32), a batch of K9_MAX_BATCH + 3 proofs (two launches),
    every coefficient and beta 0, 1 or p - 1 in turn."""
    rng = np.random.default_rng(arity_bits)
    flib.shim_k9_set_threads(lanes_threads, 0)
    try:
        batch, size = fri_cuda.K9_MAX_BATCH + 3, 1 << 9
        c = _ext(rng, batch, size, edges=True)
        beta = _ext(rng, batch)
        for k, v in enumerate(EDGES):
            c[k] = v
            beta[k] = v
        c0, c1 = _pair(c)
        got = fri_cuda.fold(c0, c1, beta, arity_bits, lib=flib)
    finally:
        flib.shim_k9_set_threads(128, 0)
    assert _equal(got, fd._fold_plain(c0, c1, *_pair(beta), arity_bits))


# (arity bits, next arity bits, rate bits, B, log2 of the folded length)
K9_ROUNDS = [(1, 1, 1, 1, 1), (2, 1, 3, 3, 3), (3, 2, 2, 1, 4), (4, 4, 3, 1, 9),
             (4, 4, 3, 3, 5), (5, 1, 3, 1, 6), (5, 5, 1, 3, 5), (6, 3, 2, 1, 7),
             (6, 5, 3, 3, 6), (2, 2, 1, 1, 13), (4, 1, 3, 1, 2), (1, 4, 2, 3, 4)]


@pytest.mark.parametrize("arity_bits,next_bits,rate_bits,batch,log_m", K9_ROUNDS)
def test_k9_round_matches_plain(flib, arity_bits, next_bits, rate_bits, batch, log_m):
    """K9's round mode == _fold_round_plain (the fold, the coset NTT, the
    fiber leaves): arity bits 1-6, next arity bits 1-5, rate bits 1-3, B = 1
    and 3, folded lengths 2-2^13 (one K4 round up to 2^4, two, three, the
    2^13 pass of four), coefficients with lanes of 0, 1 and p - 1 and proof
    0 a constant p - 1, betas at the edges."""
    rng = np.random.default_rng(arity_bits * 100 + next_bits * 10 + rate_bits + batch)
    size = 1 << (log_m + arity_bits)
    c = _ext(rng, batch, size, edges=True)
    if batch > 1:
        c[1] = P - 1
    beta = _ext(rng, batch, edges=True)
    shift = pow(7, 1 << (arity_bits + 1), P)
    c0, c1 = _pair(c)
    got = fri_cuda.fold_round(c0, c1, beta, arity_bits, next_bits, rate_bits, shift, lib=flib)
    want = fd._fold_round_plain(c0, c1, *_pair(beta), arity_bits, next_bits, rate_bits, shift)
    assert got[2].shape == (batch, (1 << (log_m + rate_bits - next_bits)), 2 << next_bits)
    assert _equal(got, want)


@pytest.mark.parametrize("value", [0, 1, P - 1])
@pytest.mark.parametrize("group_log", [0, 1, 2, 3])
def test_k9_round_groups_and_edges(flib, value, group_log):
    """Every coefficient and beta 0, 1 or p - 1, each group of cosets that
    folds once (1, 2, 4, 8 blocks: a cluster on the card) at rate 2^3 and
    the wormhole's arity, over a strided batch (every other row of a
    view) of 2 and a batch of K9_MAX_BATCH + 1 (two launches); ==
    _fold_round_plain."""
    rng = np.random.default_rng(group_log)
    c = np.full((4, 1 << 8, 2), value, dtype=U64)
    beta = np.full((4, 2), value, dtype=U64)
    c0, c1 = _pair(c)
    args = (4, 2, 3, pow(7, 16, P))
    got = fri_cuda.fold_round(c0[::2], c1[::2], beta[::2], *args, lib=flib, group_log=group_log)
    want = fd._fold_round_plain(c0[::2], c1[::2], *_pair(beta[::2]), *args)
    assert _equal(got, want)
    batch = fri_cuda.K9_MAX_BATCH + 1
    c = _ext(rng, batch, 1 << 7, edges=True)
    beta = _ext(rng, batch, edges=True)
    c0, c1 = _pair(c)
    got = fri_cuda.fold_round(c0, c1, beta, *args, lib=flib, group_log=group_log)
    assert _equal(got, fd._fold_round_plain(c0, c1, *_pair(beta), *args))


# (arity bits, next arity bits, rate bits, log2 of the folded length): the
# JAX program jitted, its unrolled Horner kept to arity bits 2 (XLA's CPU
# compile of arity 8 took 32 s here)
K9_JAX_ROUNDS = [(1, 2, 2, 3), (2, 1, 1, 2), (2, 2, 3, 4)]


@pytest.mark.parametrize("arity_bits,next_bits,rate_bits,log_m", K9_JAX_ROUNDS)
def test_k9_round_matches_the_jax_fold_commit_run(flib, arity_bits, next_bits, rate_bits,
                                                  log_m):
    """K9's round mode == the JAX package's _make_fold_commit_run (jitted):
    its f0, f1 and leaves, proof by proof of a batch of 3."""
    rng = np.random.default_rng(log_m + 7 * arity_bits)
    batch, size = 3, 1 << (log_m + arity_bits)
    c = _ext(rng, batch, size, edges=True)
    beta = _ext(rng, batch, edges=True)
    shift = pow(7, 1 << arity_bits, P)
    c0, c1 = _pair(c)
    f0, f1, leaves = fri_cuda.fold_round(c0, c1, beta, arity_bits, next_bits, rate_bits, shift,
                                         lib=flib)
    rows = 1 << (log_m + rate_bits - next_bits)
    run = jax.jit(jfd._make_fold_commit_run(arity_bits, next_bits, rows.bit_length() - 1,
                                            shift, rate_bits))
    for b in range(batch):
        jf0, jf1, jl = _jax_u64(*run(_gf(c[b, :, 0]), _gf(c[b, :, 1]), _gf(beta[b, 0]),
                                     _gf(beta[b, 1]))[:3])
        assert np.array_equal(_u(f0[b]), jf0) and np.array_equal(_u(f1[b]), jf1)
        assert np.array_equal(_u(leaves[b]), jl)


def test_k9_round_size_rule(flib):
    """round_fits: folded polynomials up to 2^13 coefficients (the wormhole's
    2^9 and 2^5, the level circuits' 2^10 and 2^6, a 2^16 codeword at rate
    2^3), not 2^14; the clusters' cosets and shared memory at the main
    path's shapes; the round mode refuses what the rule refuses."""
    assert fri_cuda.round_fits(1 << 13, 4) and fri_cuda.round_fits(1 << 14, 4)
    assert fri_cuda.round_fits(1 << 17, 4) and not fri_cuda.round_fits(1 << 18, 4)
    # clusters: the fewest cosets whose blocks fold in one pass (64 outputs
    # a block of 256 threads at arity 16): the wormhole's 2^9 over 8, the
    # level circuits' 2^10 over 8 and 2^6 in one block, arity 2^5's 2^6
    # over 2, 2^13 at arity 2 over 8 blocks of 512 threads
    assert [fri_cuda.round_threads(m) for m in (9, 12, 13)] == [256, 256, 512]
    assert [fri_cuda.round_group_log(3, m, a) for m, a in ((9, 4), (10, 4), (6, 4), (6, 5),
                                                           (13, 1), (1, 1))] == [3, 3, 0, 1, 3, 0]
    for log_m, group_log in ((9, 3), (10, 3), (13, 0), (13, 3), (1, 1), (5, 2)):
        call = fri_cuda._K9RoundCall(log_m=log_m, group_log=group_log)
        assert fri_cuda.round_smem(log_m, group_log) == \
            8 * flib.shim_k9_round_smem(ctypes.byref(call))
    assert fri_cuda.round_smem(9, 3) == 8 * (64 + 512 + 32 + (512 + 64) + 64)
    assert fri_cuda.round_smem(13, 0) <= 227 * 1024
    c = _pair(_ext(np.random.default_rng(1), 1, 1 << 18))
    with pytest.raises(ValueError, match="round mode"):
        fri_cuda.fold_round(*c, np.zeros((1, 2), dtype=U64), 4, 4, 3, 7, lib=flib)


# --- refusals ------------------------------------------------------------------------


def test_refusals(flib):
    """A CPU tensor without a host build, a bad arity, a table the call
    lacks, too many sets and a points table of the wrong shape raise; no
    plain fallback."""
    rng = np.random.default_rng(3)
    c0, c1 = _pair(_ext(rng, 2, 32))
    beta = _ext(rng, 2)
    b0, b1 = _pair(beta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fri_cuda.fold(c0, c1, beta, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fri_cuda.fold_round(c0, c1, beta, 2, 1, 3, 7)
    with pytest.raises(ValueError, match="on the host"):   # a tensor would cost a sync
        fri_cuda.fold(c0, c1, b0, 2, lib=flib)
    with pytest.raises(ValueError, match="betas for"):
        fri_cuda.fold(c0, c1, beta[:1], 2, lib=flib)
    for bits in (0, 6):                   # 2^6 does not divide 32
        with pytest.raises(ValueError):
            fri_cuda.fold(c0, c1, beta, bits, lib=flib)
    with pytest.raises(ValueError, match="round mode"):   # next arity above the fold
        fri_cuda.fold_round(c0, c1, beta, 2, 4, 3, 7, lib=flib)
    x = _t(_rand(rng, 2, 3, 32))
    pts = _pts(_ext(rng, 2))
    with pytest.raises(ValueError, match="table"):
        fri_cuda.openings([(x, 1)], pts, lib=flib)
    with pytest.raises(ValueError):
        fri_cuda.openings([(x, 0)] * 9, pts, lib=flib)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fri_cuda.openings([(x, 0)], pts)
    with pytest.raises(ValueError, match="points"):
        fri_cuda.compose(_pair(_ext(rng, 2, 32)), _pair(_ext(rng, 2, 32)), pts, lib=flib)
    with pytest.raises(ValueError, match="powers of alpha"):
        fri_cuda.reduce_alpha([(x, 0, fri_cuda.MAX_POW - 2)], pts, lib=flib)
    with pytest.raises(ValueError):
        fd.fold(c0.to("meta"), c1.to("meta"), beta, 2)
    with pytest.raises(ValueError):
        fd.fold_round(c0.to("meta"), c1.to("meta"), beta, 2, 1, 3, 7)


# --- the slice: whole proofs through the shim -----------------------------------------


FRI_ROUNDS = dict(proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2,
                  final_poly_bits=1)


def _square(builder, witness, config, **build_kw):
    b = builder.CircuitBuilder(config.CircuitConfig(
        zero_knowledge=True, fri_config=config.FriConfig(**FRI_ROUNDS)))
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    data = b.build(**build_kw)

    def pw(v):
        w = witness.PartialWitness()
        w.set_target(x, v)
        return w

    return data, pw


@pytest.fixture
def through_shim(flib, monkeypatch):
    """fri_device's plain versions replaced by the kernels through the
    shim, each call counted by kernel (K9's round mode as ``k9_round``
    too); the betas go to K9 on the host, as on the card."""
    calls = types.SimpleNamespace(k7=0, k8=0, k9=0, k9_round=0)

    def via(name, kernel):
        def run(*args):
            setattr(calls, kernel, getattr(calls, kernel) + 1)
            if kernel == "k9":   # (c0, c1, b0, b1, ...): the betas back to the host
                calls.k9_round += name == "fold_round"
                args = (*args[:2], gfd.to_ext(*args[2:4]), *args[4:])
            return getattr(fri_cuda, name)(*args, lib=flib)
        return run

    for plain, name, kernel in (("_openings_plain", "openings", "k7"),
                                ("_reduce_alpha_plain", "reduce_alpha", "k8"),
                                ("_compose_plain", "compose", "k8"),
                                ("_fold_plain", "fold", "k9"),
                                ("_fold_round_plain", "fold_round", "k9")):
        monkeypatch.setattr(fd, plain, via(name, kernel))
    return calls


def test_batch_and_sharded_proofs_through_the_shim(through_shim):
    """A zk square circuit with FRI fold rounds: a batch of 2 and a
    sharded proof over a 2-shard CPU mesh, every FRI field operation
    through K7-K9's host build, byte-equal to the JAX host path's proofs;
    K7 once, K8 twice and K9 once a fold round for the batch (the round
    mode but in the last round), and a call a shard for the sharded
    proof (the fold mode alone)."""
    ref, ref_pw = _square(j_builder, j_witness, j_config)
    want = {v: j_bytes(j_prove(ref, ref_pw(v), use_device=False)) for v in (3, 7)}
    data, pw = _square(t_builder, t_witness, t_config, device="cpu")
    rounds = len(data.common.config.fri_config.reduction_arities(data.common.degree_bits))
    assert rounds >= 1
    proofs = prove_batch(data, [pw(3), pw(7)], device="cpu")
    assert [t_bytes(p) for p in proofs] == [want[3], want[7]]
    assert vars(through_shim) == {"k7": 1, "k8": 2, "k9": rounds, "k9_round": rounds - 1}
    proof = prove_sharded(data, pw(7), make_mesh(2, device="cpu"))
    assert t_bytes(proof) == want[7]
    assert through_shim.k7 == 1 + 2 + 1 and through_shim.k8 == 2 + 2 + 2
    assert through_shim.k9_round == rounds - 1


def test_arity_32_proof_through_the_shim(through_shim):
    """chip_smoke's mul chain (degree 2^11) under FRI folds of arity 2^5
    (arities [5, 1]), every FRI field operation through K7-K9's host
    build: its bytes are the JAX host path's (the pin that
    tests/test_torch_jax_pins.py derives from the JAX package)."""
    import hashlib

    import chip_smoke

    data, pw = chip_smoke.mul_chain(t_builder, t_witness, t_config, "arity5", device="cpu")
    assert data.common.config.fri_config.reduction_arities(data.common.degree_bits) == [5, 1]
    proof = prove_batch(data, [pw], device="cpu")[0]
    assert hashlib.sha256(t_bytes(proof)).hexdigest() == \
        chip_smoke.GOLDEN_MUL_CHAIN_SHA256["arity5"]
    assert vars(through_shim) == {"k7": 1, "k8": 2, "k9": 2, "k9_round": 1}
