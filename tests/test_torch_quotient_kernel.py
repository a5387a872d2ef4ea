"""K5 (the vanishing polynomial over the LDE coset) and K6 (the
permutation argument's products over H), built for the host.

csrc/quotient.cuh and csrc/permutation.cuh are __host__ __device__ code;
here they are compiled with g++ behind a host copy of quotient.cu's and
permutation.cu's C interfaces (k5_vanishing, k6_products and their
K5Call/K6Call sizes) and driven through the wrappers' own
``quotient_cuda.vanishing`` and ``permutation_cuda.products`` on CPU
tensors.  A K5 call runs each proof's block tables, then its points one
after another; K6's two launches run ``k6_point_block`` and
``k6_scan_block`` block by block, each block's threads in turn in each
phase (``shim_k6_set_shape`` picks the point and scan blocks' threads and
the SM count the tiles are sized from: 320, 256 and 132 on the card; the
tests force tiles of 1 to 256 points through the wrapper's
``MIN_TILE``/``MAX_TILE``).  Equal integers are required against the port's plain
versions (``plonk/prover.py::_device_vanishing_eval`` times 1/Z_H,
``_zs_values_plain``) and the JAX package's host path
(``plonk/prover.py::compute_quotient_values(..., use_device=False)`` and
``compute_zs_and_partial_products``).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_gates import (arithmetic_extension_gate, arithmetic_gate, base_sum_gate,
                              constant_gate, poseidon_gate, random_access_gate)
from test_torch_prover import JAX, TORCH, _build, _witness
from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.iop import gates as t_gates
from zk_circuits_torch.plonk import circuit_data as t_cd
from zk_circuits_torch.plonk import permutation_cuda, quotient_cuda
from zk_circuits_torch.plonk.prover import _device_vanishing_eval, _zs_values_plain
from zk_circuits_torch.utils import nvcc
from zk_circuits_tpu.host import gl as jgl
from zk_circuits_tpu.iop import gates as j_gates
from zk_circuits_tpu.iop import witness as j_witness
from zk_circuits_tpu.plonk import circuit_data as j_cd
from zk_circuits_tpu.plonk import prover as j_prover

P = jgl.P_INT
U64 = np.uint64
CIRCUITS = [constant_gate, arithmetic_gate, base_sum_gate, arithmetic_extension_gate,
            random_access_gate, poseidon_gate]

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

SHIM = r"""
#include <vector>
#include "quotient.cuh"
#include "permutation.cuh"

static const uint64_t RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;
static int shim_point = 320, shim_scan = 256, shim_sms = 132;   // K6's blocks and SMs, as on the card

// A block on the host: each phase runs the block's threads in turn.
struct ShimBlock {
  int n;
  int threads() const { return n; }
  template <class F>
  void each(F f) const {
    for (int t = 0; t < n; t++) f(t);
  }
  void sync() const {}
};

// K5's two launches: every point's permutation terms, then its gates.
template <int NC>
static void k5_host(const K5Call& c) {
  std::vector<uint64_t> apow(NC * K5_MAX_POW), am(NC), bk(NC * PERM_MAX_ROUTED);
  for (int b = 0; b < c.batch; b++) {
    k5_perm_tables<NC>(c, b, am.data(), bk.data(), 0, 1);
    for (long long i = 0; i < c.points; i++) k5_perm_point<NC>(c, b, i, am.data(), bk.data());
  }
  for (int b = 0; b < c.batch; b++) {
    k5_alpha_table<NC>(c, b, apow.data(), 0, 1);
    for (long long i = 0; i < c.points; i++) k5_gate_point<NC>(c, b, i, apow.data(), RC);
  }
}

// K6's point launch: every tile of every proof.
template <int NC>
static void k6_points_host(const K6Call& c) {
  ShimBlock blk{shim_point};
  std::vector<uint64_t> sm(k6_point_smem(k6_chunks(c), NC, c.tile));
  for (int b = 0; b < c.batch; b++)
    for (long long g = 0; g < k6_tiles(c); g++) k6_point_block<NC>(blk, c, b, g, sm.data());
}

extern "C" {
int k5_vanishing(int, const K5Call* call, void*) {
  const K5Call& c = *call;
  if (k5_valid(c)) return 1;
  switch (c.nc) {
    case 1: k5_host<1>(c); break;
    case 2: k5_host<2>(c); break;
    case 3: k5_host<3>(c); break;
    default: k5_host<4>(c); break;
  }
  return 0;
}
int k5_call_size(void) { return (int)sizeof(K5Call); }

int k6_products(int, const K6Call* call, int step, void*) {
  const K6Call& c = *call;
  if (k6_valid(c) || shim_point % k6_lanes(c.tile) || step < 0 || step > 1) return 1;
  if (step == 0) {
    switch (c.nc) {
      case 1: k6_points_host<1>(c); break;
      case 2: k6_points_host<2>(c); break;
      case 3: k6_points_host<3>(c); break;
      default: k6_points_host<4>(c); break;
    }
    return 0;
  }
  ShimBlock blk{shim_scan};
  std::vector<uint64_t> sm(k6_scan_smem(c.nc, shim_scan, c.tile));
  for (int b = 0; b < c.batch; b++)
    for (long long g = 0; g < k6_tiles(c); g++) k6_scan_block(blk, c, b, g, sm.data());
  return 0;
}
int k6_call_size(void) { return (int)sizeof(K6Call); }

int k6_challenges(int routed, int q, int tile) { return k6_max_ch(routed, q, tile); }
int k6_sm_count(int) { return shim_sms; }
int k6_point_threads(void) { return shim_point; }

void shim_k6_set_shape(int point, int scan, int sms) {
  shim_point = point;
  shim_scan = scan;
  shim_sms = sms;
}
void shim_k6_inverse(const uint64_t* a, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_canon(k6_inverse(a[i]));
}
}
"""


@pytest.fixture(scope="module")
def qlib():
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"k5_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    poseidon_cuda.write_constants_header(build)
    src = build / "k5_shim.cc"
    src.write_text(SHIM)
    so = build / "libk5shim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(nvcc.CSRC),
                    "-I", str(build), "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    quotient_cuda.bind(lib)        # the wrappers' declarations and mirror checks
    permutation_cuda.bind(lib)
    lib.shim_k6_set_shape.argtypes = [ctypes.c_int] * 3
    lib.shim_k6_inverse.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    yield lib
    shutil.rmtree(build, ignore_errors=True)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=U64).view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(U64)


# --- circuits ----------------------------------------------------------------------


def _wormhole_gates(g):
    """The gate types of the zk wormhole circuit (the port's build of it,
    13 rows: Poseidon, Arithmetic(20), BaseSum2(32), BaseSum2(5),
    Constant(2), PublicInput, Noop in groups [[0, 1], [2, 3, 4, 5, 6]])."""
    return [g.PoseidonGate(), g.ArithmeticGate(num_ops=20), g.BaseSum2Gate(num_limbs=32),
            g.BaseSum2Gate(num_limbs=5), g.ConstantGate(num_consts=2), g.PublicInputGate(),
            g.NoopGate()]


def _common(cd, gates, cfg, degree_bits):
    """A package's CommonCircuitData for these gate types, with its own
    bookkeeping of build_circuit_data (sort, selector groups)."""
    gate_types = sorted(gates, key=lambda g: (-g.degree, g.id))
    groups = cd._selector_groups(gate_types, cfg.max_quotient_degree_factor)
    return cd.CommonCircuitData(
        config=cfg, degree_bits=degree_bits, gate_types=gate_types, selector_groups=groups,
        gate_to_group={gate_types[gi].id: k for k, grp in enumerate(groups) for gi in grp},
        gate_to_index={g.id: i for i, g in enumerate(gate_types)},
        num_gate_constraints=max(g.num_constraints for g in gate_types),
        num_public_inputs=0,
        k_is=jgl.powers(jgl.MULTIPLICATIVE_GROUP_GENERATOR, cfg.num_routed_wires))


def _wormhole_commons(**cfg_kw):
    tc = _common(t_cd, _wormhole_gates(t_gates), TORCH.C(zero_knowledge=True, **cfg_kw), 13)
    jc = _common(j_cd, _wormhole_gates(j_gates), JAX.C(zero_knowledge=True, **cfg_kw), 13)
    return tc, jc


@pytest.fixture(scope="module")
def gate_circuits():
    """Each gate circuit of tests/test_torch_gates.py built by both
    packages: (port data, assignments, JAX data)."""
    out = {}
    for circuit in CIRCUITS:
        data, assign = _build(TORCH, circuit, False, device="cpu")
        jdata, _ = _build(JAX, circuit, False)
        out[circuit.__name__] = (data, assign, jdata)
    return out


# --- K5 ------------------------------------------------------------------------------


def _k5_inputs(common, rng, batch, points, value=None):
    """Seeded canonical inputs of a K5 call at ``points`` coset points: the
    circuit's cs (k, points), the proofs' wires (B, W + 4, points) and zsp
    (B, nc (1 + pp) + 4, points) (4 salt rows each, which K5 does not
    read), coset tables, pi hashes (B, 1, 4) and challenges (nc, B, 1);
    every value ``value`` when it is given."""
    cfg = common.config
    nc = cfg.num_challenges
    pp = -(-cfg.num_routed_wires // common.quotient_degree_factor) - 1

    def draw(*shape):
        if value is not None:
            return np.full(shape, value, dtype=U64)
        a = rng.integers(0, P, shape, dtype=U64)
        k = min(3, a.size)
        a.reshape(-1)[:k] = np.array([0, 1, P - 1], dtype=U64)[:k]
        return a

    return dict(cs=draw(common.num_constants_sigmas_polys, points),
                wires=draw(batch, cfg.num_wires + 4, points),
                zsp=draw(batch, nc * (1 + pp) + 4, points),
                tables=tuple(draw(points) for _ in range(3)),
                pi_hash=draw(batch, 1, 4), betas=draw(nc, batch, 1),
                gammas=draw(nc, batch, 1), alphas=draw(nc, batch, 1))


def _k5(qlib, common, inp, **kw):
    """K5 on the host shim through the wrapper: (nc, B, points)."""
    out = quotient_cuda.vanishing(
        common, _t(inp["cs"]), _t(inp["wires"]), _t(inp["zsp"]),
        tuple(_t(a) for a in inp["tables"]), _t(inp["pi_hash"]), _t(inp["betas"]),
        _t(inp["gammas"]), _t(inp["alphas"]), lib=qlib, **kw)
    return _u(out)


def _k5_plain(common, inp):
    """The port's plain version: _device_vanishing_eval times 1/Z_H."""
    from zk_circuits_torch.field import goldilocks as gfd

    x, l1, zh_inv = (_t(a) for a in inp["tables"])
    vans = _device_vanishing_eval(
        common, _t(inp["cs"]).t(), _t(inp["wires"]).transpose(-1, -2),
        _t(inp["zsp"]).transpose(-1, -2), x, l1, _t(inp["pi_hash"]), _t(inp["betas"]),
        _t(inp["gammas"]), _t(inp["alphas"]))
    return _u(gfd.mul(torch.stack(vans), zh_inv))


def _k5_jax(jcommon, inp):
    """The JAX host path, proof by proof, times 1/Z_H: (nc, B, points)."""
    x, l1, zh_inv = inp["tables"]
    out = []
    for b in range(inp["wires"].shape[0]):
        vans = j_prover.compute_quotient_values(
            jcommon, inp["cs"].T, inp["wires"][b].T, inp["zsp"][b].T, x, l1,
            inp["pi_hash"][b], inp["betas"][:, b, 0], inp["gammas"][:, b, 0],
            inp["alphas"][:, b, 0], use_device=False)
        out.append([jgl.mul(v, zh_inv) for v in vans])
    return np.stack(out, axis=1)


@pytest.mark.parametrize("name", [c.__name__ for c in CIRCUITS])
def test_k5_gate_circuits_match_plain_and_jax(qlib, gate_circuits, name):
    """Each gate circuit's common (its gate types, selector groups and
    filters) at its 2^8-point coset, B = 2, seeded values."""
    data, _, jdata = gate_circuits[name]
    common = data.common
    inp = _k5_inputs(common, np.random.default_rng(len(name)), 2, common.lde_size)
    got = _k5(qlib, common, inp)
    assert got.shape == (common.config.num_challenges, 2, common.lde_size)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jdata.common, inp))
    assert (got < U64(P)).all()


def test_k5_wormhole_common_matches_plain_and_jax(qlib):
    """The wormhole's gate types (both packages group them alike) at 256
    points, B = 2, and one proof unbatched."""
    common, jcommon = _wormhole_commons()
    assert common.selector_groups == jcommon.selector_groups == [[0, 1], [2, 3, 4, 5, 6]]
    assert common.num_gate_constraints == 123
    inp = _k5_inputs(common, np.random.default_rng(7), 2, 256)
    got = _k5(qlib, common, inp)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jcommon, inp))
    one = {k: (v[:1] if k in ("wires", "zsp", "pi_hash") else
               v[:, :1] if k in ("betas", "gammas", "alphas") else v) for k, v in inp.items()}
    single = quotient_cuda.vanishing(
        common, _t(one["cs"]), _t(one["wires"][0]), _t(one["zsp"][0]),
        tuple(_t(a) for a in one["tables"]), _t(one["pi_hash"]), _t(one["betas"]),
        _t(one["gammas"]), _t(one["alphas"]), lib=qlib)
    assert np.array_equal(_u(single), got[:, 0])


@pytest.mark.parametrize("value", [0, 1, P - 1])
def test_k5_constant_rows_match_plain(qlib, value):
    """Every input 0, 1 or p - 1."""
    common, jcommon = _wormhole_commons()
    inp = _k5_inputs(common, None, 1, 64, value=value)
    got = _k5(qlib, common, inp)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jcommon, inp))


def test_k5_short_last_chunk_matches_plain_and_jax(qlib):
    """78 routed wires in chunks of 8: a last chunk of 6, which the
    generic permutation terms take (plonk/vanishing.py:116)."""
    common, jcommon = _wormhole_commons(num_routed_wires=78)
    assert common.num_partial_products == 9
    inp = _k5_inputs(common, np.random.default_rng(78), 2, 64)
    got = _k5(qlib, common, inp)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jcommon, inp))


def test_k5_odd_last_chunk_matches_plain_and_jax(qlib):
    """77 routed wires in chunks of 8: a last chunk of 5, whose first
    factor stands alone before the pairs (perm_chunk.cuh)."""
    common, jcommon = _wormhole_commons(num_routed_wires=77)
    inp = _k5_inputs(common, np.random.default_rng(77), 2, 64)
    got = _k5(qlib, common, inp)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jcommon, inp))


@pytest.mark.parametrize("shards", [2, 4])
def test_k5_sharded_rows_with_halo_match_whole(qlib, shards):
    """The sharded path's calls: shard d's rows, row0 = d r, zs at g x
    from its own rows and the next shard's first 2^rate_bits (the halo),
    as plonk/prover_sharded.py::_quotient_sharded makes them; together
    equal to the single call, which wraps at the coset's end."""
    common, _ = _wormhole_commons()
    nc, rate = common.config.num_challenges, 1 << common.config.rate_bits
    points = 128
    r = points // shards
    inp = _k5_inputs(common, np.random.default_rng(shards), 1, points)
    whole = _k5(qlib, common, inp)
    zsp = inp["zsp"][0]
    parts = []
    for d in range(shards):
        rows = slice(d * r, (d + 1) * r)
        halo = zsp[:nc, ((d + 1) % shards) * r:((d + 1) % shards) * r + rate]
        zs_next = np.concatenate([zsp[:nc, d * r + rate:(d + 1) * r], halo], axis=1)
        out = quotient_cuda.vanishing(
            common, _t(inp["cs"][:, rows]), _t(inp["wires"][0][:, rows]), _t(zsp[:, rows]),
            tuple(_t(a) for a in inp["tables"]), _t(inp["pi_hash"]), _t(inp["betas"]),
            _t(inp["gammas"]), _t(inp["alphas"]), zs_next=_t(zs_next), row0=d * r, lib=qlib)
        parts.append(_u(out))
    assert np.array_equal(np.concatenate(parts, axis=-1), whole[:, 0])


def test_k5_five_challenges_match_plain_and_jax(qlib):
    """Five challenges: two launches through the wrapper (challenges 0-3,
    then 4, their rows read in place), B = 2, equal to the plain version
    and the JAX host path."""
    common, jcommon = _wormhole_commons(num_challenges=5)
    assert common.config.num_challenges == 5 > quotient_cuda.MAX_CH
    inp = _k5_inputs(common, np.random.default_rng(55), 2, 64)
    got = _k5(qlib, common, inp)
    assert got.shape == (5, 2, 64)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jcommon, inp))


def test_k5_poseidon_gate_at_edge_values(qlib):
    """The Poseidon gate alone (beside a NoopGate), every wire, constant and
    challenge drawn from 0, 1, p - 1 and p - 2 or seeded, B = 2."""
    cfg = TORCH.C(zero_knowledge=True)
    common = _common(t_cd, [t_gates.PoseidonGate(), t_gates.NoopGate()], cfg, 6)
    jcommon = _common(j_cd, [j_gates.PoseidonGate(), j_gates.NoopGate()],
                      JAX.C(zero_knowledge=True), 6)
    rng = np.random.default_rng(12)
    inp = _k5_inputs(common, rng, 2, 128)
    edges = np.array([0, 1, P - 1, P - 2], dtype=U64)
    for k, v in inp.items():
        for a in (v if k == "tables" else (v,)):
            pick = rng.integers(0, 2 * len(edges), a.shape)
            a[pick < len(edges)] = edges[pick[pick < len(edges)]]
    got = _k5(qlib, common, inp)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jcommon, inp))


def test_k5_random_access_at_its_largest_bits(qlib):
    """A random-access gate of 6 bits, the most a copy's index, claimed
    element and 2^bits list take of the standard config's 80 routed wires
    (one copy), beside a NoopGate, B = 2."""
    cfg = TORCH.C(zero_knowledge=True)
    common = _common(t_cd, [t_gates.RandomAccessGate(bits=6, num_copies=1),
                            t_gates.NoopGate()], cfg, 6)
    jcommon = _common(j_cd, [j_gates.RandomAccessGate(bits=6, num_copies=1),
                             j_gates.NoopGate()], JAX.C(zero_knowledge=True), 6)
    inp = _k5_inputs(common, np.random.default_rng(64), 2, 128)
    bits = inp["wires"][:, 66:72]            # some rows' index bits boolean
    bits[..., :64] = np.random.default_rng(65).integers(0, 2, bits[..., :64].shape, dtype=U64)
    got = _k5(qlib, common, inp)
    assert np.array_equal(got, _k5_plain(common, inp))
    assert np.array_equal(got, _k5_jax(jcommon, inp))


def test_k5_refuses_unknown_gates_and_bad_calls(qlib):
    """A gate class without an evaluator (a subclass too) raises
    NotImplementedError; wrong shapes, devices and shifts raise ValueError."""

    class Custom(t_gates.ArithmeticGate):
        pass

    common, _ = _wormhole_commons()
    bad = _common(t_cd, [Custom(num_ops=3), t_gates.NoopGate()], common.config, 4)
    with pytest.raises(NotImplementedError, match="no evaluator"):
        quotient_cuda.circuit_blob(bad)
    inp = _k5_inputs(bad, np.random.default_rng(1), 1, 32)
    with pytest.raises(NotImplementedError):
        _k5(qlib, bad, inp)
    inp = _k5_inputs(common, np.random.default_rng(1), 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        _k5(None, common, inp)
    short = dict(inp, wires=inp["wires"][:, :100])
    with pytest.raises(ValueError, match="wires"):
        _k5(qlib, common, short)
    with pytest.raises(ValueError, match="zs shift"):
        _k5(qlib, common, _k5_inputs(common, np.random.default_rng(1), 1, 8))


def test_k5_table_records(gate_circuits):
    """The blob's header and records against the common they come from."""
    data, _, _ = gate_circuits["random_access_gate"]
    common = data.common
    blob = quotient_cuda.circuit_blob(common)
    head, routed = blob[:quotient_cuda.HEAD], common.config.num_routed_wires
    assert list(head[:10]) == [len(common.gate_types), common.num_selectors, 2, routed, 8, 10,
                               9, common.num_gate_constraints, 2, 135]
    assert np.array_equal(blob[16:16 + routed].view(U64), common.k_is)
    recs = blob[16 + routed:].reshape(-1, quotient_cuda.GATE_FIELDS)
    for gate, rec in zip(common.gate_types, recs):
        grp = common.gate_to_group[gate.id]
        assert rec[3] == grp and rec[5] == common.num_gate_constraints - gate.num_constraints
        others = [g for g in common.selector_groups[grp] if g != common.gate_to_index[gate.id]]
        assert list(rec[6:6 + rec[4]]) == others + [common.unused_selector]
    ra = recs[[g.id for g in common.gate_types].index("RandomAccessGate(bits=4,copies=4)")]
    assert list(ra[:3]) == [6, 4, 4]


# --- K6 ------------------------------------------------------------------------------


CARD_SHAPE = (None, 320, 256)   # K6's tile (None: sized by the wrapper), point and scan threads


def _k6(qlib, common, wv, sig, x, betas, gammas, shape=CARD_SHAPE):
    """K6 through the wrapper on the host shim, its blocks of ``shape``
    (points a tile, point-block threads, scan-block threads)."""
    tile, point, scan = shape
    saved = permutation_cuda.MIN_TILE, permutation_cuda.MAX_TILE
    if tile:
        permutation_cuda.MIN_TILE = permutation_cuda.MAX_TILE = tile
    qlib.shim_k6_set_shape(point, scan, 132)
    try:
        values, finals = permutation_cuda.products(common, _t(wv), _t(sig), _t(x), _t(betas),
                                                   _t(gammas), lib=qlib)
    finally:
        permutation_cuda.MIN_TILE, permutation_cuda.MAX_TILE = saved
        qlib.shim_k6_set_shape(*CARD_SHAPE[1:], 132)
    return _u(values), _u(finals)


def _k6_plain(common, wv, sig, x, betas, gammas):
    values, finals = _zs_values_plain(common, _t(wv), _t(sig), _t(x), _t(betas), _t(gammas))
    return _u(values), _u(finals)


@pytest.mark.parametrize("name", [c.__name__ for c in CIRCUITS])
def test_k6_valid_witness_matches_plain_and_jax(qlib, gate_circuits, name):
    """Each gate circuit's witness on H (JAX host witness, equal circuits):
    Z and the partial products equal the JAX package's
    compute_zs_and_partial_products and the plain version, B = 2 with
    each proof's own challenges, and every closing product is 1."""
    data, assign, jdata = gate_circuits[name]
    common, po = data.common, data.prover_only
    wires, _ = j_witness.generate_witness(jdata, _witness(JAX, assign))   # (n, W)
    routed = common.config.num_routed_wires
    wv = np.stack([wires.T[:routed]] * 2)
    rng = np.random.default_rng(len(name) + 100)
    betas, gammas = (rng.integers(0, P, (2, 2, 1), dtype=U64) for _ in range(2))
    got, finals = _k6(qlib, common, wv, po.sigmas_values, po.subgroup, betas, gammas,
                       (4, 12, 8))
    want, want_finals = _k6_plain(common, wv, po.sigmas_values, po.subgroup, betas, gammas)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)
    assert (finals == 1).all()
    for b in range(2):
        ref = j_prover.compute_zs_and_partial_products(
            jdata.common, jdata.prover_only, wires, betas[:, b, 0], gammas[:, b, 0])
        assert np.array_equal(got[b], ref)


# scan threads -> the blocks' shape: tiles of 1 to 256 points (one run of
# lanes or several), point blocks of 1 to 8 runs, scan blocks of 1 to 1024
SHAPES = {1: (1, 1, 1), 4: (4, 8, 4), 32: (64, 96, 32), 1024: (256, 320, 1024)}


@pytest.mark.parametrize("threads", [1, 4, 32, 1024])
def test_k6_random_values_and_zero_denominator(qlib, threads):
    """Random values on H (the product does not close), with one
    denominator of one chunk of one point 0: its inverse is masked to 0, as
    the plain version's 1/0, and that chunk's ratio zeroes the rest of the
    scan; tiles of 1 to 256 points (256 tiles to 1), point blocks of 1 to
    8 runs of lanes, scan blocks of 1 to 1024 threads."""
    common, _ = _wormhole_commons()
    n, routed, nc = 256, 80, 2
    rng = np.random.default_rng(threads)
    wv = rng.integers(0, P, (3, routed, n), dtype=U64)
    sig = rng.integers(0, P, (routed, n), dtype=U64)
    x = jgl.powers(jgl.primitive_root_of_unity(8), n)
    betas, gammas = (rng.integers(0, P, (nc, 3, 1), dtype=U64) for _ in range(2))
    b, j, i = 1, 13, 77
    wv[b, j, i] = (P - int(jgl.add(jgl.mul(betas[0, b, 0], sig[j, i]), gammas[0, b, 0]))) % P
    got, finals = _k6(qlib, common, wv, sig, x, betas, gammas, SHAPES[threads])
    want, want_finals = _k6_plain(common, wv, sig, x, betas, gammas)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)
    assert (got[b, 0, i + 1:] == 0).all() and got[b, 0, i] != 0 and finals[b, 0] == 0
    assert (got < U64(P)).all()


def test_k6_short_last_chunk_matches_plain_and_jax(qlib):
    """78 routed wires in chunks of 8: a last chunk of 6.  A valid
    permutation witness made from seeded pairs of cells that swap places
    (each pair one value), so the JAX package's
    compute_zs_and_partial_products, which refuses a product that does
    not close, takes it; B = 2, each proof its own challenges."""
    from types import SimpleNamespace

    cfg_kw = dict(zero_knowledge=True, num_routed_wires=78)
    common = _common(t_cd, _wormhole_gates(t_gates), TORCH.C(**cfg_kw), 6)
    jcommon = _common(j_cd, _wormhole_gates(j_gates), JAX.C(**cfg_kw), 6)
    assert common.num_partial_products == jcommon.num_partial_products == 9
    n, routed = 64, 78
    rng = np.random.default_rng(78)
    x = jgl.powers(jgl.primitive_root_of_unity(6), n)
    ids = jgl.mul(np.asarray(common.k_is, dtype=U64)[:, None], x[None, :]).reshape(-1)
    wv = np.empty((2, routed * n), dtype=U64)
    sig = np.empty(routed * n, dtype=U64)
    pairs = rng.permutation(routed * n).reshape(-1, 2)
    sig[pairs[:, 0]], sig[pairs[:, 1]] = ids[pairs[:, 1]], ids[pairs[:, 0]]
    for b in range(2):
        v = rng.integers(0, P, len(pairs), dtype=U64)
        wv[b, pairs[:, 0]], wv[b, pairs[:, 1]] = v, v
    wv, sig = wv.reshape(2, routed, n), sig.reshape(routed, n)
    betas, gammas = (rng.integers(0, P, (2, 2, 1), dtype=U64) for _ in range(2))
    got, finals = _k6(qlib, common, wv, sig, x, betas, gammas, (4, 8, 4))
    want, want_finals = _k6_plain(common, wv, sig, x, betas, gammas)
    assert got.shape == (2, 20, n)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)
    assert (finals == 1).all()
    po = SimpleNamespace(subgroup=x, sigmas_values=sig)
    for b in range(2):
        ref = j_prover.compute_zs_and_partial_products(
            jcommon, po, wv[b].T, betas[:, b, 0], gammas[:, b, 0])
        assert np.array_equal(got[b], ref)


def test_k6_odd_last_chunk_matches_plain(qlib):
    """77 routed wires in chunks of 8 (a last chunk of 5) on random values,
    B = 2, tiles of 4 points."""
    common = _common(t_cd, _wormhole_gates(t_gates), TORCH.C(zero_knowledge=True,
                                                              num_routed_wires=77), 6)
    n, rng = 64, np.random.default_rng(7)
    wv = rng.integers(0, P, (2, 77, n), dtype=U64)
    sig = rng.integers(0, P, (77, n), dtype=U64)
    x = jgl.powers(jgl.primitive_root_of_unity(6), n)
    betas, gammas = (rng.integers(0, P, (2, 2, 1), dtype=U64) for _ in range(2))
    got, finals = _k6(qlib, common, wv, sig, x, betas, gammas, (4, 8, 4))
    want, want_finals = _k6_plain(common, wv, sig, x, betas, gammas)
    assert got.shape == (2, 20, n)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)


@pytest.mark.parametrize("value", [0, 1, P - 1])
def test_k6_constant_rows_and_unbatched(qlib, value):
    """Every input 0, 1 or p - 1, one proof unbatched (the sharded
    prover's call)."""
    common, _ = _wormhole_commons()
    n = 64
    full = np.full((80, n), value, dtype=U64)
    ch = np.full((2, 1), value, dtype=U64)
    got, finals = _k6(qlib, common, full, full, full[0], ch, ch)
    want, want_finals = _k6_plain(common, full, full, full[0], ch, ch)
    assert got.shape == (20, n) and finals.shape == (2,)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)


def test_k6_five_challenges_match_plain_and_jax(qlib):
    """Five challenges (two groups of launches, rows and closing products
    written in place): a valid permutation witness of seeded pairs of
    cells that swap places against the JAX package's
    compute_zs_and_partial_products (every product closes to 1), and
    random values with one zero denominator of challenge 4 against the
    plain version."""
    from types import SimpleNamespace

    cfg_kw = dict(zero_knowledge=True, num_challenges=5)
    common = _common(t_cd, _wormhole_gates(t_gates), TORCH.C(**cfg_kw), 6)
    jcommon = _common(j_cd, _wormhole_gates(j_gates), JAX.C(**cfg_kw), 6)
    n, routed = 64, 80
    rng = np.random.default_rng(5)
    x = jgl.powers(jgl.primitive_root_of_unity(6), n)
    ids = jgl.mul(np.asarray(common.k_is, dtype=U64)[:, None], x[None, :]).reshape(-1)
    wv = np.empty((2, routed * n), dtype=U64)
    sig = np.empty(routed * n, dtype=U64)
    pairs = rng.permutation(routed * n).reshape(-1, 2)
    sig[pairs[:, 0]], sig[pairs[:, 1]] = ids[pairs[:, 1]], ids[pairs[:, 0]]
    for b in range(2):
        v = rng.integers(0, P, len(pairs), dtype=U64)
        wv[b, pairs[:, 0]], wv[b, pairs[:, 1]] = v, v
    wv, sig = wv.reshape(2, routed, n), sig.reshape(routed, n)
    betas, gammas = (rng.integers(0, P, (5, 2, 1), dtype=U64) for _ in range(2))
    got, finals = _k6(qlib, common, wv, sig, x, betas, gammas, (4, 8, 4))
    want, want_finals = _k6_plain(common, wv, sig, x, betas, gammas)
    assert got.shape == (2, 50, n) and finals.shape == (2, 5)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)
    assert (finals == 1).all()
    po = SimpleNamespace(subgroup=x, sigmas_values=sig)
    for b in range(2):
        ref = j_prover.compute_zs_and_partial_products(
            jcommon, po, wv[b].T, betas[:, b, 0], gammas[:, b, 0])
        assert np.array_equal(got[b], ref)
    rand = rng.integers(0, P, (2, routed, n), dtype=U64)
    b, j, i = 1, 13, 7
    rand[b, j, i] = (P - int(jgl.add(jgl.mul(betas[4, b, 0], sig[j, i]), gammas[4, b, 0]))) % P
    got, finals = _k6(qlib, common, rand, sig, x, betas, gammas, (8, 24, 32))
    want, want_finals = _k6_plain(common, rand, sig, x, betas, gammas)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)
    assert finals[b, 4] == 0 and finals[b, 3] != 0


def _zero_den(wv, sig, betas, gammas, b, c, j, i):
    """Sets wire j of proof b at point i so that challenge c's denominator
    factor w + beta s + gamma there is 0."""
    wv[b, j, i] = (P - int(jgl.add(jgl.mul(betas[c, b, 0], sig[j, i]), gammas[c, b, 0]))) % P


# (name, n, the blocks' shape, zeros as (proof, challenge, wire, point))
K6_ZERO_CASES = [
    ("two_chunks_one_point", 64, (8, 24, 16), [(1, 0, 17, 37), (1, 0, 50, 37)]),
    ("each_challenge", 64, (8, 24, 16), [(0, 0, 3, 10), (0, 1, 70, 40), (1, 1, 79, 63)]),
    ("tile_edges", 256, (64, 64, 256), [(0, 0, 5, 64), (0, 1, 44, 127), (1, 0, 9, 128),
                                        (1, 1, 60, 255)]),
    ("n_not_a_tile_multiple", 100, (32, 320, 256), [(0, 1, 21, 99), (1, 0, 0, 96)]),
    ("tiles_of_one_point", 64, (1, 4, 8), [(0, 0, 8, 0), (1, 1, 33, 31)]),
]


@pytest.mark.parametrize("name,n,shape,zeros", K6_ZERO_CASES, ids=[c[0] for c in K6_ZERO_CASES])
def test_k6_zero_denominators_and_tiles(qlib, name, n, shape, zeros):
    """Random values with chunk denominators of 0 where the batch inversion
    has to mask them: two chunks of one point, a zero in each challenge,
    the first and last point of a tile, n not a multiple of the tile (the
    last tile short), tiles of one point; B = 2, against the plain
    version (1/0 = 0), and every running product from the first zero on
    is 0."""
    common, _ = _wormhole_commons()
    routed, nc = 80, 2
    rng = np.random.default_rng(n + len(name))
    wv = rng.integers(0, P, (2, routed, n), dtype=U64)
    sig = rng.integers(0, P, (routed, n), dtype=U64)
    x = rng.integers(0, P, n, dtype=U64)
    betas, gammas = (rng.integers(0, P, (nc, 2, 1), dtype=U64) for _ in range(2))
    for z in zeros:
        _zero_den(wv, sig, betas, gammas, *z)
    got, finals = _k6(qlib, common, wv, sig, x, betas, gammas, shape)
    want, want_finals = _k6_plain(common, wv, sig, x, betas, gammas)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)
    for b, c, j, i in zeros:
        t = j // 8                                  # the zero's chunk
        assert finals[b, c] == 0 and (got[b, c, i + 1:] == 0).all()
        pps = got[b, nc + c * 9: nc + (c + 1) * 9, i]
        assert (pps[t:] == 0).all()


@pytest.mark.parametrize("routed,q,n,batch,tile,group", [
    (80, 8, 1 << 13, 1, 32, 4), (80, 8, 1 << 13, 4, 128, 4), (80, 8, 1 << 14, 4, 128, 4),
    (256, 8, 1 << 13, 4, 128, 3), (256, 2, 1 << 13, 4, 32, 3), (256, 1, 32, 1, 32, 1)])
def test_k6_tile_shape(qlib, routed, q, n, batch, tile, group):
    """The tile and the challenges a launch on 132 SMs and point blocks of
    320 threads: 32 points at one wormhole proof, 128 at B = 4 and for the
    level-1 batch (its 2 x 128 chains fill the block); where a tile's
    chunk values would pass a block's shared memory, smaller tiles until
    the circuit's two challenges fit a launch, or tiles of 32 and fewer
    challenges a launch (k6_max_ch); at 256 routed wires in chunks of 1
    (one challenge a launch, two launch pairs) K6 equals the plain
    version."""
    cfg = TORCH.C(zero_knowledge=True, num_wires=max(135, routed), num_routed_wires=routed,
                  max_quotient_degree_factor=q)
    common = _common(t_cd, _wormhole_gates(t_gates), cfg, 5)
    assert permutation_cuda.tile_shape(common, n, batch, 132, qlib) == (tile, group)
    if q != 1:
        return
    rng = np.random.default_rng(routed)
    wv = rng.integers(0, P, (1, routed, n), dtype=U64)
    sig = rng.integers(0, P, (routed, n), dtype=U64)
    x = rng.integers(0, P, n, dtype=U64)
    betas, gammas = (rng.integers(0, P, (2, 1, 1), dtype=U64) for _ in range(2))
    _zero_den(wv, sig, betas, gammas, 0, 1, 200, 7)
    got, finals = _k6(qlib, common, wv, sig, x, betas, gammas)
    want, want_finals = _k6_plain(common, wv, sig, x, betas, gammas)
    assert got.shape == (1, 2 * 256, n)
    assert np.array_equal(got, want) and np.array_equal(finals, want_finals)


def test_k6_other_coset_shifts(qlib):
    """Coset shifts that are not the generator's powers 7^j, each beta k_j x read
    from the block's table, against the plain version, with a zero
    denominator."""
    import dataclasses

    common, _ = _wormhole_commons()
    n, rng = 64, np.random.default_rng(11)
    other = dataclasses.replace(common, k_is=rng.integers(1, P, 80, dtype=U64))
    permutation_cuda._KIS.clear()   # the shifts are cached by routed wires and device
    try:
        wv = rng.integers(0, P, (2, 80, n), dtype=U64)
        sig = rng.integers(0, P, (80, n), dtype=U64)
        x = rng.integers(0, P, n, dtype=U64)
        betas, gammas = (rng.integers(0, P, (2, 2, 1), dtype=U64) for _ in range(2))
        _zero_den(wv, sig, betas, gammas, 1, 1, 42, 9)
        got, finals = _k6(qlib, other, wv, sig, x, betas, gammas, (8, 24, 16))
        want, want_finals = _k6_plain(other, wv, sig, x, betas, gammas)
        assert np.array_equal(got, want) and np.array_equal(finals, want_finals)
    finally:
        permutation_cuda._KIS.clear()


def test_k6_inverse_chain(qlib):
    """The addition chain's a^(p-2) against the host inverse, 0 -> 0."""
    rng = np.random.default_rng(3)
    a = np.concatenate([np.array([0, 1, P - 1, 2, 7, 2**32, P - 2], dtype=U64),
                        rng.integers(0, P, 4096, dtype=U64)])
    out = np.empty_like(a)
    qlib.shim_k6_inverse(a.ctypes.data_as(ctypes.c_void_p),
                         out.ctypes.data_as(ctypes.c_void_p), a.size)
    assert np.array_equal(out, jgl.inverse(a))


def test_k6_refuses_bad_calls(qlib):
    common, _ = _wormhole_commons()
    wv = np.zeros((1, 80, 16), dtype=U64)
    ch = np.zeros((2, 1, 1), dtype=U64)
    with pytest.raises(ValueError, match="CUDA"):
        permutation_cuda.products(common, _t(wv), _t(wv[0]), _t(wv[0, 0]), _t(ch), _t(ch))
    with pytest.raises(ValueError, match="wvals"):
        _k6(qlib, common, wv[:, :40], wv[0], wv[0, 0], ch, ch)
    with pytest.raises(ValueError, match="challenges"):
        _k6(qlib, common, wv, wv[0], wv[0, 0], ch[:, :, :0], ch)


def test_stage_bodies_route_by_device():
    """The quotient and zs bodies take K5/K6 on a CUDA tensor and their
    plain versions on a CPU tensor; any other device raises."""
    from zk_circuits_torch.plonk.prover import _on

    assert _on(torch.zeros(2, dtype=torch.int64)) == "cpu"
    with pytest.raises(ValueError, match="CUDA or CPU"):
        _on(torch.zeros(2, dtype=torch.int64, device="meta"))


def test_five_challenge_proof_through_the_shim(qlib, monkeypatch):
    """chip_smoke's mul chain (degree 2^11) under five challenges, its
    quotient and permutation products through K5's and K6's host build
    (two groups of challenges each): its bytes are the JAX host path's
    (the pin that tests/test_torch_jax_pins.py derives from the JAX
    package)."""
    import hashlib
    import types

    import chip_smoke
    from zk_circuits_torch.iop import builder as t_builder
    from zk_circuits_torch.iop import witness as t_witness
    from zk_circuits_torch.plonk import config as t_config
    from zk_circuits_torch.plonk import prover as t_prover
    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    calls = types.SimpleNamespace(k5=0, k6=0)

    def vanishing(*args, **kw):
        calls.k5 += 1
        return quotient_cuda.vanishing(*args, lib=qlib, **kw)

    def products(*args, **kw):
        calls.k6 += 1
        return permutation_cuda.products(*args, lib=qlib, **kw)

    # the stage bodies take their kernel branch, the kernels' host build
    monkeypatch.setattr(t_prover, "_on", lambda t: "cuda")
    monkeypatch.setattr(t_prover, "quotient_cuda", types.SimpleNamespace(vanishing=vanishing))
    monkeypatch.setattr(t_prover, "permutation_cuda", types.SimpleNamespace(products=products))
    data, pw = chip_smoke.mul_chain(t_builder, t_witness, t_config, "challenges5",
                                    device="cpu")
    assert data.common.config.num_challenges == 5
    proof = prove_batch(data, [pw], device="cpu")[0]
    assert hashlib.sha256(proof_to_bytes(proof)).hexdigest() == \
        chip_smoke.GOLDEN_MUL_CHAIN_SHA256["challenges5"]
    assert vars(calls) == {"k5": 1, "k6": 1}
