"""The port's multi-device path against the JAX package, on CPU meshes.

A CPU mesh (``make_mesh(E, device="cpu")``) holds E shards on the CPU, so
every block exchange takes K2's plain version; the same inputs, made with
numpy from a seed, go through the JAX functions on the 8-virtual-device
mesh of tests/conftest.py.  Every comparison is integer equality: the
exchange, the four-step NTT and INTT, the coset and batch LDEs, the
row-sharded commit, the FRI commit chain, and the bytes of a sharded proof.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.fri.fri_sharded import fri_commit_sharded
from zk_circuits_torch.hash import merkle as tmerkle
from zk_circuits_torch.hash.challenger import Challenger as TChallenger
from zk_circuits_torch.parallel import exchange_cuda
from zk_circuits_torch.parallel import mesh as tmesh
from zk_circuits_torch.parallel import ntt_exchange as tnx
from zk_circuits_torch.parallel import ntt_sharded as tns
from zk_circuits_torch.plonk.prover_sharded import commit_sharded, prove_sharded
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.fri.fri import ext_coset_ntt, fold_coeffs
from zk_circuits_tpu.fri.oracle import PolynomialBatch as JBatch
from zk_circuits_tpu.hash import merkle as jmerkle
from zk_circuits_tpu.hash.challenger import Challenger as JChallenger
from zk_circuits_tpu.host import gl
from zk_circuits_tpu.ntt import ntt as jntt
from zk_circuits_tpu.parallel import mesh as jmesh
from zk_circuits_tpu.parallel import ntt_exchange as jnx
from zk_circuits_tpu.parallel import ntt_sharded as jns
from zk_circuits_tpu.plonk.prover import prove as j_prove
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

P = gl.P_INT
U64 = np.uint64

# One intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the machine.
torch.set_num_threads(1)


def _cpu_mesh(e):
    return tmesh.make_mesh(e, device="cpu")


def _jmesh(e):
    return JMesh(np.array(jax.devices()[:e]), ("x",))


def _vec(n, seed):
    x = np.random.default_rng(seed).integers(0, P, n, dtype=U64)
    x[:3] = [0, 1, P - 1]
    return x


def _sharded(x, mesh):
    return tmesh.shard_last(tgf.from_u64(x), mesh)


def _joined(shards):
    return tgf.to_u64(tmesh.gather(shards))


# --- K2's plain version: the block exchange ---------------------------------


@pytest.mark.parametrize("e", [2, 4, 8])
def test_exchange_matches_jax_kernel(e):
    """The JAX RDMA kernel under the Mosaic interpret simulator at the
    shape of tests/test_ntt_exchange.py (B=64) vs the port's exchange."""
    x = np.random.default_rng(13 + e).integers(0, 2**32, (e, e, 64), dtype=np.uint32)
    want = np.asarray(jnx.all_to_all_blocks(x, _jmesh(e), "x", interpret=True))
    xs = [torch.from_numpy(x[s].astype(np.int64)) for s in range(e)]
    got = torch.stack(tnx.all_to_all_blocks(xs)).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(got, np.swapaxes(x, 0, 1).astype(np.int64))


@pytest.mark.parametrize("b", [1, 7, 64])
def test_exchange_full_u64_and_strided_blocks(b):
    """Whole 64-bit patterns (edge values included) and the strided block
    views a commit re-shard hands the exchange."""
    e = 4
    x = np.random.default_rng(b).integers(0, 2**64 - 1, (e, e, 3, b), dtype=U64)
    x[0, 0, 0, :1] = 2**64 - 1
    x[1, 2, 1, :1] = P - 1
    xs = [torch.from_numpy(x[s].view(np.int64)) for s in range(e)]
    before = exchange_cuda.launches
    got = np.stack([t.numpy() for t in exchange_cuda.exchange(xs)]).view(U64)
    assert np.array_equal(got, np.swapaxes(x, 0, 1))
    # (k, E*R) column blocks read through strides, as rows_from_polys does
    v = np.random.default_rng(b + 1).integers(0, P, (e, 5, e * b), dtype=U64)
    views = [torch.from_numpy(v[s].view(np.int64)).reshape(5, e, b).permute(1, 0, 2)
             for s in range(e)]
    out = tnx.all_to_all_blocks(views)
    for d in range(e):
        want = np.stack([v[s][:, d * b:(d + 1) * b] for s in range(e)])
        assert np.array_equal(out[d].numpy().view(U64), want)
    assert exchange_cuda.launches == before   # CPU shards never count


def test_exchange_refuses_bad_shards():
    with pytest.raises(ValueError):
        exchange_cuda.exchange([torch.zeros((2, 4), dtype=torch.int64)] * 3)
    with pytest.raises(ValueError):
        exchange_cuda.exchange([torch.zeros((2, 4), dtype=torch.int32)] * 2)


# --- K2's fused modes: plain versions against the unfused composition -------


def _edge_blocks(e, shape, seed):
    """E canonical shards of ``shape`` with 0, 1, p-2 and p-1 in front."""
    x = np.random.default_rng(seed).integers(0, P, (e, *shape), dtype=U64)
    flat = x.reshape(e, -1)
    flat[:, :4] = np.array([0, 1, P - 2, P - 1], dtype=U64)[: flat.shape[1]]
    return x


def _blocks_of(x):
    return [torch.from_numpy(b.view(np.int64)) for b in x]


@pytest.mark.parametrize("e", [2, 4, 8])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_fused_dft_and_twiddle_plain_match_unfused(e, inverse):
    """dft_plain and twiddle_plain against exchange_plain followed by the
    size-E DFT and the twiddle multiply in host products, with the JAX
    package's DFT and twiddle matrices."""
    bm = 8
    m, n = e * bm, e * e * bm
    x = _edge_blocks(e, (e, bm), e + inverse)
    r = [t.numpy().view(U64) for t in exchange_cuda.exchange_plain(_blocks_of(x))]
    w = jns._dft_matrix_e(e, inverse)
    got = exchange_cuda.dft_plain(_blocks_of(x), inverse)
    for d in range(e):
        want = np.stack([gl.sum_mod(np.stack([gl.mul(r[d][s], w[s, t1]) for s in range(e)]),
                                    axis=0) for t1 in range(e)])
        assert np.array_equal(got[d].numpy().view(U64), want)
    tw = jns._twiddle_matrix(n, e, inverse)
    got = exchange_cuda.twiddle_plain(_blocks_of(x), n, inverse)
    for d in range(e):
        assert np.array_equal(got[d].numpy().view(U64), gl.mul(r[d].reshape(m), tw[d]))
    before = exchange_cuda.launches
    assert all(torch.equal(a, b) for a, b in zip(
        exchange_cuda.exchange_dft(_blocks_of(x), inverse),
        exchange_cuda.dft_plain(_blocks_of(x), inverse)))
    assert exchange_cuda.launches == before   # CPU shards never count


@pytest.mark.parametrize("e", [2, 4, 8])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_fused_interleave_plain_matches_unfused(e, inverse):
    """interleave_plain against the reversal (inverse), exchange_plain,
    the t1-minor interleave and n^-1 (inverse), written out in numpy."""
    bm = 8
    m, n = e * bm, e * e * bm
    z = _edge_blocks(e, (m,), 40 + e + inverse)
    zz = np.concatenate([z[:, :1], z[:, 1:][:, ::-1]], axis=1) if inverse else z
    blocks = [torch.from_numpy(np.ascontiguousarray(b).view(np.int64)).reshape(e, bm)
              for b in zz]
    r = [t.numpy().view(U64) for t in exchange_cuda.exchange_plain(blocks)]
    got = exchange_cuda.interleave_plain(_blocks_of(z), inverse)
    for d in range(e):
        want = r[d].T.reshape(m)
        if inverse:
            want = gl.mul(want, gl.inverse(U64(n)))
        assert np.array_equal(got[d].numpy().view(U64), want)
        assert torch.equal(exchange_cuda.exchange_interleave(_blocks_of(z), inverse)[d],
                           got[d])


def test_fused_modes_refuse_bad_shards():
    with pytest.raises(ValueError):   # m not a power of two
        exchange_cuda.exchange_interleave([torch.zeros(12, dtype=torch.int64)] * 2, False)
    with pytest.raises(ValueError):   # n != E * m
        exchange_cuda.exchange_twiddle([torch.zeros((2, 4), dtype=torch.int64)] * 2, 64, False)


# --- the four-step NTT --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_four_step():
    """JAX four-step results (impl="collective" on the 8-device mesh),
    computed once per (n, inverse)."""
    cache = {}

    def get(n, inverse):
        if (n, inverse) not in cache:
            x = _vec(n, n + inverse)
            f = jnx.intt_sharded_pallas if inverse else jnx.ntt_sharded_pallas
            got = jgf.to_u64(f(jgf.from_u64(x), _jmesh(8), impl="collective",
                               interpret=False))
            cache[n, inverse] = (x, got)
        return cache[n, inverse]

    return get


@pytest.mark.parametrize("n", [512, 4096])
@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
def test_four_step_matches_jax(jax_four_step, n, inverse):
    """The JAX four-step (inverse: at n=512 only, its compile is the cost)
    and the host transforms vs the port's on meshes of 2, 4 and 8."""
    if inverse and n > 512:
        x = _vec(n, n + inverse)
        want = jntt.host_intt(x)
    else:
        x, want = jax_four_step(n, inverse)
        host = jntt.host_intt(x) if inverse else jntt.host_ntt(x)
        assert np.array_equal(want, host)
    pallas = tnx.intt_sharded_pallas if inverse else tnx.ntt_sharded_pallas
    named = tns.intt_sharded if inverse else tns.ntt_sharded
    for e in (2, 4, 8):
        mesh = _cpu_mesh(e)
        assert np.array_equal(_joined(pallas(_sharded(x, mesh), mesh)), want)
        assert np.array_equal(_joined(named(_sharded(x, mesh), mesh)), want)


def test_coset_and_batch_lde_match_jax():
    rate, mesh8 = 3, _jmesh(8)
    coeffs = _vec(256, 5)
    d = jax.device_put(jgf.from_u64(coeffs), jmesh.shard_last(mesh8, 1))
    want = jgf.to_u64(jns.coset_lde_sharded(d, rate, mesh8))
    assert np.array_equal(want, jntt.host_lde(coeffs, rate))
    batch = np.random.default_rng(6).integers(0, P, (8, 64), dtype=U64)
    db = jax.device_put(jgf.from_u64(batch), jmesh.shard_batch(mesh8, 2))
    want_b = jgf.to_u64(jns.lde_batch_sharded(db, rate, mesh8))
    for e in (2, 4, 8):
        mesh = _cpu_mesh(e)
        got = _joined(tns.coset_lde_sharded(_sharded(coeffs, mesh), rate, mesh))
        assert np.array_equal(got, want)
        shards = tmesh.shard_batch(tgf.from_u64(batch), mesh)
        got_b = tgf.to_u64(tmesh.gather(tns.lde_batch_sharded(shards, rate, mesh), dim=0))
        assert np.array_equal(got_b, want_b)


# --- the row-sharded commit and Merkle tree ---------------------------------


@pytest.mark.parametrize("e,k", [(2, 13), (4, 13), (8, 5)])
def test_commit_sharded_matches_host_commit(e, k):
    """Poly-sharded LDE -> K2 re-shard to rows -> per-shard leaves and
    subtrees: the cap, leaves and levels of the host commit."""
    coeffs = np.random.default_rng(e + k).integers(0, P, (k, 32), dtype=U64)
    ref = JBatch.from_coeffs(coeffs, 3, 2, use_device=False)
    mesh = _cpu_mesh(e)
    kps = -(-k // e)
    padded = np.zeros((kps * e, 32), dtype=U64)
    padded[:k] = coeffs
    got = commit_sharded(tmesh.shard_batch(tgf.from_u64(padded), mesh), k, 3, 2, mesh)
    assert np.array_equal(got.cap, ref.cap)
    assert np.array_equal(tgf.to_u64(tmesh.gather(got.rows)).T, ref.leaves)
    for lv, want in zip(got.levels, ref.levels):
        assert np.array_equal(tgf.to_u64(tmesh.gather(lv, dim=0)), want)


def test_sharded_merkle_above_the_cap():
    """More shards than cap nodes: the top levels are built on the first
    shard's device."""
    leaves = np.random.default_rng(3).integers(0, P, (64, 9), dtype=U64)
    want = jmerkle.MerkleTree.build(leaves, 1).levels
    mesh = _cpu_mesh(8)
    shards = tmesh.shard_batch(tgf.from_u64(leaves), mesh)
    got = tmerkle.sharded_merkle_levels([tmerkle.leaf_digests(t) for t in shards], 1)
    assert len(got) == len(want) and len(got[-1]) == 1
    for lv, w in zip(got, want):
        assert np.array_equal(tgf.to_u64(tmesh.gather(lv, dim=0)), w)


def test_reshard_pads_and_moves_blocks():
    mesh = _cpu_mesh(4)
    a, b = torch.arange(5), torch.arange(5, 11)
    out = tmesh.reshard([a, b], 16, mesh)
    assert [t.tolist() for t in out] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 0],
                                        [0, 0, 0, 0]]
    rows = tmesh.reshard([torch.ones(3, 2, dtype=torch.int64)], 4, _cpu_mesh(2), dim=0)
    assert [t.sum().item() for t in rows] == [4, 2]
    assert torch.equal(tmesh.gather(tmesh.replicated(a, mesh)), a.repeat(4))


# --- the FRI commit chain -------------------------------------------------------


def _host_commit(coeffs, degree_bits, fri_config, challenger, shift):
    """The JAX package's host FRI commit phase, as tests/test_fri_sharded.py
    builds it."""
    lde_size = (1 << degree_bits) << fri_config.rate_bits
    values = ext_coset_ntt(coeffs, shift, lde_size)
    caps, betas, size = [], [], lde_size
    for a_bits in fri_config.reduction_arities(degree_bits):
        arity = 1 << a_bits
        m = size // arity
        leaves = np.ascontiguousarray(
            np.moveaxis(values.reshape(arity, m, 2), 0, 1)).reshape(m, arity * 2)
        tree = jmerkle.MerkleTree.build(leaves, fri_config.cap_height)
        caps.append(np.asarray(tree.levels[-1], dtype=U64).reshape(-1, 4))
        challenger.observe_cap(caps[-1])
        betas.append(challenger.get_extension_challenge())
        coeffs = fold_coeffs(coeffs, betas[-1], a_bits)
        shift = pow(shift, arity, P)
        size = m
        values = ext_coset_ntt(coeffs, shift, size)
    return caps, betas, coeffs


@pytest.mark.parametrize("arity_bits", [2, 4])
def test_fri_commit_sharded_matches_host(arity_bits):
    degree_bits = 9
    kw = dict(rate_bits=3, cap_height=2, reduction_arity_bits=arity_bits,
              final_poly_bits=3, num_query_rounds=4)
    coeffs = np.random.default_rng(11).integers(0, P, (1 << degree_bits, 2), dtype=U64)
    caps_h, betas_h, final_h = _host_commit(
        coeffs.copy(), degree_bits, j_config.FriConfig(**kw), JChallenger(),
        gl.MULTIPLICATIVE_GROUP_GENERATOR)
    caps, betas, final = fri_commit_sharded(
        coeffs, degree_bits, t_config.FriConfig(**kw), TChallenger(), _cpu_mesh(4))
    assert len(caps) == len(caps_h) >= 2
    for got, want in zip(caps + betas, caps_h + betas_h):
        assert np.array_equal(got, want)
    assert np.array_equal(final, final_h)


# --- the sharded proof ----------------------------------------------------------


def _square(pkg_builder, pkg_witness, cfg, **build_kw):
    b = pkg_builder.CircuitBuilder(cfg)
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    pw = pkg_witness.PartialWitness()
    pw.set_target(x, 7)
    return b.build(**build_kw), pw


@pytest.mark.parametrize("zk,fri,e", [(False, {}, 2), (True, {}, 2),
                                      (True, dict(reduction_arity_bits=2,
                                                  final_poly_bits=1), 4)],
                         ids=["standard", "zk", "zk-fri-rounds"])
def test_prove_sharded_matches_reference_bytes(zk, fri, e):
    """The square circuit under the standard configs, narrowed to few
    queries and PoW bits (the plain CPU sponge is most of a CPU proof, and
    every shard adds its own calls); the third case adds FRI fold rounds,
    whose last fold is too short to stay sharded."""
    kw = dict(proof_of_work_bits=2, num_query_rounds=3, **fri)
    ref_data, ref_pw = _square(j_builder, j_witness, j_config.CircuitConfig(
        zero_knowledge=zk, fri_config=j_config.FriConfig(**kw)))
    want = j_bytes(j_prove(ref_data, ref_pw, use_device=False))
    data, pw = _square(t_builder, t_witness, t_config.CircuitConfig(
        zero_knowledge=zk, fri_config=t_config.FriConfig(**kw)), device="cpu")
    proof = prove_sharded(data, pw, _cpu_mesh(e))
    assert t_bytes(proof) == want
    data.verify(proof)


def test_prove_sharded_takes_check_witness_by_keyword_only():
    """The JAX package's prove_sharded takes the mesh axis fourth; the
    port's has none, so a fourth positional argument is refused rather
    than taken for check_witness."""
    data, pw = _square(t_builder, t_witness, t_config.CircuitConfig(), device="cpu")
    with pytest.raises(TypeError):
        prove_sharded(data, pw, _cpu_mesh(2), True)


def test_sharded_entry_points_take_the_axis_in_the_reference_position():
    """prove_sharded(cd, pw, mesh, "x") and fri_commit_sharded(..., ch,
    mesh, "x"), the JAX package's argument order, give the bytes of the
    keyword form on a 4-shard mesh."""
    mesh = _cpu_mesh(4)
    data, pw = _square(t_builder, t_witness, t_config.CircuitConfig(
        fri_config=t_config.FriConfig(proof_of_work_bits=2, num_query_rounds=3)), device="cpu")
    assert t_bytes(prove_sharded(data, pw, mesh, "x")) == \
        t_bytes(prove_sharded(data, pw, mesh=mesh, axis="x"))
    kw = dict(rate_bits=3, cap_height=2, reduction_arity_bits=2, final_poly_bits=3,
              num_query_rounds=4)
    coeffs = np.random.default_rng(12).integers(0, P, (1 << 9, 2), dtype=U64)
    positional = fri_commit_sharded(coeffs, 9, t_config.FriConfig(**kw), TChallenger(),
                                    mesh, "x")
    keyword = fri_commit_sharded(coeffs, 9, t_config.FriConfig(**kw), TChallenger(),
                                 mesh=mesh, axis="x")
    caps, betas, final = positional
    assert len(caps) == len(keyword[0]) >= 2
    for got, want in zip(caps + betas + [final], keyword[0] + keyword[1] + [keyword[2]]):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("axis", [True, 3, ["x"], (), ("x", 1)])
def test_sharded_entry_points_refuse_an_axis_that_is_no_name(axis):
    mesh = _cpu_mesh(2)
    with pytest.raises(TypeError, match="axis"):
        prove_sharded(None, None, mesh, axis)
    with pytest.raises(TypeError, match="axis"):
        fri_commit_sharded(np.zeros((8, 2), U64), 3, t_config.FriConfig(), TChallenger(),
                           mesh, axis)
