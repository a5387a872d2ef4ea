"""The torch port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU and nvcc; skipped without a card.  Imports no JAX, so
it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from zk_circuits_torch.field import goldilocks as gf
from zk_circuits_torch.hash import poseidon as plain
from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.hash import poseidon_pallas as pp

P = 2**64 - 2**32 + 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the leaf kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,cols", [(1, 5), (127, 9), (4096, 139), (5000, 32)])
def test_leaf_kernel_matches_plain(cuda, n, cols):
    x = np.random.default_rng(n + cols).integers(0, P, (n, cols), dtype=np.uint64)
    x[0, 0] = 2**64 - 1                       # non-canonical input lane
    rows = torch.from_numpy(x.view(np.int64)).to(cuda)
    before = poseidon_cuda.launches
    want = gf.to_u64(plain.batch_hash_no_pad(rows))
    got_rows = gf.to_u64(pp.hash_leaves(rows))
    got_vals = gf.to_u64(pp.hash_values(rows.t().contiguous()))
    torch.cuda.synchronize()
    assert poseidon_cuda.launches == before + 2
    assert np.array_equal(got_rows, want)
    assert np.array_equal(got_vals, want)
    assert (got_rows < np.uint64(P)).all()


@pytest.mark.parametrize("team", list(poseidon_cuda.TEAMS))
@pytest.mark.parametrize("rows", [32, 256])
def test_sponge_every_team_at_the_edges(cuda, team, rows):
    """Every team size and block size: n below the team, n not a multiple
    of the block's rows, cols 1 to 139, both layouts."""
    if -(-rows // (32 // team)) * 32 > poseidon_cuda.max_threads(team):
        pytest.skip(f"{rows} rows a block need more threads than team {team} allows")
    rng = np.random.default_rng(team * 1000 + rows)
    for n in (1, 2, 3, 33, 517):
        for cols in (1, 5, 8, 9, 16, 32, 135, 139):
            x = rng.integers(0, 2**64 - 1, (n, cols), dtype=np.uint64, endpoint=True)
            rows_t = torch.from_numpy(x.view(np.int64)).to(cuda)
            want = poseidon_cuda.hash_rows_plain(rows_t)
            for view in (rows_t, rows_t.t().contiguous().t()):
                got = poseidon_cuda.hash_rows(view, team, rows)
                assert torch.equal(got, want), (n, cols, view.stride())


def test_k1_on_every_card(cuda):
    """K1 on each card in turn, at a sharded commit's per-shard shape: one
    thread a row and 256 rows a block, above 48 KB of shared memory, which a
    card allows only once the kernel has opted in on that card."""
    x = np.random.default_rng(3).integers(0, P, (1 << 14, 139), dtype=np.uint64)
    for i in range(torch.cuda.device_count()):
        rows_t = torch.from_numpy(x.view(np.int64)).to(torch.device("cuda", i))
        view = rows_t.t().contiguous().t()
        assert torch.equal(poseidon_cuda.hash_rows(view), poseidon_cuda.hash_rows_plain(rows_t))
        got = poseidon_cuda.hash_tree(view, 4)
        for g, w in zip(got, poseidon_cuda.hash_tree_plain(rows_t, 4), strict=True):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n,cols,cap_height", [
    (1 << 16, 139, 4), (1 << 16, 24, 4), (1 << 16, 20, 4), (1 << 12, 32, 4),
    (1 << 8, 32, 4), (256, 8, 0), (1024, 139, 2), (64, 3, 2)])
def test_hash_tree_matches_plain_levels(cuda, n, cols, cap_height):
    """hash_tree against the plain level loop: the wormhole's commit and FRI
    tree shapes, and small trees; row-major and column-major leaves."""
    x = np.random.default_rng(n + cols).integers(0, P, (n, cols), dtype=np.uint64)
    rows_t = torch.from_numpy(x.view(np.int64)).to(cuda)
    want = poseidon_cuda.hash_tree_plain(rows_t, cap_height)
    for view in (rows_t, rows_t.t().contiguous().t()):
        before = dict(poseidon_cuda.launches_by_mode)
        got = poseidon_cuda.hash_tree(view, cap_height)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        team, rows = poseidon_cuda.config(n)
        plan = poseidon_cuda.tree_plan(n if cols > 4 else n // 2, cap_height, rows)
        if cols > 4 or n > 1 << cap_height:
            assert poseidon_cuda.launches_by_mode["tree"] == before["tree"] + 1
            assert poseidon_cuda.launches_by_mode["top"] == \
                before["top"] + bool(plan["top_threads"])


@pytest.mark.parametrize("n,cols,layout", [
    (1 << 16, 139, "column-major"), (1 << 12, 32, "row-major"), (1 << 8, 32, "row-major"),
    (64, 12, "column-major"), (32, 3, "row-major")])
def test_batched_hash_tree_and_rows_match_plain(cuda, n, cols, layout):
    """A batch of 4 matrices (a leading proof axis): one tree launch and at
    most one top launch build the 4 trees, each equal to the plain one."""
    x = np.random.default_rng(n + cols).integers(0, P, (4, n, cols), dtype=np.uint64)
    rows_t = torch.from_numpy(x.view(np.int64)).to(cuda)
    view = rows_t if layout == "row-major" else \
        rows_t.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(poseidon_cuda.hash_rows(view), poseidon_cuda.hash_rows_plain(rows_t))
    before = dict(poseidon_cuda.launches_by_mode)
    got = poseidon_cuda.hash_tree(view, 2)
    torch.cuda.synchronize()
    assert poseidon_cuda.launches_by_mode["tree"] == before["tree"] + 1
    assert poseidon_cuda.launches_by_mode["top"] <= before["top"] + 1
    for g, w in zip(got, poseidon_cuda.hash_tree_plain(rows_t, 2), strict=True):
        assert torch.equal(g, w)


def test_prove_batch_cuda_equals_cpu(cuda):
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    out = []
    for device in ("cuda", "cpu"):
        b = CircuitBuilder(CircuitConfig.standard_recursion_zk_config())
        x = b.add_virtual_target()
        b.register_public_input(b.square(x))
        data = b.build(device=device)
        pws = []
        for v in (5, 6, 7):
            pws.append(PartialWitness())
            pws[-1].set_target(x, v)
        out.append([proof_to_bytes(p) for p in prove_batch(data, pws, device=device)])
    assert out[0] == out[1]


def test_square_proof_cuda_equals_cpu(cuda):
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    out = []
    for device in ("cuda", "cpu"):
        b = CircuitBuilder(CircuitConfig.standard_recursion_zk_config())
        x = b.add_virtual_target()
        b.register_public_input(b.square(x))
        data = b.build(device=device)
        pw = PartialWitness()
        pw.set_target(x, 5)
        out.append(proof_to_bytes(data.prove(pw, device=device)))
    assert out[0] == out[1]


def _mesh_shards(x, devices):
    return [torch.from_numpy(x[s].view(np.int64)).to(d) for s, d in enumerate(devices)]


@pytest.mark.parametrize("e", [2, 4, 8])
@pytest.mark.parametrize("b", [1, 7, 64, 4096])
def test_block_exchange_matches_plain(cuda, e, b):
    from zk_circuits_torch.parallel import exchange_cuda

    x = np.random.default_rng(e * b).integers(0, 2**64 - 1, (e, e, b), dtype=np.uint64)
    x[0, 0, :1] = 2**64 - 1
    x[-1, 0, -1:] = P - 1
    xs = _mesh_shards(x, [cuda] * e)
    before = exchange_cuda.launches
    got = exchange_cuda.exchange(xs)
    assert exchange_cuda.launches == before + 1      # one launch per card
    want = exchange_cuda.exchange_plain(xs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert np.array_equal(np.stack([g.cpu().numpy() for g in got]).view(np.uint64),
                          np.swapaxes(x, 0, 1))


def test_block_exchange_strided_and_across_cards(cuda):
    from zk_circuits_torch.parallel import exchange_cuda

    e, k, r = 4, 5, 96
    v = np.random.default_rng(1).integers(0, P, (e, k, e * r), dtype=np.uint64)
    counts = [1] + ([torch.cuda.device_count()] if torch.cuda.device_count() > 1 else [])
    for count in counts:
        devices = [torch.device("cuda", i % count) for i in range(e)]
        views = [t.reshape(k, e, r).permute(1, 0, 2) for t in _mesh_shards(v, devices)]
        before = exchange_cuda.launches
        got = exchange_cuda.exchange(views)
        assert exchange_cuda.launches == before + len(set(devices))
        want = exchange_cuda.exchange_plain(views)
        for d in range(e):
            torch.cuda.synchronize(devices[d])
            assert got[d].device == devices[d]
            assert torch.equal(got[d], want[d])


def test_sharded_ntt_and_proof_on_the_card(cuda):
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.parallel import exchange_cuda, mesh as meshm
    from zk_circuits_torch.parallel.ntt_exchange import ntt_sharded_pallas
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.plonk.prover_sharded import prove_sharded
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    mesh = meshm.make_mesh(4)
    x = gf.from_u64(np.random.default_rng(5).integers(0, P, 1 << 12, dtype=np.uint64), cuda)
    before = exchange_cuda.launches
    got = meshm.gather(ntt_sharded_pallas(meshm.shard_last(x, mesh), mesh))
    assert exchange_cuda.launches - before == 3 * len(set(mesh.devices))
    assert torch.equal(got.to(cuda), nttm.ntt(x))
    b = CircuitBuilder(CircuitConfig.standard_recursion_zk_config())
    t = b.add_virtual_target()
    b.register_public_input(b.square(t))
    data = b.build(device="cuda")
    proofs = []
    for run in (lambda pw: data.prove(pw, device="cuda"),
                lambda pw: prove_sharded(data, pw, mesh)):
        pw = PartialWitness()
        pw.set_target(t, 5)
        proofs.append(proof_to_bytes(run(pw)))
    assert proofs[0] == proofs[1]


def _fused_shards(e, shape, seed, devices):
    x = np.random.default_rng(seed).integers(0, P, (e, *shape), dtype=np.uint64)
    flat = x.reshape(e, -1)
    flat[:, :4] = np.array([0, 1, P - 2, P - 1], dtype=np.uint64)[: flat.shape[1]]
    return _mesh_shards(x, devices)


@pytest.mark.parametrize("e,bm", [(2, 4096), (4, 3), (4, 1 << 14), (8, 64)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_block_exchange_fused_modes_match_plain(cuda, e, bm, inverse):
    """dft, twiddle and interleave (forward and inverse) against their
    plain versions, one launch each on one card."""
    from zk_circuits_torch.parallel import exchange_cuda as xc

    m = e * bm
    if m & (m - 1):
        pytest.skip("the four-step's shards are powers of two")
    blocks = _fused_shards(e, (e, bm), e * bm + inverse, [cuda] * e)
    rows = [b.reshape(m) for b in blocks]
    for mode, run, plain in (
            ("dft", lambda: xc.exchange_dft(blocks, inverse), lambda: xc.dft_plain(blocks, inverse)),
            ("twiddle", lambda: xc.exchange_twiddle(blocks, e * m, inverse),
             lambda: xc.twiddle_plain(blocks, e * m, inverse)),
            ("interleave", lambda: xc.exchange_interleave(rows, inverse),
             lambda: xc.interleave_plain(rows, inverse))):
        before = xc.launches_by_mode[mode]
        got = run()
        assert xc.launches_by_mode[mode] == before + 1, mode
        want = plain()
        torch.cuda.synchronize()
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), mode


@pytest.mark.parametrize("b", [1, 7, 64, 4097])
def test_block_exchange_copy_paths(cuda, b):
    """The copy on one card, contiguous blocks with edge values and B odd,
    and the strided re-shard view."""
    from zk_circuits_torch.parallel import exchange_cuda as xc

    e = 4
    x = np.random.default_rng(b).integers(0, 2**64 - 1, (e, e, b), dtype=np.uint64,
                                          endpoint=True)
    x[:, :, :1] = 2**64 - 1
    xs = _mesh_shards(x, [cuda] * e)
    got = xc.exchange(xs)
    torch.cuda.synchronize()
    assert np.array_equal(np.stack([g.cpu().numpy() for g in got]).view(np.uint64),
                          np.swapaxes(x, 0, 1))
    v = np.random.default_rng(b + 1).integers(0, P, (e, 5, e * b), dtype=np.uint64)
    views = [t.reshape(5, e, b).permute(1, 0, 2) for t in _mesh_shards(v, [cuda] * e)]
    for g, w in zip(xc.exchange(views), xc.exchange_plain(views), strict=True):
        assert torch.equal(g, w)


def test_sharded_ntt_intt_2_16_on_four_shards(cuda):
    """The four-step at 2^16 on E=4 against the single-device NTT and
    INTT: dft, twiddle and interleave once each a transform."""
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.parallel import exchange_cuda as xc, mesh as meshm
    from zk_circuits_torch.parallel.ntt_exchange import intt_sharded_pallas, ntt_sharded_pallas

    mesh = meshm.make_mesh(4)
    cards = len(set(mesh.devices))
    x = gf.from_u64(np.random.default_rng(16).integers(0, P, 1 << 16, dtype=np.uint64), cuda)
    for fn, single in ((ntt_sharded_pallas, nttm.ntt), (intt_sharded_pallas, nttm.intt)):
        before = dict(xc.launches_by_mode)
        got = meshm.gather(fn(meshm.shard_last(x, mesh), mesh))
        assert {k: xc.launches_by_mode[k] - before[k] for k in before} == {
            "copy": 0, "dft": cards, "twiddle": cards, "interleave": cards}
        assert torch.equal(got.to(cuda), single(x))


def _k3_circuits(device):
    """The circuit of every generator kind and the deep chain, built on
    ``device``, each with a batch of distinct witnesses."""
    import chip_smoke
    from zk_circuits_torch.iop import builder as t_builder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.plonk.config import CircuitConfig

    out = []
    for circuit, seeds in ((lambda b: chip_smoke.kinds_circuit(b, t_builder.GeneratorOp),
                            chip_smoke.KINDS_SEEDS),
                           (chip_smoke.chain_circuit, ((12345, 67890), (1, P - 1)))):
        b = t_builder.CircuitBuilder(CircuitConfig.standard_recursion_config())
        targets = circuit(b)
        data = b.build(device=device)
        out.append((data, [chip_smoke.seed(PartialWitness, targets, v) for v in seeds]))
    return out


def test_k3_kernels_match_plain_batch_by_batch(cuda):
    """The walk one schedule level a launch (first=i, last=i+1), each on
    the values the levels before it left, against the plain version of
    that level (the value table, and a Poseidon level's trace columns);
    then the cells against the plain cell scatter and public inputs."""
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop import witness_device as wdev

    lib = witness_cuda._lib()
    for data, pws in _k3_circuits(cuda):
        table = wdev.device_table(data, cuda)
        values = table.seeded_values(*wdev.seed_batch(data, pws))
        b, n, w = values.shape[0], table.n, table.num_wires
        wires = torch.zeros((b, w * n), dtype=torch.int64, device=cuda)
        pis = torch.empty((b, table.pi_reps.numel()), dtype=torch.int64, device=cuda)
        stream = torch.cuda.current_stream().cuda_stream
        for i, st in enumerate(table.steps):
            want_v, want_w = values.clone(), wires.clone()
            out = wdev._step_plain(st, want_v, want_w, n).reshape(b, -1)
            want_v[:, st.outs.reshape(-1)] = out
            done = witness_cuda.launch_schedule(lib, table, values, wires, pis, stream,
                                                i, i + 1, cells=False)
            torch.cuda.synchronize()
            assert done == [("walk", 0)]
            assert torch.equal(values, want_v), st.kind
            assert torch.equal(wires, want_w), st.kind
        want_w = wires.clone()
        want_w[:, table.cell_pos] = values[:, table.cell_rep]
        n_levels = len(table.steps)
        done = witness_cuda.launch_schedule(lib, table, values, wires, pis, stream,
                                            n_levels, n_levels)
        torch.cuda.synchronize()
        assert done == [("cells", 0)]
        assert torch.equal(wires, want_w)
        assert torch.equal(pis, values[:, table.pi_reps])


def test_k3_witness_matches_plain_and_host(cuda):
    """generate_witnesses_device on the card (K3: one walk launch and one
    cells launch a witness or a batch; these circuits have no level wide
    enough for an ops launch) against the plain version on the card and
    the host witness, alone and in a batch."""
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop import witness_device as wdev
    from zk_circuits_torch.iop.witness import generate_witness

    for data, pws in _k3_circuits(cuda):
        for batch in (pws[:1], pws):
            before = dict(witness_cuda.launches_by_kernel)
            wires, pis = wdev.generate_witnesses_device(data, batch, cuda)
            assert {k: v - before[k] for k, v in witness_cuda.launches_by_kernel.items()} == \
                {"walk": 1, "ops": 0, "cells": 1}
            table = wdev.device_table(data, cuda)
            plain_w, plain_p = wdev.witness_plain(
                table, table.seeded_values(*wdev.seed_batch(data, batch)))
            assert torch.equal(wires, plain_w) and torch.equal(pis, plain_p)
            for i, pw in enumerate(batch):
                host_w, host_p = generate_witness(data, pw)
                assert np.array_equal(gf.to_u64(wires[i]), host_w.T)
                assert np.array_equal(gf.to_u64(pis[i]), host_p)


@pytest.fixture(scope="module")
def level_circuit():
    """The level circuit over two proofs of the zk square circuit (a cheap
    FRI config: 2 query rounds, 1 PoW bit), built on the card, and the
    witnesses of two chunks."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from zk_circuits_torch.aggregation.tree import LevelCircuit
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig

    b = CircuitBuilder(CircuitConfig(zero_knowledge=True, fri_config=FriConfig(
        num_query_rounds=2, proof_of_work_bits=1)))
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    inner = b.build(device="cuda")

    def proof(v):
        pw = PartialWitness()
        pw.set_target(x, v)
        return inner.prove(pw, device="cuda")

    proofs = [proof(v) for v in (3, 5, 7, 11)]
    level = LevelCircuit(inner.common, 2, device="cuda")
    pws = [level._chunk_witness(proofs[i : i + 2], inner.verifier_only) for i in (0, 2)]
    return level, pws


def test_k3_level_witness_matches_plain_and_host(cuda, level_circuit):
    """One level-1 witness at B=2 by K3 (the recursion schedule: thousands
    of arith_ext, random_access and Poseidon levels) against the plain
    version on the card and the host witness."""
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop import witness_device as wdev
    from zk_circuits_torch.iop.witness import generate_witness

    level, pws = level_circuit
    data = level.circuit_data
    before = witness_cuda.launches
    wires, pis = wdev.generate_witnesses_device(data, pws, cuda)
    assert witness_cuda.launches > before
    table = wdev.device_table(data, cuda)
    plain_w, plain_p = wdev.witness_plain(table, table.seeded_values(*wdev.seed_batch(data, pws)))
    assert torch.equal(wires, plain_w) and torch.equal(pis, plain_p)
    for i, pw in enumerate(pws):
        host_w, host_p = generate_witness(data, pw)
        assert np.array_equal(gf.to_u64(wires[i]), host_w.T)
        assert np.array_equal(gf.to_u64(pis[i]), host_p)


def test_k1_level_wires_tree_matches_plain(cuda, level_circuit):
    """K1's tree at the level circuit's wires shape (its LDE rows x 139
    columns, column-major, as the wires commit hands it over) against the
    plain level loop."""
    level, _ = level_circuit
    common = level.circuit_data.common
    cap = common.config.fri_config.cap_height
    x = torch.randint(0, P >> 1, (common.config.num_wires + 4, common.lde_size),
                      dtype=torch.int64, device=cuda).t()
    got = poseidon_cuda.hash_tree(x, cap)
    want = poseidon_cuda.hash_tree_plain(x, cap)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("log_n", [1, 6, 13, 14, 16, 20])
def test_k4_every_mode_matches_plain(cuda, log_n):
    """ntt/ntt.py's transforms on a CUDA tensor launch K4 (one launch on
    the row path, two for the four-step) and give the plain stage loop's
    integers."""
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.ntt import ntt_cuda

    n = 1 << log_n
    x = np.random.default_rng(log_n).integers(0, P, (3, n), dtype=np.uint64)
    x[0, : min(n, 3)] = [0, 1, P - 1][: min(n, 3)]
    t = gf.from_u64(x, cuda)
    cases = [(nttm.ntt, nttm.ntt_plain, n), (nttm.intt, nttm.intt_plain, n),
             (nttm.coset_ntt, nttm.coset_ntt_plain, n),
             (nttm.coset_intt, nttm.coset_intt_plain, n),
             (lambda v: nttm.lde(v, 3), lambda v: nttm.lde_plain(v, 3), n << 3),
             (lambda v: nttm.coset_ntt(v, size=2 * n),
              lambda v: nttm.coset_ntt_plain(v, size=2 * n), 2 * n)]
    for fn, plain, points in cases:
        before = ntt_cuda.launches
        got = fn(t)
        torch.cuda.synchronize()
        assert ntt_cuda.launches == before + (2 if ntt_cuda.plan(points) else 1)
        assert torch.equal(got, plain(t)), (log_n, points)


def test_ntt_mxu_on_the_card(cuda):
    """ntt_mxu/intt_mxu on a CUDA tensor are ntt.ntt/ntt.intt, one K4 call
    each on the path K4 plans for the size (the row path to 2^12 points,
    the four-step above), and equal the plain stage loop."""
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_torch.ntt import ntt_mxu as mxu

    for n in (8, 128, 256, 1 << 14, 1 << 16):
        t = gf.from_u64(np.random.default_rng(n).integers(0, P, (2, 3, n), dtype=np.uint64),
                        cuda)
        before = ntt_cuda.launches
        assert torch.equal(mxu.ntt_mxu(t), nttm.ntt_plain(t))
        assert torch.equal(mxu.intt_mxu(t), nttm.intt_plain(t))
        assert ntt_cuda.launches == before + 2 * (2 if ntt_cuda.plan(n) else 1)


def _gate_common(gates, degree_bits=13, **cfg_kw):
    """The port's CommonCircuitData for these gate types (build_circuit_data's
    sort and selector groups); the wormhole's gates by default."""
    from zk_circuits_torch.host import gl
    from zk_circuits_torch.plonk import circuit_data as cdm
    from zk_circuits_torch.plonk.config import CircuitConfig

    cfg = CircuitConfig(zero_knowledge=True, **cfg_kw)
    gate_types = sorted(gates, key=lambda g: (-g.degree, g.id))
    groups = cdm._selector_groups(gate_types, cfg.max_quotient_degree_factor)
    return cdm.CommonCircuitData(
        config=cfg, degree_bits=degree_bits, gate_types=gate_types, selector_groups=groups,
        gate_to_group={gate_types[gi].id: k for k, grp in enumerate(groups) for gi in grp},
        gate_to_index={g.id: i for i, g in enumerate(gate_types)},
        num_gate_constraints=max(g.num_constraints for g in gate_types), num_public_inputs=0,
        k_is=gl.powers(gl.MULTIPLICATIVE_GROUP_GENERATOR, cfg.num_routed_wires))


def _wormhole_gates():
    from zk_circuits_torch.iop import gates as G

    return [G.PoseidonGate(), G.ArithmeticGate(num_ops=20), G.BaseSum2Gate(num_limbs=32),
            G.BaseSum2Gate(num_limbs=5), G.ConstantGate(num_consts=2), G.PublicInputGate(),
            G.NoopGate()]


def _k5_inputs(common, device, batch, seed):
    from zk_circuits_torch.plonk.prover import _coset_tables

    cfg = common.config
    rng = np.random.default_rng(seed)
    pts, nc = common.lde_size, cfg.num_challenges

    def draw(*shape):
        return gf.from_u64(rng.integers(0, P, shape, dtype=np.uint64), device)

    return dict(cs=draw(common.num_constants_sigmas_polys, pts),
                wires=draw(batch, cfg.num_wires + 4, pts),
                zsp=draw(batch, nc * (1 + common.num_partial_products) + 4, pts),
                tables=_coset_tables(common, device), pi_hash=draw(batch, 1, 4),
                betas=draw(nc, batch, 1), gammas=draw(nc, batch, 1), alphas=draw(nc, batch, 1))


def _k5_plain(common, inp):
    from zk_circuits_torch.plonk.prover import _device_vanishing_eval

    x, l1, zh_inv = inp["tables"]
    vans = _device_vanishing_eval(common, inp["cs"].t(), inp["wires"].transpose(-1, -2),
                                  inp["zsp"].transpose(-1, -2), x, l1, inp["pi_hash"],
                                  inp["betas"], inp["gammas"], inp["alphas"])
    return gf.mul(torch.stack(vans), zh_inv)


@pytest.mark.parametrize("batch", [1, 4])
def test_k5_matches_plain(cuda, batch):
    """K5 at the wormhole's gates and coset (2^16 points), its two launches
    (the permutation terms, then the gates), equal to plonk/prover.py's
    _device_vanishing_eval times 1/Z_H."""
    from zk_circuits_torch.plonk import quotient_cuda

    common = _gate_common(_wormhole_gates())
    inp = _k5_inputs(common, cuda, batch, batch)
    before = quotient_cuda.launches
    got = quotient_cuda.vanishing(common, inp["cs"], inp["wires"], inp["zsp"], inp["tables"],
                                  inp["pi_hash"], inp["betas"], inp["gammas"], inp["alphas"])
    torch.cuda.synchronize()
    assert quotient_cuda.launches == before + quotient_cuda.LAUNCHES_PER_GROUP
    assert torch.equal(got, _k5_plain(common, inp))


def test_k5_level_gates_match_plain(cuda):
    """The recursion's gates (arithmetic extension, random access) beside
    Poseidon, at a 2^12-point coset, B = 2."""
    from zk_circuits_torch.iop import gates as G
    from zk_circuits_torch.plonk import quotient_cuda

    common = _gate_common([G.PoseidonGate(), G.ArithmeticExtensionGate(num_ops=10),
                           G.RandomAccessGate(bits=4, num_copies=4), G.ConstantGate(2),
                           G.PublicInputGate(), G.NoopGate()], degree_bits=9)
    inp = _k5_inputs(common, cuda, 2, 5)
    got = quotient_cuda.vanishing(common, inp["cs"], inp["wires"], inp["zsp"], inp["tables"],
                                  inp["pi_hash"], inp["betas"], inp["gammas"], inp["alphas"])
    assert torch.equal(got, _k5_plain(common, inp))


def test_k5_refuses_an_unknown_gate(cuda):
    """A gate class K5 has no evaluator for raises NotImplementedError; no
    eager fallback."""
    from zk_circuits_torch.iop import gates as G
    from zk_circuits_torch.plonk import quotient_cuda

    class Custom(G.ArithmeticGate):
        pass

    common = _gate_common([Custom(num_ops=3), G.NoopGate()], degree_bits=4)
    inp = _k5_inputs(common, cuda, 1, 9)
    with pytest.raises(NotImplementedError):
        quotient_cuda.vanishing(common, inp["cs"], inp["wires"], inp["zsp"], inp["tables"],
                                inp["pi_hash"], inp["betas"], inp["gammas"], inp["alphas"])


@pytest.mark.parametrize("batch", [1, 4])
def test_k6_matches_plain(cuda, batch):
    """K6 at the wormhole's H (2^13 points), two launches, equal to
    plonk/prover.py's _zs_values_plain, with a zero denominator in one
    chunk of proof 0."""
    from zk_circuits_torch.plonk import permutation_cuda
    from zk_circuits_torch.plonk.prover import _zs_values_plain

    common = _gate_common(_wormhole_gates())
    n, rng = common.degree, np.random.default_rng(batch + 10)
    wv = rng.integers(0, P, (batch, 80, n), dtype=np.uint64)
    sig = rng.integers(0, P, (80, n), dtype=np.uint64)
    betas, gammas = (rng.integers(0, P, (2, batch, 1), dtype=np.uint64) for _ in range(2))
    wv[0, 5, 100] = (P - (int(betas[0, 0, 0]) * int(sig[5, 100]) + int(gammas[0, 0, 0])) % P) % P
    x = gf.from_u64(rng.integers(0, P, n, dtype=np.uint64), cuda)
    args = [gf.from_u64(a, cuda) for a in (wv, sig)] + [x] + \
        [gf.from_u64(a, cuda) for a in (betas, gammas)]
    before = permutation_cuda.launches
    got, finals = permutation_cuda.products(common, *args)
    torch.cuda.synchronize()
    assert permutation_cuda.launches == before + 2
    want, want_finals = _zs_values_plain(common, *args)
    assert torch.equal(got, want) and torch.equal(finals, want_finals)
    assert int(finals[0, 0]) == 0


WORMHOLE_FRI_WIDTHS = (84, 139, 24, 20)   # the zk wormhole's oracles, salts included


def _fri_rows(device, batch, seed, n=1 << 13, widths=WORMHOLE_FRI_WIDTHS, num_zs=2):
    """The prover's rows for K7/K8 at the wormhole's shapes: the
    constants/sigmas (k, n), shared, the other oracles (B, k, n), row r of
    them at alpha^r, the Z rows at g*zeta (alpha^0, ...); then comp0 and
    comp1 ((B, n) pairs), alpha (1, 2, B) and the points (3, 2, B: zeta,
    g*zeta, alpha^num_zs, proof 0's zeta -1), rows of 0, 1 and p - 1
    first."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        x = rng.integers(0, P, shape, dtype=np.uint64)
        x[..., :3] = [0, 1, P - 1][: x.shape[-1]]
        return gf.from_u64(x, device)

    sets = [draw(widths[0], n)] + [draw(batch, k, n) for k in widths[1:]]
    first = np.cumsum((0,) + widths[:-1])
    rows = [(x, 0, int(e)) for x, e in zip(sets, first)] + [(sets[2][:, :num_zs], 1, 0)]
    comps = [(draw(batch, n), draw(batch, n)) for _ in range(2)]
    pts = rng.integers(0, P, (4, 2, batch), dtype=np.uint64)
    pts[0, :, 0] = [P - 1, 0]
    pts = gf.from_u64(pts, device)
    return rows, comps, pts[3:], pts[:3]


@pytest.mark.parametrize("batch", [1, 4])
def test_k7_matches_plain(cuda, batch):
    """K7 at the wormhole's oracles (267 rows of 2^13 and the 2 Z rows at
    g*zeta), one launch, equal to fri/fri_device.py's _openings_plain."""
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri.fri_device import _openings_plain

    rows, _, _, pts = _fri_rows(cuda, batch, 70 + batch)
    before = fri_cuda.launches_by_kernel["k7"]
    got = fri_cuda.openings(rows, pts[:2])
    torch.cuda.synchronize()
    assert fri_cuda.launches_by_kernel["k7"] == before + 1
    want = _openings_plain(rows, pts[:2])
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("batch", [1, 4])
def test_k8_matches_plain(cuda, batch):
    """K8's point kernel (one launch) and scan (fri_cuda.SCAN_LAUNCHES) at
    the wormhole's shapes, equal to _reduce_alpha_plain and
    _compose_plain."""
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri.fri_device import _compose_plain, _reduce_alpha_plain

    rows, comps, alpha, pts = _fri_rows(cuda, batch, 80 + batch)
    before = fri_cuda.launches_by_kernel["k8"]
    comp = fri_cuda.reduce_alpha(rows, alpha)
    want = _reduce_alpha_plain(rows, alpha)
    assert [torch.equal(g, w) for c, d in zip(comp, want, strict=True)
            for g, w in zip(c, d, strict=True)] == [True] * 4
    args = (*comps, pts)
    f = fri_cuda.compose(*args)
    torch.cuda.synchronize()
    assert fri_cuda.launches_by_kernel["k8"] == before + 1 + fri_cuda.SCAN_LAUNCHES
    assert all(torch.equal(g, w) for g, w in zip(f, _compose_plain(*args), strict=True))


@pytest.mark.parametrize("arity_bits", [1, 2, 3, 4, 5, 6])
def test_k9_matches_plain(cuda, arity_bits):
    """K9's fold mode at 2^13 coefficients, B = 4 and a 1-D shard piece,
    the betas on the host, equal to _fold_plain."""
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri.fri_device import _fold_plain

    rng = np.random.default_rng(90 + arity_bits)
    c0, c1 = (gf.from_u64(rng.integers(0, P, (4, 1 << 13), dtype=np.uint64), cuda)
              for _ in range(2))
    beta = np.array([[P - 1, P - 1], [0, 0], [1, 1], [12345, 12345]], dtype=np.uint64)
    b0, b1 = gf.ext_pair(beta, cuda)
    before = fri_cuda.launches_by_kernel["k9"]
    got = fri_cuda.fold(c0, c1, beta, arity_bits)
    piece = fri_cuda.fold(c0[2], c1[2], beta[2], arity_bits)
    torch.cuda.synchronize()
    assert fri_cuda.launches_by_kernel["k9"] == before + 2
    want = _fold_plain(c0, c1, b0, b1, arity_bits)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert all(torch.equal(g, w[2]) for g, w in zip(piece, want, strict=True))


@pytest.mark.parametrize("arity_bits,next_bits,log_m,group_log", [
    (4, 4, 9, 3), (4, 4, 9, 0), (4, 4, 10, 3), (4, 1, 6, 3), (5, 1, 6, 3), (1, 5, 13, 3),
    (6, 2, 13, 0), (2, 2, 2, 2), (3, 1, 1, 1)])
def test_k9_round_matches_plain(cuda, arity_bits, next_bits, log_m, group_log):
    """K9's round mode at B = 4 and rate 2^3 (clusters of 1-8 blocks, the
    wormhole's and level circuits' rounds, the mul chain's arity 2^5, a
    2^16 codeword) equal to _fold_round_plain, one launch."""
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri.fri_device import _fold_round_plain

    rng = np.random.default_rng(log_m * 10 + arity_bits)
    c0, c1 = (gf.from_u64(rng.integers(0, P, (4, 1 << (log_m + arity_bits)), dtype=np.uint64),
                          cuda) for _ in range(2))
    beta = np.array([[P - 1, 0], [0, 1], [1, P - 1], [12345, 678]], dtype=np.uint64)
    shift = pow(7, 1 << arity_bits, P)
    before = fri_cuda.k9_by_mode["round"]
    got = fri_cuda.fold_round(c0, c1, beta, arity_bits, next_bits, 3, shift,
                              group_log=group_log)
    torch.cuda.synchronize()
    assert fri_cuda.k9_by_mode["round"] == before + 1
    want = _fold_round_plain(c0, c1, *gf.ext_pair(beta, cuda), arity_bits, next_bits, 3, shift)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


def test_k7_k8_k9_launches_on_a_proof(cuda):
    """A zk square circuit with FRI fold rounds proved on the card: K7 once,
    K8 three times (its point kernel, its scan's two launches) and K9 once
    a fold round (its round mode in every round but the last), no plain
    FRI body on a CUDA tensor, and the proof equal to the CPU's."""
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cfg = CircuitConfig(zero_knowledge=True, fri_config=FriConfig(
        proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2, final_poly_bits=1))
    out, plain = [], []
    for device in ("cuda", "cpu"):
        b = CircuitBuilder(cfg)
        x = b.add_virtual_target()
        b.register_public_input(b.square(x))
        data = b.build(device=device)
        pw = PartialWitness()
        pw.set_target(x, 5)
        before = dict(fri_cuda.launches_by_kernel)
        rounds_before = fri_cuda.k9_by_mode["round"]
        real = {k: getattr(fd, k) for k in ("_openings_plain", "_reduce_alpha_plain",
                                            "_compose_plain", "_fold_plain",
                                            "_fold_round_plain")}
        for k, fn in real.items():
            setattr(fd, k, lambda *a, _k=k, _fn=fn: plain.append((device, _k)) or _fn(*a))
        try:
            out.append(proof_to_bytes(data.prove(pw, device=device)))
        finally:
            for k, fn in real.items():
                setattr(fd, k, fn)
        if device == "cuda":
            rounds = len(cfg.fri_config.reduction_arities(data.common.degree_bits))
            assert rounds >= 1
            assert {k: v - before[k] for k, v in fri_cuda.launches_by_kernel.items()} == \
                {"k7": 1, "k8": 1 + fri_cuda.SCAN_LAUNCHES, "k9": rounds}
            assert fri_cuda.k9_by_mode["round"] - rounds_before == rounds - 1
    assert out[0] == out[1]
    assert [d for d, _ in plain] == ["cpu"] * len(plain) and plain


def _gather_forest(cuda, rng, batch):
    """The query gather's kinds at small main-path shapes: a shared
    column-major oracle (20, 2^12), a batched one (B, 30, 2^12), a FRI tree
    (B, 256, 32) row-major, and a tree of 16 leaves that are its cap (no
    sibling level); every word any u64 (in [p, 2^64) too); levels of K1's
    layout (views of one buffer), cap height 4."""
    def words(*shape):
        return gf.from_u64(rng.integers(0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True),
                           cuda)

    def tree(lead, leaf_shape, n, cap):
        sizes = [n >> lv for lv in range(n.bit_length() - cap)]
        return words(*lead, *leaf_shape), list(torch.split(words(*lead, sum(sizes), 4), sizes,
                                                           dim=-2))

    trees = [tree((), (20, 1 << 12), 1 << 12, 4), tree((batch,), (30, 1 << 12), 1 << 12, 4),
             tree((batch,), (256, 32), 256, 4), tree((batch,), (16, 8), 16, 4)]
    idxs = []
    for n in (1 << 12, 1 << 12, 256, 16):
        i = rng.integers(0, n, (batch, 28))
        i[:, :3] = [0, n - 1, 0]
        idxs.append(i)
    return trees, idxs, [True, False, False, False], [True, True, False, False]


@pytest.mark.parametrize("batch", [1, 4])
def test_k10_matches_plain(cuda, batch):
    """K10 on the card: one launch for every tree and proof, the same words
    as the plain version (a take a leaf matrix and a level) on the card,
    and gather_trees_batch's host arrays equal to the CPU's."""
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.fri import gather_cuda

    trees, idxs, shared, colmajor = _gather_forest(cuda, np.random.default_rng(batch), batch)
    before = gather_cuda.launches
    got = gather_cuda.gather(trees, idxs, shared, colmajor)
    torch.cuda.synchronize()
    assert gather_cuda.launches == before + 1
    assert torch.equal(got, fd._gather_plain(trees, idxs, shared, colmajor))
    on_card = fd.gather_trees_batch(trees, idxs, shared, colmajor)
    cpu = [(lf.cpu(), [lv.cpu() for lv in lvs]) for lf, lvs in trees]
    for (gr, gs), (wr, ws) in zip(on_card, fd.gather_trees_batch(cpu, idxs, shared, colmajor),
                                  strict=True):
        assert np.array_equal(gr, wr) and np.array_equal(gs, ws)
    assert gather_cuda.launches == before + 2


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("arity_bits", [1, 2, 3, 4, 5])
def test_k4_leaf_mode_matches_plain(cuda, arity_bits, batch):
    """K4's leaf mode on the card at FRI's round-0 shape (2^13 -> 2^16, the
    four-step, two launches), at 2^9 -> 2^12 (the four-step too: a row-path
    tile holds a row of each component up to 2^11) and on the row path
    (2^8 -> 2^11), the two components read from K8's (2, B, n) buffer,
    stored as whole leaves: equal to the plain stage
    loop's coset NTT regrouped into fiber leaves, and to K4's coset NTT and
    the regroup (``_commit_codeword_plain`` on the card)."""
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.ntt import ntt_cuda

    rng = np.random.default_rng(10 * arity_bits + batch)
    for n, size in ((1 << 13, 1 << 16), (1 << 9, 1 << 12), (1 << 8, 1 << 11)):
        f = gf.from_u64(rng.integers(0, P, (2, batch, n), dtype=np.uint64), cuda)
        before = ntt_cuda.launches_by_mode[ntt_cuda.LEAF_MODE]
        got = ntt_cuda.coset_leaves(f[0], f[1], 7, size, arity_bits)
        torch.cuda.synchronize()
        assert ntt_cuda.launches_by_mode[ntt_cuda.LEAF_MODE] - before == \
            (2 if ntt_cuda.leaf_plan(size) else 1)
        v = nttm.coset_ntt_plain(f, 7, size)
        assert torch.equal(got, fd._fiber_leaves(v[0], v[1], 1 << arity_bits))
        assert torch.equal(got, fd._commit_codeword_plain(f[0], f[1], 7, size, arity_bits))


def test_k10_and_leaf_mode_on_a_proof(cuda):
    """A zk square circuit with FRI fold rounds proved on the card: K10
    once, K4's leaf mode for the round-0 codeword, no plain gather or plain
    codeword on a CUDA tensor, and the proof equal to the CPU's."""
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.fri import gather_cuda
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cfg = CircuitConfig(zero_knowledge=True, fri_config=FriConfig(
        proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2, final_poly_bits=1))
    out, plain = [], []
    for device in ("cuda", "cpu"):
        b = CircuitBuilder(cfg)
        x = b.add_virtual_target()
        b.register_public_input(b.square(x))
        data = b.build(device=device)
        pw = PartialWitness()
        pw.set_target(x, 5)
        before = gather_cuda.launches, ntt_cuda.launches_by_mode[ntt_cuda.LEAF_MODE]
        real = {k: getattr(fd, k) for k in ("_gather_plain", "_commit_codeword_plain")}
        for k, fn in real.items():
            setattr(fd, k, lambda *a, _k=k, _fn=fn: plain.append((device, _k)) or _fn(*a))
        try:
            out.append(proof_to_bytes(data.prove(pw, device=device)))
        finally:
            for k, fn in real.items():
                setattr(fd, k, fn)
        if device == "cuda":
            assert gather_cuda.launches - before[0] == 1
            assert ntt_cuda.launches_by_mode[ntt_cuda.LEAF_MODE] > before[1]
    assert out[0] == out[1]
    assert [d for d, _ in plain] == ["cpu"] * len(plain) and plain


def test_sharded_wormhole_gathers_once_and_hashes_by_shard(cuda):
    """The zk wormhole of the golden inputs proved over make_mesh(4) on the
    card: K10 once (the shards' pieces read where they lie, no plain take
    on a CUDA tensor), K1 as chip_smoke.py's sharded phase counts it
    (``expected_sharded_k1_launches``: each shard's subtree in K1's tree
    mode, and the PoW sweeps), and the proof's sha256 the pinned
    ``GOLDEN_WORMHOLE_ZK_SHA256``."""
    import hashlib

    import chip_smoke
    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.circuits.wormhole import golden_fixtures
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.fri import gather_cuda
    from zk_circuits_torch.parallel import mesh as meshm
    from zk_circuits_torch.plonk import prover_sharded as ps
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    prover = WormholeProver(CircuitConfig.standard_recursion_zk_config(), device="cuda")
    cd, targets = prover.circuit_data, prover.targets
    mesh = meshm.make_mesh(chip_smoke.SHARDS)
    takes = []
    real = {(m, k): getattr(m, k) for m, k in ((fd, "_take_all"), (ps, "_take_sharded"))}
    for (m, k), fn in real.items():
        setattr(m, k, lambda *a, _k=k, _fn=fn, **kw: takes.append(_k) or _fn(*a, **kw))
    try:
        for _ in range(2):   # the second proof warm
            pw = WormholeProver(circuit_data=cd, targets=targets).commit(
                golden_fixtures.test_inputs()).partial_witness
            before = gather_cuda.launches, poseidon_cuda.launches
            proof = ps.prove_sharded(cd, pw, mesh)
            torch.cuda.synchronize()
            k10, k1 = gather_cuda.launches - before[0], poseidon_cuda.launches - before[1]
    finally:
        for (m, k), fn in real.items():
            setattr(m, k, fn)
    assert takes == []
    assert k10 == 1
    assert k1 == chip_smoke.expected_sharded_k1_launches(
        cd.common, chip_smoke.SHARDS, proof.proof.opening_proof.pow_witness)
    assert k1 <= chip_smoke.SHARDED_K1_MAX
    assert hashlib.sha256(proof_to_bytes(proof)).hexdigest() == \
        chip_smoke.GOLDEN_WORMHOLE_ZK_SHA256
