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
