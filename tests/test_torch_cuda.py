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
