"""The port's batch over a mesh of shards against the JAX package.

``prove_batch(data, pws, mesh=m)`` on a CPU mesh (``make_mesh(E,
device="cpu")``: E shards on the CPU, the sub-batches in turn) must return, in the order of ``pws``, proofs byte-equal to
``prove`` of each witness and to the JAX host path's
``prove_batch(..., mesh=make_mesh(4))`` on the conftest's 8 virtual CPU
devices, for E = 2 and 4 at B = 4 and 8.  The batch is split only when B
is a multiple of E (the JAX package's rule, its prover_batch.py
``_shard``): B = 6 over E = 4 runs unsharded, with the same bytes.  The
square circuit under the cheap FRI-rounds config of
tests/test_torch_batch.py; distinct witnesses catch a shard that proves
another shard's witnesses.
"""

import numpy as np
import pytest
import torch
from test_torch_batch import FRI_ROUNDS, JAX, TORCH, _square

from zk_circuits_torch.parallel.mesh import make_mesh
from zk_circuits_torch.plonk import prover_batch
from zk_circuits_torch.plonk.prover import prove, prove_batch
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.parallel.mesh import make_mesh as j_make_mesh
from zk_circuits_tpu.plonk.prover import prove_batch as j_prove_batch
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

VALUES = (3, 7, 11, 255, 2, 5, 6, 9)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """One torch thread, for the reason tests/test_torch_recursion.py's
    fixture gives."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def square():
    """The port's square circuit, its witness maker, and the JAX host
    path's mesh batch of every value (bytes by value)."""
    j_data, j_witness = _square(JAX, True, FRI_ROUNDS)
    j_proofs = j_prove_batch(j_data, [j_witness(v) for v in VALUES], mesh=j_make_mesh(4),
                             use_device=False)
    want = {v: j_bytes(p) for v, p in zip(VALUES, j_proofs)}
    data, witness = _square(TORCH, True, FRI_ROUNDS, device="cpu")
    return data, witness, want


@pytest.fixture
def sub_batches(monkeypatch):
    """Every prove_batch_device call: (batch size, device)."""
    calls = []
    real = prover_batch.prove_batch_device

    def spy(cd, pws, device, *a, **k):
        calls.append((len(pws), str(device)))
        return real(cd, pws, device, *a, **k)

    monkeypatch.setattr(prover_batch, "prove_batch_device", spy)
    return calls


@pytest.mark.parametrize("shards,batch", [(2, 4), (2, 8), (4, 4), (4, 8)])
def test_mesh_batch_matches_prove_and_jax(square, sub_batches, shards, batch):
    data, witness, want = square
    values = VALUES[:batch]
    proofs = prove_batch(data, [witness(v) for v in values],
                         mesh=make_mesh(shards, device="cpu"), device="cpu")
    assert sub_batches == [(batch // shards, "cpu")] * shards
    assert [p.public_inputs.tolist() for p in proofs] == [[v * v] for v in values]
    assert [t_bytes(p) for p in proofs] == [want[v] for v in values]
    if (shards, batch) == (4, 4):
        assert t_bytes(prove(data, witness(values[-1]), device="cpu")) == t_bytes(proofs[-1])
        data.verify(proofs[-1])


def test_mesh_batch_not_a_multiple_runs_unsharded(square, sub_batches):
    """B = 6 over E = 4: one batch of 6 on the mesh's first device."""
    data, witness, want = square
    values = VALUES[:6]
    proofs = prove_batch(data, [witness(v) for v in values],
                         mesh=make_mesh(4, device="cpu"), device="cpu")
    assert sub_batches == [(6, "cpu")]
    assert [t_bytes(p) for p in proofs] == [want[v] for v in values]


def test_mesh_decides_the_device(square):
    """A device of another type than the mesh's raises; an empty batch
    over a mesh is empty."""
    data, witness, _ = square
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="contradicts the mesh"):
        prove_batch(data, [witness(3), witness(7)], mesh=mesh)
    with pytest.raises(ValueError, match="contradicts the mesh"):
        prove_batch(data, [witness(3), witness(7)], mesh, None, device="cuda")
    assert prove_batch(data, [], mesh=mesh, device="cpu") == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2)


def test_mesh_batch_proves_the_shards_in_turn(monkeypatch):
    """The shards' sub-batches go through prove_batch_device in shard
    order, each on its shard's device; the proofs come back in the order
    of pws."""
    from zk_circuits_torch.parallel.mesh import Mesh

    seen = []

    def fake(cd, pws, device, check_witness=False):
        seen.append((str(device), list(pws)))
        return [f"{device}:{w}" for w in pws]

    monkeypatch.setattr(prover_batch, "prove_batch_device", fake)
    devices = tuple(torch.device(d) for d in ("cpu", "meta", "cpu", "meta"))
    out = prover_batch.prove_batch_mesh(None, list(range(8)), Mesh(devices))
    assert out == ["cpu:0", "cpu:1", "meta:2", "meta:3", "cpu:4", "cpu:5", "meta:6", "meta:7"]
    assert seen == [("cpu", [0, 1]), ("meta", [2, 3]), ("cpu", [4, 5]), ("meta", [6, 7])]
    with pytest.raises(ValueError, match="does not split"):
        prover_batch.prove_batch_mesh(None, list(range(6)), Mesh(devices))


def test_hybrid_mesh_layout():
    """Named axes, their shape and the blocks each shard holds; a tensor
    split over one axis is copied along the other, one tensor per block
    and device."""
    from zk_circuits_torch.parallel import distributed
    from zk_circuits_torch.parallel import mesh as meshm
    from zk_circuits_torch.parallel import ntt_sharded as nts

    mesh = distributed.hybrid_mesh(num_hosts=2, local_shards=8, device="cpu")
    assert mesh.shape == {"dcn": 2, "ici": 4} and mesh.size == 8
    assert mesh.block_index(("dcn", "ici")) == tuple(range(8))
    assert mesh.block_index(("ici", "dcn")) == (0, 2, 4, 6, 1, 3, 5, 7)
    assert mesh.block_index("dcn") == (0,) * 4 + (1,) * 4
    assert [nts._axis_size(mesh, a) for a in ("dcn", "ici", ("dcn", "ici"))] == [2, 4, 8]
    assert distributed.host_local_slice(mesh) == 0 and not mesh.spans_processes
    x = torch.arange(16)
    parts = meshm.shard_last(x, mesh, "dcn")
    assert [p.tolist() for p in parts] == [list(range(8))] * 4 + [list(range(8, 16))] * 4
    assert parts[0] is parts[3] and parts[4] is parts[7]
    assert [p.tolist() for p in meshm.shard_batch(x, mesh, ("ici", "dcn"))][:3] == \
        [[0, 1], [4, 5], [8, 9]]
    copies = meshm.replicated(x, mesh)
    assert torch.equal(copies[0], x) and all(p is copies[0] for p in copies)
    with pytest.raises(ValueError, match="not a set of the mesh's axes"):
        meshm.shard_last(x, mesh, "x")
    with pytest.raises(ValueError, match="not divisible"):
        distributed.hybrid_mesh(num_hosts=3, local_shards=8, device="cpu")
    with pytest.raises(ValueError, match="name the backend"):
        distributed.initialize("localhost:1", 1, 0)
    two = meshm.Mesh(mesh.devices, mesh.axis_names, mesh.axis_sizes, (0,) * 4 + (1,) * 4, 1)
    assert two.local == (4, 5, 6, 7) and two.spans_processes
    assert np.array_equal(two.block_index(), np.arange(8))
    from zk_circuits_torch.plonk.prover_sharded import prove_sharded

    with pytest.raises(ValueError, match="one process"):
        prove_sharded(None, None, two)
