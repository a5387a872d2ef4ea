"""The port's aggregator over a mesh of CPU shards against the JAX package.

``WormholeProofAggregator(..., mesh=make_mesh(2, device="cpu"))`` folds
one pushed square proof padded to 4 leaves by the loader (b=2, d=2):
level 1's two chunks split one a shard (``prove_batch_mesh``), level 2
one ``prove_chunk``.  Its root must be byte-equal to the JAX package's
aggregate of the same leaves over ``make_mesh(4)`` (its level 1, B=2,
unsharded by its rule), pinned below by sha256;
tests/test_torch_jax_pins.py derives that root with the JAX package and
holds it to the pin, and tests/test_torch_aggregation.py holds the port's
unsharded aggregate to it.  A file of its own, so that it runs beside
that one.
"""

import hashlib

import pytest
import torch
from test_torch_recursion import TORCH, square

from zk_circuits_torch.aggregation.aggregator import WormholeProofAggregator
from zk_circuits_torch.aggregation.tree import TreeAggregationConfig
from zk_circuits_torch.parallel.mesh import make_mesh
from zk_circuits_torch.plonk import prover_batch
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes

# sha256 of the JAX host path's root: square(JAX) proofs of 2 (pushed) and
# 1 (the loader's dummy), TreeAggregationConfig(2, 2), mesh=make_mesh(4)
JAX_MESH_ROOT_SHA256 = "1d0bea4f21125babbf0b0b52e30b98bd7797f9596325e73813f2b4bae4021c0b"


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """One torch thread, for the reason tests/test_torch_recursion.py's
    fixture gives."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_mesh_aggregate_matches_unsharded_and_jax(monkeypatch):
    data, witness = square(TORCH, device="cpu")

    def prove(v):
        return data.prove(witness(v), device="cpu")

    splits = []
    real = prover_batch.prove_batch_mesh

    def spy(cd, pws, mesh, check_witness=False):
        splits.append((len(pws), mesh.size))
        return real(cd, pws, mesh, check_witness)

    monkeypatch.setattr(prover_batch, "prove_batch_mesh", spy)
    agg = WormholeProofAggregator(data.common, data.verifier_only, TreeAggregationConfig(2, 2),
                                  mesh=make_mesh(2, device="cpu"),
                                  dummy_loader=lambda: prove(1), device="cpu")
    agg.push(prove(2))
    root = agg.aggregate()
    assert splits == [(2, 2)]
    assert root.public_inputs.tolist() == [4, 1, 1, 1]
    assert hashlib.sha256(t_bytes(root)).hexdigest() == JAX_MESH_ROOT_SHA256
    agg.root_circuit_data.verify(root)
