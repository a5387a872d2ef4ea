"""The port's tree aggregation and aggregator API against the JAX package.

The semantics of the JAX package's tests/test_aggregator_api.py (buffer
overflow, empty buffer, padding through the dummy loader, a dummy of the
wrong shape, the level-circuit cache, leaf extraction), on the port's
``aggregation/aggregator.py`` and ``aggregation/tree.py`` with
``device="cpu"``, and byte-equal roots: a 2-level tree (b=2, d=2: the
first level a batch of two chunks through ``prove_batch``, the second a
``prove_chunk``) of one pushed proof padded by the loader, and a repeat
aggregation at depth 1 that builds no circuit.  The inner circuit is the
zk square circuit of tests/test_torch_recursion.py under its cheap FRI
config.  The JAX roots are pinned by sha256: the 2-level root is the JAX
package's aggregate over ``make_mesh(4)``, the digest that
tests/test_torch_mesh_aggregate.py holds the port's aggregate over a mesh
of 2 CPU shards to; tests/test_torch_jax_pins.py (and
scripts/golden_digests.py) re-derive both from the frozen JAX package.
"""

import hashlib
import types

import numpy as np
import pytest
import torch
from test_torch_mesh_aggregate import JAX_MESH_ROOT_SHA256
from test_torch_recursion import JAX, TORCH, square

from zk_circuits_torch.aggregation import tree as t_tree
from zk_circuits_torch.aggregation.aggregator import WormholeProofAggregator
from zk_circuits_torch.circuits.wormhole.inputs import LEAF_PI_LEN, PublicCircuitInputs
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.aggregation import tree as j_tree
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

# sha256 of the JAX host path's depth-1 root of square(JAX) proofs of 6 and
# 7: aggregate_to_tree(..., TreeAggregationConfig(2, 1)).
JAX_CHUNK_ROOT_SHA256 = "73a4dcd14a7c92e9f4ca5a5f5798b3e67a8b7356049c44aa95311ff438777642"


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """One torch thread, for the reason tests/test_torch_recursion.py's
    fixture gives."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sq():
    """The port's square circuit and a prover; its proof of a value equals
    the JAX package's."""
    t_data, t_wit = square(TORCH, device="cpu")
    j_data, j_wit = square(JAX)

    def prove(v):
        return t_data.prove(t_wit(v), device="cpu")

    assert t_bytes(prove(2)) == j_bytes(j_data.prove(j_wit(2), use_device=False))
    return types.SimpleNamespace(data=t_data, prove=prove)


def _aggregator(sq, config, **kw):
    return WormholeProofAggregator(sq.data.common, sq.data.verifier_only, config,
                                   device="cpu", **kw)


@pytest.fixture(scope="module")
def tree(sq):
    """One pushed proof padded to 4 leaves by the loader and folded by a
    2-level tree by the port (the JAX package's root, pinned, folds the
    same leaves over its mesh of 4 virtual devices, where level 1's 2
    chunks run unsharded by its rule): (port aggregator, loader calls)."""
    calls = []

    def loader():
        calls.append(1)
        return sq.prove(1)

    agg = _aggregator(sq, t_tree.TreeAggregationConfig(2, 2), dummy_loader=loader)
    agg.push(sq.prove(2))
    agg.aggregate()
    return agg, calls


def test_tree_aggregation_config():
    cfg = t_tree.TreeAggregationConfig.default()
    assert (cfg.branching_factor, cfg.depth, cfg.num_leaf_proofs) == (2, 3, 8)
    assert t_tree.TreeAggregationConfig(3, 2).num_leaf_proofs == 9
    assert cfg == t_tree.TreeAggregationConfig(*vars(j_tree.TreeAggregationConfig()).values())


def test_buffer_rejects_overflow(sq):
    agg = _aggregator(sq, t_tree.TreeAggregationConfig(2, 1))
    agg.push(sq.prove(2))
    agg.push(sq.prove(3))
    with pytest.raises(ValueError, match="full"):
        agg.push(sq.prove(4))


def test_aggregate_empty_buffer_raises(sq):
    with pytest.raises(ValueError, match="no proofs"):
        _aggregator(sq, None).aggregate()


def test_mismatched_dummy_shape_raises(sq):
    agg = _aggregator(sq, t_tree.TreeAggregationConfig(2, 2))
    agg.push(sq.prove(2))
    bad_dummy = types.SimpleNamespace(public_inputs=np.zeros(16, np.uint64))
    with pytest.raises(ValueError, match="dummy proof shape"):
        agg.aggregate(dummy_proof=bad_dummy)


def test_extract_leaf_public_inputs_requires_aggregate(sq):
    with pytest.raises(ValueError, match="aggregate"):
        _aggregator(sq, None).extract_leaf_public_inputs()


def test_extract_leaf_public_inputs_splits_the_root(sq):
    """inputs.rs:61-89: a root's public inputs split into per-leaf
    chunks, through the aggregator and through PublicCircuitInputs."""
    pis = np.zeros(2 * LEAF_PI_LEN, dtype=np.uint64)
    pis[0:4] = [1, 2, 3, 4]          # nullifier digest felts (leaf 0)
    pis[16:20] = [5, 6, 7, 8]        # nullifier digest felts (leaf 1)
    fake_root = types.SimpleNamespace(public_inputs=pis)
    leaves = PublicCircuitInputs.try_from_aggregated(fake_root, LEAF_PI_LEN, 2)
    assert len(leaves) == 2
    assert leaves[0].nullifier != leaves[1].nullifier
    assert leaves[0].funding_amount == 0
    agg = _aggregator(sq, t_tree.TreeAggregationConfig(2, 1))
    agg.root_proof = fake_root
    assert agg.extract_leaf_public_inputs() == leaves


def test_two_level_tree_pads_via_loader_and_matches_jax(tree):
    agg, calls = tree
    assert calls == [1]
    assert agg.root_proof.public_inputs.tolist() == [4, 1, 1, 1]
    assert hashlib.sha256(t_bytes(agg.root_proof)).hexdigest() == JAX_MESH_ROOT_SHA256
    agg.root_circuit_data.verify(agg.root_proof)


def test_level_circuit_cache_reused_and_chunk_matches_jax(sq, tree, monkeypatch):
    """A second aggregation of the same inner circuit builds no circuit
    (the reference rebuilds per chunk, tree.rs:111-127); its root, one
    prove_chunk of the cached level circuit, equals the JAX package's
    (pinned)."""
    builds = []
    real_init = t_tree.LevelCircuit.__init__

    def spy(self, *a, **k):
        builds.append(1)
        real_init(self, *a, **k)

    n_cached = len(t_tree._LEVEL_CACHE)
    monkeypatch.setattr(t_tree.LevelCircuit, "__init__", spy)
    cfg = t_tree.TreeAggregationConfig(2, 1)
    root, root_data = t_tree.aggregate_to_tree([sq.prove(6), sq.prove(7)], sq.data.common,
                                               sq.data.verifier_only, cfg, device="cpu")
    assert builds == []
    assert len(t_tree._LEVEL_CACHE) == n_cached
    assert root.public_inputs.tolist() == [36, 49]
    root_data.verify(root)
    assert hashlib.sha256(t_bytes(root)).hexdigest() == JAX_CHUNK_ROOT_SHA256
