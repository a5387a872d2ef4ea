"""The digests chip_smoke.py pins for the port's full-size wormhole proof
and for the root of its aggregation.

The port proves the zk wormhole and aggregates it on the GPU only
(chip_smoke.py), on a machine without JAX.  These tests derive the sha256
of the JAX package's host-path proofs of the same inputs and require each
to equal the digest that chip_smoke.py holds the GPU proof's bytes to.
"""

import hashlib

import pytest

import chip_smoke
from zk_circuits_tpu.api.prover import WormholeProver
from zk_circuits_tpu.circuits.wormhole import golden_fixtures
from zk_circuits_tpu.plonk.config import CircuitConfig
from zk_circuits_tpu.utils.serialization import proof_to_bytes


def test_pinned_wormhole_digest_is_the_reference_proof():
    prover = WormholeProver(CircuitConfig.standard_recursion_zk_config())
    proof = prover.commit(golden_fixtures.test_inputs()).prove(use_device=False)
    digest = hashlib.sha256(proof_to_bytes(proof)).hexdigest()
    assert digest == chip_smoke.GOLDEN_WORMHOLE_ZK_SHA256


@pytest.mark.slow
def test_pinned_aggregate_digest_is_the_reference_root():
    """chip_smoke.py's aggregate phase holds the card's root proof to the
    JAX host path's: the default tree (b=2, d=3) of the zk wormhole proof,
    pushed 3 times and its own dummy.  Slow: three wormhole-scale level
    circuits built and 7 of their proofs made on the host, about 5
    minutes (``scripts/golden_digests.py`` prints the same digest)."""
    from zk_circuits_tpu.aggregation.aggregator import WormholeProofAggregator
    from zk_circuits_tpu.aggregation.tree import TreeAggregationConfig

    prover = WormholeProver(CircuitConfig.standard_recursion_zk_config())
    leaf = prover.commit(golden_fixtures.test_inputs()).prove(use_device=False)
    cd = prover.circuit_data
    agg = WormholeProofAggregator(cd.common, cd.verifier_only, TreeAggregationConfig(2, 3),
                                  dummy_loader=lambda: leaf)
    for _ in range(3):
        agg.push(leaf)
    root = agg.aggregate()
    digest = hashlib.sha256(proof_to_bytes(root)).hexdigest()
    assert digest == chip_smoke.GOLDEN_AGGREGATE_ZK_SHA256
