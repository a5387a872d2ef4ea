"""The digest chip_smoke.py pins for the port's full-size wormhole proof.

The port proves the zk wormhole on the GPU only (chip_smoke.py), on a
machine without JAX.  This test derives the sha256 of the JAX package's
host-path proof of the same inputs and requires it to equal the digest
that chip_smoke.py holds the GPU proof's bytes to.
"""

import hashlib

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
