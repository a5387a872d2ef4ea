"""The JAX package's results that the port's recursion and aggregation
tests hold the port to, re-derived from the JAX package and held to their
pins.

tests/test_torch_recursion.py, tests/test_torch_aggregation.py and
tests/test_torch_mesh_aggregate.py compare the port's level circuit, its
chunk proof and its roots with sha256 pins of the JAX host path's (the
JAX package is frozen).  This file derives each pin once, from the JAX
package alone, in a file of its own so that it runs beside the port's
proofs; scripts/golden_digests.py prints the same values.  Every
derivation goes through one JAX level circuit over two square(JAX)
proofs, built once (``LevelCircuit.cached``).  It also derives
chip_smoke.py's pins of the mul chain's proofs under FRI folds of arity 2^5
and under five challenges (GOLDEN_MUL_CHAIN_SHA256), which the port's
card run and its CPU tests through the kernels' host builds
(tests/test_torch_fri_kernel.py, tests/test_torch_quotient_kernel.py) are
held to.
"""

import hashlib

import pytest
from test_torch_aggregation import JAX_CHUNK_ROOT_SHA256

import chip_smoke
from test_torch_mesh_aggregate import JAX_MESH_ROOT_SHA256
from test_torch_recursion import (
    JAX,
    JAX_CHUNK_SHA256,
    JAX_LEVEL_COMMON_SHA256,
    JAX_LEVEL_DEGREE_BITS,
    JAX_LEVEL_GATE_ROWS,
    JAX_LEVEL_VERIFIER_SHA256,
    VALUES,
    square,
)

import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_tpu.aggregation import tree as j_tree
from zk_circuits_tpu.aggregation.aggregator import WormholeProofAggregator
from zk_circuits_tpu.api import artifacts as j_art
from zk_circuits_tpu.parallel.mesh import make_mesh
from zk_circuits_tpu.utils.serialization import proof_to_bytes


def _sha256(proof) -> str:
    return hashlib.sha256(proof_to_bytes(proof)).hexdigest()


class JaxSquare:
    """square(JAX), a host-path prover of it, and its level circuit."""

    def __init__(self):
        self.data, self.witness = square(JAX)

    def prove(self, v):
        return self.data.prove(self.witness(v), use_device=False)

    def level(self):
        return j_tree.LevelCircuit.cached(self.data.common, 2)

    def level_pins(self) -> dict:
        level = self.level()
        cd = level.circuit_data
        return {"gate_rows": level.num_gate_rows, "degree_bits": cd.common.degree_bits,
                "common_sha256": hashlib.sha256(
                    j_art.common_data_to_bytes(cd.common)).hexdigest(),
                "verifier_sha256": hashlib.sha256(
                    j_art.verifier_data_to_bytes(cd.verifier_only)).hexdigest()}

    def chunk_sha256(self) -> str:
        """prove_chunk of VALUES' proofs (tests/test_torch_recursion.py)."""
        proofs = [self.prove(v) for v in VALUES]
        return _sha256(self.level().prove_chunk(proofs, self.data.verifier_only))

    def mesh_root_sha256(self) -> str:
        """One pushed proof of 2 padded with proofs of 1 to 4 leaves, b=2,
        d=2, over make_mesh(4) (tests/test_torch_mesh_aggregate.py)."""
        agg = WormholeProofAggregator(self.data.common, self.data.verifier_only,
                                      j_tree.TreeAggregationConfig(2, 2), mesh=make_mesh(4),
                                      dummy_loader=lambda: self.prove(1))
        agg.push(self.prove(2))
        return _sha256(agg.aggregate())

    def chunk_root_sha256(self) -> str:
        """The depth-1 root of proofs of 6 and 7
        (tests/test_torch_aggregation.py)."""
        root, _ = j_tree.aggregate_to_tree([self.prove(6), self.prove(7)], self.data.common,
                                           self.data.verifier_only,
                                           j_tree.TreeAggregationConfig(2, 1))
        return _sha256(root)


@pytest.fixture(scope="module")
def jax_square():
    return JaxSquare()


def test_level_circuit_pins(jax_square):
    assert jax_square.level_pins() == {
        "gate_rows": JAX_LEVEL_GATE_ROWS, "degree_bits": JAX_LEVEL_DEGREE_BITS,
        "common_sha256": JAX_LEVEL_COMMON_SHA256, "verifier_sha256": JAX_LEVEL_VERIFIER_SHA256}


def test_chunk_pin(jax_square):
    assert jax_square.chunk_sha256() == JAX_CHUNK_SHA256


def test_mesh_root_pin(jax_square):
    assert jax_square.mesh_root_sha256() == JAX_MESH_ROOT_SHA256


def test_chunk_root_pin(jax_square):
    assert jax_square.chunk_root_sha256() == JAX_CHUNK_ROOT_SHA256


def mul_chain_sha256(which: str) -> str:
    """sha256 of the JAX host path's proof of chip_smoke's mul chain under
    chip_smoke.WIDE_CONFIGS[which]."""
    data, pw = chip_smoke.mul_chain(j_builder, j_witness, j_config, which)
    return _sha256(data.prove(pw, use_device=False))


@pytest.mark.parametrize("which", sorted(chip_smoke.WIDE_CONFIGS))
def test_mul_chain_pins(which):
    assert mul_chain_sha256(which) == chip_smoke.GOLDEN_MUL_CHAIN_SHA256[which]
