"""The port's recursion against the JAX package, byte for byte.

A level circuit (``aggregation/tree.py::LevelCircuit``: the in-circuit
verifier of ``recursion/verifier_circuit.py`` over two proofs of a
one-gate square circuit) built by the port on the CPU must equal the JAX
package's, gate rows and common.bin/verifier.bin bytes (its degree,
digest and constants/sigmas cap among them), and its proof of a chunk
(``prove_chunk``, the device witness and every kernel's plain version)
must equal the JAX host path's proof of the same chunk.  The JAX
package's side is pinned below by sha256: the package is frozen, and
tests/test_torch_jax_pins.py (and scripts/golden_digests.py) re-derive
every pin from it, so that tier-1 builds and proves the JAX level
circuit once.  The inner circuit is zk, as the card's aggregation of
zk wormhole proofs is, so the salt columns of every inner oracle are on
the path, and the FRI config is cheap (2 query rounds, 1 PoW bit) to keep
the plain sponge's work small.

A tampered inner proof is refused with the JAX package's host witness's
error, by the host witness (``ZKT_CHECK_WITNESS=1``) and by the device
witness of the default path.
"""

import hashlib
import types

import numpy as np
import pytest
import torch

import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.aggregation import tree as t_tree
from zk_circuits_torch.api import artifacts as t_art
from zk_circuits_torch.utils.serialization import proof_from_bytes as t_from_bytes
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

TORCH = types.SimpleNamespace(B=t_builder, W=t_witness, C=t_config)
JAX = types.SimpleNamespace(B=j_builder, W=j_witness, C=j_config)
CHEAP_FRI = dict(num_query_rounds=2, proof_of_work_bits=1)
VALUES = (3, 5)

# The JAX package's level circuit over two square(JAX) proofs
# (LevelCircuit.cached(common, 2)) and its prove_chunk of VALUES' proofs.
JAX_LEVEL_GATE_ROWS = 2440
JAX_LEVEL_DEGREE_BITS = 12
JAX_LEVEL_COMMON_SHA256 = "30c40769634d3f518a05c9fa1421e6a641e837cdc7c7482e1501b799e6a6b873"
JAX_LEVEL_VERIFIER_SHA256 = "f729a0646bd48ae92de7916917558f537c31c0877ca4fee571f311bf72f3066a"
JAX_CHUNK_SHA256 = "bc7d2c77f1af02a2c4ae7748bdd032a22a4ea8e7e705959634b5773f2c0a5c82"


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """One torch thread for this module's plain-version proofs of 2^12
    level circuits.  Tier-1 runs six test files at once on eight cores;
    with more torch threads than free cores the plain version's short
    operations wait at the thread pool's barriers (the level proofs took
    longer on four threads beside three other files than on one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def square(pkg, **build_kw):
    """The zk one-gate square circuit under the cheap FRI config, and a
    maker of its witnesses."""
    cfg = pkg.C.CircuitConfig(zero_knowledge=True, fri_config=pkg.C.FriConfig(**CHEAP_FRI))
    b = pkg.B.CircuitBuilder(cfg)
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    data = b.build(**build_kw)

    def witness(v):
        pw = pkg.W.PartialWitness()
        pw.set_target(x, v)
        return pw

    return data, witness


@pytest.fixture(scope="module")
def inner():
    """The square circuit of both packages and its proofs of VALUES, equal
    bytes."""
    t_data, t_wit = square(TORCH, device="cpu")
    j_data, j_wit = square(JAX)
    t_proofs = [t_data.prove(t_wit(v), device="cpu") for v in VALUES]
    j_proofs = [j_data.prove(j_wit(v), use_device=False) for v in VALUES]
    assert [t_bytes(p) for p in t_proofs] == [j_bytes(p) for p in j_proofs]
    return types.SimpleNamespace(t_data=t_data, t_proofs=t_proofs)


@pytest.fixture(scope="module")
def levels(inner):
    """The port's level circuit over two square proofs, built once."""
    return t_tree.LevelCircuit.cached(inner.t_data.common, 2, device="cpu")


def test_level_circuit_matches_jax(levels):
    t_cd = levels.circuit_data
    assert levels.num_gate_rows == JAX_LEVEL_GATE_ROWS
    assert t_cd.common.degree_bits == JAX_LEVEL_DEGREE_BITS
    assert np.array_equal(t_cd.common.circuit_digest, t_cd.verifier_only.circuit_digest)
    assert sha256(t_art.common_data_to_bytes(t_cd.common)) == JAX_LEVEL_COMMON_SHA256
    assert sha256(t_art.verifier_data_to_bytes(t_cd.verifier_only)) == \
        JAX_LEVEL_VERIFIER_SHA256
    # the recursion kinds are all in the schedule the device witness runs
    kinds = {b.kind for b in t_cd.prover_only.schedule}
    assert {"arith_ext", "ext_inv", "random_access", "poseidon"} <= kinds


def test_cached_level_circuit_keys_on_the_device(inner, levels):
    assert t_tree.LevelCircuit.cached(inner.t_data.common, 2, device="cpu") is levels
    assert levels.device.type == "cpu"


def test_prove_chunk_matches_jax(inner, levels):
    got = levels.prove_chunk(inner.t_proofs, inner.t_data.verifier_only)
    assert sha256(t_bytes(got)) == JAX_CHUNK_SHA256
    # outer public inputs = the inner ones, concatenated (tree.rs:117-124)
    assert got.public_inputs.tolist() == [v * v for v in VALUES]
    levels.circuit_data.verify(got)


def _tampered(inner):
    """The second inner proof with one opened wire value changed."""
    bad = t_from_bytes(t_bytes(inner.t_proofs[1]))
    bad.proof.openings.wires[0, 0] ^= np.uint64(1)
    return [inner.t_proofs[0], bad]


def test_tampered_inner_proof_is_refused_by_the_host_witness(inner, levels, monkeypatch):
    monkeypatch.setenv("ZKT_CHECK_WITNESS", "1")
    with pytest.raises(t_witness.WitnessConflict, match="set twice"):
        levels.prove_chunk(_tampered(inner), inner.t_data.verifier_only)


def test_tampered_inner_proof_is_refused_by_the_device_witness(inner, levels, monkeypatch):
    monkeypatch.delenv("ZKT_CHECK_WITNESS", raising=False)
    with pytest.raises(t_witness.WitnessConflict, match="set twice"):
        levels.prove_chunk(_tampered(inner), inner.t_data.verifier_only)
