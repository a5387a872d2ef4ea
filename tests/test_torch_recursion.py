"""The port's recursion against the JAX package, byte for byte.

A level circuit (``aggregation/tree.py::LevelCircuit``: the in-circuit
verifier of ``recursion/verifier_circuit.py`` over two proofs of a
one-gate square circuit) built by the port on the CPU must equal the JAX
package's, digest, constants/sigmas cap and common.bin/verifier.bin
bytes, and its proof of a chunk (``prove_chunk``, the device witness and
every kernel's plain version) must equal the JAX host path's proof of
the same chunk.  The inner circuit is zk, as the card's aggregation of
zk wormhole proofs is, so the salt columns of every inner oracle are on
the path, and the FRI config is cheap (2 query rounds, 1 PoW bit) to keep
the plain sponge's work small.

A tampered inner proof is refused with the JAX package's host witness's
error, by the host witness (``ZKT_CHECK_WITNESS=1``) and by the device
witness of the default path.
"""

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
from zk_circuits_tpu.aggregation import tree as j_tree
from zk_circuits_tpu.api import artifacts as j_art
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

TORCH = types.SimpleNamespace(B=t_builder, W=t_witness, C=t_config)
JAX = types.SimpleNamespace(B=j_builder, W=j_witness, C=j_config)
CHEAP_FRI = dict(num_query_rounds=2, proof_of_work_bits=1)
VALUES = (3, 5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Four torch threads for this module's plain-version proofs of 2^12
    level circuits (about 35 s a proof; 86 s on one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
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
    return types.SimpleNamespace(t_data=t_data, j_data=j_data, t_proofs=t_proofs,
                                 j_proofs=j_proofs)


@pytest.fixture(scope="module")
def levels(inner):
    """The level circuit over two square proofs, built once by each package."""
    return (t_tree.LevelCircuit.cached(inner.t_data.common, 2, device="cpu"),
            j_tree.LevelCircuit.cached(inner.j_data.common, 2))


def test_level_circuit_matches_jax(levels):
    t_level, j_level = levels
    t_cd, j_cd = t_level.circuit_data, j_level.circuit_data
    assert t_level.num_gate_rows == j_level.num_gate_rows
    assert t_cd.common.degree_bits == j_cd.common.degree_bits
    assert np.array_equal(t_cd.common.circuit_digest, j_cd.common.circuit_digest)
    assert np.array_equal(t_cd.verifier_only.constants_sigmas_cap,
                          j_cd.verifier_only.constants_sigmas_cap)
    assert t_art.common_data_to_bytes(t_cd.common) == j_art.common_data_to_bytes(j_cd.common)
    assert t_art.verifier_data_to_bytes(t_cd.verifier_only) == \
        j_art.verifier_data_to_bytes(j_cd.verifier_only)
    # the recursion kinds are all in the schedule the device witness runs
    kinds = {b.kind for b in t_cd.prover_only.schedule}
    assert {"arith_ext", "ext_inv", "random_access", "poseidon"} <= kinds


def test_cached_level_circuit_keys_on_the_device(inner, levels):
    t_level, _ = levels
    assert t_tree.LevelCircuit.cached(inner.t_data.common, 2, device="cpu") is t_level
    assert t_level.device.type == "cpu"


def test_prove_chunk_matches_jax(inner, levels):
    t_level, j_level = levels
    got = t_level.prove_chunk(inner.t_proofs, inner.t_data.verifier_only)
    want = j_level.prove_chunk(inner.j_proofs, inner.j_data.verifier_only)
    assert t_bytes(got) == j_bytes(want)
    # outer public inputs = the inner ones, concatenated (tree.rs:117-124)
    assert got.public_inputs.tolist() == [v * v for v in VALUES]
    t_level.circuit_data.verify(got)


def _tampered(inner):
    """The second inner proof with one opened wire value changed."""
    bad = t_from_bytes(t_bytes(inner.t_proofs[1]))
    bad.proof.openings.wires[0, 0] ^= np.uint64(1)
    return [inner.t_proofs[0], bad]


def test_tampered_inner_proof_is_refused_by_the_host_witness(inner, levels, monkeypatch):
    monkeypatch.setenv("ZKT_CHECK_WITNESS", "1")
    t_level, _ = levels
    with pytest.raises(t_witness.WitnessConflict, match="set twice"):
        t_level.prove_chunk(_tampered(inner), inner.t_data.verifier_only)


def test_tampered_inner_proof_is_refused_by_the_device_witness(inner, levels, monkeypatch):
    monkeypatch.delenv("ZKT_CHECK_WITNESS", raising=False)
    t_level, _ = levels
    with pytest.raises(t_witness.WitnessConflict, match="set twice"):
        t_level.prove_chunk(_tampered(inner), inner.t_data.verifier_only)
