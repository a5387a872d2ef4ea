"""The port's vote circuit against the JAX package, byte for byte.

``circuits/voting.py`` built by the port on the CPU must equal the JAX
package's circuit (digest, constants/sigmas cap, common.bin and
verifier.bin), and its proof of the inputs of tests/test_voting.py
(``chip_smoke.vote_inputs``, made with the port's own modules) must equal
the JAX host path's proof, under a cheap FRI config (2 query rounds, 1
PoW bit).  The invalid-vote cases of
tests/test_voting.py raise as there: the two of ``fill_targets`` at once,
the two of ``prove`` from the witness, the device witness of the default
path as well as the host witness of ``check_witness``.  The
digest chip_smoke.py pins for the card's vote proof, under
``standard_recursion_config``, is derived here from the JAX package.
"""

import hashlib
import types

import numpy as np
import pytest
import torch
from test_voting import create_test_inputs

import chip_smoke
import zk_circuits_torch.circuits.voting as t_voting
import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.circuits.voting as j_voting
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.api import artifacts as t_art
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.api import artifacts as j_art
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

TORCH = types.SimpleNamespace(B=t_builder, W=t_witness, C=t_config, V=t_voting)
JAX = types.SimpleNamespace(B=j_builder, W=j_witness, C=j_config, V=j_voting)
CHEAP_FRI = dict(num_query_rounds=2, proof_of_work_bits=1)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def build(pkg, config, **build_kw):
    builder = pkg.B.CircuitBuilder(config)
    targets = pkg.V.VoteTargets.new(builder)
    pkg.V.VoteCircuitData.circuit(targets, builder)
    return builder.build(**build_kw), targets


def cheap(pkg):
    return pkg.C.CircuitConfig(fri_config=pkg.C.FriConfig(**CHEAP_FRI))


@pytest.fixture(scope="module")
def vote():
    t_data, t_targets = build(TORCH, cheap(TORCH), device="cpu")
    j_data, j_targets = build(JAX, cheap(JAX))
    return types.SimpleNamespace(data=t_data, targets=t_targets, j_data=j_data,
                                 j_targets=j_targets)


def witness(v, inputs):
    pw = t_witness.PartialWitness()
    inputs.fill_targets(pw, v.targets)
    return pw


def test_vote_inputs_equal_the_reference_test_inputs():
    got, want = chip_smoke.vote_inputs(), create_test_inputs()
    for part in ("public_inputs", "private_inputs"):
        g, w = getattr(got, part), getattr(want, part)
        for k, wv in vars(w).items():
            gv = getattr(g, k)
            assert np.array_equal(np.asarray(gv, dtype=object), np.asarray(wv, dtype=object)), k
    key, pid = want.private_inputs.private_key, want.public_inputs.proposal_id
    assert np.array_equal(t_voting.compute_nullifier(key, pid),
                          j_voting.compute_nullifier(key, pid))


def test_vote_circuit_matches_jax(vote):
    assert vote.data.common.degree_bits == vote.j_data.common.degree_bits
    assert np.array_equal(vote.data.common.circuit_digest, vote.j_data.common.circuit_digest)
    assert np.array_equal(vote.data.verifier_only.constants_sigmas_cap,
                          vote.j_data.verifier_only.constants_sigmas_cap)
    assert t_art.common_data_to_bytes(vote.data.common) == \
        j_art.common_data_to_bytes(vote.j_data.common)
    assert t_art.verifier_data_to_bytes(vote.data.verifier_only) == \
        j_art.verifier_data_to_bytes(vote.j_data.verifier_only)


def test_vote_proof_matches_jax(vote):
    proof = vote.data.prove(witness(vote, chip_smoke.vote_inputs()), device="cpu")
    j_pw = j_witness.PartialWitness()
    create_test_inputs().fill_targets(j_pw, vote.j_targets)
    assert t_bytes(proof) == j_bytes(vote.j_data.prove(j_pw, use_device=False))
    vote.data.verify(proof)
    # PI layout: proposal_id(4) ‖ merkle_root(4) ‖ vote(1) ‖ nullifier(4)
    assert proof.public_inputs.shape == (13,)
    assert proof.public_inputs[8] == 1


def test_invalid_merkle_depth(vote):
    inputs = chip_smoke.vote_inputs()
    inputs.private_inputs.actual_merkle_depth = t_voting.MAX_MERKLE_DEPTH + 1
    with pytest.raises(ValueError, match="exceeds maximum allowed depth"):
        inputs.fill_targets(t_witness.PartialWitness(), vote.targets)


def test_merkle_proof_length_mismatch(vote):
    inputs = chip_smoke.vote_inputs()
    inputs.private_inputs.path_indices.append(False)
    with pytest.raises(ValueError, match="length mismatch"):
        inputs.fill_targets(t_witness.PartialWitness(), vote.targets)


def _wrong_depth():
    inputs = chip_smoke.vote_inputs()
    inputs.private_inputs.actual_merkle_depth = 1  # should be 2
    return inputs


def _wrong_everything():
    inputs = chip_smoke.vote_inputs()
    inputs.private_inputs.private_key = np.full(4, 12345, dtype=np.uint64)
    inputs.private_inputs.merkle_siblings = [
        np.full(4, 67890, dtype=np.uint64),
        np.full(4, 11111, dtype=np.uint64),
    ]
    inputs.private_inputs.path_indices = [True, True]
    inputs.private_inputs.actual_merkle_depth = 2
    return inputs


@pytest.mark.parametrize("make", [_wrong_depth, _wrong_everything],
                         ids=["invalid_merkle_proof", "completely_invalid_proof"])
def test_invalid_vote_is_refused(vote, make):
    """The vote is refused as the JAX package's host witness refuses it:
    the Merkle root and nullifier the circuit computes differ from the
    claimed ones that the vote seeds, on the default path (the device
    witness) and under check_witness (the host witness)."""
    pw = witness(vote, make())
    for check in (True, False):
        with pytest.raises(t_witness.WitnessConflict, match="set twice"):
            vote.data.prove(pw, check_witness=check, device="cpu")


def test_pinned_vote_digest_is_the_reference_proof():
    data, targets = build(JAX, j_config.CircuitConfig.standard_recursion_config())
    pw = j_witness.PartialWitness()
    create_test_inputs().fill_targets(pw, targets)
    proof = data.prove(pw, use_device=False)
    digest = hashlib.sha256(j_bytes(proof)).hexdigest()
    assert digest == chip_smoke.GOLDEN_VOTE_SHA256
