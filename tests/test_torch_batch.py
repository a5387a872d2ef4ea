"""The port's batched prover against the JAX package, byte for byte.

``prove_batch`` of B distinct witnesses of one circuit on CPU tensors (the
plain versions of every kernel) must give, for each witness, the proof
the JAX package's host path gives for that witness alone, and it must
verify.  Distinct witnesses catch a stage that takes one proof's value
for every proof of the batch.
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
from zk_circuits_torch.plonk.prover import prove_batch
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.plonk.prover import prove as j_prove
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

TORCH = types.SimpleNamespace(B=t_builder, W=t_witness, C=t_config)
JAX = types.SimpleNamespace(B=j_builder, W=j_witness, C=j_config)
VALUES = (3, 7, 255)

torch.set_num_threads(1)


def _config(pkg, zk: bool, fri: dict | None):
    if fri is None:
        c = pkg.C.CircuitConfig
        return c.standard_recursion_zk_config() if zk else c.standard_recursion_config()
    return pkg.C.CircuitConfig(zero_knowledge=zk, fri_config=pkg.C.FriConfig(**fri))


def _square(pkg, zk, fri, **build_kw):
    b = pkg.B.CircuitBuilder(_config(pkg, zk, fri))
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    data = b.build(**build_kw)

    def witness(v):
        pw = pkg.W.PartialWitness()
        pw.set_target(x, v)
        return pw

    return data, witness


def _reference_bytes(zk, fri, values):
    data, witness = _square(JAX, zk, fri)
    return {v: j_bytes(j_prove(data, witness(v), use_device=False)) for v in values}


def check_batch_against_reference(zk: bool) -> None:
    """The standard configs as they are (28 queries, 16 PoW bits); the
    square circuit is below the first FRI fold.  Each config costs about
    40 s here (the plain sponge's PoW grind), so the zk one runs in
    test_torch_batch_parts.py, on another worker."""
    want = _reference_bytes(zk, None, VALUES)
    data, witness = _square(TORCH, zk, None, device="cpu")
    proofs = prove_batch(data, [witness(v) for v in VALUES], device="cpu")
    assert len(proofs) == len(VALUES)
    for v, proof in zip(VALUES, proofs):
        assert proof.public_inputs.tolist() == [v * v]
        assert t_bytes(proof) == want[v], v
        data.verify(proof)


def test_prove_batch_matches_reference_bytes():
    check_batch_against_reference(zk=False)


# FRI fold rounds on the square circuit (arity 4 down to 2 coefficients),
# few queries and PoW bits: the batched commit chain, folds and fold-tree
# gathers, at little cost.
FRI_ROUNDS = dict(proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2,
                  final_poly_bits=1)


def test_prove_batch_fri_rounds_in_any_order_and_size():
    want = _reference_bytes(True, FRI_ROUNDS, VALUES)
    data, witness = _square(TORCH, True, FRI_ROUNDS, device="cpu")
    for values in (VALUES, (255, 3, 7), (7,)):
        proofs = prove_batch(data, [witness(v) for v in values], device="cpu")
        assert [t_bytes(p) for p in proofs] == [want[v] for v in values], values
        assert len(proofs[0].proof.opening_proof.commit_phase_caps) == 2
    data.verify(proofs[0])
    assert prove_batch(data, [], device="cpu") == []


def test_prove_batch_refuses_a_mesh_and_needs_cuda_by_default():
    """A mesh decides where the batch runs: a device of another type than
    its shards' is refused.  Without a mesh or a device, the batch needs
    CUDA."""
    from zk_circuits_torch.parallel.mesh import make_mesh

    data, witness = _square(TORCH, False, FRI_ROUNDS, device="cpu")
    with pytest.raises(ValueError, match="contradicts the mesh"):
        prove_batch(data, [witness(3), witness(7)], mesh=make_mesh(2, device="cpu"))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prove_batch(data, [witness(3), witness(7)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prove_batch(data, [])


def test_prove_batch_takes_the_reference_argument_order(monkeypatch):
    """prove_batch(circuit_data, pws, mesh, check_witness) as the JAX
    package orders them: a positional mesh is a mesh (its two shards
    prove a witness each, with check_witness off, not taken for
    check_witness), and the device is a keyword only."""
    from zk_circuits_torch.parallel.mesh import make_mesh
    from zk_circuits_torch.plonk import prover_batch

    data, witness = _square(TORCH, False, FRI_ROUNDS, device="cpu")
    splits = []
    real = prover_batch.prove_batch_mesh

    def spy(cd, pws, mesh, check_witness=False):
        splits.append((len(pws), mesh.size, check_witness))
        return real(cd, pws, mesh, check_witness)

    monkeypatch.setattr(prover_batch, "prove_batch_mesh", spy)
    proofs = prove_batch(data, [witness(3), witness(7)], make_mesh(2, device="cpu"),
                         device="cpu")
    assert splits == [(2, 2, False)]
    want = _reference_bytes(False, FRI_ROUNDS, (3, 7))
    assert [t_bytes(p) for p in proofs] == [want[3], want[7]]
    with pytest.raises(TypeError):
        prove_batch(data, [witness(3)], None, None, "cpu")
