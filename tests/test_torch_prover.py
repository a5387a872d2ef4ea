"""End-to-end parity of the port's prover with the JAX package's host path.

The same circuit is built with both packages' builders (equal circuit
digests), proved by the port on CPU tensors and by the reference with
use_device=False, and the serialized proofs must be byte-identical.  The
reference circuit is also carried into the port with
circuit_data_from_reference.  tests/test_torch_gates.py does the same for
one small circuit per gate type.
"""

import types

import numpy as np
import pytest
import torch

import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_torch.utils.serialization as t_ser
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.carry import circuit_data_from_reference
from zk_circuits_torch.plonk.prover import prove as t_prove
from zk_circuits_tpu.plonk.prover import prove as j_prove
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

TORCH = types.SimpleNamespace(B=t_builder.CircuitBuilder, W=t_witness.PartialWitness,
                              C=t_config.CircuitConfig)
JAX = types.SimpleNamespace(B=j_builder.CircuitBuilder, W=j_witness.PartialWitness,
                            C=j_config.CircuitConfig)

# One intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the machine.
torch.set_num_threads(1)


def square(b):
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    return [(x, 3)]


def _build(pkg, circuit, zk, **build_kw):
    cfg = pkg.C.standard_recursion_zk_config() if zk else pkg.C.standard_recursion_config()
    b = pkg.B(cfg)
    assignments = circuit(b)
    data = b.build(**build_kw)
    return data, assignments


def _witness(pkg, assignments):
    pw = pkg.W()
    for t, v in assignments:
        pw.set_target(t, int(v))
    return pw


def _reference(circuit, zk):
    data, assignments = _build(JAX, circuit, zk)
    proof = j_prove(data, _witness(JAX, assignments), use_device=False)
    return data, assignments, j_bytes(proof)


@pytest.mark.parametrize("zk", [False, True], ids=["standard", "zk"])
def test_square_circuit_matches_reference_bytes(zk):
    ref_data, assignments, ref_bytes = _reference(square, zk)
    data, t_assign = _build(TORCH, square, zk, device="cpu")
    # (a) the port's builder gives the reference's circuit
    assert np.array_equal(data.common.circuit_digest, ref_data.common.circuit_digest)
    assert np.array_equal(data.verifier_only.constants_sigmas_cap,
                          ref_data.verifier_only.constants_sigmas_cap)
    # (b) byte-identical proofs on the port-built circuit ...
    proof = t_prove(data, _witness(TORCH, t_assign), device="cpu")
    assert t_ser.proof_to_bytes(proof) == ref_bytes
    data.verify(proof)
    # ... and on the reference circuit carried across
    carried = circuit_data_from_reference(ref_data, device="cpu")
    proof2 = carried.prove(_witness(TORCH, assignments), device="cpu")
    assert t_ser.proof_to_bytes(proof2) == ref_bytes

    # negative probes: a tampered wires cap, overwritten public inputs.
    # The cap's first byte follows the magic, the version, the public
    # inputs and the cap's length, so the bytes still parse.
    raw = bytearray(ref_bytes)
    raw[16 + 8 * len(proof.public_inputs)] ^= 0x01
    with pytest.raises(ValueError, match="vanishing identity failed"):
        data.verify(t_ser.proof_from_bytes(bytes(raw), data.common))
    proof.public_inputs = np.array(proof.public_inputs, dtype=np.uint64)
    proof.public_inputs[0] = np.uint64(10)
    with pytest.raises(ValueError):
        data.verify(proof)


def test_prove_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error path is moot")
    data, assignments = _build(TORCH, square, False, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_prove(data, _witness(TORCH, assignments))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data.prove(_witness(TORCH, assignments))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build(TORCH, square, False)
    # the commit oracle, the mesh and the sharded prover default to the card
    from zk_circuits_torch.fri.oracle import PolynomialBatch
    from zk_circuits_torch.parallel.mesh import make_mesh
    from zk_circuits_torch.plonk.prover_sharded import prove_sharded

    coeffs = np.arange(64, dtype=np.uint64).reshape(2, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PolynomialBatch.from_coeffs(coeffs, 3, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PolynomialBatch.from_values(coeffs, 3, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prove_sharded(data, _witness(TORCH, assignments))
