"""One small circuit per gate type of iop/gates.py (constant, arithmetic,
base-sum, arithmetic-extension, random-access, Poseidon), proved by the
port on CPU tensors and by the JAX package's host path: equal circuit
digests and byte-identical proofs hold each gate's torch ``eval_device``
rewrite to the reference.
"""

import numpy as np
import pytest
import torch

import zk_circuits_torch.utils.serialization as t_ser
from test_torch_prover import TORCH, _build, _reference, _witness
from zk_circuits_torch.plonk.prover import prove as t_prove

P = 2**64 - 2**32 + 1

# One intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the machine.
torch.set_num_threads(1)


def constant_gate(b):
    x = b.add_virtual_target()
    b.connect(x, b.constant(424242))
    b.register_public_input(x)
    return [(x, 424242)]


def arithmetic_gate(b):
    xs = b.add_virtual_targets(3)
    acc = b.mul_add(xs[0], xs[1], xs[2])
    for i in range(25):
        acc = b.arithmetic(3 + i, 5, acc, xs[i % 3], xs[(i + 1) % 3])
    b.register_public_input(acc)
    return list(zip(xs, [7, P - 2, 2**40 + 1]))


def base_sum_gate(b):
    x = b.add_virtual_target()
    bits = b.split_le(x, 32)
    b.range_check(b.add(x, b.one()), 40)
    b.register_public_input(bits[3].target)
    return [(x, 0xDEADBEEF)]


def arithmetic_extension_gate(b):
    m0, m1, ad = ((b.add_virtual_target(), b.add_virtual_target()) for _ in range(3))
    out = b.arithmetic_extension(3, 5, m0, m1, ad)
    out2 = b.arithmetic_extension(1, 1, out, m1, m0)
    b.register_public_inputs(list(out2))
    return list(zip(m0 + m1 + ad, [11, 12, P - 13, 14, 2**50, 16]))


def random_access_gate(b):
    vals = b.add_virtual_targets(16)
    idx = b.add_virtual_target()
    b.register_public_input(b.random_access(idx, vals))
    return list(zip(vals, [(i * 0x9E3779B97F4A7C15) % P for i in range(16)])) + [(idx, 11)]


def poseidon_gate(b):
    state = b.add_virtual_targets(12)
    out = b.permute_poseidon(state)
    b.register_public_inputs(out[:4])
    return list(zip(state, [(i * 0x1234567 + 1) % P for i in range(12)]))



@pytest.mark.parametrize("circuit", [constant_gate, arithmetic_gate, base_sum_gate,
                                     arithmetic_extension_gate, random_access_gate,
                                     poseidon_gate], ids=lambda f: f.__name__)
def test_gate_circuit_matches_reference_bytes(circuit):
    ref_data, assignments, ref_bytes = _reference(circuit, zk=False)
    data, t_assign = _build(TORCH, circuit, False, device="cpu")
    assert np.array_equal(data.common.circuit_digest, ref_data.common.circuit_digest)
    gate_ids = {g.id for g in data.common.gate_types}
    assert gate_ids == {g.id for g in ref_data.common.gate_types}
    proof = t_prove(data, _witness(TORCH, t_assign), check_witness=True, device="cpu")
    # byte equality with the reference proof is the check; the verifier (a
    # copy of the reference's) is held to it in tests/test_torch_prover.py
    assert t_ser.proof_to_bytes(proof) == ref_bytes
