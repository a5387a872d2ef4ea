"""A batch whose witnesses seed different sets of targets, against the JAX
package, byte for byte.

The square circuit with ``pa`` seeding x = 7 and ``pb`` seeding x = 5 and
x^2 = 25: the device witness takes one set of seeded targets a batch, so
``prove_batch`` proves each set as a batch of its own and returns the
proofs in the order of the witnesses.  The JAX package's host path proves
the same batch; every proof must equal its bytes.  The FRI config is
narrowed to few queries and PoW bits (the plain CPU sponge's grind is most
of a CPU proof at the standard configs' 16 bits).
"""

import dataclasses
import types

import pytest
import torch

import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.iop import witness_device as wdev
from zk_circuits_torch.plonk.prover import prove_batch
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.plonk.prover import prove_batch as j_prove_batch
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

TORCH = types.SimpleNamespace(B=t_builder, W=t_witness, C=t_config)
JAX = types.SimpleNamespace(B=j_builder, W=j_witness, C=j_config)
FRI = dict(num_query_rounds=2, proof_of_work_bits=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _square(pkg, **build_kw):
    """The circuit and its two witnesses: "a" seeds x = 7, "b" seeds x = 5
    and x^2 = 25."""
    cfg = dataclasses.replace(pkg.C.CircuitConfig.standard_recursion_config(),
                              fri_config=pkg.C.FriConfig(**FRI))
    b = pkg.B.CircuitBuilder(cfg)
    x = b.add_virtual_target()
    y = b.square(x)
    b.register_public_input(y)
    data = b.build(**build_kw)
    pa = pkg.W.PartialWitness()
    pa.set_target(x, 7)
    pb = pkg.W.PartialWitness()
    pb.set_target(x, 5)
    pb.set_target(y, 25)
    return data, {"a": pa, "b": pb}


@pytest.fixture(scope="module")
def circuits():
    return _square(JAX), _square(TORCH, device="cpu")


@pytest.mark.parametrize("order", ["ab", "bab"])
def test_prove_batch_of_mixed_seed_sets_matches_reference(circuits, order):
    (j_data, j_pws), (data, pws) = circuits
    want = [j_bytes(p) for p in j_prove_batch(j_data, [j_pws[k] for k in order],
                                              use_device=False)]
    batch = [pws[k] for k in order]
    assert len(wdev.seed_groups(data, batch)) == 2
    proofs = prove_batch(data, batch, device="cpu")
    assert [t_bytes(p) for p in proofs] == want
    assert [int(p.public_inputs[0]) for p in proofs] == [{"a": 49, "b": 25}[k] for k in order]
    data.verify(proofs[-1])
