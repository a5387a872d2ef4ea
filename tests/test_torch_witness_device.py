"""The port's device witness against the JAX package, integer for integer.

``generate_witness_device`` on CPU tensors (the plain version of K3,
``witness_plain``) must give the wire matrix and public inputs of the JAX
package's device witness (its XLA program, compiled for the CPU at these
small sizes, as tests/test_witness_device.py runs it) and of both host
witnesses: on a circuit of every generator kind at several seed sets, on
a deep arith_ext/Poseidon chain, for a batch of distinct witnesses, and
on the full-width zk wormhole, whose port-built circuit must equal the
JAX package's.  The prover takes this witness unless ``check_witness``
is on.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.iop import witness_device as wdev
from zk_circuits_torch.plonk import prover_batch
from zk_circuits_torch.plonk.prover import prove_batch
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.iop import witness_device as j_wdev
from zk_circuits_tpu.plonk.prover import prove as j_prove
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

TORCH = types.SimpleNamespace(B=t_builder, W=t_witness, C=t_config)
JAX = types.SimpleNamespace(B=j_builder, W=j_witness, C=j_config)
CHAIN_SEEDS = ((12345, 67890), (0, chip_smoke.P - 1))

torch.set_num_threads(1)


def _build(pkg, circuit, config=None, **build_kw):
    b = pkg.B.CircuitBuilder(config or pkg.C.CircuitConfig.standard_recursion_config())
    targets = (circuit(b, pkg.B.GeneratorOp) if circuit is chip_smoke.kinds_circuit
               else circuit(b))
    return b.build(**build_kw), targets


@pytest.fixture(scope="module")
def circuits():
    """Each small circuit built by both packages: (port data, port
    targets, JAX data, JAX targets)."""
    out = {}
    for name, circuit in (("kinds", chip_smoke.kinds_circuit), ("chain", chip_smoke.chain_circuit)):
        data, targets = _build(TORCH, circuit, device="cpu")
        j_data, j_targets = _build(JAX, circuit)
        assert np.array_equal(data.common.circuit_digest, j_data.common.circuit_digest)
        out[name] = (data, targets, j_data, j_targets)
    return out


def _check_against_jax(circuits, name, values):
    data, targets, j_data, j_targets = circuits[name]
    assert wdev.supported(data) and j_wdev.supported(j_data)
    wires, pis = wdev.generate_witness_device(data, chip_smoke.seed(TORCH.W.PartialWitness,
                                                                    targets, values), "cpu")
    wires, pis = wires.numpy().view(np.uint64), np.asarray(pis)
    j_pw = chip_smoke.seed(JAX.W.PartialWitness, j_targets, values)
    j_wires, j_pis = j_wdev.generate_witness_device(j_data, j_pw)
    h_wires, h_pis = JAX.W.generate_witness(j_data, j_pw)
    t_wires, t_pis = TORCH.W.generate_witness(
        data, chip_smoke.seed(TORCH.W.PartialWitness, targets, values))
    for want_w, want_p in ((jgf.to_u64(j_wires), j_pis), (h_wires, h_pis), (t_wires, t_pis)):
        assert np.array_equal(wires, want_w.T)
        assert np.array_equal(pis, want_p)
    return wires, pis


@pytest.mark.parametrize("values", chip_smoke.KINDS_SEEDS)
def test_every_kind_matches_jax_device_and_host(circuits, values):
    kinds = {b.kind for b in circuits["kinds"][0].prover_only.schedule}
    assert kinds == set(wdev.KINDS), kinds
    _check_against_jax(circuits, "kinds", values)


@pytest.mark.parametrize("values", CHAIN_SEEDS)
def test_deep_chain_matches_jax_device_and_host(circuits, values):
    levels = [b.kind for b in circuits["chain"][0].prover_only.schedule]
    assert levels.count("poseidon") >= 5 and levels.count("arith_ext") >= 13, levels
    _check_against_jax(circuits, "chain", values)


def test_batch_of_distinct_witnesses(circuits):
    data, targets, _, _ = circuits["kinds"]
    singles = [_check_against_jax(circuits, "kinds", v) for v in chip_smoke.KINDS_SEEDS]
    wires, pis = wdev.generate_witnesses_device(
        data, [chip_smoke.seed(TORCH.W.PartialWitness, targets, v)
               for v in chip_smoke.KINDS_SEEDS], "cpu")
    assert wires.shape == (3, data.common.config.num_wires, data.common.degree)
    for b, (w, p) in enumerate(singles):
        assert np.array_equal(wires[b].numpy().view(np.uint64), w)
        assert np.array_equal(pis[b].numpy().view(np.uint64), p)
    assert len({w.tobytes() for w, _ in singles}) == 3


def test_seed_batch_refuses_foreign_targets_and_differing_sets(circuits):
    for pkg, seed_batch, (data, targets) in (
            (TORCH, wdev.seed_batch, circuits["kinds"][:2]),
            (JAX, j_wdev.seed_batch, circuits["kinds"][2:])):
        values = chip_smoke.KINDS_SEEDS[0]
        pw = chip_smoke.seed(pkg.W.PartialWitness, targets, values)
        reps, seeds = seed_batch(data, [pw, pw])
        assert list(reps) == sorted(reps) and seeds.shape == (2, len(values))
        other = chip_smoke.seed(pkg.W.PartialWitness, targets[:-1], values[:-1])
        with pytest.raises(ValueError, match="different target sets"):
            seed_batch(data, [pw, other])
        foreign = chip_smoke.seed(pkg.W.PartialWitness, targets, values)
        foreign.set_target(10**9, 1)
        with pytest.raises(KeyError, match="not part of the circuit"):
            seed_batch(data, [foreign])


FRI_ROUNDS = dict(proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2,
                  final_poly_bits=1)


def test_prove_takes_the_device_witness_unless_checking(monkeypatch):
    """prove_batch on the CPU makes its witnesses with the plain version of
    K3 (the host witness never runs) and its proofs equal the JAX host
    path's; with check_witness the host witness runs, a proof at a time."""
    def config(pkg):
        return pkg.C.CircuitConfig(zero_knowledge=True, fri_config=pkg.C.FriConfig(**FRI_ROUNDS))

    values = chip_smoke.KINDS_SEEDS[:2]
    j_data, j_targets = _build(JAX, chip_smoke.kinds_circuit, config(JAX))
    want = [j_bytes(j_prove(j_data, chip_smoke.seed(JAX.W.PartialWitness, j_targets, v),
                            use_device=False)) for v in values]
    data, targets = _build(TORCH, chip_smoke.kinds_circuit, config(TORCH), device="cpu")
    host_calls = []

    def host_witness(*args):
        host_calls.append(args)
        return TORCH.W.generate_witness(*args)

    monkeypatch.setattr(prover_batch, "generate_witness", host_witness)
    for check in (False, True):
        pws = [chip_smoke.seed(TORCH.W.PartialWitness, targets, v) for v in values]
        assert [t_bytes(p) for p in prove_batch(data, pws, check_witness=check,
                                                device="cpu")] == want
        assert len(host_calls) == (len(values) if check else 0), check
    assert "cpu" in data.prover_only.witness_tables


def test_wormhole_circuit_and_witness_match_jax():
    """The full-width zk wormhole: the port-built circuit (its modules run
    nowhere else on the CPU) equals the JAX package's, and the plain
    device witness of the golden inputs equals the JAX host witness."""
    from zk_circuits_torch.api.prover import WormholeProver as TProver
    from zk_circuits_torch.circuits.wormhole import golden_fixtures as t_golden
    from zk_circuits_tpu.api.prover import WormholeProver as JProver
    from zk_circuits_tpu.circuits.wormhole import golden_fixtures as j_golden

    j_prover = JProver(JAX.C.CircuitConfig.standard_recursion_zk_config())
    j_data = j_prover.circuit_data
    j_wires, j_pis = JAX.W.generate_witness(
        j_data, j_prover.commit(j_golden.test_inputs()).partial_witness)
    prover = TProver(TORCH.C.CircuitConfig.standard_recursion_zk_config(), device="cpu")
    data = prover.circuit_data
    assert np.array_equal(data.common.circuit_digest, j_data.common.circuit_digest)
    assert np.array_equal(data.verifier_only.constants_sigmas_cap,
                          j_data.verifier_only.constants_sigmas_cap)
    wires, pis = wdev.generate_witness_device(
        data, prover.commit(t_golden.test_inputs()).partial_witness, "cpu")
    assert wires.shape == (135, 1 << 13)
    assert np.array_equal(wires.numpy().view(np.uint64), j_wires.T)
    assert np.array_equal(pis, j_pis)
