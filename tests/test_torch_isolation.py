"""The port stands alone: importing it (and chip_smoke.py, and
scripts/torch_multihost_sim.py and torch_four_cards.py) loads neither
JAX nor the JAX package,
and its entry points never fall back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import zk_circuits_torch, chip_smoke
mods = [m.name for m in pkgutil.walk_packages(zk_circuits_torch.__path__,
                                              "zk_circuits_torch.")]
assert "zk_circuits_torch.compat.verifier" in mods, mods
for m in mods:
    importlib.import_module(m)
for script in ("scripts/torch_multihost_sim.py", "scripts/torch_four_cards.py"):
    spec = importlib.util.spec_from_file_location("script", script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "zk_circuits_tpu")))
print(len(mods), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 30   # every module of the port


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error path is moot")
    from zk_circuits_torch import resolve_device
    from zk_circuits_torch.api.prover import WormholeProver

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WormholeProver()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _square_bins(out_dir):
    """common.bin, verifier.bin and prover.bin of a one-gate circuit built
    on the CPU."""
    from zk_circuits_torch.api import artifacts
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.plonk.config import CircuitConfig

    b = CircuitBuilder(CircuitConfig.standard_recursion_config())
    b.register_public_input(b.square(b.add_virtual_target()))
    data = b.build(device="cpu")
    artifacts.write_circuit_binaries(out_dir, data, targets=None)
    (out_dir / "prover.bin").write_bytes(artifacts.prover_data_to_bytes(data, None))
    return data


def test_recursion_and_api_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """Aggregation, the level circuits, the artifact loaders, the example
    and the vote circuit's builder take ``device="cuda"`` by default and
    raise at once without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error path is moot")
    from zk_circuits_torch.aggregation import aggregator, tree
    from zk_circuits_torch.api import example
    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.api.verifier import WormholeVerifier
    from zk_circuits_torch.circuits.voting import VoteCircuitData, VoteTargets
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.plonk.config import CircuitConfig

    data = _square_bins(tmp_path)
    monkeypatch.setattr(aggregator, "_DUMMY_CACHE_DIR", tmp_path / "dummies")
    vote = CircuitBuilder(CircuitConfig.standard_recursion_config())
    VoteCircuitData.circuit(VoteTargets.new(vote), vote)
    calls = [
        lambda: tree.LevelCircuit(data.common, 2),
        lambda: tree.LevelCircuit.cached(data.common, 2),
        lambda: tree.aggregate_to_tree([None, None], data.common, data.verifier_only,
                                       tree.TreeAggregationConfig(2, 1)),
        lambda: aggregator.WormholeProofAggregator(data.common, data.verifier_only),
        lambda: aggregator.load_dummy_proof(zk=True),
        lambda: WormholeProver.new_from_files(tmp_path / "prover.bin", tmp_path / "common.bin"),
        lambda: WormholeVerifier(),
        lambda: example.main(str(tmp_path / "proof.hex")),
        lambda: vote.build(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "proof.hex").exists()
    # the verifier's loader needs no device
    WormholeVerifier.new_from_files(tmp_path / "verifier.bin", tmp_path / "common.bin")
