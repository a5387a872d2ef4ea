"""Fixtures of the benchmark's own tests: a copy of zkbench/ in a temporary
directory with a test-only cell added by new files and entries alone, and
the card, for the tests marked ``cuda``."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# A chain of squarings of a few rows, under the wormhole's configuration
# but with 4 PoW bits: a whole run of it fits into a test on the CPU.
SQUARE_CONFIG = {
    "circuit": "square_chain", "squarings": 40,
    "config": {"num_wires": 135, "num_routed_wires": 80, "num_constants": 2,
               "use_base_arithmetic_gate": True, "security_bits": 100, "num_challenges": 2,
               "zero_knowledge": True, "max_quotient_degree_factor": 8,
               "fri": {"rate_bits": 3, "cap_height": 4, "proof_of_work_bits": 4,
                       "reduction_arity_bits": 4, "final_poly_bits": 5,
                       "num_query_rounds": 28}}}
SQUARE_MIX = {"driver": "prove_batch", "batch": 4, "pool": 8, "warm_calls": 1}
SQUARE_CELL = "square-b4"
# Its tree of b=2, d=1 (one level circuit) under 4 FRI queries: the
# aggregation driver's run on the CPU.
SQUARE_AGG_CELL = "square-agg"
SQUARE_AGG_MIX = {"driver": "aggregate", "leaves": 2, "pool": 4, "leaf_batch": 4,
                  "warm_calls": 1}
AGG_METRICS = [("aggregate_s", "s", "lower", "host_clock", None),
               ("level_prove_s.agg", "s", "lower", "program_span", "aggregation"),
               ("agg_host_s.agg", "s", "lower", "program_span", "aggregation"),
               ("device_idle.agg", "%", "lower", "device_trace", "device"),
               ("hash_roofline.agg", "%", "higher", "device_trace", "kernels")]


def add_square_cell(root: Path) -> None:
    """Add the test-only cell ``square-b4`` to the benchmark under ``root``:
    a configuration file, a traffic mix and entries in BENCHMARK.json, and
    nothing else."""
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["configs"].append({"name": "square", "source": "https://example.org/square",
                            "file": "zkbench/configs/square.json", "reduced": [],
                            "why": "a test-only circuit"})
    spec["workloads"].append({"name": SQUARE_CELL, "config": "square",
                              "traffic": SQUARE_CELL, "chips": 1, "why": "test only"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "wormhole-b16" in m.get("workloads", []):
            m["workloads"].append(SQUARE_CELL)
    # the aggregation cell, with the metrics of the aggregation driver
    spec["configs"].append({"name": "square-agg", "source": "https://example.org/square",
                            "file": "zkbench/configs/square-agg.json", "reduced": [],
                            "why": "a test-only tree"})
    spec["workloads"].append({"name": SQUARE_AGG_CELL, "config": "square-agg",
                              "traffic": SQUARE_AGG_CELL, "chips": 1, "why": "test only"})
    for name, unit, better, source, layer in AGG_METRICS:
        m = {"name": name, "unit": unit, "better": better, "source": source,
             "workloads": [SQUARE_AGG_CELL]}
        if layer is None:
            spec["end_to_end"].append(dict(m, bound=0.25))
        else:
            spec["per_layer"].append(dict(m, layer=layer, moves="aggregate_s"))
    path.write_text(json.dumps(spec, indent=1))
    (root / "zkbench/configs/square.json").write_text(json.dumps(SQUARE_CONFIG))
    (root / f"zkbench/workloads/{SQUARE_CELL}.json").write_text(json.dumps(SQUARE_MIX))
    agg = dict(SQUARE_CONFIG, aggregation={"branching_factor": 2, "depth": 1})
    agg["config"] = dict(agg["config"], fri=dict(agg["config"]["fri"], num_query_rounds=4))
    (root / "zkbench/configs/square-agg.json").write_text(json.dumps(agg))
    (root / f"zkbench/workloads/{SQUARE_AGG_CELL}.json").write_text(json.dumps(SQUARE_AGG_MIX))


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory) -> Path:
    """BENCHMARK.json and zkbench/ copied into a temporary root, with the
    test-only cell added."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "zkbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    add_square_cell(root)
    return root


def run_bench(root: Path, *args: str, script: str = "run.py") -> subprocess.CompletedProcess:
    """zkbench/<script> of the copy under ``root`` in a process of its own,
    the program importable from this repository."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, str(root / "zkbench" / script), *args],
                          capture_output=True, text=True, env=env, cwd=root, timeout=600)


def result_line(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
