"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's file is the ``file`` of its entry in
``configs``, the traffic mix is ``zkbench/workloads/<traffic>.json``, its
driver ``zkbench/traffic/<driver>.py``, a circuit ``zkbench/circuits/
<circuit>.py`` and a per-layer metric's reader ``zkbench/metrics/<metric>.py``.
Adding a cell, a configuration or a metric adds files and entries; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

@dataclass
class Cell:
    """One cell as the run needs it: its entries and files."""

    name: str
    entry: dict            # the cell's entry in ``workloads``
    config_entry: dict     # its configuration's entry in ``configs``
    config: dict           # the configuration's file
    mix: dict              # the traffic mix's file
    end_to_end: list       # the end-to-end metric entries this cell reports
    per_layer: list        # the per-layer metric entries this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir.parent / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json beside {bench_dir}")
    return load_json(path)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(spec: dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell called ``name`` with its configuration, traffic mix and
    metrics; KeyError where a name is unknown."""
    entry = _by_name(spec["workloads"], name, "cell")
    config_entry = _by_name(spec["configs"], entry["config"], "configuration")
    config = load_json(bench_dir.parent / config_entry["file"])
    mix = load_json(bench_dir / "workloads" / f"{entry['traffic']}.json")
    return Cell(name, entry, config_entry, config, mix,
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """``zkbench/<kind>/<name>.py`` as a module (names may hold dots and
    dashes, so it is loaded by path)."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {path.relative_to(bench_dir.parent)}")
    spec = importlib.util.spec_from_file_location(f"zkbench_{kind}_{_ident(name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ident(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)

