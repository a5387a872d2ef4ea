"""BENCHMARK.json against the contract's limits, and every name it gives
found as a file."""

from __future__ import annotations

import json
import re

from zkbench.harness import spec

from .conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_names(bench: dict) -> list:
    """Every name, unit and key of ``reduced`` against the allowed
    characters; returns the faults found."""
    faults = []
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    faults += [f"name {n!r}" for n in names if not NAME_RE.match(n)]
    faults += [f"unit {m['unit']!r}" for key in ("end_to_end", "per_layer")
               for m in bench[key] if not UNIT_RE.match(m["unit"])]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in bench[key]]
        faults += [f"{key}: {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    return faults


def test_keys_and_names_are_within_the_allowed_characters():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert check_names(SPEC) == []
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    texts = [c["why"] for c in SPEC["configs"] + SPEC["workloads"]] + [
        c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_run_seconds_fits_the_full_check_of_24_cells():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_and_paths():
    assert SPEC["command"] == ["python3", "zkbench/run.py"]
    assert SPEC["paths"] == ["zkbench"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        cell = spec.find_cell(SPEC, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_cells_configs_and_metrics_are_found_by_name():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = spec.find_cell(SPEC, w["name"])
        assert cell.config_entry["file"].startswith("zkbench/")
        assert (BENCH / "circuits" / f"{cell.config['circuit']}.py").is_file()
        assert callable(spec.load_module("traffic", cell.mix["driver"]).Driver)
        assert w["chips"] == 1
    for m in SPEC["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)
        assert len({x["layer"] for x in SPEC["per_layer"] if x["name"] == m["name"]}) == 1


def test_an_unknown_name_is_refused():
    import pytest

    with pytest.raises(KeyError):
        spec.find_cell(SPEC, "no-such-cell")
    with pytest.raises(KeyError):
        spec.load_module("metrics", "no_such_metric")
