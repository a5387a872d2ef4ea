"""The port's utils/profiling.py against the JAX package's.

``dump_timings`` writes the JAX version's JSON (per stage: total_s,
count, mean_s); ``device_trace`` writes a torch.profiler Chrome trace
under ``$ZKT_PROFILE_DIR/<label>`` and is inert without it; a stage
timer's nesting depth is its own thread's (a caller may prove on several
threads at once).
"""

import json
import threading

import torch

from zk_circuits_torch.utils import profiling as tprof
from zk_circuits_tpu.utils import profiling as jprof


def _stages(mod):
    mod.reset_timings()
    with mod.stage_timer("batch/wires"):
        with mod.stage_timer("fri/commit(batch)"):
            pass
    with mod.stage_timer("batch/wires"):
        pass


def test_dump_timings_matches_jax(tmp_path):
    for mod, name in ((tprof, "torch.json"), (jprof, "jax.json")):
        _stages(mod)
        mod.dump_timings(str(tmp_path / name))
    got = json.loads((tmp_path / "torch.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert sorted(got) == sorted(want) == ["batch/wires", "fri/commit(batch)"]
    for stage in want:
        assert sorted(got[stage]) == sorted(want[stage]) == ["count", "mean_s", "total_s"]
        assert got[stage]["count"] == want[stage]["count"]
    assert got["batch/wires"]["count"] == 2
    tprof.reset_timings()
    jprof.reset_timings()


def test_device_trace_writes_under_the_profile_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("ZKT_PROFILE_DIR", raising=False)
    with tprof.device_trace("inert") as prof:
        torch.ones(4).sum()
    assert prof is None and not any(tmp_path.iterdir())
    monkeypatch.setenv("ZKT_PROFILE_DIR", str(tmp_path))
    with tprof.device_trace("prove") as prof:
        (torch.arange(64) * 3).sum()
    assert prof is not None
    traces = list((tmp_path / "prove").glob("trace.*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_stage_timer_depth_is_per_thread(monkeypatch, capsys):
    """Two threads each inside two nested stages at once print their
    inner stage at depth 1 (a depth shared by threads would reach 3)."""
    monkeypatch.setenv("ZKT_TIMING", "1")
    inside = threading.Barrier(2, timeout=30)

    def nested(tag):
        with tprof.stage_timer(f"{tag}/outer"):
            with tprof.stage_timer(f"{tag}/inner"):
                inside.wait()
                inside.wait()

    threads = [threading.Thread(target=nested, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    lines = capsys.readouterr().out.splitlines()
    for tag in ("a", "b"):
        assert any(ln.startswith(f"[timing]   {tag}/inner:") for ln in lines), lines
        assert any(ln.startswith(f"[timing] {tag}/outer:") for ln in lines), lines
    tprof.reset_timings()
