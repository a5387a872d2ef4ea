"""A whole run of a cell that exists only in this test's files (a copy of
zkbench/ with a configuration, a traffic mix and BENCHMARK.json entries
added), through the harness's dry path on the CPU: found by name, driven,
compared with the reference, and its line printed."""

from __future__ import annotations

from .conftest import SQUARE_CELL, result_line, run_bench

ARGS = ("--workload", SQUARE_CELL, "--seed", str(2**31 + 3), "--seconds", "1", "--dry", "1")


def test_a_cell_added_by_files_alone_runs_and_is_correct(bench_copy):
    proc = run_bench(bench_copy, *ARGS, "--trace", "0")
    line = result_line(proc)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"proofs_per_s", "proof_p95_s", "setup_s"}
    assert line["attempted"] % 4 == 0 and line["attempted"] >= 4
    assert list(line)[-1] == "checks"
    assert line["checks"]["sampled"]["value"] == 4
    assert proc.stderr.strip().splitlines()[-1].startswith("check failed: 0")


def test_a_trace_run_reports_what_its_readers_find(bench_copy):
    line = result_line(run_bench(bench_copy, *ARGS, "--trace", "1"))
    assert line["correct"] is True
    # the CPU has no device trace: those readers find nothing, and the
    # program's stage timers are read
    assert set(line["metrics"]) == {"openings_fri_ms.b16", "fri_host_ms.b16"}
    assert line["metrics"]["openings_fri_ms.b16"]["unit"] == "ms"


def test_without_a_card_the_run_exits_without_a_result(bench_copy):
    proc = run_bench(bench_copy, "--workload", SQUARE_CELL, "--seed", "1",
                     "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_the_run_exits_without_a_result(tmp_path, bench_copy):
    import shutil
    import subprocess
    import sys

    shutil.copytree(bench_copy / "zkbench", tmp_path / "zkbench")
    shutil.copy(bench_copy / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, str(tmp_path / "zkbench/run.py"), *ARGS],
                          capture_output=True, text=True, cwd=tmp_path, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
