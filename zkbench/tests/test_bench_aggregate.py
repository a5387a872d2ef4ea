"""The aggregation driver (zkbench/traffic/aggregate.py) through the dry
path, on a test-only tree of one level circuit: the program's roots,
leaves and extracted public inputs equal the plain reference's, and the
aggregation metrics are read.  No cell of BENCHMARK.json runs it yet
(PERF.md, Open questions)."""

from __future__ import annotations

from .conftest import SQUARE_AGG_CELL, result_line, run_bench


def test_an_aggregation_cell_runs_and_is_correct(bench_copy):
    line = result_line(run_bench(bench_copy, "--workload", SQUARE_AGG_CELL, "--seed",
                                 str(2**31 + 7), "--seconds", "1", "--trace", "1",
                                 "--dry", "1"))
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"level_prove_s.agg", "agg_host_s.agg"}
    checks = line["checks"]
    assert checks["sampled"]["value"] == 1
    assert checks["leaves_differ"]["value"] == 0 and checks["leaf_inputs_differ"]["value"] == 0
