"""A short run of the benchmark's cell on the card (skipped without one):
the port's proofs of a window equal the plain reference's."""

from __future__ import annotations

import pytest

from .conftest import ROOT, result_line, run_bench

pytestmark = pytest.mark.cuda


def test_the_batch_cell_runs_correct_on_the_card(card):
    line = result_line(run_bench(ROOT, "--workload", "wormhole-b16", "--seed", str(2**31 + 99),
                                 "--seconds", "2", "--trace", "1"))
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < line["metrics"]["hash_roofline.b16"]["value"] < 100
