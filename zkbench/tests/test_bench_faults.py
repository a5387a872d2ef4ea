"""The comparison catches a broken timed path: the rest of a run is driven
(the dry path skips the look for a chip) with the program's prove_batch
broken underneath, and ``correct`` comes out false.  And the control,
the plain reference without the configuration's zero knowledge put in
the program's place, comes out not correct."""

from __future__ import annotations

import json

import pytest

from .conftest import SQUARE_CELL, result_line, run_bench

ARGS = ["--workload", SQUARE_CELL, "--seed", str(2**31 + 21), "--seconds", "1",
        "--trace", "0", "--dry", "1"]


def _run_broken(bench_copy, monkeypatch, capsys, fault):
    import sys

    from zk_circuits_torch.plonk import prover

    real = prover.prove_batch
    monkeypatch.setattr(prover, "prove_batch", lambda *a, **k: fault(real(*a, **k)))
    monkeypatch.syspath_prepend(str(bench_copy))
    for name in [m for m in sys.modules if m == "zkbench" or m.startswith("zkbench.")]:
        monkeypatch.delitem(sys.modules, name)
    from zkbench import run

    assert run.main(ARGS) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _alter_one_word(proofs):
    cap = proofs[-1].proof.wires_cap
    cap[0, 0] = (int(cap[0, 0]) + 1) % ((1 << 64) - (1 << 32) + 1)
    return proofs


def _alter_the_pow_witness(proofs):
    proofs[0].proof.opening_proof.pow_witness += 1
    return proofs


def _half_the_batch(proofs):
    return proofs[: len(proofs) // 2]


@pytest.mark.parametrize("fault,layer", [(_alter_one_word, "wires_cap_differ"),
                                         (_alter_the_pow_witness, "pow_witness_differ"),
                                         (_half_the_batch, "failed")])
def test_a_broken_timed_path_is_not_correct(bench_copy, monkeypatch, capsys, fault, layer):
    line = _run_broken(bench_copy, monkeypatch, capsys, fault)
    assert line["correct"] is False
    assert line["checks"][layer]["value"] > 0


def test_the_unbroken_path_is_correct_in_process(bench_copy, monkeypatch, capsys):
    assert _run_broken(bench_copy, monkeypatch, capsys, lambda p: p)["correct"] is True


def test_the_control_is_not_correct(bench_copy):
    line = result_line(run_bench(bench_copy, *ARGS, script="control.py"))
    assert line["correct"] is False
    # without salts every commit differs; the PoW witness may agree by chance
    assert line["checks"]["wires_cap_differ"]["value"] == 4
    assert line["checks"]["query_paths_differ"]["value"] == 4
