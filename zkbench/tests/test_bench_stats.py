"""The window's arithmetic."""

from __future__ import annotations

import pytest

from zkbench.harness import stats


def test_rate_is_over_the_whole_window():
    assert stats.rate(160, 32.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_tail_is_over_every_answer():
    # 16 answers a call share the call's time: 19 calls of 1 s, one of 9 s
    lat = [1.0] * (16 * 19) + [9.0] * 16
    assert stats.percentile(lat, 95) == 1.0          # 304 of 320 answers <= 1 s
    assert stats.percentile(lat + [9.0], 95) == 9.0
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert stats.percentile(list(range(1, 101)), 95) == 95


def test_busy_time_is_the_union_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == 3.0
    assert stats.union_length(iv, lo=0.5, hi=3.5) == 2.0


def test_idle_share_of_a_traced_window():
    from zkbench.harness.trace import DeviceWindow

    dw = DeviceWindow([("void k1_leaf_kernel<1>(K1Call)", 0.0, 1.0),
                       ("k5_gate_kernel", 0.5, 2.0), ("Memcpy DtoH", 3.0, 4.0)], 5.0)
    assert dw.busy_s == 3.0
    assert dw.seconds_of(("k1_",)) == 1.0
    bd = dw.breakdown("prove_batch")
    assert bd["device_ops"][0] == ["k5_gate_kernel", 1.5]
    assert bd["idle_gaps"] == [["prove_batch: k5_gate_kernel -> Memcpy DtoH", 1.0]]
