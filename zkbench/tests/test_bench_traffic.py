"""The traffic: the same for a seed, different across seeds, and every
withdrawal of a pool and of a call distinct."""

from __future__ import annotations

import numpy as np

from zkbench.harness import spec

WORMHOLE = spec.load_module("circuits", "wormhole")
CONFIG = spec.load_json(spec.ROOT / "zkbench/configs/wormhole-zk.json")


def _pool(seed, n=64):
    return WORMHOLE.withdrawals(CONFIG, np.random.default_rng([seed, 0]), n)


def test_the_same_seed_gives_the_same_withdrawals():
    assert _pool(2**31 + 11) == _pool(2**31 + 11)


def test_seeds_differ_and_every_withdrawal_is_distinct():
    a, b = _pool(7), _pool(2**31 + 9)
    assert len({w["exit_account"] for w in a}) == 64
    assert {w["exit_account"] for w in a}.isdisjoint({w["exit_account"] for w in b})
    p = (1 << 64) - (1 << 32) + 1
    for w in a:   # each 8-byte limb a field element, as the circuit's digest wants
        assert all(int.from_bytes(w["exit_account"][i:i + 8], "little") < p
                   for i in range(0, 32, 8))


def test_calls_draw_distinct_members_in_seeded_order(monkeypatch):
    cell = spec.find_cell(spec.load_spec(), "wormhole-b16")
    driver_mod = spec.load_module("traffic", cell.mix["driver"])

    def calls(seed):
        d = driver_mod.Driver(cell, seed, None, spec.BENCH_DIR / "_cache")
        d.pws = list(range(d.pool_size))
        return [tuple(d._draw(d._order)[0]) for _ in range(5)]

    a = calls(2**31 + 5)
    assert a == calls(2**31 + 5) and a != calls(12)
    assert all(len(set(c)) == cell.mix["batch"] for c in a)
