"""The window's arithmetic: rates and times over the whole window, a tail
over every answer, and the device's busy time as the union of its
intervals."""

from __future__ import annotations

import math


def rate(count: int, window_s: float) -> float:
    """Answers completed in the window over the window's seconds."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return count / window_s


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-th percentile of every value: the smallest value
    that at least q% of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)) - 1, 0)]


def union_length(intervals, lo: float | None = None, hi: float | None = None) -> float:
    """The length of the union of (start, end) intervals, each clipped to
    [lo, hi] where those are given: time in which at least one of them ran."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
