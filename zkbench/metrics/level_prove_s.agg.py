"""level_prove_s.agg: the port's ``agg/level_prove`` timer (a level's
witnesses and its batched prove) summed over the window, per
aggregation."""


def read(window):
    vals = window.timings.get("agg/level_prove")
    return sum(vals) / window.given if vals and window.given else None
