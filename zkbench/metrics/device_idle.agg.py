"""device_idle.agg: the share of the traced window in which no operation
ran on the card, in percent."""

from zkbench.harness import readers


def read(window):
    return readers.device_idle_pct(window)
