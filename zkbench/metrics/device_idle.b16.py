"""device_idle.b16: the share of the traced window in which no operation
ran on the card (1 less the union of the device's intervals over the
window), in percent."""

from zkbench.harness import readers


def read(window):
    return readers.device_idle_pct(window)
