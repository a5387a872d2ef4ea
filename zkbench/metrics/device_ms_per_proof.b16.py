"""device_ms_per_proof.b16: the seconds in which some operation (a kernel,
a copy or a set) ran on the card over the traced window, per proof, in
milliseconds."""

from zkbench.harness import readers


def read(window):
    return readers.device_ms_per_answer(window)
