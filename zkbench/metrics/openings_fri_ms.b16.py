"""openings_fri_ms.b16: the mean of the prover's ``batch/openings+fri``
stage timer per call of the window (the openings, FRI's commit phase, the
PoW grind and the query gather, with the host transcript between them)."""

from zkbench.harness import readers


def read(window):
    return readers.stage_mean_ms(window, "batch/openings+fri")
