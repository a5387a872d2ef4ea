"""fri_host_ms.b16: ``batch/openings+fri`` less the ``fri/*(batch)`` stage
timers inside it, per call: the host transcript and the helpers between
FRI's fetches."""

from zkbench.harness import readers


def read(window):
    return readers.host_less_children_ms(window, "batch/openings+fri", ("fri/", "(batch)"))
