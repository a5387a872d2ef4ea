"""agg_host_s.agg: an aggregation's time less its level proves (the
aggregator's buffer, the chunk witnesses' padding and the tree's
bookkeeping), per aggregation of the window."""


def read(window):
    vals = window.timings.get("agg/level_prove")
    if not vals or not window.given:
        return None
    return (sum(c.seconds for c in window.calls if c.given) - sum(vals)) / window.given
