"""What the per-layer metrics' readers (zkbench/metrics/<name>.py) share.
A reader that finds nothing to read returns None, and the run leaves its
metric out."""

from __future__ import annotations

from zkbench.yardstick import hash_work


def stage_mean_ms(window, name: str):
    """The mean of a stage timer over the window, in milliseconds."""
    vals = window.timings.get(name)
    return 1e3 * sum(vals) / len(vals) if vals else None



def host_less_children_ms(window, parent: str, children: str):
    """A stage's time less the time of the stages named ``children`` (a
    prefix and a suffix, ``(prefix, suffix)``) inside it, per call of the
    stage, in milliseconds."""
    outer = window.timings.get(parent)
    if not outer:
        return None
    prefix, suffix = children
    inner = sum(sum(v) for k, v in window.timings.items()
                if k.startswith(prefix) and k.endswith(suffix))
    return 1e3 * (sum(outer) - inner) / len(outer)


def device_ms_per_answer(window):
    if window.device is None or not window.given:
        return None
    return 1e3 * window.device.busy_s / window.given


def device_idle_pct(window):
    if window.device is None or window.seconds <= 0:
        return None
    return 100.0 * (1.0 - window.device.busy_s / window.seconds)


def hash_roofline_pct(window, kernels: tuple, proofs: list):
    """The least time for the Poseidon work of ``proofs`` (a list of
    (shape proof, PoW witnesses, degree bits) per circuit: every proof of a circuit has
    its trees), over the device time of the kernels whose names start with
    one of ``kernels``, in percent."""
    if window.device is None:
        return None
    k_s = window.device.seconds_of(kernels)
    if k_s <= 0:
        return None
    fri = window.driver.cell.config["config"]["fri"]
    perms = nbytes = 0
    for shape_proof, witnesses, bits in proofs:
        trees = hash_work.proof_trees(shape_proof, bits, fri["rate_bits"])
        for rows, cols in trees:
            p, b = hash_work.tree_work(rows, cols, fri["cap_height"])
            perms, nbytes = perms + p * len(witnesses), nbytes + b * len(witnesses)
        for w in witnesses:
            p, b = hash_work.pow_work(w)
            perms, nbytes = perms + p, nbytes + b
    return 100.0 * hash_work.bound_s(perms, nbytes)[0] / k_s
