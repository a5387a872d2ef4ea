"""Device operations of one FRI query gather on the card, K10 against its
plain version, counted by torch.profiler in a process of their own.

    python scripts/gather_device_ops.py

At one wormhole proof's shapes (the four oracles' trees, the constants/sigmas
one shared, and the two FRI trees; 28 queries): ten calls of each in one
profiler window (card only), then again after a CUDA graph of K10 launches
has been captured and replayed.  Prints one JSON line a window: the device
events by name and their count a call, and the card's name and power limit.
This is the one count of a gather call's device operations: chip_smoke.py's
gather_time times the gather and leaves the count to this script (late in
a whole smoke run, a profiler window recorded no event for K10's calls).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from zk_circuits_torch.fri import fri_device as fd  # noqa: E402
from zk_circuits_torch.fri import gather_cuda  # noqa: E402

CALLS = 10
LDE, CAP, QUERIES = 1 << 16, 4, 28
ORACLE_WIDTHS = (84, 139, 24, 20)   # the zk wormhole's oracles (chip_smoke.fri_widths)
FRI_LEAVES = ((1 << 12, 32), (1 << 8, 32))


def trees_and_indices(gen):
    def words(*shape):
        return torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=gen, device="cuda",
                             dtype=torch.int64)

    def tree(lead, leaf_shape, n):
        sizes = [n >> lv for lv in range(n.bit_length() - CAP)]
        return words(*lead, *leaf_shape), list(torch.split(words(*lead, sum(sizes), 4), sizes,
                                                           dim=-2))

    trees = [tree((), (ORACLE_WIDTHS[0], LDE), LDE)]
    trees += [tree((1,), (w, LDE), LDE) for w in ORACLE_WIDTHS[1:]]
    trees += [tree((1,), (m, w), m) for m, w in FRI_LEAVES]
    idx = np.random.default_rng(0).integers(0, LDE, (1, QUERIES))
    idxs = [idx] * 4 + [idx % m for m, _ in FRI_LEAVES]
    return trees, idxs, [True] + [False] * 5, [True] * 4 + [False] * 2


def window(name, fn):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    events = chip_smoke.device_events(prof)
    print(json.dumps({"window": name, "calls": CALLS,
                      "device_ops_per_call": sum(v[1] for v in events.values()) / CALLS,
                      "by_name": {k[:60]: v[1] for k, v in events.items()}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_device_ops: CUDA is not available", file=sys.stderr)
        return 2
    trees, idxs, shared, cm = trees_and_indices(torch.Generator(device="cuda").manual_seed(7))
    k10 = lambda: fd.gather_trees_batch(trees, idxs, shared, cm)   # noqa: E731
    plain = lambda: fd._gather_plain(trees, idxs, shared, cm)     # noqa: E731
    k10()
    plain()
    window("k10_gather_trees_batch", k10)
    window("plain_gather", plain)
    prep = gather_cuda.prepare(trees, idxs, shared, cm)
    chip_smoke.graph_ms([lambda: gather_cuda.launch(prep)] * 4)
    window("k10_gather_trees_batch_after_a_graph", k10)
    window("plain_gather_after_a_graph", plain)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
