"""Chosen phases of chip_smoke.py on one card, in order, each printing its
JSON line; exits non-zero at the first phase that fails.

    python scripts/smoke_phases.py wormhole k6_check k6_time fri_check fri_time
    python scripts/smoke_phases.py wormhole gather_check gather_time

The card phase (the builds, the card's name and power limit) always runs
first.  Without the aggregate phase, the phases that read its level-1
circuit and proof (k5_check to gather_time) get the wormhole's in their place,
and a launch count that only a skipped phase records reads 0.  Full runs of
chip_smoke.py give the figures of every shape; this gives a few phases'
quickly.
"""

import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main(names: list) -> int:
    unknown = [n for n in names if n not in chip_smoke.PHASES]
    if unknown:
        print(f"unknown phases {unknown}; known: {list(chip_smoke.PHASES)}", file=sys.stderr)
        return 2
    state = collections.defaultdict(lambda: collections.defaultdict(int))
    for name in ["card"] + [n for n in names if n != "card"]:
        t0 = time.perf_counter()
        chip_smoke.PHASES[name](state)
        if name == "wormhole" and "aggregate" not in names:
            state["level1_cd"] = state["wormhole"][0]
            state["level1_proof"] = state["wormhole_proof"]
        print(json.dumps({"phase_done": name, "s": time.perf_counter() - t0}), flush=True)
    print(state["smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
