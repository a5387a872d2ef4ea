"""The torch port across four cards: what chip_smoke's one-card run
cannot show.

    python scripts/torch_four_cards.py [--phases a,b,...] [--log-dir DIR]

On a machine with four cards it runs chip_smoke's card and wormhole
phases (what the others need), then the phases asked for, by default
all of them, in this order:

- batch_mesh: chip_smoke's, the mesh batch of 8 over make_mesh(4) (one
  process, the shards in turn) beside the unsharded batch of 8;
- k1_k2_cards: K1 and K2 across the cards (chip_smoke's ``k1_cards``,
  ``k2_cards``);
- aggregate: chip_smoke's b=2, d=3 zk aggregate unsharded (first and
  warm), then its aggregate_mesh phase, the same tree over make_mesh(4)
  in this process;
- multihost: chip_smoke's, the 2^22-point four-step over 2 processes of
  2 cards each under nccl;
- sim_batch: scripts/torch_multihost_sim.py over 4 processes of a card
  each under nccl, the 2^22-point four-step and the zk wormhole batch of
  8 (each process proving its card's 2), beside the batch unsharded on
  process 0's card; run only when every phase before it passed.

Every phase prints one JSON line; the simulation's whole output goes to
--log-dir (a new temporary directory by default).
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PHASES = ("batch_mesh", "k1_k2_cards", "aggregate", "multihost", "sim_batch")


def aggregate(cs, state) -> None:
    """chip_smoke's aggregate tree unsharded on cuda:0, first (building the
    level circuits) and warm, seconds a level; then chip_smoke's
    aggregate_mesh phase: the same tree over make_mesh(4) in this process
    with those level circuits."""
    from zk_circuits_torch.aggregation import tree as treem
    from zk_circuits_torch.aggregation.aggregator import WormholeProofAggregator
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cd = state["wormhole"][0]
    leaf = state["wormhole_proof"]
    runs = []
    for run in ("first", "warm"):
        agg = WormholeProofAggregator(cd.common, cd.verifier_only,
                                      treem.TreeAggregationConfig(*cs.AGG_CONFIG),
                                      dummy_loader=lambda: leaf, device="cuda")
        for _ in range(cs.AGG_PUSHES):
            agg.push(leaf)
        with cs.level_prove_records() as records:
            root, secs = cs._synced(agg.aggregate)
        digest = hashlib.sha256(proof_to_bytes(root)).hexdigest()
        if digest != cs.GOLDEN_AGGREGATE_ZK_SHA256:
            raise AssertionError(f"aggregate ({run}): root sha256 {digest}")
        runs.append({"run": run, "s": secs,
                     "level_s": {i + 1: r["s"] for i, r in enumerate(records)}})
    state["aggregate_warm_s"] = runs[-1]["s"]
    state["aggregate_warm_level_s"] = runs[-1]["level_s"]
    cs.emit({"phase": "aggregate_unsharded", "runs": runs,
             "timing": "s: perf_counter, ending in a synchronise"})
    cs.PHASES["aggregate_mesh"](state)


def sim(cs, log_dir, tag, args, timeout) -> dict | None:
    """One scripts/torch_multihost_sim.py run; its result line (None if
    it failed) and the head of its errors printed, its whole output kept
    in log_dir."""
    cmd = [sys.executable, os.path.join(REPO, "scripts", "torch_multihost_sim.py"), *args]
    t = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", str(e.stdout), str(e.stderr)
    with open(os.path.join(log_dir, f"sim_{tag}.log"), "w") as f:
        f.write(f"rc={rc}\n--- stdout\n{out}\n--- stderr\n{err}\n")
    line = [ln for ln in (out or "").splitlines() if ln.startswith("{")]
    result = json.loads(line[-1]) if rc == 0 and line else None
    cs.emit({"phase": f"sim_{tag}", "rc": rc, "s": time.perf_counter() - t, "result": result,
             "stderr_head": (err or "")[:1500]})
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--phases", default=None,
                    help=f"comma-separated, of {','.join(PHASES)} (default: all)")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs

    if torch.cuda.device_count() < 4:
        print("torch_four_cards: needs four cards", file=sys.stderr)
        return 2
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="torch_four_cards_")
    os.makedirs(log_dir, exist_ok=True)
    state = {"k3_launches_batch": 0}    # the batch phase does not run here
    failed = 0

    def run(name, fn):
        nonlocal failed
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report the phase and go on to the next
            traceback.print_exc()
            cs.emit({"phase": name, "ok": False, "error": repr(e)[:3000]})
            failed += 1
        return time.perf_counter() - t

    phases = args.phases.split(",") if args.phases else list(PHASES)
    if set(phases) - set(PHASES):
        raise SystemExit(f"phases are {PHASES}, got {phases}")
    phase_s = {name: run(name, lambda name=name: cs.PHASES[name](state))
               for name in ("card", "wormhole")}

    def cards():
        cd = state["wormhole"][0]
        cap = cd.common.config.fri_config.cap_height
        trees = {n: (k, c, lay) for n, k, c, lay in cs.wormhole_trees(cd.common)}
        cs.emit({"phase": "k1_cards", "cards": cs.k1_cards(cap, trees["wires"])})
        cs.emit({"phase": "k2_cards", "cards": cs.k2_cards(np.random.default_rng(9))})

    steps = {"batch_mesh": lambda: cs.PHASES["batch_mesh"](state), "k1_k2_cards": cards,
             "aggregate": lambda: aggregate(cs, state)}
    for name in phases:
        if name in steps:
            phase_s[name] = run(name, steps[name])
    torch.cuda.empty_cache()
    if "multihost" in phases:
        cs.SIM_TIMEOUT = 90
        phase_s["multihost"] = run("multihost", lambda: cs.PHASES["multihost"](state))
    if "sim_batch" in phases and not failed:    # an nccl hang would hold all four cards
        t = time.perf_counter()
        res = sim(cs, log_dir, "batch",
                  ["--procs", "4", "--local-shards", "1", "--log2n", "22", "--device", "cuda",
                   "--backend", "nccl", "--batch", "8", "--circuit", "wormhole",
                   "--timeout", "240"], 260)
        phase_s["sim_batch"] = time.perf_counter() - t
        if res is None or res["backend"] != "nccl" or \
                set(res["batch"]["sha256"]) != {cs.GOLDEN_WORMHOLE_ZK_SHA256}:
            failed += 1
    cs.emit({"phase_s": phase_s, "log_dir": log_dir})
    print(state.get("smi"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
