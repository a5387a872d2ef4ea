"""Host-clock times of warm zk wormhole proofs with the torch port on one
GPU: five single proofs and three batches of four, after one of each to
warm up, with the stage timers' medians; one JSON line.

    python scripts/torch_prove_times.py [CHECKOUT]

CHECKOUT is the root of the checkout whose ``zk_circuits_torch`` is
timed (default: this one), so that two commits can be compared on one
card in turns: unpack the other commit with ``git archive`` into a
git-ignored directory and run old, new, new, old on one card in a row.
"""

import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

from zk_circuits_torch.api.prover import WormholeProver  # noqa: E402
from zk_circuits_torch.circuits.wormhole import golden_fixtures  # noqa: E402
from zk_circuits_torch.plonk.config import CircuitConfig  # noqa: E402
from zk_circuits_torch.plonk.prover import prove_batch  # noqa: E402
from zk_circuits_torch.utils import profiling  # noqa: E402


def main() -> None:
    prover = WormholeProver(CircuitConfig.standard_recursion_zk_config(), device="cuda")
    cd, targets = prover.circuit_data, prover.targets
    inputs = golden_fixtures.test_inputs()

    def pw():
        return WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness

    def timed(fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    timed(lambda: cd.prove(pw(), device="cuda"))
    timed(lambda: prove_batch(cd, [pw() for _ in range(4)]))
    profiling.reset_timings()
    single = [timed(lambda: cd.prove(pw(), device="cuda")) for _ in range(5)]
    batch = [timed(lambda: prove_batch(cd, [pw() for _ in range(4)])) for _ in range(3)]
    stages = {k: statistics.median(v) for k, v in profiling.get_timings().items()
              if k.split("/")[0] in ("prove", "batch")}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "single_s": single,
                      "batch_s": batch, "single_median_s": statistics.median(single),
                      "batch_median_s": statistics.median(batch), "stages": stages}),
          flush=True)


if __name__ == "__main__":
    main()
