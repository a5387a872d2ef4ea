"""Host-clock times of zk wormhole proofs with the torch port on one GPU:
the cold build of the circuit (with every kernel and the host runtime
built before it), the first single proof and the first batch of four
after it (cold: each kernel's first launch in the process among them),
then five single proofs and three batches of four, with the stage
timers' medians and each openings+fri stage beside the sum of its fri/*
timers (the remainder is the host transcript); one JSON line.

    python scripts/torch_prove_times.py [CHECKOUT]

CHECKOUT is the root of the checkout whose ``zk_circuits_torch`` is
timed (default: this one), so that two commits can be compared on one
card in turns: unpack the other commit with ``git archive`` into a
git-ignored directory and run old, new, new, old on one card in a row.
A checkout without the host runtime (``zk_circuits_torch.native``) is
timed without it; every kernel a checkout has (K5 and K6 where
``plonk/quotient_cuda.py`` exists, K7-K9 where ``fri/fri_cuda.py`` does)
is built before the circuit.
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


def _medians(prefixes: tuple) -> dict:
    return {k: statistics.median(v) for k, v in profiling.get_timings().items()
            if k.split("/")[0] in prefixes}


def _remainder(stages: dict, stage: str, tag: str) -> float:
    """The openings+fri stage less its fri/* timers (medians)."""
    return stages[stage] - sum(v for k, v in stages.items()
                               if k.startswith("fri/") and k.endswith(tag))


def main() -> None:
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.iop import witness_cuda

    poseidon_cuda.build()
    witness_cuda.build()
    try:
        from zk_circuits_torch.ntt import ntt_cuda
    except ImportError:
        ntt_cuda = None
    if ntt_cuda is not None:
        ntt_cuda.build()
    try:
        from zk_circuits_torch.plonk import permutation_cuda, quotient_cuda
    except ImportError:
        permutation_cuda = quotient_cuda = None
    if quotient_cuda is not None:
        quotient_cuda.build()
        permutation_cuda.build()
    try:
        from zk_circuits_torch.fri import fri_cuda
    except ImportError:
        fri_cuda = None
    if fri_cuda is not None:
        fri_cuda.build()
    try:
        from zk_circuits_torch import native
    except ImportError:
        native = None
    if native is not None:
        native.available()
    t0 = time.perf_counter()
    prover = WormholeProver(CircuitConfig.standard_recursion_zk_config(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cd, targets = prover.circuit_data, prover.targets
    inputs = golden_fixtures.test_inputs()

    def pw():
        return WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness

    def timed(fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    cold_single = timed(lambda: cd.prove(pw(), device="cuda"))
    cold_batch = timed(lambda: prove_batch(cd, [pw() for _ in range(4)]))
    profiling.reset_timings()
    single = [timed(lambda: cd.prove(pw(), device="cuda")) for _ in range(5)]
    single_stages = _medians(("prove", "fri"))
    profiling.reset_timings()
    batch = [timed(lambda: prove_batch(cd, [pw() for _ in range(4)])) for _ in range(3)]
    batch_stages = _medians(("batch", "fri"))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "native": native is not None,
        "build_s": build_s, "cold_single_s": cold_single, "cold_batch_s": cold_batch,
        "single_s": single, "batch_s": batch,
        "single_median_s": statistics.median(single),
        "batch_median_s": statistics.median(batch),
        "single_transcript_s": _remainder(single_stages, "prove/openings+fri", ""),
        "batch_transcript_s": _remainder(batch_stages, "batch/openings+fri", "(batch)"),
        "stages": {**single_stages, **batch_stages}}), flush=True)


if __name__ == "__main__":
    main()
