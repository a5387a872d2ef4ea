"""Derive the sha256 digests that chip_smoke.py pins, from the JAX
package's host path (numpy and the native C++ library, on the CPU).

    JAX_PLATFORMS=cpu python scripts/golden_digests.py [--no-aggregate]

Prints one JSON line: the digest of each proof, and the seconds each took.

- ``GOLDEN_WORMHOLE_SHA256``: the wormhole proof of
  ``golden_fixtures.test_inputs()`` under ``standard_recursion_config``
  (what ``api/example.py`` writes);
- ``GOLDEN_VOTE_SHA256``: the vote proof of
  ``tests/test_voting.py::create_test_inputs`` under
  ``standard_recursion_config``;
- ``GOLDEN_AGGREGATE_ZK_SHA256``: the root proof of the default tree
  aggregation (branching factor 2, depth 3: 8 leaves) of the zk wormhole
  proof of the golden inputs, pushed 3 times and padded with itself as
  the dummy (several minutes; left out with ``--no-aggregate``).

tests/test_torch_wormhole_golden.py re-derives each one the same way.
"""

import hashlib
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def _digest(proof) -> str:
    from zk_circuits_tpu.utils.serialization import proof_to_bytes

    return hashlib.sha256(proof_to_bytes(proof)).hexdigest()


def wormhole_proof(config):
    """The JAX host-path wormhole proof of the golden inputs; returns the
    proof and its prover."""
    from zk_circuits_tpu.api.prover import WormholeProver
    from zk_circuits_tpu.circuits.wormhole import golden_fixtures

    prover = WormholeProver(config)
    return prover.commit(golden_fixtures.test_inputs()).prove(use_device=False), prover


def vote_proof():
    """The JAX host-path vote proof of test_voting.create_test_inputs()."""
    from test_voting import create_test_inputs

    from zk_circuits_tpu.circuits.voting import VoteCircuitData, VoteTargets
    from zk_circuits_tpu.iop.builder import CircuitBuilder
    from zk_circuits_tpu.iop.witness import PartialWitness
    from zk_circuits_tpu.plonk.config import CircuitConfig

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    targets = VoteTargets.new(builder)
    VoteCircuitData.circuit(targets, builder)
    data = builder.build()
    pw = PartialWitness()
    create_test_inputs().fill_targets(pw, targets)
    return data.prove(pw, use_device=False)


def aggregate_root():
    """The JAX host-path root proof of the b=2, d=3 aggregation of the zk
    wormhole proof (3 pushes, 5 dummies, the proof its own dummy)."""
    from zk_circuits_tpu.aggregation.aggregator import WormholeProofAggregator
    from zk_circuits_tpu.aggregation.tree import TreeAggregationConfig
    from zk_circuits_tpu.plonk.config import CircuitConfig

    leaf, prover = wormhole_proof(CircuitConfig.standard_recursion_zk_config())
    cd = prover.circuit_data
    agg = WormholeProofAggregator(cd.common, cd.verifier_only, TreeAggregationConfig(2, 3),
                                  dummy_loader=lambda: leaf)
    for _ in range(3):
        agg.push(leaf)
    return agg.aggregate()


def main() -> None:
    from zk_circuits_tpu.plonk.config import CircuitConfig

    out = {}
    jobs = [("GOLDEN_WORMHOLE_SHA256",
             lambda: wormhole_proof(CircuitConfig.standard_recursion_config())[0]),
            ("GOLDEN_VOTE_SHA256", vote_proof)]
    if "--no-aggregate" not in sys.argv[1:]:
        jobs.append(("GOLDEN_AGGREGATE_ZK_SHA256", aggregate_root))
    for name, job in jobs:
        t = time.perf_counter()
        out[name] = _digest(job())
        out[f"{name}_s"] = time.perf_counter() - t
        print(json.dumps({name: out[name], "s": out[f"{name}_s"]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
