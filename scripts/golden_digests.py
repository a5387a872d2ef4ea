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
  the dummy (several minutes; left out with ``--no-aggregate``);
- ``GOLDEN_COMPAT_LAYOUT_SHA256``: the emulated reference wormhole layout
  of ``compat/refcircuit.build_wormhole_layout(True)``: its selector,
  constant and sigma polys stacked, (84, 2^13) little-endian u64.

tests/test_torch_wormhole_golden.py re-derives each proof digest the same
way, tests/test_torch_compat.py the layout's.

It also prints the pins of the port's recursion and aggregation tests
(tests/test_torch_jax_pins.py derives and checks them in tier-1): the JAX
level circuit over two square proofs (gate rows, degree, common.bin and
verifier.bin sha256), its chunk proof, and the 2-level mesh root and
depth-1 root of tests/test_torch_aggregation.py; and
``GOLDEN_MUL_CHAIN_SHA256``: chip_smoke's mul chain proved under FRI folds
of arity 2^5 and under five challenges (``chip_smoke.WIDE_CONFIGS``).
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


def compat_layout_digest() -> str:
    """sha256 of the JAX package's emulated reference wormhole layout."""
    import numpy as np

    from zk_circuits_tpu.compat.refcircuit import build_wormhole_layout

    layout = build_wormhole_layout(True)
    polys = np.concatenate([layout.selector_polys(), layout.constant_polys(),
                            layout.sigma_polys()])
    return hashlib.sha256(np.ascontiguousarray(polys, dtype="<u8").tobytes()).hexdigest()


def main() -> None:
    from zk_circuits_tpu.plonk.config import CircuitConfig

    out = {}
    jobs = [("GOLDEN_WORMHOLE_SHA256",
             lambda: _digest(wormhole_proof(CircuitConfig.standard_recursion_config())[0])),
            ("GOLDEN_VOTE_SHA256", lambda: _digest(vote_proof())),
            ("GOLDEN_COMPAT_LAYOUT_SHA256", compat_layout_digest)]
    from test_torch_jax_pins import JaxSquare, mul_chain_sha256

    import chip_smoke

    sq = JaxSquare()
    jobs += [(f"GOLDEN_MUL_CHAIN_SHA256[{w}]", lambda w=w: mul_chain_sha256(w))
             for w in chip_smoke.WIDE_CONFIGS]
    jobs += [("JAX_LEVEL", sq.level_pins), ("JAX_CHUNK_SHA256", sq.chunk_sha256),
             ("JAX_MESH_ROOT_SHA256", sq.mesh_root_sha256),
             ("JAX_CHUNK_ROOT_SHA256", sq.chunk_root_sha256)]
    if "--no-aggregate" not in sys.argv[1:]:
        jobs.append(("GOLDEN_AGGREGATE_ZK_SHA256", lambda: _digest(aggregate_root())))
    for name, job in jobs:
        t = time.perf_counter()
        out[name] = job()
        out[f"{name}_s"] = time.perf_counter() - t
        print(json.dumps({name: out[name], "s": out[f"{name}_s"]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
