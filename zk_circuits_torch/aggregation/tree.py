"""Tree aggregation of proofs via recursive verification.

Port of wormhole/aggregator/src/circuits/tree.rs semantics:
- ``TreeAggregationConfig{branching_factor b, depth d}`` → b^d leaf slots
  (tree.rs:15-53);
- level-by-level recursion: every chunk of b proofs is folded by a circuit
  that verifies the b inner proofs and re-registers their public inputs,
  so the root proof carries all b^d × leaf_pi felts (tree.rs:106-143).

As in the JAX package's aggregation/tree.py, each level's circuit is built
once and reused for all chunks of that level (they share shape), and a
level's chunks are proved as one batch (``prove_batch``).  Here the level
circuit is built on ``device`` (its constants/sigmas commitment lives
there) and the batch is proved there: on the card, K3 makes the B
witnesses and K1 hashes every Merkle tree of the B proofs.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..iop.builder import CircuitBuilder
from ..iop.witness import PartialWitness
from ..plonk.config import CircuitConfig
from ..recursion.verifier_circuit import (
    add_virtual_proof_with_pis,
    add_virtual_verifier_data,
    set_proof_with_pis_target,
    set_verifier_data_target,
    verify_proof_circuit,
)


@dataclass(frozen=True)
class TreeAggregationConfig:
    """tree.rs:15-53; defaults b=2, d=3 → 8 leaves."""

    branching_factor: int = 2
    depth: int = 3

    def __post_init__(self):
        assert self.branching_factor >= 2
        assert self.depth >= 1

    @property
    def num_leaf_proofs(self) -> int:
        return self.branching_factor ** self.depth

    @staticmethod
    def default() -> "TreeAggregationConfig":
        return TreeAggregationConfig()


def _log_level_circuit(lc: "LevelCircuit") -> None:
    """One line per LevelCircuit build quantifying the recursive verifier
    circuit: gate rows before padding, padded degree, gate-type mix, and
    build wall time."""
    import logging
    import os
    from collections import Counter

    common = lc.circuit_data.common
    mix = Counter(type(g).__name__ for g in lc.circuit_data.prover_only.gates_by_row)
    msg = (f"LevelCircuit b={lc.branching_factor} inner=2^{lc.inner_common.degree_bits}"
           f" -> rows={lc.num_gate_rows} degree=2^{common.degree_bits}"
           f" build={lc.build_seconds:.1f}s gates={dict(mix)}")
    logging.getLogger("zk_circuits_torch").info(msg)
    if os.environ.get("ZKT_TIMING"):
        print(f"[zkt] {msg}", flush=True)


_LEVEL_CACHE: dict = {}


class LevelCircuit:
    """One aggregation level: verifies ``branching_factor`` proofs of the
    inner circuit and concatenates their public inputs."""

    @staticmethod
    def cached(inner_common, branching_factor: int,
               config: CircuitConfig | None = None, device="cuda") -> "LevelCircuit":
        """Process-wide cache keyed on the inner circuit's transcript
        digest and the device: repeat aggregations (and the upper levels of
        every aggregation, whose inner circuit recurs run to run) pay no
        circuit build (the reference rebuilds per chunk, tree.rs:111-127)."""
        from .. import resolve_device

        device = resolve_device(device)
        key = (tuple(int(x) for x in inner_common.circuit_digest),
               inner_common.degree_bits, branching_factor,
               config or inner_common.config, str(device))
        lc = _LEVEL_CACHE.get(key)
        if lc is None:
            lc = LevelCircuit(inner_common, branching_factor, config, device)
            _LEVEL_CACHE[key] = lc
        return lc

    def __init__(self, inner_common, branching_factor: int,
                 config: CircuitConfig | None = None, device="cuda"):
        import time as _time

        from .. import resolve_device

        self.device = resolve_device(device)
        self.inner_common = inner_common
        self.branching_factor = branching_factor
        cfg = config or inner_common.config
        t0 = _time.perf_counter()
        builder = CircuitBuilder(cfg)
        cap_h = inner_common.config.fri_config.cap_height
        self.verifier_data_targets = add_virtual_verifier_data(builder, cap_h)
        self.proof_targets = []
        for _ in range(branching_factor):
            pt = add_virtual_proof_with_pis(builder, inner_common)
            builder.register_public_inputs(pt.public_inputs)
            self.proof_targets.append(pt)
        for pt in self.proof_targets:
            verify_proof_circuit(builder, inner_common, pt,
                                 self.verifier_data_targets)
        self.num_gate_rows = len(builder.gates)
        self.circuit_data = builder.build(self.device)
        self.build_seconds = _time.perf_counter() - t0
        _log_level_circuit(self)

    def _chunk_witness(self, proofs: list, inner_verifier_only) -> PartialWitness:
        assert len(proofs) == self.branching_factor
        pw = PartialWitness()
        set_verifier_data_target(pw, self.verifier_data_targets,
                                 inner_verifier_only)
        for pt, proof in zip(self.proof_targets, proofs):
            set_proof_with_pis_target(pw, pt, proof)
        return pw

    def prove_chunk(self, proofs: list, inner_verifier_only):
        pw = self._chunk_witness(proofs, inner_verifier_only)
        return self.circuit_data.prove(pw, device=self.device)

    def prove_level(self, proofs: list, inner_verifier_only, mesh=None) -> list:
        """Prove ALL chunks of this level at once: one witness per chunk,
        then one batched prove on the level's device (replaces the
        reference's rayon par_chunks fan-out, tree.rs:92-103).  ``mesh``
        (the batch over several cards) is not ported: ``prove_batch``
        raises NotImplementedError for it."""
        from ..plonk.prover import prove_batch

        b = self.branching_factor
        pws = [
            self._chunk_witness(proofs[i : i + b], inner_verifier_only)
            for i in range(0, len(proofs), b)
        ]
        return prove_batch(self.circuit_data, pws, mesh=mesh, device=self.device)


def aggregate_to_tree(proofs: list, inner_common, inner_verifier_only,
                      config: TreeAggregationConfig, mesh=None, device="cuda") -> tuple:
    """Fold proofs level by level; returns (root_proof, root_circuit_data).

    All proofs must come from the same inner circuit.  len(proofs) must be
    b^d (pad with dummy proofs first — aggregator.py).  Every level circuit
    is built and proved on ``device``; a ``mesh`` raises NotImplementedError
    at the first level of more than one chunk (``LevelCircuit.prove_level``)."""
    import time as _time

    from ..utils import profiling

    b = config.branching_factor
    assert len(proofs) == config.num_leaf_proofs
    common = inner_common
    verifier_only = inner_verifier_only
    level_data = None
    while len(proofs) > 1:
        level = LevelCircuit.cached(common, b, device=device)
        t0 = _time.perf_counter()
        if len(proofs) > b:
            proofs = level.prove_level(proofs, verifier_only, mesh=mesh)
        else:
            proofs = [level.prove_chunk(proofs, verifier_only)]
        profiling._TIMINGS["agg/level_prove"].append(_time.perf_counter() - t0)
        level_data = level.circuit_data
        common = level_data.common
        verifier_only = level_data.verifier_only
    return proofs[0], level_data
