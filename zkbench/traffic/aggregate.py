"""Closed loop, one caller: each call pushes ``leaves`` distinct leaf
proofs into a new ``WormholeProofAggregator`` (b^d slots, so a full
buffer and no dummy) and calls ``aggregate()``.  The leaves are drawn in
seeded order from a pool of ``pool`` leaf proofs that the program proves
at set-up from withdrawals made from the seed (``leaf_batch`` a
``prove_batch`` call).

The mix's parameters: ``leaves``, ``pool``, ``leaf_batch`` and
``warm_calls`` (aggregations made in set-up, not timed; the first builds
the level circuits).  After the window one aggregation drawn from the
seed is made again by the plain reference, from its own leaf proofs of
the same withdrawals and its own level circuits: its root layer by
layer, its leaves and the leaves' public inputs extracted from the root
are compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from zkbench.harness import compare, spec

ENTRY = "aggregate"


class Driver:
    def __init__(self, cell, seed: int, device, cache_dir, program_cls=None):
        self.cell = cell
        self.leaves = int(cell.mix["leaves"])
        self.pool_size = int(cell.mix["pool"])
        self.leaf_batch = int(cell.mix["leaf_batch"])
        self.warm_calls = int(cell.mix["warm_calls"])
        tree = cell.config["aggregation"]
        self.b, self.d = int(tree["branching_factor"]), int(tree["depth"])
        if self.leaves != self.b ** self.d or self.leaves > self.pool_size:
            raise ValueError("a full buffer of distinct leaves: leaves = b^d <= pool")
        self.asked_per_call = 1
        self.circuit = spec.load_module("circuits", cell.config["circuit"])
        self.program_cls = program_cls or self.circuit.Program
        self.device = device
        self.cache_dir = cache_dir / cell.entry["config"]
        self.pool = self.circuit.withdrawals(cell.config, np.random.default_rng([seed, 0]),
                                             self.pool_size)
        self._order = np.random.default_rng([seed, 1])
        self._warm_order = np.random.default_rng([seed, 2])
        self._pick = np.random.default_rng([seed, 3])
        self.program = None
        self.leaf_proofs = None
        self.calls = 0
        self.sample = None      # (pool indices, root, leaf public inputs, leaves)
        self.roots = []         # PoW witnesses of the window's roots
        self.shape_proof = None  # (a root of the window, its circuit's degree bits)
        self.check_s = {}

    def setup(self) -> dict:
        self.program = self.program_cls(self.cell.config, self.cache_dir, self.device)
        want = self.cell.config.get("degree_bits")
        if want is not None and self.program.degree_bits != want:
            raise RuntimeError(f"the leaf circuit has 2^{self.program.degree_bits} rows, "
                               f"the configuration states 2^{want}")
        pws = [self.program.witness(w) for w in self.pool]
        self.leaf_proofs = []
        for i in range(0, self.pool_size, self.leaf_batch):
            self.leaf_proofs += self.program.prove(pws[i:i + self.leaf_batch])
        t0 = time.perf_counter()
        for _ in range(self.warm_calls):
            self._aggregate(self._draw(self._warm_order))
        return {"built_circuit": self.program.built,
                "warm_aggregations_s": time.perf_counter() - t0}

    def _draw(self, rng):
        return rng.choice(self.pool_size, self.leaves, replace=False)

    def _aggregate(self, idx) -> tuple:
        return self.program.aggregate([self.leaf_proofs[i] for i in idx], self.b, self.d)

    def call(self) -> tuple:
        """One timed aggregation: (1 asked, 1 done)."""
        idx = self._draw(self._order)
        root, pis, bits = self._aggregate(idx)
        self.calls += 1
        if self._pick.integers(self.calls) == 0:
            self.sample = ([int(i) for i in idx], root, pis,
                           [self.leaf_proofs[i] for i in idx])
        want = self.cell.config.get("level_degree_bits")
        if want is not None and bits != want:
            raise RuntimeError(f"the root circuit has 2^{bits} rows, the configuration "
                               f"states 2^{want}")
        self.roots.append(int(root.proof.opening_proof.pow_witness))
        self.shape_proof = self.shape_proof or (root, bits)
        return 1, 1

    def timings(self) -> dict:
        """The program's stage timers (none for a program put in its place)."""
        if self.program_cls is not self.circuit.Program:
            return {}
        from zk_circuits_torch.utils import profiling

        return profiling.get_timings()

    def end_to_end(self, window) -> dict:
        return {"aggregate_s": window.seconds / window.given if window.given else None}

    def release(self) -> None:
        self.program = None
        self.leaf_proofs = None
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()

    def check(self) -> list:
        """(name, number, limit, kind): the sampled aggregation's root layer by
        layer, its leaves and the leaves' public inputs extracted from it,
        each a count of what differs from the reference's."""
        if self.sample is None:
            return [("sampled", 0, 1, "min")]
        idx, root, pis, got_leaves = self.sample
        t0 = time.perf_counter()
        ref = self.circuit.Reference(self.cell.config, self.device)
        leaves = ref.prove([self.pool[i] for i in idx])
        t1 = time.perf_counter()
        want_root, want_pis, _ = ref.aggregate(leaves, self.b, self.d)
        self.check_s = {"reference_leaves_s": t1 - t0,
                        "reference_aggregate_s": time.perf_counter() - t1}
        counts = dict.fromkeys(compare.LAYERS, 0)
        for layer in compare.differing(root, want_root):
            counts[layer] += 1
        leaves_differ = sum(1 for g, w in zip(got_leaves, leaves) if compare.differing(g, w))
        inputs_differ = sum(1 for g, w in zip(pis, want_pis) if g != w)
        return [("sampled", 1, 1, "min")] + [
            (f"root_{k}_differ", v, 0, "max") for k, v in counts.items()] + [
            ("leaves_differ", leaves_differ, 0, "max"),
            ("leaf_inputs_differ", inputs_differ + abs(len(pis) - len(want_pis)), 0, "max")]
