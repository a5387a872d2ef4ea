"""Closed loop, one caller: each call proves ``batch`` distinct inputs of
the configuration's circuit with one ``prove_batch`` call, drawn in seeded
order from a pool of ``pool`` made at set-up from the seed.

The mix's parameters: ``batch``, ``pool`` and ``warm_calls`` (calls of
the same shape made in set-up, not timed).  Every proof of a call waits
the call's time.  After the window one proof of each batch position,
from a call drawn from the seed, is proved again by the plain reference
and compared layer by layer.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from zkbench.harness import compare, spec, stats

ENTRY = "prove_batch"


class Driver:
    def __init__(self, cell, seed: int, device, cache_dir, program_cls=None):
        self.cell = cell
        self.batch = int(cell.mix["batch"])
        self.asked_per_call = self.batch
        self.pool_size = int(cell.mix["pool"])
        self.warm_calls = int(cell.mix["warm_calls"])
        if self.batch > self.pool_size:
            raise ValueError("a batch of distinct inputs needs a pool at least as large")
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
        self.pws = None
        self.calls = 0
        self.check_s = {}
        self.sample = [None] * self.batch        # (pool index, proof or None) a position
        self.pow_witnesses = []                  # of the window's proofs, for the metrics
        self.shape_proof = None                  # a proof of the window (the tree shapes)

    def setup(self) -> dict:
        self.program = self.program_cls(self.cell.config, self.cache_dir, self.device)
        want = self.cell.config.get("degree_bits")
        if want is not None and self.program.degree_bits != want:
            raise RuntimeError(f"the circuit has 2^{self.program.degree_bits} rows, "
                               f"the configuration states 2^{want}")
        self.pws = [self.program.witness(w) for w in self.pool]
        for _ in range(self.warm_calls):
            self.program.prove(self._draw(self._warm_order)[1])
        return {"built_circuit": self.program.built}

    def _draw(self, rng) -> tuple:
        idx = rng.choice(self.pool_size, self.batch, replace=False)
        return idx, [self.pws[i] for i in idx]

    def call(self) -> tuple:
        """One timed call: (answers asked, answers given)."""
        idx, pws = self._draw(self._order)
        proofs = list(self.program.prove(pws))
        self.calls += 1
        # one proof a batch position, from a call drawn uniformly (reservoir)
        for p, i in enumerate(idx):
            if self._pick.integers(self.calls) == 0:
                self.sample[p] = (int(i), proofs[p] if p < len(proofs) else None)
        self.pow_witnesses += [int(q.proof.opening_proof.pow_witness) for q in proofs]
        self.shape_proof = self.shape_proof or (proofs[0] if proofs else None)
        return len(pws), len(proofs)

    def timings(self) -> dict:
        """The program's stage timers (none for a program put in its place)."""
        if self.program_cls is not self.circuit.Program:
            return {}
        from zk_circuits_torch.utils import profiling

        return profiling.get_timings()

    def end_to_end(self, window) -> dict:
        lat = [c.seconds for c in window.calls for _ in range(c.given)]
        return {"proofs_per_s": stats.rate(window.given, window.seconds),
                "proof_p95_s": stats.percentile(lat, 95) if lat else None}

    def release(self) -> None:
        """Drop the program's state, so that the reference finds the card
        empty."""
        self.program = None
        self.pws = None
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()

    def check(self) -> list:
        """(name, number, limit, kind) of each comparison: a layer's count of
        sampled proofs that differ from the reference's there (at most the
        limit), and the count sampled (at least one a batch position)."""
        sample = [s for s in self.sample if s is not None]
        t0 = time.perf_counter()
        ref = self.circuit.Reference(self.cell.config, self.device)
        t1 = time.perf_counter()
        want = ref.prove([self.pool[i] for i, _ in sample])
        self.check_s = {"reference_build_s": t1 - t0,
                        "reference_prove_s": time.perf_counter() - t1}
        counts = dict.fromkeys(compare.LAYERS, 0)
        for (_, got), w in zip(sample, want):
            for layer in compare.differing(got, w):
                counts[layer] += 1
        return [("sampled", len(sample), self.batch, "min")] + [
            (f"{k}_differ", v, 0, "max") for k, v in counts.items()]
