"""A chain of squarings, x -> x^(2^k), with x^(2^k) a public input: a
circuit of a few rows, on which a whole run fits into a test on the CPU.
No deployment runs it; the benchmark's cells do not name it."""

from __future__ import annotations

import numpy as np

P = (1 << 64) - (1 << 32) + 1


def withdrawals(config: dict, rng, count: int) -> list:
    """``count`` distinct inputs x."""
    xs = []
    while len(xs) < count:
        x = int(rng.integers(2, P, dtype=np.uint64))
        if x not in xs:
            xs.append(x)
    return [{"x": x} for x in xs]


def _build(builder_cls, config_cls, fri_cls, config: dict, device):
    fields = dict(config["config"])
    builder = builder_cls(config_cls(fri_config=fri_cls(**fields.pop("fri")), **fields))
    x = y = builder.add_virtual_target()
    for _ in range(config["squarings"]):
        y = builder.mul(y, y)
    builder.register_public_input(y)
    return builder.build(device), x


class Program:
    def __init__(self, config: dict, cache_dir, device):
        from zk_circuits_torch.iop.builder import CircuitBuilder
        from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig

        self.device = device
        self.built = True
        self.circuit_data, self._x = _build(CircuitBuilder, CircuitConfig, FriConfig, config,
                                            device)
        self.degree_bits = self.circuit_data.common.degree_bits

    def witness(self, w: dict):
        from zk_circuits_torch.iop.witness import PartialWitness

        pw = PartialWitness()
        pw.set_target(self._x, w["x"])
        return pw

    def prove(self, pws: list) -> list:
        from zk_circuits_torch.plonk.prover import prove_batch

        return prove_batch(self.circuit_data, pws, device=self.device)

    def aggregate(self, leaves: list, b: int, d: int) -> tuple:
        from zk_circuits_torch.aggregation import tree

        return _aggregate(tree, self.circuit_data, leaves, b, d, self.device)


def _aggregate(tree, data, leaves, b, d, device):
    root, root_data = tree.aggregate_to_tree(leaves, data.common, data.verifier_only,
                                             tree.TreeAggregationConfig(b, d), device=device)
    return root, [{"y": int(v)} for v in root.public_inputs], root_data.common.degree_bits


class Reference:
    def __init__(self, config: dict, device):
        from zkbench.reference.zkref.iop.builder import CircuitBuilder
        from zkbench.reference.zkref.plonk.config import CircuitConfig, FriConfig

        self.device = device
        self.circuit_data, self._x = _build(CircuitBuilder, CircuitConfig, FriConfig, config,
                                            device)

    def prove(self, ws: list) -> list:
        from zkbench.reference.zkref.iop.witness import PartialWitness
        from zkbench.reference.zkref.plonk.prover import prove_batch

        pws = []
        for w in ws:
            pw = PartialWitness()
            pw.set_target(self._x, w["x"])
            pws.append(pw)
        return prove_batch(self.circuit_data, pws, device=self.device)

    def aggregate(self, leaves: list, b: int, d: int) -> tuple:
        from zkbench.reference.zkref.aggregation import tree

        return _aggregate(tree, self.circuit_data, leaves, b, d, self.device)
