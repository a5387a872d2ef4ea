"""The wormhole withdrawal circuit (Quantus-Network/zk-circuits,
wormhole/circuit): withdrawals made from the seed, the program's prover
loaded from its circuit binaries, and the plain reference's own build.

A withdrawal is the canonical fixture of the upstream test helpers (a
captured 7-node Substrate storage proof, its secret, transfer count and
amount) with an exit account of its own: the exit account is a public
input that the storage proof does not bind, so every withdrawal of a pool
is distinct and valid.  Both sides get the same withdrawal as plain data
and make their own inputs from it.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np

P = (1 << 64) - (1 << 32) + 1
BINARIES = ("common.bin", "verifier.bin", "prover.bin")


def withdrawals(config: dict, rng, count: int) -> list:
    """``count`` distinct withdrawals, each a dict of plain data."""
    from zkbench.reference.zkref.circuits.wormhole import golden_fixtures as fx

    base = fx.test_inputs()
    out, seen = [], set()
    while len(out) < count:
        exit_account = b"".join(int(v).to_bytes(8, "little")
                                for v in rng.integers(0, P, 4, dtype=np.uint64))
        if exit_account in seen:
            continue
        seen.add(exit_account)
        out.append({
            "funding_amount": base.public.funding_amount, "nullifier": base.public.nullifier,
            "root_hash": base.public.root_hash, "exit_account": exit_account,
            "secret": base.private.secret, "nodes": list(base.private.storage_proof.proof),
            "indices": list(base.private.storage_proof.indices),
            "transfer_count": base.private.transfer_count,
            "funding_account": base.private.funding_account,
            "unspendable_account": base.private.unspendable_account})
    return out


def _inputs(mod, w: dict):
    """A withdrawal as ``mod``'s CircuitInputs (``mod`` the inputs module of
    either side)."""
    return mod.CircuitInputs(
        public=mod.PublicCircuitInputs(funding_amount=w["funding_amount"],
                                       nullifier=w["nullifier"], root_hash=w["root_hash"],
                                       exit_account=w["exit_account"]),
        private=mod.PrivateCircuitInputs(
            secret=w["secret"],
            storage_proof=mod.ProcessedStorageProof(list(w["nodes"]), list(w["indices"])),
            transfer_count=w["transfer_count"], funding_account=w["funding_account"],
            unspendable_account=w["unspendable_account"]))


def _circuit_config(cls_config, cls_fri, config: dict):
    fields = dict(config["config"])
    return cls_config(fri_config=cls_fri(**fields.pop("fri")), **fields)


class Program:
    """The port's prover of the circuit, as a deployed prover takes it: from
    its prover.bin and common.bin (``WormholeProver.new_from_files``).  The
    first run in a checkout builds the circuit and writes the binaries with
    the port's artifacts API into ``cache_dir``."""

    def __init__(self, config: dict, cache_dir: Path, device):
        from zk_circuits_torch.api import artifacts
        from zk_circuits_torch.api.prover import WormholeProver
        from zk_circuits_torch.circuits.wormhole.circuit import WormholeCircuit
        from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig

        self.device = device
        self.built = False
        if not all((cache_dir / f).is_file() for f in BINARIES):
            circuit = WormholeCircuit(_circuit_config(CircuitConfig, FriConfig, config))
            data = circuit.build_circuit(device)
            part = cache_dir.with_name(cache_dir.name + ".part")
            part.mkdir(parents=True, exist_ok=True)
            artifacts.write_circuit_binaries(part, data, circuit.targets())
            if cache_dir.exists():
                shutil.rmtree(cache_dir)
            os.replace(part, cache_dir)
            self.built = True
        prover = WormholeProver.new_from_files(cache_dir / "prover.bin",
                                               cache_dir / "common.bin", device)
        self.circuit_data, self._targets = prover.circuit_data, prover.targets
        self.degree_bits = self.circuit_data.common.degree_bits

    def witness(self, w: dict):
        from zk_circuits_torch.api.prover import WormholeProver
        from zk_circuits_torch.circuits.wormhole import inputs

        prover = WormholeProver(circuit_data=self.circuit_data, targets=self._targets)
        return prover.commit(_inputs(inputs, w)).partial_witness

    def prove(self, pws: list) -> list:
        from zk_circuits_torch.plonk.prover import prove_batch

        return prove_batch(self.circuit_data, pws, device=self.device)

    def aggregate(self, leaves: list, b: int, d: int) -> tuple:
        """A new aggregator of b^d slots, ``leaves`` pushed and folded: (root,
        the leaves' public inputs extracted from it as dicts, the root
        circuit's degree bits)."""
        from zk_circuits_torch.aggregation.aggregator import WormholeProofAggregator
        from zk_circuits_torch.aggregation.tree import TreeAggregationConfig

        agg = WormholeProofAggregator(self.circuit_data.common, self.circuit_data.verifier_only,
                                      TreeAggregationConfig(b, d), device=self.device)
        for leaf in leaves:
            agg.push(leaf)
        root = agg.aggregate()
        return (root, [vars(p) for p in agg.extract_leaf_public_inputs()],
                agg.root_circuit_data.common.degree_bits)


class Reference:
    """The plain reference's circuit, built from the configuration's file,
    and its proofs of withdrawals (plain torch on ``device``)."""

    def __init__(self, config: dict, device):
        from zkbench.reference.zkref.circuits.wormhole.circuit import WormholeCircuit
        from zkbench.reference.zkref.plonk.config import CircuitConfig, FriConfig

        circuit = WormholeCircuit(_circuit_config(CircuitConfig, FriConfig, config))
        self.targets = circuit.targets()
        self.circuit_data = circuit.build_circuit(device)
        self.device = device

    def prove(self, ws: list) -> list:
        from zkbench.reference.zkref.api.prover import WormholeProver
        from zkbench.reference.zkref.circuits.wormhole import inputs
        from zkbench.reference.zkref.plonk.prover import prove_batch

        pws = [WormholeProver(circuit_data=self.circuit_data, targets=self.targets)
               .commit(_inputs(inputs, w)).partial_witness for w in ws]
        return prove_batch(self.circuit_data, pws, device=self.device)

    def aggregate(self, leaves: list, b: int, d: int) -> tuple:
        """The reference's tree of ``leaves`` (its own proofs): as
        ``Program.aggregate``."""
        from zkbench.reference.zkref.aggregation.tree import (TreeAggregationConfig,
                                                              aggregate_to_tree)
        from zkbench.reference.zkref.circuits.wormhole.inputs import (LEAF_PI_LEN,
                                                                      PublicCircuitInputs)

        root, root_data = aggregate_to_tree(leaves, self.circuit_data.common,
                                            self.circuit_data.verifier_only,
                                            TreeAggregationConfig(b, d), device=self.device)
        pis = PublicCircuitInputs.try_from_aggregated(root, LEAF_PI_LEN, len(leaves))
        return root, [vars(p) for p in pis], root_data.common.degree_bits
