"""WormholeProofAggregator — the user-facing aggregation API.

Port of wormhole/aggregator/src/aggregator.rs: buffer up to b^d wormhole
proofs, pad with a dummy proof (the reference embeds pre-generated
dummy_proof{,_zk}.bin via include_bytes!, util.rs:6-29; here the dummy is
generated once from the golden test inputs and cached on disk), fold to a
tree on ``device``, and expose per-leaf public-input extraction
(aggregator.rs:64-71).

The dummy cache is the port's own git-ignored directory
(``zk_circuits_torch/_generated-bins``), apart from the JAX package's, so
that neither package reads what the other wrote.
"""

from __future__ import annotations

from pathlib import Path

from ..circuits.wormhole.inputs import LEAF_PI_LEN, PublicCircuitInputs
from ..plonk.config import CircuitConfig
from ..utils.serialization import proof_from_bytes, proof_to_bytes
from .tree import TreeAggregationConfig, aggregate_to_tree

_DUMMY_CACHE_DIR = Path(__file__).resolve().parent.parent / "_generated-bins"


def _dummy_name(zk: bool) -> str:
    return "dummy_proof_zk.bin" if zk else "dummy_proof.bin"


def load_dummy_proof(zk: bool = False, device="cuda"):
    """Deterministic wormhole proof over the canonical fixtures — the
    aggregator's padding filler (util.rs:11-29).  Generated on ``device``
    and cached on first use (the reference vendors the equivalent bytes)."""
    cache = _DUMMY_CACHE_DIR / _dummy_name(zk)
    if cache.exists():
        return proof_from_bytes(cache.read_bytes())
    cfg = (CircuitConfig.standard_recursion_zk_config() if zk
           else CircuitConfig.standard_recursion_config())
    return proof_from_bytes(generate_dummy_proof(cfg, device))


def generate_dummy_proof(config: CircuitConfig | None = None, device="cuda") -> bytes:
    """Build the wormhole circuit, prove the golden fixture inputs on
    ``device``, cache the bytes (analog of the reference's vendored
    dummy_proof.bin)."""
    from ..api.prover import WormholeProver
    from ..circuits.wormhole import golden_fixtures

    config = config or CircuitConfig.standard_recursion_config()
    prover = WormholeProver(config, device=device)
    proof = prover.commit(golden_fixtures.test_inputs()).prove(device=device)
    blob = proof_to_bytes(proof)
    _DUMMY_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    (_DUMMY_CACHE_DIR / _dummy_name(config.zero_knowledge)).write_bytes(blob)
    return blob


class WormholeProofAggregator:
    """Buffers wormhole proofs and folds them into one recursive proof on
    ``device``."""

    def __init__(self, inner_common, inner_verifier_only,
                 config: TreeAggregationConfig | None = None, mesh=None,
                 dummy_loader=None, device="cuda"):
        from .. import resolve_device

        self.inner_common = inner_common
        self.inner_verifier_only = inner_verifier_only
        self.config = config or TreeAggregationConfig.default()
        self.mesh = mesh  # prove each level's chunks split over the mesh's shards
        self.device = resolve_device(device)
        # Padding source when the buffer is short of b^d proofs — the
        # reference auto-pads from its embedded dummy (util.rs:11-29);
        # default: the cached wormhole dummy matching the inner config's
        # zk-ness.  Non-wormhole users (e.g. the square-circuit tests)
        # pass a loader proving THEIR inner circuit.
        self.dummy_loader = dummy_loader
        self.proofs: list = []
        self.root_proof = None
        self.root_circuit_data = None

    def push(self, proof) -> None:
        """aggregator.rs:51-62: reject when the buffer is full."""
        if len(self.proofs) >= self.config.num_leaf_proofs:
            raise ValueError(
                f"proof buffer is full ({self.config.num_leaf_proofs} proofs)"
            )
        self.proofs.append(proof)

    def aggregate(self, dummy_proof=None):
        """Pad with the dummy proof to b^d leaves and fold
        (aggregator.rs:74-92)."""
        if not self.proofs:
            raise ValueError("no proofs to aggregate")
        proofs = list(self.proofs)
        if len(proofs) < self.config.num_leaf_proofs:
            if dummy_proof is None:
                if self.dummy_loader is not None:
                    dummy_proof = self.dummy_loader()
                else:
                    dummy_proof = load_dummy_proof(
                        zk=self.inner_common.config.zero_knowledge, device=self.device)
            if (len(dummy_proof.public_inputs)
                    != len(proofs[0].public_inputs)):
                raise ValueError(
                    "dummy proof shape does not match the inner circuit "
                    f"({len(dummy_proof.public_inputs)} public inputs vs "
                    f"{len(proofs[0].public_inputs)}); pass dummy_proof= "
                    "or dummy_loader= proving the same circuit")
            proofs += [dummy_proof] * (self.config.num_leaf_proofs - len(proofs))
        self.root_proof, self.root_circuit_data = aggregate_to_tree(
            proofs, self.inner_common, self.inner_verifier_only, self.config,
            mesh=self.mesh, device=self.device,
        )
        return self.root_proof

    def extract_leaf_public_inputs(self) -> list:
        """Recover every leaf's PublicCircuitInputs from the root proof
        (aggregator.rs:64-71, inputs.rs:61-89)."""
        if self.root_proof is None:
            raise ValueError("aggregate() has not been run")
        return PublicCircuitInputs.try_from_aggregated(
            self.root_proof, LEAF_PI_LEN, self.config.num_leaf_proofs
        )
