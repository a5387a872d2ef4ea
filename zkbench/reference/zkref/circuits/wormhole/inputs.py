"""Wormhole circuit inputs and public-input layout.

Port of wormhole/circuit/src/inputs.rs: public-input felt
layout (16 felts): nullifier[0..4], root_hash[4..8], funding_amount[8..12],
exit_account[12..16] (inputs.rs:12-19, 91-104)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...utils import codecs

LEAF_PI_LEN = 16
NULLIFIER_START_INDEX = 0
NULLIFIER_END_INDEX = 4
ROOT_HASH_START_INDEX = 4
ROOT_HASH_END_INDEX = 8
FUNDING_AMOUNT_START_INDEX = 8
FUNDING_AMOUNT_END_INDEX = 12
EXIT_ACCOUNT_START_INDEX = 12
EXIT_ACCOUNT_END_INDEX = 16


@dataclass
class ProcessedStorageProof:
    """A storage proof plus per-node indices of the committed child hash
    (storage_proof/mod.rs:59-77)."""

    proof: list[bytes]
    indices: list[int]

    def __post_init__(self):
        if len(self.proof) != len(self.indices):
            raise ValueError(
                "indices length must be equal to proof length, actual lengths: "
                f"{len(self.proof)}, {len(self.indices)}"
            )


@dataclass
class PublicCircuitInputs:
    funding_amount: int          # u128
    nullifier: bytes             # 32-byte digest
    root_hash: bytes             # 32-byte digest
    exit_account: bytes          # 32-byte digest

    @staticmethod
    def try_from_slice(pis: np.ndarray) -> "PublicCircuitInputs":
        if len(pis) != LEAF_PI_LEN:
            raise ValueError(
                f"public inputs should contain: {LEAF_PI_LEN} field elements, "
                f"got: {len(pis)}"
            )
        nullifier = codecs.digest_felts_to_bytes(pis[NULLIFIER_START_INDEX:NULLIFIER_END_INDEX])
        codecs.validate_bytes_digest(nullifier)
        root_hash = codecs.digest_felts_to_bytes(pis[ROOT_HASH_START_INDEX:ROOT_HASH_END_INDEX])
        codecs.validate_bytes_digest(root_hash)
        funding_amount = codecs.felts_to_u128(
            pis[FUNDING_AMOUNT_START_INDEX:FUNDING_AMOUNT_END_INDEX]
        )
        exit_account = codecs.digest_felts_to_bytes(
            pis[EXIT_ACCOUNT_START_INDEX:EXIT_ACCOUNT_END_INDEX]
        )
        codecs.validate_bytes_digest(exit_account)
        return PublicCircuitInputs(funding_amount, nullifier, root_hash, exit_account)

    @staticmethod
    def try_from_proof(proof_with_pis) -> "PublicCircuitInputs":
        return PublicCircuitInputs.try_from_slice(proof_with_pis.public_inputs)

    @staticmethod
    def try_from_aggregated(aggr, leaf_pi_len: int, num_leaves: int):
        """Split a root aggregated proof's PIs into per-leaf inputs
        (inputs.rs:61-89)."""
        pis = aggr.public_inputs
        expected = leaf_pi_len * num_leaves
        if len(pis) != expected:
            raise ValueError(
                f"aggregated public inputs should contain: {expected} "
                f"(= {num_leaves} leaves x {leaf_pi_len} fields), got: {len(pis)}"
            )
        return [
            PublicCircuitInputs.try_from_slice(pis[i * leaf_pi_len : (i + 1) * leaf_pi_len])
            for i in range(num_leaves)
        ]


@dataclass
class TransferProofJson:
    """Live-node transfer-proof JSON schema (common/src/circuit.rs:14-20):
    the output of the quantus-api-client ``sample_proof`` example, consumed
    by the online e2e flow (tests/src/circuit/circuit_data_tests.rs:46-70,
    253-299)."""

    transfer_count: int        # u64
    state_root: str            # hex, no 0x prefix
    storage_proof: list[str]   # hex-encoded trie nodes
    indices: list[int]         # per-node byte index of the committed child hash

    @staticmethod
    def from_json(text: str) -> "TransferProofJson":
        """Parse from a JSON document; like the reference's fallback parser,
        accepts surrounding log noise by extracting the last JSON object."""
        import json

        try:
            obj = json.loads(text)
        except json.JSONDecodeError:
            obj = _extract_last_json(text)
        return TransferProofJson(
            transfer_count=int(obj["transfer_count"]),
            state_root=str(obj["state_root"]),
            storage_proof=[str(s) for s in obj["storage_proof"]],
            indices=[int(i) for i in obj["indices"]],
        )

    def state_root_bytes(self) -> bytes:
        root = bytes.fromhex(self.state_root.removeprefix("0x"))
        if len(root) != 32:
            raise ValueError("state_root must be 32 bytes")
        return root

    def to_processed_storage_proof(self) -> ProcessedStorageProof:
        nodes = [bytes.fromhex(s.removeprefix("0x")) for s in self.storage_proof]
        return ProcessedStorageProof(nodes, list(self.indices))


_TRANSFER_PROOF_KEYS = frozenset(
    ("transfer_count", "state_root", "storage_proof", "indices")
)


def _extract_last_json(text: str) -> dict:
    """Last JSON object in a mixed stdout stream that deserializes as a
    TransferProofJson (mirrors the reference's typed extract_last_json,
    circuit_data_tests.rs:28-44: candidates that don't parse as the proof
    schema — e.g. trailing JSON-formatted log lines or nested objects —
    are skipped, not returned)."""
    import json

    last = None
    for start in (i for i, c in enumerate(text) if c == "{"):
        try:
            obj, _ = json.JSONDecoder().raw_decode(text[start:])
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and _TRANSFER_PROOF_KEYS <= obj.keys():
            last = obj
    if last is None:
        raise ValueError("no transfer-proof JSON object found in stream")
    return last


@dataclass
class PrivateCircuitInputs:
    secret: bytes                       # 32 bytes
    storage_proof: ProcessedStorageProof
    transfer_count: int                 # u64
    funding_account: bytes              # 32-byte digest
    unspendable_account: bytes          # 32-byte digest


@dataclass
class CircuitInputs:
    public: PublicCircuitInputs
    private: PrivateCircuitInputs
