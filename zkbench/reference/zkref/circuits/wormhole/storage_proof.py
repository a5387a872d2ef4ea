"""Storage-proof fragment: verifies a Substrate state-trie inclusion chain
inside the circuit.

Port of wormhole/circuit/src/storage_proof/mod.rs and
storage_proof/leaf.rs.  For each of MAX_PROOF_LEN=20 padded node slots:
(a) is_proof_node = i < proof_len; (b) Poseidon-hash the node and constrain
(h - prev_hash) * is_proof_node = 0; (c) scan node felts with is_equal to
extract the committed child hash (8x32-bit limbs recombined pairwise
lo + hi*2^32); (d) range-check every node felt to 32 bits; (e) leaf check:
H(leaf_inputs) must match prev_hash on the last 3 of 4 felts when
i == proof_len."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...iop.builder import CircuitBuilder
from ...iop.targets import HashOutTarget
from ...iop.witness import PartialWitness
from ...utils import codecs
from ..fragment import is_const_less_than
from .inputs import ProcessedStorageProof
from .substrate_account import SubstrateAccount

MAX_PROOF_LEN = 20           # storage_proof/mod.rs:22
PROOF_NODE_MAX_SIZE_F = 188  # mod.rs:23
PROOF_NODE_MAX_SIZE_B = 256  # mod.rs:24
FELTS_PER_U64 = 2
FELTS_PER_U128 = 4


@dataclass
class LeafTargets:
    """leaf.rs:17-56."""

    transfer_count: list      # 2 targets
    funding_account: HashOutTarget
    to_account: HashOutTarget
    funding_amount: list      # 4 targets (public inputs)

    @staticmethod
    def new(builder: CircuitBuilder) -> "LeafTargets":
        transfer_count = builder.add_virtual_targets(FELTS_PER_U64)
        funding_account = builder.add_virtual_hash()
        to_account = builder.add_virtual_hash()
        funding_amount = [builder.add_virtual_public_input() for _ in range(FELTS_PER_U128)]
        return LeafTargets(transfer_count, funding_account, to_account, funding_amount)

    def collect_to_vec(self) -> list:
        return (
            list(self.transfer_count)
            + list(self.funding_account.elements)
            + list(self.to_account.elements)
            + list(self.funding_amount)
        )

    def collect_32_bit_targets(self) -> list:
        return list(self.transfer_count) + list(self.funding_amount)


@dataclass
class LeafInputs:
    """leaf.rs:58-84."""

    transfer_count: np.ndarray      # (2,)
    funding_account: SubstrateAccount
    to_account: SubstrateAccount
    funding_amount: np.ndarray      # (4,)

    @staticmethod
    def new(transfer_count: int, funding_account: bytes, to_account: bytes,
            funding_amount: int) -> "LeafInputs":
        return LeafInputs(
            codecs.u64_to_felts(transfer_count),
            SubstrateAccount.from_bytes(funding_account),
            SubstrateAccount.from_bytes(to_account),
            codecs.u128_to_felts(funding_amount),
        )

    @staticmethod
    def from_inputs(inputs) -> "LeafInputs":
        return LeafInputs.new(
            inputs.private.transfer_count,
            inputs.private.funding_account,
            inputs.private.unspendable_account,
            inputs.public.funding_amount,
        )


@dataclass
class StorageProofTargets:
    root_hash: HashOutTarget       # public input
    proof_len: int
    proof_data: list               # MAX_PROOF_LEN x PROOF_NODE_MAX_SIZE_F targets
    indices: list                  # MAX_PROOF_LEN targets
    leaf_inputs: LeafTargets

    @staticmethod
    def new(builder: CircuitBuilder) -> "StorageProofTargets":
        proof_data = [
            builder.add_virtual_targets(PROOF_NODE_MAX_SIZE_F)
            for _ in range(MAX_PROOF_LEN)
        ]
        indices = builder.add_virtual_targets(MAX_PROOF_LEN)
        return StorageProofTargets(
            root_hash=builder.add_virtual_hash_public_input(),
            proof_len=builder.add_virtual_target(),
            proof_data=proof_data,
            indices=indices,
            leaf_inputs=LeafTargets.new(builder),
        )


@dataclass
class StorageProof:
    proof: list                     # list of np arrays (felts per node)
    indices: np.ndarray             # (len,) felt indices
    root_hash: bytes                # 32 bytes
    leaf_inputs: LeafInputs

    @staticmethod
    def new(processed: ProcessedStorageProof, root_hash: bytes,
            leaf_inputs: LeafInputs) -> "StorageProof":
        proof = [codecs.injective_bytes_to_felts(node) for node in processed.proof]
        # Byte-index -> felt-index: divide by 8 (mod.rs:105-113).
        indices = np.array(
            [i // (codecs.INJECTIVE_BYTES_PER_ELEMENT * 2) for i in processed.indices],
            dtype=np.uint64,
        )
        return StorageProof(proof, indices, root_hash, leaf_inputs)

    @staticmethod
    def from_inputs(inputs) -> "StorageProof":
        return StorageProof.new(
            inputs.private.storage_proof,
            inputs.public.root_hash,
            LeafInputs.from_inputs(inputs),
        )

    @staticmethod
    def circuit(t: StorageProofTargets, builder: CircuitBuilder) -> None:
        # Range-constrain transfer_count and funding_amount to 32 bits.
        for target in t.leaf_inputs.collect_32_bit_targets():
            builder.range_check(target, 32)

        leaf_inputs_hash = builder.hash_n_to_hash_no_pad(t.leaf_inputs.collect_to_vec())

        two_pow_32 = builder.constant(1 << 32)
        prev_hash = t.root_hash
        n_log = (MAX_PROOF_LEN - 1).bit_length()
        zero = builder.zero()
        for i in range(MAX_PROOF_LEN):
            node = t.proof_data[i]
            is_proof_node = is_const_less_than(builder, i, t.proof_len, n_log)
            i_t = builder.constant(i)
            is_leaf_node = builder.is_equal(i_t, t.proof_len)

            computed_hash = builder.hash_n_to_hash_no_pad(list(node))
            for y in range(4):
                diff = builder.sub(computed_hash.elements[y], prev_hash.elements[y])
                result = builder.mul(diff, is_proof_node.target)
                builder.connect(result, zero)

            # Extract the committed child hash at the witnessed felt index.
            found_hash = [zero, zero, zero, zero]
            expected_hash_index = t.indices[i]
            for j in range(PROOF_NODE_MAX_SIZE_F - 8):
                builder.range_check(node[j], 32)
                felt_index = builder.constant(j)
                is_start = builder.is_equal(felt_index, expected_hash_index)
                combined = []
                for h in range(4):
                    hi_shifted = builder.mul(node[j + 2 * h + 1], two_pow_32)
                    combined.append(builder.add(node[j + 2 * h], hi_shifted))
                for h in range(4):
                    found_hash[h] = builder.select(is_start, combined[h], found_hash[h])
            for j in range(PROOF_NODE_MAX_SIZE_F - 8, PROOF_NODE_MAX_SIZE_F):
                builder.range_check(node[j], 32)

            # Leaf check on the last 3 of 4 felts (mod.rs:232-240).
            for y in range(1, 4):
                diff = builder.sub(leaf_inputs_hash.elements[y], prev_hash.elements[y])
                result = builder.mul(diff, is_leaf_node.target)
                builder.connect(result, zero)

            prev_hash = HashOutTarget.from_list(found_hash)

    def fill_targets(self, pw: PartialWitness, t: StorageProofTargets) -> None:
        root = codecs.validate_bytes_digest(self.root_hash)
        pw.set_hash_target(t.root_hash, codecs.digest_bytes_to_felts(root))
        if len(self.proof) > MAX_PROOF_LEN:
            raise ValueError(
                f"proof length exceeds maximum allowed length: "
                f"{len(self.proof)} > {MAX_PROOF_LEN}"
            )
        pw.set_target(t.proof_len, len(self.proof))
        for i in range(MAX_PROOF_LEN):
            if i < len(self.proof):
                node = self.proof[i]
                if len(node) > PROOF_NODE_MAX_SIZE_F:
                    raise ValueError(f"proof node at index {i} is too large: {len(node)}")
                padded = np.zeros(PROOF_NODE_MAX_SIZE_F, dtype=np.uint64)
                padded[: len(node)] = node
            else:
                padded = np.zeros(PROOF_NODE_MAX_SIZE_F, dtype=np.uint64)
            pw.set_target_arr(t.proof_data[i], padded)
        for i in range(MAX_PROOF_LEN):
            felt = int(self.indices[i]) if i < len(self.indices) else 0
            pw.set_target(t.indices[i], felt)

        li = self.leaf_inputs
        pw.set_target_arr(t.leaf_inputs.transfer_count, li.transfer_count)
        pw.set_hash_target(t.leaf_inputs.funding_account, li.funding_account.account_id)
        pw.set_hash_target(t.leaf_inputs.to_account, li.to_account.account_id)
        pw.set_target_arr(t.leaf_inputs.funding_amount, li.funding_amount)
