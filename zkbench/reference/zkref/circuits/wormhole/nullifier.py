"""Nullifier fragment.

Port of wormhole/circuit/src/nullifier.rs: the nullifier is
H(H("~nullif~" ‖ secret(8 felts) ‖ transfer_count(2 felts))) with every
preimage felt range-checked to 32 bits; the hash is a public input."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...host import poseidon as hposeidon
from ...iop.builder import CircuitBuilder
from ...iop.targets import HashOutTarget
from ...iop.witness import PartialWitness
from ...utils import codecs

NULLIFIER_SALT = "~nullif~"
SECRET_NUM_TARGETS = 8
TRANSFER_COUNT_NUM_TARGETS = 2


@dataclass
class Nullifier:
    hash: np.ndarray            # Digest (4,)
    secret: np.ndarray          # (8,) injective felts
    transfer_count: np.ndarray  # (2,)

    @staticmethod
    def new(digest: bytes, secret: bytes, transfer_count: int) -> "Nullifier":
        return Nullifier(
            codecs.digest_bytes_to_felts(digest),
            codecs.injective_bytes_to_felts(secret),
            codecs.u64_to_felts(transfer_count),
        )

    @staticmethod
    def from_preimage(secret: bytes, transfer_count: int) -> "Nullifier":
        salt = codecs.injective_string_to_felts(NULLIFIER_SALT)
        secret_felts = codecs.injective_bytes_to_felts(secret)
        tc = codecs.u64_to_felts(transfer_count)
        preimage = np.concatenate([salt, secret_felts, tc])
        inner = hposeidon.hash_no_pad(preimage)
        outer = hposeidon.hash_no_pad(inner)
        return Nullifier(outer, secret_felts, tc)

    @staticmethod
    def from_inputs(inputs) -> "Nullifier":
        return Nullifier.new(
            inputs.public.nullifier, inputs.private.secret, inputs.private.transfer_count
        )

    @staticmethod
    def circuit(t: "NullifierTargets", builder: CircuitBuilder) -> None:
        salt = codecs.injective_string_to_felts(NULLIFIER_SALT)
        preimage = [builder.constant(int(salt[0])), builder.constant(int(salt[1]))]
        preimage += list(t.secret)
        preimage += list(t.transfer_count)
        for target in preimage:
            builder.range_check(target, 32)
        inner = builder.hash_n_to_hash_no_pad(preimage)
        computed = builder.hash_n_to_hash_no_pad(list(inner.elements))
        builder.connect_hashes(computed, t.hash)

    def fill_targets(self, pw: PartialWitness, t: "NullifierTargets") -> None:
        pw.set_hash_target(t.hash, self.hash)
        pw.set_target_arr(t.secret, self.secret)
        pw.set_target_arr(t.transfer_count, self.transfer_count)


@dataclass
class NullifierTargets:
    hash: HashOutTarget
    secret: list
    transfer_count: list

    @staticmethod
    def new(builder: CircuitBuilder) -> "NullifierTargets":
        return NullifierTargets(
            hash=builder.add_virtual_hash_public_input(),
            secret=builder.add_virtual_targets(SECRET_NUM_TARGETS),
            transfer_count=builder.add_virtual_targets(TRANSFER_COUNT_NUM_TARGETS),
        )
