"""Unspendable-account fragment.

Port of wormhole/circuit/src/unspendable_account.rs:
account_id = H(H("wormhole" ‖ secret(8 felts))); account_id stays private
(virtual hash, not a public input)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...host import poseidon as hposeidon
from ...iop.builder import CircuitBuilder
from ...iop.targets import HashOutTarget
from ...iop.witness import PartialWitness
from ...utils import codecs

UNSPENDABLE_SALT = "wormhole"
SECRET_NUM_TARGETS = 8


@dataclass
class UnspendableAccount:
    account_id: np.ndarray  # Digest (4,)
    secret: np.ndarray      # (8,)

    @staticmethod
    def new(account_id: bytes, secret: bytes) -> "UnspendableAccount":
        return UnspendableAccount(
            codecs.digest_bytes_to_felts(account_id),
            codecs.injective_bytes_to_felts(secret),
        )

    @staticmethod
    def from_secret(secret: bytes) -> "UnspendableAccount":
        assert len(secret) == 32
        salt = codecs.injective_string_to_felts(UNSPENDABLE_SALT)
        secret_felts = codecs.injective_bytes_to_felts(secret)
        preimage = np.concatenate([salt, secret_felts])
        inner = hposeidon.hash_no_pad(preimage)
        outer = hposeidon.hash_no_pad(inner)
        return UnspendableAccount(outer, secret_felts)

    @staticmethod
    def from_inputs(inputs) -> "UnspendableAccount":
        return UnspendableAccount.new(
            inputs.private.unspendable_account, inputs.private.secret
        )

    @staticmethod
    def circuit(t: "UnspendableAccountTargets", builder: CircuitBuilder) -> None:
        salt = codecs.injective_string_to_felts(UNSPENDABLE_SALT)
        preimage = [builder.constant(int(salt[0])), builder.constant(int(salt[1]))]
        # Salt range checks (unspendable_account.rs:193-196); the secret's
        # range check is delegated to the nullifier fragment.
        for target in preimage:
            builder.range_check(target, 32)
        preimage += list(t.secret)
        inner = builder.hash_n_to_hash_no_pad(preimage)
        generated = builder.hash_n_to_hash_no_pad(list(inner.elements))
        builder.connect_hashes(generated, t.account_id)

    def fill_targets(self, pw: PartialWitness, t: "UnspendableAccountTargets") -> None:
        pw.set_hash_target(t.account_id, self.account_id)
        pw.set_target_arr(t.secret, self.secret)


@dataclass
class UnspendableAccountTargets:
    account_id: HashOutTarget
    secret: list

    @staticmethod
    def new(builder: CircuitBuilder) -> "UnspendableAccountTargets":
        return UnspendableAccountTargets(
            account_id=builder.add_virtual_hash(),
            secret=builder.add_virtual_targets(SECRET_NUM_TARGETS),
        )
