"""The reference wormhole circuit, constructed on the upstream-layout
emulator (refbuild.RefBuilder) in the reference's EXACT op order.

Every call here mirrors a line of the in-tree reference source:
- targets:   wormhole/circuit/src/circuit.rs:53-60
- nullifier: nullifier.rs:200-208, 215-242
- unspendable: unspendable_account.rs:166-175, 181-208
- storage:   storage_proof/mod.rs:37-55, 140-244; leaf.rs:25-56
- exit:      substrate_account.rs:76-88
- shared:    circuit.rs:111-137
- gadget:    common/src/gadgets.rs:14-65 (is_const_less_than, xor)
"""

from __future__ import annotations

from ..utils import codecs
from .refbuild import RefBuilder

MAX_PROOF_LEN = 20
PROOF_NODE_MAX_SIZE_F = 188
SECRET_NUM_TARGETS = 8
TRANSFER_COUNT_NUM_TARGETS = 2
NULLIFIER_SALT = "~nullif~"
UNSPENDABLE_SALT = "wormhole"


def xor_gadget(b: RefBuilder, a, bb):
    ab = b.mul(a, bb)
    two_ab = b.mul_const(2, ab)
    a_plus_b = b.add(a, bb)
    return b.sub(a_plus_b, two_ab)


def is_const_less_than(b: RefBuilder, left: int, right, n_log: int):
    right_bits = b.split_le(right, n_log)
    left_bits = [((left >> i) & 1) != 0 for i in range(n_log)]
    lt = b._false()
    eq = b._true()
    for i in reversed(range(n_log)):
        a = b.constant_bool(left_bits[i])
        bit = right_bits[i]
        not_a = b.not_(a)
        not_a_and_b = b.and_(not_a, bit)
        this_lt = b.and_(not_a_and_b, eq)
        lt = b.or_(lt, this_lt)
        a_xor_b = xor_gadget(b, a, bit)
        not_xor = b.not_(a_xor_b)
        eq = b.and_(eq, not_xor)
    return lt


def build_wormhole_layout(zero_knowledge: bool = True):
    b = RefBuilder(zero_knowledge=zero_knowledge)

    # ---- CircuitTargets::new -------------------------------------------
    # NullifierTargets
    nul_hash = b.add_virtual_hash_public_input()
    nul_secret = b.add_virtual_targets(SECRET_NUM_TARGETS)
    nul_tc = [b.add_virtual_target() for _ in range(TRANSFER_COUNT_NUM_TARGETS)]
    # UnspendableAccountTargets
    uns_account = b.add_virtual_hash()
    uns_secret = b.add_virtual_targets(SECRET_NUM_TARGETS)
    # StorageProofTargets (let-bindings first: proof_data, indices)
    proof_data = [b.add_virtual_targets(PROOF_NODE_MAX_SIZE_F)
                  for _ in range(MAX_PROOF_LEN)]
    indices = [b.add_virtual_target() for _ in range(MAX_PROOF_LEN)]
    sp_root = b.add_virtual_hash_public_input()
    proof_len = b.add_virtual_target()
    # LeafTargets
    leaf_tc = [b.add_virtual_target() for _ in range(2)]
    leaf_funding = b.add_virtual_hash()
    leaf_to = b.add_virtual_hash()
    leaf_amount = [b.add_virtual_public_input() for _ in range(4)]
    # ExitAccountTargets
    exit_addr = b.add_virtual_hash_public_input()

    # ---- Nullifier::circuit --------------------------------------------
    salt = codecs.injective_string_to_felts(NULLIFIER_SALT)
    preimage = [b.constant(int(salt[0])), b.constant(int(salt[1]))]
    preimage += nul_secret
    preimage += nul_tc
    for t in preimage:
        b.range_check(t, 32)
    inner = b.hash_n_to_hash_no_pad(preimage)
    computed = b.hash_n_to_hash_no_pad(list(inner))
    b.connect_hashes(computed, nul_hash)

    # ---- UnspendableAccount::circuit -----------------------------------
    salt_u = codecs.injective_string_to_felts(UNSPENDABLE_SALT)
    pre_u = [b.constant(int(salt_u[0])), b.constant(int(salt_u[1]))]
    for t in pre_u:
        b.range_check(t, 32)
    pre_u += uns_secret
    inner_u = b.hash_n_to_hash_no_pad(pre_u)
    gen_acc = b.hash_n_to_hash_no_pad(list(inner_u))
    b.connect_hashes(gen_acc, uns_account)

    # ---- StorageProof::circuit -----------------------------------------
    leaf_32 = leaf_tc + leaf_amount
    for t in leaf_32:
        b.range_check(t, 32)
    leaf_vec = leaf_tc + leaf_funding + leaf_to + leaf_amount
    leaf_hash = b.hash_n_to_hash_no_pad(leaf_vec)
    two_pow_32 = b.constant(1 << 32)
    prev_hash = list(sp_root)
    n_log = 5  # usize::BITS - (MAX_PROOF_LEN-1).leading_zeros()
    for i in range(MAX_PROOF_LEN):
        node = proof_data[i]
        is_proof_node = is_const_less_than(b, i, proof_len, n_log)
        i_t = b.constant(i)
        is_leaf_node = b.is_equal(i_t, proof_len)
        computed_hash = b.hash_n_to_hash_no_pad(node)
        for y in range(4):
            diff = b.sub(computed_hash[y], prev_hash[y])
            result = b.mul(diff, is_proof_node)
            zero = b.zero()
            b.connect(result, zero)
        found_hash = [b.zero(), b.zero(), b.zero(), b.zero()]
        expected_hash_index = indices[i]
        for j in range(PROOF_NODE_MAX_SIZE_F - 8):
            felt = node[j]
            b.range_check(felt, 32)
            felt_index = b.constant(j)
            is_start = b.is_equal(felt_index, expected_hash_index)

            def combine(lo, hi):
                hi_shifted = b.mul(hi, two_pow_32)
                return b.add(lo, hi_shifted)

            h0 = combine(node[j], node[j + 1])
            h1 = combine(node[j + 2], node[j + 3])
            h2 = combine(node[j + 4], node[j + 5])
            h3 = combine(node[j + 6], node[j + 7])
            found_hash[0] = b.select(is_start, h0, found_hash[0])
            found_hash[1] = b.select(is_start, h1, found_hash[1])
            found_hash[2] = b.select(is_start, h2, found_hash[2])
            found_hash[3] = b.select(is_start, h3, found_hash[3])
        for j in range(PROOF_NODE_MAX_SIZE_F - 8, PROOF_NODE_MAX_SIZE_F):
            b.range_check(node[j], 32)
        for y in range(1, 4):
            diff = b.sub(leaf_hash[y], prev_hash[y])
            result = b.mul(diff, is_leaf_node)
            zero = b.zero()
            b.connect(result, zero)
        prev_hash = found_hash

    # ---- SubstrateAccount::circuit: no-op ------------------------------

    # ---- connect_shared_targets ----------------------------------------
    for a, c in zip(nul_secret, uns_secret):
        b.connect(a, c)
    for a, c in zip(nul_tc, leaf_tc):
        b.connect(a, c)
    b.connect_hashes(uns_account, leaf_to)

    return b.build()
