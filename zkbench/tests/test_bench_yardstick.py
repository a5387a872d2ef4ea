"""The frozen count of the Poseidon work a proof needs, pinned at the
wormhole proof's shapes (LDE 2^16, cap height 4) and at the level-1
aggregation circuit's (LDE 2^17)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from zkbench.yardstick import hash_work as hw


@pytest.mark.parametrize("rows,cols,perms,nbytes", [
    (1 << 16, 139, 1245168, 77069824),     # wires (135 + 4 salts)
    (1 << 16, 24, 262128, 16776704),       # Zs and partial products (+ salts)
    (1 << 16, 20, 262128, 14679552),       # quotient (16 + 4 salts)
    (4096, 32, 20464, 1310208),            # FRI's first tree, fibers of 16
    (256, 32, 1264, 81408),                # FRI's second tree
    (1 << 17, 139, 2490352, 154140160),    # level-1 wires
])
def test_tree_work_at_the_main_path_shapes(rows, cols, perms, nbytes):
    assert hw.tree_work(rows, cols, 4) == (perms, nbytes)


@pytest.mark.parametrize("w", [0, 1, 6000, 131071])
def test_a_pow_witness_w_counts_w_plus_one_permutations(w):
    assert hw.pow_work(w) == (w + 1, (w + 1) * (5 * 8 + 32))


def test_the_bound_is_the_larger_of_multiplies_and_bytes():
    t, by = hw.bound_s(1245168, 77069824)
    assert by == "operations"
    assert t == pytest.approx(0.281087e-3, rel=1e-5)   # the wires tree's bound
    assert hw.MULS_PER_PERM == 3776
    assert hw.bound_s(1, 10**9)[1] == "bytes"


def _proof(widths, arities, pow_witness):
    step = [SimpleNamespace(coset_values=[0] * a) for a in arities]
    fri = SimpleNamespace(query_rounds=[SimpleNamespace(steps=step)], pow_witness=pow_witness)
    op = SimpleNamespace(wires=[0] * widths[0], zs_partial_products=[0] * widths[1],
                         quotient=[0] * widths[2])
    return SimpleNamespace(proof=SimpleNamespace(openings=op, opening_proof=fri))


def test_a_wormhole_proof_commits_five_trees():
    proof = _proof((139, 24, 20), (16, 16), 5000)
    assert hw.proof_trees(proof, 13, 3) == [(65536, 139), (65536, 24), (65536, 20),
                                            (4096, 32), (256, 32)]
    perms, _ = hw.proof_work(proof, 13, 3, 4)
    assert perms == 1245168 + 262128 * 2 + 20464 + 1264 + 5001
