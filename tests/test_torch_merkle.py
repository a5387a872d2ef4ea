"""The plain version of K1's tree mode (poseidon_cuda.hash_tree on CPU
tensors, and the Merkle builders routed through it) against the JAX
package's host MerkleTree.build, integer for integer, for row-major and
column-major leaves."""

import numpy as np
import pytest
import torch

from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.hash import merkle as tmerkle
from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_tpu.hash.merkle import MerkleTree

P = 2**64 - 2**32 + 1
U64 = np.uint64

torch.set_num_threads(1)


def _leaves(n, cols, seed):
    x = np.random.default_rng(seed).integers(0, P, (n, cols), dtype=U64)
    x[0] = P - 1
    return x


@pytest.mark.parametrize("cols", [3, 5, 8, 32, 139])
@pytest.mark.parametrize("n,cap_height", [(16, 0), (32, 2), (64, 4)])
def test_hash_tree_plain_matches_merkle_build(n, cols, cap_height):
    x = _leaves(n, cols, n * 1000 + cols)
    want = MerkleTree.build(x, cap_height).levels
    rows = tgf.from_u64(x)
    values = rows.t().contiguous()          # column-major (cols, n)
    for name, got in (
            ("row-major", poseidon_cuda.hash_tree(rows, cap_height)),
            ("column-major", poseidon_cuda.hash_tree(values.t(), cap_height)),
            ("device_merkle_levels", tmerkle.device_merkle_levels(rows, cap_height)),
            ("device_merkle_levels_values",
             tmerkle.device_merkle_levels_values(values, cap_height))):
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert np.array_equal(tgf.to_u64(g), w), name


def test_hash_tree_rejects_bad_leaf_counts():
    x = tgf.from_u64(_leaves(24, 8, 1))
    with pytest.raises(ValueError):
        poseidon_cuda.hash_tree(x, 2)
    with pytest.raises(ValueError):
        poseidon_cuda.hash_tree(x[:8], 4)


def test_tree_plan_counts_launches():
    """The wormhole's trees at 128 rows per block: the commits (2^16 leaves,
    cap height 4) and the first FRI tree (2^12) need a top launch, the
    second FRI tree (2^8) does not."""
    for n, top in ((1 << 16, True), (1 << 12, True), (1 << 8, False)):
        plan = poseidon_cuda.tree_plan(n, 4, rows=128)
        assert plan["depth"] == n.bit_length() - 5
        assert bool(plan["top_threads"]) == top
        assert plan["sizes"][-1] == 16 and sum(plan["sizes"]) == 2 * n - 16
