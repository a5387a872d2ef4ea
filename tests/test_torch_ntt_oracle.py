"""The port's NTT, Merkle levels and commit oracle against the JAX
package's host golden models (host_ntt and siblings, MerkleTree.build and
the host PolynomialBatch commit).  Integer equality throughout."""

import numpy as np
import pytest
import torch

from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.fri.oracle import PolynomialBatch as TBatch
from zk_circuits_torch.hash import merkle as tmerkle
from zk_circuits_torch.ntt import ntt as tntt
from zk_circuits_tpu.fri.oracle import PolynomialBatch as JBatch
from zk_circuits_tpu.hash.merkle import MerkleTree
from zk_circuits_tpu.ntt import ntt as jntt

P = 2**64 - 2**32 + 1
U64 = np.uint64

# One intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the machine.
torch.set_num_threads(1)


def _coeffs(k, n, seed):
    c = np.random.default_rng(seed).integers(0, P, (k, n), dtype=U64)
    c[0, :3] = [0, 1, P - 1][: min(n, 3)]
    return c


@pytest.mark.parametrize("n", [1, 2, 8, 256])
def test_transforms_match_host(n):
    c = _coeffs(3, n, n)
    t = tgf.from_u64(c)
    assert np.array_equal(tgf.to_u64(tntt.ntt(t)), jntt.host_ntt(c))
    assert np.array_equal(tgf.to_u64(tntt.intt(t)), jntt.host_intt(c))
    assert np.array_equal(tgf.to_u64(tntt.coset_ntt(t)), jntt.host_coset_ntt(c))
    assert np.array_equal(tgf.to_u64(tntt.coset_intt(t)), jntt.host_coset_intt(c))
    for rate_bits in (1, 3):
        assert np.array_equal(tgf.to_u64(tntt.lde(t, rate_bits)),
                              jntt.host_lde(c, rate_bits))
    # the port's own host copies agree with the reference's
    assert np.array_equal(tntt.host_ntt(c), jntt.host_ntt(c))
    assert np.array_equal(tntt.host_lde(c, 3), jntt.host_lde(c, 3))


@pytest.mark.parametrize("cols", [3, 4, 5, 32])
def test_merkle_levels_match_tree_build(cols):
    rng = np.random.default_rng(cols)
    leaves = rng.integers(0, P, (64, cols), dtype=U64)
    want = MerkleTree.build(leaves, 2).levels
    rows = tgf.from_u64(leaves)
    for got in (tmerkle.device_merkle_levels(rows, 2),
                tmerkle.device_merkle_levels_values(rows.t().contiguous(), 2)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(tgf.to_u64(g), w)
    tree = tmerkle.MerkleTree.build(leaves, 2)
    for i in (0, 17, 63):
        assert tmerkle.verify_merkle_proof(leaves[i], i, tree.cap, tree.prove(i))


@pytest.mark.parametrize("blinding", [False, True])
def test_commit_matches_host_commit(blinding):
    coeffs = _coeffs(13, 32, 5 + blinding)
    ref = JBatch.from_coeffs(coeffs, 3, 2, blinding=blinding, use_device=False)
    got = TBatch.from_coeffs(coeffs, 3, 2, blinding=blinding, device="cpu")
    assert np.array_equal(got.cap, ref.cap)
    assert len(got.levels) == len(ref.levels)
    for g, w in zip(got.levels, ref.levels):
        assert np.array_equal(g, w)
    assert np.array_equal(got.leaves, ref.leaves)
    assert np.array_equal(tgf.to_u64(got.coeffs_dev), ref.coeffs)
    idx = np.array([0, 1, 5, 200, 255, 128])
    rows, sibs = got.open_rows(idx)
    want_rows, want_sibs = ref.open_rows(idx)
    assert np.array_equal(rows, want_rows)
    assert np.array_equal(sibs, want_sibs)
    assert got.ensure_device("cpu") is got


def test_from_values_matches_host():
    vals = _coeffs(4, 64, 9)
    ref = JBatch.from_values(vals, 3, 4, use_device=False)
    got = TBatch.from_values(vals, 3, 4, device="cpu")
    assert np.array_equal(got.cap, ref.cap)
