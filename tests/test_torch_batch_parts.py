"""The pieces of the port's batched prover against the JAX package, integer
for integer: K1's tree over a leading proof axis (its plain version, which
the CPU runs), the batched commit of the wires stage, the batched PoW grind, the batched
query gathers and the packed fetch; and the zk config's batched proof."""

import jax
import numpy as np
import pytest
import torch

from test_torch_batch import check_batch_against_reference
from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.fri import fri as tfri
from zk_circuits_torch.fri import fri_device as tfri_device
from zk_circuits_torch.fri import oracle as toracle
from zk_circuits_torch.hash import merkle as tmerkle
from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.plonk import prover as tprover
from zk_circuits_torch.utils.fetch import fetch_packed
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.fri import fri as jfri
from zk_circuits_tpu.fri import fri_device as jfri_device
from zk_circuits_tpu.fri import oracle as joracle
from zk_circuits_tpu.hash import merkle as jmerkle
from zk_circuits_tpu.hash.merkle import MerkleTree

P = 2**64 - 2**32 + 1
U64 = np.uint64

torch.set_num_threads(1)


def _matrices(shape, seed):
    x = np.random.default_rng(seed).integers(0, P, shape, dtype=U64)
    x.reshape(-1)[:2] = [0, P - 1]
    return x


def test_prove_batch_zk_matches_reference_bytes():
    check_batch_against_reference(zk=True)


def test_batched_hash_tree_matches_jax_vmap():
    """B=3 column-major (12, 2^6) leaf matrices, cap height 2: the port's
    hash_tree over the (B, n, cols) view of a (B, cols, n) tensor equals
    jax.vmap of the JAX package's device_merkle_levels_values."""
    values = _matrices((3, 12, 64), 21)
    want = jax.vmap(lambda v: jmerkle.device_merkle_levels_values(v, 2))(
        jgf.from_u64(values))
    t = tgf.from_u64(values)
    for got in (poseidon_cuda.hash_tree(t.transpose(1, 2), 2),
                tmerkle.device_merkle_levels_values(t, 2)):
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.shape == (3, w.lo.shape[1], 4)
            assert np.array_equal(tgf.to_u64(g), jgf.to_u64(w))


@pytest.mark.parametrize("cols", [3, 8, 24])
def test_batched_tree_is_each_proofs_tree(cols):
    """Row-major batches, narrow leaves too: proof b's levels are
    MerkleTree.build of proof b's leaves, and hash_rows gives each proof's
    leaf digests."""
    leaves = _matrices((4, 32, cols), cols)
    got = tmerkle.device_merkle_levels(tgf.from_u64(leaves), 1)
    for b in range(4):
        want = MerkleTree.build(leaves[b], 1).levels
        assert [tgf.to_u64(g[b]).tolist() for g in got] == [w.tolist() for w in want]
    if cols > 4:
        assert np.array_equal(tgf.to_u64(poseidon_cuda.hash_rows(tgf.from_u64(leaves))),
                              np.stack([MerkleTree.build(x, 0).levels[0] for x in leaves]))


@pytest.mark.parametrize("blinding", [False, True])
def test_batch_commit_matches_jax(blinding):
    """The batched commit of prove_batch_device (the wires stage's INTT and
    salts, then one LDE and K1's B trees over the proof axis) against the
    JAX package's batch_from_coeffs / batch_from_values."""
    coeffs = _matrices((3, 5, 16), 31)
    want = joracle.batch_from_coeffs(coeffs, 3, 2, blinding=blinding, use_device=False)
    c = tgf.from_u64(coeffs)
    values, levels = toracle._device_commit_fn(tprover._with_salts(c) if blinding else c, 3, 2)
    assert values.shape[0] == len(want) == 3
    for b, w in enumerate(want):
        assert np.array_equal(tgf.to_u64(levels[-1][b]), w.cap)
        assert np.array_equal(tgf.to_u64(values[b]).T, w.leaves)
    values = _matrices((2, 5, 16), 32)
    want = joracle.batch_from_values(values, 3, 2, blinding=blinding, use_device=False)
    _, levels = toracle._device_commit_fn(
        tprover._device_wires_coeffs_fn(tgf.from_u64(values), blinding), 3, 2)
    assert [tgf.to_u64(g).tolist() for g in levels[-1]] == [w.cap.tolist() for w in want]


@pytest.mark.parametrize("bits,window", [(8, None), (10, 64)])
def test_pow_grind_batch_matches_jax(monkeypatch, bits, window):
    """Each base's smallest witness, as the JAX package's per-base host
    grind finds it; with a 64-candidate window the bases find theirs in
    different sweeps."""
    if window:
        monkeypatch.setitem(tfri.GRIND_BATCH, "cpu", window)
    bases = _matrices((5, 4), 40 + bits)
    want = jfri.proof_of_work_grind_batch(bases, bits)
    got = tfri.proof_of_work_grind_batch(bases, bits, "cpu")
    assert got == want
    assert len(set(got)) > 1
    for b, w in zip(bases, got):
        assert tfri.check_pow(b, w, bits)


@pytest.mark.parametrize("bits", [0, 65, -1])
def test_pow_bits_outside_1_to_64_are_refused_at_once(bits):
    """0 bits set a bound of 2^64, which no u64 hash lies below (the grind
    used to sweep to 2^40), and the JAX package refuses it too."""
    import time

    bases = _matrices((2, 4), 7)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="1..64"):
        tfri.proof_of_work_grind_batch(bases, bits, "cpu")
    with pytest.raises(ValueError, match="1..64"):
        tfri.proof_of_work_grind(bases[0], bits, "cpu")
    with pytest.raises(ValueError, match="1..64"):
        tfri.check_pow(bases[0], 0, bits)
    assert time.perf_counter() - t0 < 1.0
    if bits == 0:
        with pytest.raises(OverflowError):
            jfri.proof_of_work_grind_batch(bases, bits)


def test_gather_trees_batch_matches_jax():
    """A shared column-major tree (the constants/sigmas oracle) and a
    batched row-major one, B=3, 5 queries each."""
    B, n, Q = 3, 32, 5
    shared_vals = _matrices((6, n), 50)                   # (w, N)
    batched = _matrices((B, n, 10), 51)                   # (B, N, w)
    s_levels = MerkleTree.build(np.ascontiguousarray(shared_vals.T), 2).levels
    b_levels = [np.stack(lv) for lv in zip(*(MerkleTree.build(x, 2).levels for x in batched))]
    rng = np.random.default_rng(52)
    idxs = [rng.integers(0, n, (B, Q)), rng.integers(0, n, (B, Q))]
    want = jfri_device.gather_trees_batch(
        [(jgf.from_u64(shared_vals), tuple(jgf.from_u64(lv) for lv in s_levels)),
         (jgf.from_u64(batched), tuple(jgf.from_u64(lv) for lv in b_levels))],
        idxs, [True, False], [True, False])
    got = tfri_device.gather_trees_batch(
        [(tgf.from_u64(shared_vals), [tgf.from_u64(lv) for lv in s_levels]),
         (tgf.from_u64(batched), [tgf.from_u64(lv) for lv in b_levels])],
        idxs, [True, False], [True, False])
    for (gr, gs), (wr, ws) in zip(got, want):
        assert gr.shape == wr.shape and gs.shape == ws.shape
        assert np.array_equal(gr, wr) and np.array_equal(gs, ws)


def test_fetch_packed_keeps_shapes_and_values():
    arrs = [_matrices((3, 4, 4), 60), _matrices((2,), 61), np.zeros((0, 4), U64)]
    got = fetch_packed([tgf.from_u64(a) for a in arrs])
    assert [g.shape for g in got] == [a.shape for a in arrs]
    assert all(g.dtype == U64 and np.array_equal(g, a) for g, a in zip(got, arrs))
    assert fetch_packed([]) == []
