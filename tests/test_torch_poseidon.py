"""The port's Poseidon sponge (the plain version of the leaf kernel K1)
against the JAX package: its numpy golden model, its XLA sponge, and K1
itself run in Pallas interpret mode.  Digests are compared for equality."""

import numpy as np
import pytest
import torch

from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.fri import fri as tfri
from zk_circuits_torch.hash import poseidon as tpos
from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.hash import poseidon_pallas as tpp
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.fri import fri as jfri
from zk_circuits_tpu.hash import poseidon as jpos
from zk_circuits_tpu.hash import poseidon_pallas as jpp
from zk_circuits_tpu.host import poseidon as hpos

P = 2**64 - 2**32 + 1
U64 = np.uint64

# One intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the machine.
torch.set_num_threads(1)


def _leaves(n, cols, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, (n, cols), dtype=U64)
    x[0] = 0
    x[1] = 1
    x[2] = P - 1
    x[3, : min(cols, 3)] = [0, 1, P - 1][: min(cols, 3)]
    return x


def test_permute_matches_host_and_jax():
    x = _leaves(64, 12, 1)
    got = tgf.to_u64(tpos.permute(tgf.from_u64(x)))
    assert np.array_equal(got, hpos.permute(x))
    assert np.array_equal(got, jgf.to_u64(jpos.permute(jgf.from_u64(x))))


@pytest.mark.parametrize("cols", [5, 8, 11, 16, 20, 32, 135, 139])
def test_sponge_and_plain_k1_match_jax(cols):
    for n in (128, 256):
        x = _leaves(n, cols, cols * 1000 + n)
        want = hpos.batch_hash_no_pad(x)
        t = tgf.from_u64(x)
        got = tgf.to_u64(tpos.batch_hash_no_pad(t))
        assert np.array_equal(got, want)
        assert (got < U64(P)).all()
        # the kernel's entry points, plain version on CPU tensors
        assert np.array_equal(tgf.to_u64(tpp.hash_leaves(t)), want)
        assert np.array_equal(tgf.to_u64(tpp.hash_values(t.t().contiguous())), want)
        if n == 128:
            xla = jgf.to_u64(jpos.batch_hash_no_pad(jgf.from_u64(x)))
            assert np.array_equal(got, xla)


def test_plain_k1_matches_jax_pallas_kernel_interpret():
    """The JAX K1 itself (_leaf_hash_kernel in interpret mode), column-major
    entry point, cols=5."""
    x = _leaves(128, 5, 77)
    jax_k1 = jgf.to_u64(jpp.hash_values(jgf.from_u64(np.ascontiguousarray(x.T)),
                                        interpret=True))
    got = tgf.to_u64(tpp.hash_values(tgf.from_u64(np.ascontiguousarray(x.T))))
    assert np.array_equal(got, jax_k1)
    assert np.array_equal(got, hpos.batch_hash_no_pad(x))


def test_compress_and_hash_or_noop():
    rng = np.random.default_rng(3)
    left = rng.integers(0, P, (64, 4), dtype=U64)
    right = rng.integers(0, P, (64, 4), dtype=U64)
    got = tgf.to_u64(tpos.batch_compress(tgf.from_u64(left), tgf.from_u64(right)))
    assert np.array_equal(got, hpos.compress(left, right))
    assert np.array_equal(got, jgf.to_u64(jpos.batch_compress(jgf.from_u64(left),
                                                              jgf.from_u64(right))))
    # the identity the Merkle compress levels rely on: compress(l, r) is
    # hash_no_pad(l || r), i.e. one leaf-kernel launch on (m/2, 8) rows
    level = tgf.from_u64(np.stack([left, right], axis=1).reshape(128, 4))
    assert np.array_equal(tgf.to_u64(tpp.hash_leaves(level.reshape(64, 8))), got)
    narrow = rng.integers(0, P, (16, 3), dtype=U64)
    padded = tgf.to_u64(tpos.batch_hash_or_noop(tgf.from_u64(narrow)))
    assert np.array_equal(padded[:, :3], narrow) and not padded[:, 3].any()


@pytest.mark.parametrize("pow_bits", [8, 12])
def test_grind_returns_the_smallest_witness(pow_bits):
    rng = np.random.default_rng(pow_bits)
    threshold = U64(1 << (64 - pow_bits))
    for _ in range(3):
        base = rng.integers(0, P, 4, dtype=U64)
        want = jfri._host_grind(base, threshold, 0)
        got = tfri.proof_of_work_grind(base, pow_bits, "cpu")
        assert got == want
        assert tfri.check_pow(base, got, pow_bits)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        poseidon_cuda.hash_rows(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        poseidon_cuda.hash_rows(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        poseidon_cuda.hash_rows(torch.zeros((4, 0), dtype=torch.int64))
    assert poseidon_cuda.launches == 0   # the CPU path never counts a launch


def test_constants_header_holds_the_tables():
    text = poseidon_cuda.constants_header()
    from zk_circuits_torch.hash import constants as c

    for v in c.ALL_ROUND_CONSTANTS:
        assert f"0x{v:016x}ULL" in text
    assert text.count("ULL;") == 24  # 12 circulant + 12 diagonal cases
