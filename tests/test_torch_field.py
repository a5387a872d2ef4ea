"""The port's int64 Goldilocks layer against the JAX package's field layers:
the numpy golden model (host/gl.py, host/gle.py) and the 2x32-bit limb
device field (field/goldilocks.py).  Goldilocks is exact: every comparison
is integer equality."""

import numpy as np
import pytest
import torch

from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.fri import fri_device as jfd
from zk_circuits_tpu.host import gl, gle

P = gl.P_INT
U64 = np.uint64
EDGE = [0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, 7]

# One intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the machine.
torch.set_num_threads(1)


def _pair(seed, n=300):
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.array(EDGE, U64), rng.integers(0, P, n, dtype=U64)])
    b = np.concatenate([np.array(EDGE[::-1], U64), rng.integers(0, P, n, dtype=U64)])
    return a, b


def _t(x):
    return tgf.from_u64(x)


def _j(x):
    return jgf.to_u64(x)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_host_and_jax(op):
    a, b = _pair(1)
    got = tgf.to_u64(getattr(tgf, op)(_t(a), _t(b)))
    assert np.array_equal(got, getattr(gl, op)(a, b))
    assert np.array_equal(got, _j(getattr(jgf, op)(jgf.from_u64(a), jgf.from_u64(b))))


@pytest.mark.parametrize("op", ["neg", "square", "inverse"])
def test_unary_ops_match_host_and_jax(op):
    a, _ = _pair(2, 100)
    got = tgf.to_u64(getattr(tgf, op)(_t(a)))
    assert np.array_equal(got, _j(getattr(jgf, op)(jgf.from_u64(a))))
    want = {"neg": gl.neg, "square": gl.square, "inverse": gl.inverse}[op](a)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("e", [0, 1, 5, 15, 16, 7 * 2**40 + 3, P - 2])
def test_powmod_matches_host_and_jax(e):
    a, _ = _pair(3, 50)
    got = tgf.to_u64(tgf.powmod(_t(a), e))
    assert np.array_equal(got, gl.powmod(a, e))
    assert np.array_equal(got, _j(jgf.powmod(jgf.from_u64(a), e)))


@pytest.mark.parametrize("c", [0, 1, 7, 2**32 + 5, P - 1])
def test_mul_const_matches_jax(c):
    a, _ = _pair(4, 100)
    got = tgf.to_u64(tgf.mul_const(_t(a), c))
    assert np.array_equal(got, _j(jgf.mul_const(jgf.from_u64(a), c)))


def test_select_equal_sum_mod():
    a, b = _pair(5, 99)
    mask = np.arange(a.size) % 3 == 0
    got = tgf.select(torch.from_numpy(mask), _t(a), _t(b))
    assert np.array_equal(tgf.to_u64(got), np.where(mask, a, b))
    assert np.array_equal(tgf.equal(_t(a), _t(a.copy())).numpy(), np.ones(a.size, bool))
    assert np.array_equal(tgf.equal(_t(a), _t(b)).numpy(), a == b)
    m = np.stack([a, b, a])                                  # (3, 108): odd folds
    for axis in (0, 1, -1):
        got = tgf.to_u64(tgf.sum_mod(_t(m), axis=axis))
        assert np.array_equal(got, gl.sum_mod(m, axis=axis))
        assert np.array_equal(got, _j(jgf.sum_mod(jgf.from_u64(m), axis=axis)))


def test_from_to_u64_roundtrip_and_canonicalises():
    x = np.array([0, 1, P - 1, P, P + 5, 2**64 - 1], dtype=U64)
    t = tgf.from_u64(x)
    assert t.dtype == torch.int64
    assert np.array_equal(tgf.to_u64(t), gl.asfelt(x))
    assert np.array_equal(tgf.to_u64(t), _j(jgf.from_u64(x)))


def test_non_canonical_inputs():
    """2^64 - 1 is the kind of value a lazy reduction leaves behind: mul
    and canon must treat it as its residue, and add must when the other
    operand is canonical (the sponge's state + round constant)."""
    nc = np.full(len(EDGE), 2**64 - 1, dtype=U64)
    res = (2**64 - 1) % P
    b = np.array(EDGE, U64)
    want_mul = np.array([res * int(v) % P for v in b], U64)
    want_add = np.array([(res + int(v)) % P for v in b], U64)
    assert np.array_equal(tgf.to_u64(tgf.mul(_t(nc), _t(b))), want_mul)
    assert np.array_equal(tgf.to_u64(tgf.mul(_t(b), _t(nc))), want_mul)
    raw = torch.full((len(EDGE),), -1, dtype=torch.int64)  # u64 2^64 - 1
    assert np.array_equal(tgf.to_u64(tgf.mul(raw, _t(b))), want_mul)
    assert np.array_equal(tgf.to_u64(tgf.add(raw, _t(b))), want_add)
    assert np.array_equal(tgf.to_u64(tgf.canon(raw)), np.full(len(EDGE), res, U64))
    lo = torch.tensor([-1, 5, -1], dtype=torch.int64)
    hi = torch.tensor([-1, 0, 3], dtype=torch.int64)
    want = [((2**64 - 1) + ((2**64 - 1) << 64)) % P, 5, ((2**64 - 1) + (3 << 64)) % P]
    assert tgf.to_u64(tgf.reduce128(lo, hi)).tolist() == want


def test_prefix_prod_matches_host():
    a, _ = _pair(6, 91)
    a = np.where(a == 0, U64(3), a)
    want = np.empty_like(a)
    acc = 1
    for i, v in enumerate(a):
        acc = acc * int(v) % P
        want[i] = acc
    assert np.array_equal(tgf.to_u64(tgf.prefix_prod(_t(a))), want)


def test_extension_helpers_match_gle_and_jax():
    a, b = _pair(7, 60)
    x = np.stack([a, b], axis=-1)
    y = np.stack([b[::-1], a[::-1]], axis=-1).copy()
    got_mul = tgf.to_ext(*tgf.emul(*tgf.ext_pair(x), *tgf.ext_pair(y)))
    got_add = tgf.to_ext(*tgf.eadd(*tgf.ext_pair(x), *tgf.ext_pair(y)))
    assert np.array_equal(got_mul, gle.mul(x, y))
    assert np.array_equal(got_add, gle.add(x, y))
    jx = jfd._ext_pair(x)
    jy = jfd._ext_pair(y)
    assert np.array_equal(got_mul, jfd._to_ext(*jfd._emul(*jx, *jy)))
