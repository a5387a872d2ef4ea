"""The port's host runtime against its numpy plain versions and the JAX
package, equal integers.

zk_circuits_torch.native loads csrc/host_native.cpp, which g++ builds
here at first use from the port's own headers (goldilocks.cuh,
poseidon.cuh).  host/gl.py, host/poseidon.py, hash/merkle.py and
ntt/ntt.py route through it; their numpy bodies stay as ``_np``/``_plain``
functions.  Each native function is held to that body and to the JAX
package's host function on inputs made with numpy from a seed, at small
sizes: the field operations with edge values (2^64 - 1 as a
non-canonical input), powers, the permutation (every lane canonical), the
sponge, the leaf hash, compression, Merkle caps, the NTT, INTT and coset
LDE, and a challenger transcript.  Then the ChaCha8 stream behind the
round constants, and a build that fails.
"""

import numpy as np
import pytest
import torch

from zk_circuits_torch import native
from zk_circuits_torch.hash import constants as tconst
from zk_circuits_torch.hash import merkle as tmerkle
from zk_circuits_torch.hash.challenger import Challenger as TChallenger
from zk_circuits_torch.host import gl as tgl
from zk_circuits_torch.host import poseidon as tpos
from zk_circuits_torch.ntt import ntt as tntt
from zk_circuits_torch.utils import chacha as tchacha
from zk_circuits_torch.utils import nvcc
from zk_circuits_tpu.hash import merkle as jmerkle
from zk_circuits_tpu.hash.challenger import Challenger as JChallenger
from zk_circuits_tpu.host import gl as jgl
from zk_circuits_tpu.host import poseidon as jpos
from zk_circuits_tpu.ntt import ntt as jntt
from zk_circuits_tpu.utils import chacha as jchacha

P = tgl.P_INT
M = 2**64 - 1
EDGE = [0, 1, P - 1, P - 2, 2**32 - 1, M]   # M: a non-canonical input
U64 = np.uint64
# Pairs of non-canonical inputs on which the JAX package's numpy field
# bodies (its host functions below 2^13 elements, and its sub at every
# size) return a value that is not the canonical result; the port's
# native and numpy bodies are exact there.
JAX_NOT_EXACT = {"add": {(M, M)}, "sub": {(0, M), (1, M), (M, 0), (M, 1)}, "mul": set()}
OPS = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
       "mul": lambda x, y: (x * y) % P}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _felts(rng, *shape):
    return rng.integers(0, P, shape, dtype=U64)


# --- the field ---------------------------------------------------------------


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_field_ops_with_edge_values(op):
    rng = np.random.default_rng(1)
    grid = np.array(EDGE, U64)
    a = np.concatenate([np.repeat(grid, grid.size), rng.integers(0, 2**64, 4000, dtype=U64)])
    b = np.concatenate([np.tile(grid, grid.size), rng.integers(0, 2**64, 4000, dtype=U64)])
    want = np.array([OPS[op](int(x), int(y)) for x, y in zip(a, b)], U64)
    got = getattr(native, "gl_" + op)(a, b)
    assert np.array_equal(got, want)
    assert np.array_equal(getattr(tgl, f"_{op}_np")(a, b), want)
    # the routed function: numpy below 2^13 elements, native from there
    reps = tgl._NATIVE_MUL_MIN // a.size + 1
    assert np.array_equal(getattr(tgl, op)(a, b), want)
    assert np.array_equal(getattr(tgl, op)(np.tile(a, reps), np.tile(b, reps))[:a.size], want)
    jax_got = getattr(jgl, op)(a, b)
    off = {(int(x), int(y)) for x, y, g, w in zip(a, b, jax_got, want) if g != w}
    assert off == JAX_NOT_EXACT[op]


def test_field_ops_broadcast_and_inverse():
    rng = np.random.default_rng(2)
    a, b = _felts(rng, 128), _felts(rng, 128)
    for op in ("add", "sub", "mul"):     # 2^14 elements: the native path
        got = getattr(tgl, op)(a[:, None], b[None, :])
        assert got.shape == (128, 128)
        assert np.array_equal(got, getattr(tgl, f"_{op}_np")(a[:, None], b[None, :]))
        assert np.array_equal(got, getattr(jgl, op)(a[:, None], b[None, :]))
    s = U64(rng.integers(0, P, dtype=U64))
    assert np.array_equal(tgl.mul(s, np.tile(a, 64)), tgl._mul_np(s, np.tile(a, 64)))
    x = np.array(EDGE + [5, 7], U64)
    want = np.array([pow(int(v), P - 2, P) for v in x], U64)
    assert np.array_equal(native.gl_inv(x), want)
    assert np.array_equal(native.gl_inv(x), jgl.inverse(x))


@pytest.mark.parametrize("n", [1, 100, 1 << 13, 3 << 13])
def test_powers(n):
    base = int(np.random.default_rng(n).integers(1, P, dtype=U64))
    acc, want = 1, np.empty(n, U64)
    for i in range(n):
        want[i] = acc
        acc = acc * base % P
    assert np.array_equal(tgl.powers(base, n), want)
    assert np.array_equal(native.gl_powers(base, n), want)
    assert np.array_equal(tgl._powers_np(base, n), want)
    assert np.array_equal(jgl.powers(base, n), want)


# --- Poseidon ------------------------------------------------------------------


def test_permute_batch_and_one_state():
    rng = np.random.default_rng(3)
    states = _felts(rng, 40, 12)
    for i, v in enumerate(EDGE):     # whole states of each edge value
        states[i] = v
    states[len(EDGE), :len(EDGE)] = EDGE
    got = tpos.permute(states)
    assert got.shape == states.shape and np.all(got < U64(P))
    assert np.array_equal(got, tpos.permute_plain(states))
    assert np.array_equal(got, jpos.permute(states))
    for s in states[: len(EDGE) + 1]:   # one state of shape (12,), the challenger's
        one = tpos.permute(s)
        assert one.shape == (12,) and np.all(one < U64(P))
        assert np.array_equal(one, jpos.permute(s.copy()))
    torch.set_num_threads(3)            # the thread count the loops take
    try:
        assert np.array_equal(tpos.permute(states), got)
    finally:
        torch.set_num_threads(1)


def _mds_inverse() -> list:
    """The inverse of the MDS matrix mod p (Gauss-Jordan on Python ints)."""
    w = tconst.WIDTH
    a = [[tconst.MDS_MATRIX_CIRC[(i - r) % w] + (tconst.MDS_MATRIX_DIAG[r] if r == i else 0)
          for i in range(w)] + [int(r == i) for i in range(w)] for r in range(w)]
    for c in range(w):
        piv = next(r for r in range(c, w) if a[r][c] % P)
        a[c], a[piv] = a[piv], a[c]
        inv = pow(a[c][c], P - 2, P)
        a[c] = [v * inv % P for v in a[c]]
        for r in range(w):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[c])]
    return [row[w:] for row in a]


def _reduce_split(lo: int, hi: int) -> int:
    """csrc/goldilocks.cuh's gl_reduce_split on Python ints: the lane the
    last MDS layer leaves, before any canonicalisation."""
    x = lo + ((hi << 32) & M)
    h = (hi >> 32) + (x >> 64)
    r = (x & M) + (((h << 32) - h) & M)
    return ((r & M) + (2**32 - 1 if r >> 64 else 0)) & M


def test_permute_canonicalizes_every_lane():
    """A state whose last MDS layer leaves lane 0 in [p, 2^64): the state
    before that layer is (s0, 0, ..., 0), so lane 0's halves are 25 times
    s0's (MDS[0][0] = 25), and the input is found by running the
    permutation backwards (inverse MDS, x^(1/7), round constants
    subtracted).  The returned lane must be canonical."""
    rng = np.random.default_rng(6)
    while True:
        s0 = int(rng.integers(-(-P // 25), M // 25, dtype=U64))
        if _reduce_split(25 * (s0 & 0xFFFFFFFF), 25 * (s0 >> 32)) >= P:
            break
    mds_inv, d, w = _mds_inverse(), pow(7, -1, P - 1), tconst.WIDTH
    rc = tconst.ALL_ROUND_CONSTANTS
    state = [s0] + [0] * (w - 1)
    for r in range(tconst.N_ROUNDS - 1, -1, -1):
        if r < tconst.N_ROUNDS - 1:
            state = [sum(mds_inv[i][j] * state[j] for j in range(w)) % P for i in range(w)]
        full = r < tconst.HALF_N_FULL_ROUNDS or r >= tconst.N_ROUNDS - tconst.HALF_N_FULL_ROUNDS
        state = [pow(v, d, P) if full or i == 0 else v for i, v in enumerate(state)]
        state = [(v - rc[r * w + i]) % P for i, v in enumerate(state)]
    x = np.array(state, U64)
    got = tpos.permute(x)
    assert int(got[0]) == 25 * s0 % P
    assert np.all(got < U64(P))
    assert np.array_equal(got, tpos.permute_plain(x))
    assert np.array_equal(got, jpos.permute(x.copy()))


@pytest.mark.parametrize("length", [0, 1, 8, 9, 135])
def test_hash_no_pad_batch(length):
    x = _felts(np.random.default_rng(length), 12, length)   # a batch of 12 > 8: native
    got = tpos.batch_hash_no_pad(x)
    assert got.shape == (12, 4)
    assert np.array_equal(got, native.hash_no_pad_batch(x))
    assert np.array_equal(got, tpos.batch_hash_no_pad_plain(x))
    assert np.array_equal(got, jpos.batch_hash_no_pad(x))
    assert np.array_equal(tpos.batch_hash_no_pad(x[:3]), got[:3])   # <= 8: the numpy loop
    if length:
        assert np.array_equal(got[0], jpos.hash_no_pad(x[0]))


@pytest.mark.parametrize("or_noop", [True, False])
@pytest.mark.parametrize("cols", [3, 4, 7, 135])
def test_hash_leaves(cols, or_noop):
    rng = np.random.default_rng(cols)
    leaves = _felts(rng, 20, cols)
    got = native.hash_leaves(leaves, or_noop=or_noop)
    if or_noop:
        want = np.stack([jpos.hash_or_noop(r) for r in leaves])
        assert np.array_equal(got, np.stack([tpos.hash_or_noop(r) for r in leaves]))
    else:
        want = jpos.batch_hash_no_pad(leaves)
        assert np.array_equal(got, tpos.batch_hash_no_pad_plain(leaves))
    assert np.array_equal(got, want)
    if not or_noop or cols > 4:
        assert np.array_equal(got, tpos.batch_hash_no_pad_plain(leaves))


def test_compress_level():
    d = _felts(np.random.default_rng(4), 32, 4)
    got = native.compress_level(d)
    state = np.concatenate([d[0::2], d[1::2], np.zeros((16, 4), U64)], axis=1)
    assert np.array_equal(got, tpos.permute_plain(state)[:, :4])
    assert np.array_equal(got, jpos.compress(d[0::2], d[1::2]))
    assert np.array_equal(got, tpos.compress(d[0::2], d[1::2]))


@pytest.mark.parametrize("cap_height", [0, 4])
@pytest.mark.parametrize("cols", [3, 135])
def test_merkle_tree_build(cap_height, cols):
    leaves = _felts(np.random.default_rng(cols + cap_height), 64, cols)
    got = tmerkle.MerkleTree.build(leaves, cap_height)
    want = jmerkle.MerkleTree.build(leaves, cap_height)
    assert len(got.levels) == len(want.levels) == 7 - cap_height
    for g, w in zip(got.levels, want.levels):
        assert np.array_equal(g, np.asarray(w))
    # the plain level loop
    if cols > 4:
        level = tpos.batch_hash_no_pad_plain(leaves)
    else:
        level = np.zeros((64, 4), U64)
        level[:, :cols] = leaves
    while level.shape[0] > 1 << cap_height:
        zeros = np.zeros((level.shape[0] // 2, 4), U64)
        level = tpos.permute_plain(np.concatenate([level[0::2], level[1::2], zeros], 1))[:, :4]
    assert got.cap.shape == (1 << cap_height, 4) and np.array_equal(got.cap, level)
    i = 37
    assert tmerkle.verify_merkle_proof(leaves[i], i, got.cap, got.prove(i))


# --- the NTT ---------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [2, 8, 1 << 12])
def test_ntt_intt_and_coset_lde(n, batch):
    rng = np.random.default_rng(n + batch)
    c = _felts(rng, batch, n)
    values = tntt.host_ntt(c)
    assert np.array_equal(values, native.ntt(c))
    assert np.array_equal(values, tntt.host_ntt_plain(c))
    assert np.array_equal(values, jntt.host_ntt(c))
    back = tntt.host_intt(values)
    assert np.array_equal(back, c)
    assert np.array_equal(back, tntt.host_intt_plain(values))
    assert np.array_equal(back, jntt.host_intt(values))
    v = _felts(rng, batch, n)
    assert np.array_equal(tntt.host_intt(v), jntt.host_intt(v))
    assert np.array_equal(tntt.host_intt(v), tntt.host_intt_plain(v))
    lde = native.coset_lde(c, 2, tgl.MULTIPLICATIVE_GROUP_GENERATOR)
    assert lde.shape == (batch, 4 * n)
    assert np.array_equal(lde, jntt.host_lde(c, 2))
    assert np.array_equal(lde, tntt.host_lde(c, 2))
    padded = np.zeros((batch, 4 * n), U64)
    padded[:, :n] = c
    shifts = tgl._powers_np(tgl.MULTIPLICATIVE_GROUP_GENERATOR, 4 * n)
    assert np.array_equal(lde, tntt.host_ntt_plain(tgl._mul_np(padded, shifts)))


# --- the transcript ----------------------------------------------------------


def test_challenger_transcript_replay():
    """Observe caps, hashes and elements, draw challenges in between: the
    port's challenger (its permutation native) and the JAX package's give
    the same challenges and end in the same state."""
    rng = np.random.default_rng(5)
    chs = (TChallenger(), JChallenger())
    draws = ([], [])
    for step in range(12):
        cap, h, e = _felts(rng, 16, 4), _felts(rng, 4), _felts(rng, 3 + step, 2)
        for ch, out in zip(chs, draws):
            ch.observe_cap(cap)
            ch.observe_hash(h)
            out.extend(ch.get_n_challenges(2))
            ch.observe_extension_elements(e)
            ch.observe_element(int(e[0, 0]))
            out.extend(int(v) for v in ch.get_extension_challenge())
            out.extend(int(v) for v in ch.get_hash())
    assert draws[0] == draws[1] and len(draws[0]) == 12 * 8
    assert np.array_equal(chs[0].state, chs[1].state)
    assert all(v < P for v in draws[0])


# --- ChaCha8 and the round constants ----------------------------------------


def test_chacha_regenerates_round_constants_and_matches_the_jax_stream():
    assert tchacha.generate_poseidon_round_constants() == list(tconst.ALL_ROUND_CONSTANTS)
    for seed in (0, 1, 2**64 - 1):
        t, j = tchacha.ChaCha8Rng(seed), jchacha.ChaCha8Rng(seed)
        assert [t.next_u32() for _ in range(300)] == [j.next_u32() for _ in range(300)]
        assert [t.gen_range_u64(P) for _ in range(50)] == [j.gen_range_u64(P) for _ in range(50)]
    assert tchacha.pcg32_seed_expand(7) == jchacha.pcg32_seed_expand(7)


@pytest.mark.parametrize("call", [
    lambda: native.ntt(np.zeros((2, 6), U64)),
    lambda: native.coset_lde(np.zeros(3, U64), 1, 7),
    lambda: native.compress_level(np.zeros((3, 4), U64)),
    lambda: native.compress_level(np.zeros((4, 3), U64)),
    lambda: native.poseidon_permute(np.zeros(11, U64)),
    lambda: native.hash_leaves(np.zeros(5, U64)),
    lambda: native.hash_no_pad_batch(np.zeros((2, 2, 2), U64)),
], ids=["ntt-length", "lde-length", "compress-odd", "compress-width", "permute-width",
        "leaves-1d", "sponge-3d"])
def test_wrappers_refuse_malformed_shapes(call):
    """A shape the C code would index out of bounds is refused before any
    pointer is passed."""
    with pytest.raises(ValueError):
        call()


# --- a build that fails --------------------------------------------------------


def test_failed_build_raises_without_fallback(monkeypatch, tmp_path):
    """With the compiler missing, the first call builds into an empty
    directory and raises, naming the compiler; no numpy result comes back,
    and a second call raises again."""
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "gxx", lambda: str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_LIB", None)
    state = np.zeros(12, U64)
    for call in (lambda: native.poseidon_permute(state), lambda: tpos.permute(state),
                 lambda: tgl.mul(np.ones(1 << 13, U64), np.ones(1 << 13, U64))):
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
            call()
    assert native._LIB is None
    assert not list(tmp_path.glob("*.so"))
