"""K10, the FRI query gather, built for the host.

csrc/gather.cuh is __host__ __device__ code; here it is compiled with g++
behind a host copy of gather.cu's C interface (k10_gather, k10_call_size,
k10_desc_words), which runs each tree's blocks last to first and a block's
threads in turn through the header's own ``k10_thread``, and driven through
the wrapper (``gather_cuda.gather(..., lib=shim)``) on CPU tensors.  Equal
integers are required against the port's plain version
(``fri/fri_device.py::_gather_plain``, a take a leaf matrix and a level)
and against the JAX package's ``fri/fri_device.py::gather_trees_batch``
(its jitted ``_gather_batch_fn``), at small sizes (N <= 64, Q <= 6): a
shared column-major tree beside batched row-major and column-major ones,
B = 1 and 3, cap heights 0 and 2, a tree with no sibling level, edge and
repeated indices, words with the top bit set, strided views, grids of one
block and more; then a zk batch proved with K10 through the shim, byte-equal
to the JAX host path.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.field import goldilocks as gfd
from zk_circuits_torch.fri import fri_device as fd
from zk_circuits_torch.fri import gather_cuda
from zk_circuits_torch.plonk.prover import prove_batch
from zk_circuits_torch.utils import nvcc
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.fri import fri_device as jfd
from zk_circuits_tpu.plonk.prover import prove as j_prove
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

U64 = np.uint64

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

SHIM = r"""
#include "gather.cuh"

extern "C" {
// One call: for each tree, the blocks of its row of the grid last to first
// (the card runs them in no order), a block's threads in turn.
int k10_gather(int, const K10Call* call, void*) {
  const K10Call& c = *call;
  if (!k10_valid(c)) return 1;   // cudaErrorInvalidValue
  for (int t = 0; t < c.trees; t++)
    for (long long bx = c.blocks - 1; bx >= 0; bx--)
      for (int tid = 0; tid < K10_THREADS; tid++) k10_thread(c, t, bx, tid);
  return 0;
}
int k10_call_size(void) { return (int)sizeof(K10Call); }
int k10_desc_words(void) { return (int)K10_DESC; }
}
"""


@pytest.fixture(scope="module")
def glib():
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"k10_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "k10_shim.cc"
    src.write_text(SHIM)
    so = build / "libk10shim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(nvcc.CSRC),
                    "-o", str(so), str(src)], check=True)
    yield gather_cuda.bind(ctypes.CDLL(str(so)))   # the wrapper's declarations and checks
    shutil.rmtree(build, ignore_errors=True)


P = 2**64 - 2**32 + 1


def _words(rng, *shape, wide=False) -> np.ndarray:
    """Canonical field elements (the JAX package's from_u64 reduces), the
    top bit set in about half, the first p - 1; or, ``wide``, any u64 (the
    first 2^64 - 1), which the kernel copies as bits (held to the plain
    version only)."""
    x = rng.integers(0, 2**64 - 1 if wide else P - 1, shape, dtype=U64, endpoint=True)
    x.reshape(-1)[:1] = 2**64 - 1 if wide else P - 1
    return x


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _tree(rng, batch, n, w, cap_height, layout, split=True, wide=False):
    """A tree of ``layout`` "shared" ((w, N), column-major, no proof axis),
    "col" ((B, w, N)) or "row" ((B, N, w)) leaves of random words, and its
    levels (leaf digests first, 2^cap_height digests last) of random words:
    views of one buffer, as K1's tree mode gives them, or tensors of their
    own.  Returns (torch tree, host tree, shared, colmajor)."""
    lead = () if layout == "shared" else (batch,)
    leaves = _words(rng, *lead, *((w, n) if layout != "row" else (n, w)), wide=wide)
    sizes = [n >> l for l in range(n.bit_length() - cap_height)]
    if split:
        buf = _t(_words(rng, *lead, sum(sizes), 4, wide=wide))
        levels = list(torch.split(buf, sizes, dim=-2))
    else:
        levels = [_t(_words(rng, *lead, m, 4, wide=wide)) for m in sizes]
    host = (leaves, [gfd.to_u64(lv) for lv in levels])
    return (_t(leaves), levels), host, layout == "shared", layout != "row"


def _indices(rng, batch, q, n) -> np.ndarray:
    """(B, Q) queries: 0, N - 1 and a repeat lead each proof's, the rest
    random."""
    idx = rng.integers(0, n, (batch, q))
    idx[:, :3] = np.array([0, n - 1, 0])[: min(q, 3)]
    if q > 4:
        idx[:, 4] = idx[:, 3]
    return idx


def _jax(host_trees, idxs, shared, colmajor) -> list:
    trees = [(jgf.from_u64(lf), tuple(jgf.from_u64(lv) for lv in lvs)) for lf, lvs in host_trees]
    return jfd.gather_trees_batch(trees, idxs, list(shared), list(colmajor))


def _check(glib, trees, idxs, shared, colmajor, host=None):
    """K10 through the shim == the plain version, and == the JAX package's
    gather_trees_batch when ``host`` (the trees as host arrays) is given."""
    got = gather_cuda.gather(trees, idxs, shared, colmajor, lib=glib)
    want = fd._gather_plain(trees, idxs, shared, colmajor)
    assert got.shape == want.shape and torch.equal(got, want)
    if host is not None:
        widths = [lf.shape[-2] if cm else lf.shape[-1] for (lf, _), cm in zip(trees, colmajor)]
        split = fd._split(gfd.to_u64(got), trees, idxs, widths)
        for (gr, gs), (wr, ws) in zip(split, _jax(host, idxs, shared, colmajor), strict=True):
            assert gr.shape == wr.shape and gs.shape == ws.shape
            assert np.array_equal(gr, wr) and np.array_equal(gs, ws)
    return got


def _forest(rng, batch, cap_height, split=True, wide=False):
    """The main path's kinds side by side: a shared column-major tree (the
    constants/sigmas oracle), a batched column-major one (an oracle), a
    batched row-major one (a FRI tree of arity 4: rows of 8 words)."""
    made = [_tree(rng, batch, 32, 6, cap_height, "shared", split, wide),
            _tree(rng, batch, 64, 5, cap_height, "col", split, wide),
            _tree(rng, batch, 16, 8, cap_height, "row", split, wide)]
    q = 6 if batch == 1 else 5
    idxs = [_indices(rng, batch, q, n) for n in (32, 64, 16)]
    return [m[0] for m in made], [m[1] for m in made], [m[2] for m in made], \
        [m[3] for m in made], idxs


@pytest.mark.parametrize("cap_height", [0, 2])
@pytest.mark.parametrize("batch", [1, 3])
def test_k10_matches_plain_and_jax(glib, batch, cap_height):
    trees, host, shared, colmajor, idxs = _forest(
        np.random.default_rng(100 * batch + cap_height), batch, cap_height)
    got = _check(glib, trees, idxs, shared, colmajor, host)
    assert got.numel() == sum(batch * i.shape[1] * (w + 4 * (len(lv) - 1))
                              for i, (w, lv) in zip(idxs, [(6, trees[0][1]), (5, trees[1][1]),
                                                           (8, trees[2][1])]))


def test_k10_tree_without_a_sibling_level(glib):
    """A tree whose leaves are its cap (no sibling level) beside trees with
    levels, in the middle of the call."""
    rng = np.random.default_rng(7)
    made = [_tree(rng, 2, 16, 4, 2, "col"), _tree(rng, 2, 8, 8, 3, "row"),
            _tree(rng, 2, 32, 3, 1, "shared", split=False)]
    assert len(made[1][0][1]) == 1
    idxs = [_indices(rng, 2, 4, n) for n in (16, 8, 32)]
    _check(glib, [m[0] for m in made], idxs, [m[2] for m in made], [m[3] for m in made],
           [m[1] for m in made])


@pytest.mark.parametrize("max_blocks", [1, 2])
def test_k10_grid_stride_and_wide_words(glib, monkeypatch, max_blocks):
    """Fewer blocks a tree than its words need: each thread takes several
    words of the tree in the grid-stride loop; every word any u64, in [p,
    2^64) too, copied bit for bit."""
    monkeypatch.setattr(gather_cuda, "MAX_BLOCKS", max_blocks)
    trees, _, shared, colmajor, idxs = _forest(np.random.default_rng(11), 3, 2, split=False,
                                               wide=True)
    _check(glib, trees, idxs, shared, colmajor)


def test_k10_reads_views_in_place(glib):
    """Leaves that are strided views (a slice of wider oracles, the
    transpose of a row-major batch, every other proof of a batch) and
    levels of separate tensors; equal to the plain version and the JAX
    package's on the same words."""
    rng = np.random.default_rng(13)
    wide = _t(_words(rng, 3, 9, 32))
    col = wide[:, 2:7]                                     # (3, 5, 32), rows 9 * 32 apart
    rows_t = _t(_words(rng, 3, 32, 6)).transpose(1, 2)     # (3, 6, 32) column-major view
    every_other = _t(_words(rng, 6, 16, 8))[::2]           # (3, 16, 8), proofs 256 apart
    trees, host = [], []
    for leaves, cm in ((col, True), (rows_t, True), (every_other, False)):
        n = leaves.shape[-1] if cm else leaves.shape[-2]
        levels = [_t(_words(rng, 3, n >> l, 4)) for l in range(n.bit_length() - 2)]
        trees.append((leaves, levels))
        host.append((gfd.to_u64(leaves.contiguous()), [gfd.to_u64(lv) for lv in levels]))
    idxs = [_indices(rng, 3, 5, n) for n in (32, 32, 16)]
    _check(glib, trees, idxs, [False] * 3, [True, True, False], host)


def test_k10_refusals(glib):
    """A query index outside the tree, indices of another batch size, a
    level of the wrong shape, and a CPU tensor without a host library raise
    before anything runs."""
    rng = np.random.default_rng(17)
    trees, _, shared, colmajor, idxs = _forest(rng, 2, 2)
    bad = [i.copy() for i in idxs]
    bad[1][0, 0] = 64
    with pytest.raises(ValueError, match="outside"):
        gather_cuda.gather(trees, bad, shared, colmajor, lib=glib)
    bad[1][0, 0] = -1
    with pytest.raises(ValueError, match="outside"):
        gather_cuda.gather(trees, bad, shared, colmajor, lib=glib)
    with pytest.raises(ValueError, match="indices"):
        gather_cuda.gather(trees, [idxs[0], idxs[1][:1], idxs[2]], shared, colmajor, lib=glib)
    short = [trees[0], (trees[1][0], trees[1][1][1:]), trees[2]]
    with pytest.raises(ValueError, match="level 0"):
        gather_cuda.gather(short, idxs, shared, colmajor, lib=glib)
    with pytest.raises(ValueError, match="CUDA"):
        gather_cuda.gather(trees, idxs, shared, colmajor)
    with pytest.raises(ValueError, match="trees"):
        gather_cuda.gather(trees, idxs[:2], shared, colmajor, lib=glib)


def test_k10_blob_layout(glib):
    """``describe``'s blob against csrc/gather.cuh's layout: a descriptor a
    tree, then each tree's level records (address, log2 rows a piece,
    batch stride, row stride), then its indices; a matrix of one piece
    (every matrix here) has its address in place of a piece table and
    ONE_PIECE_LOG; output offsets in call order."""
    rng = np.random.default_rng(19)
    trees, _, shared, colmajor, idxs = _forest(rng, 2, 2)
    blob, total, most = gather_cuda.describe(trees, idxs, shared, colmajor)
    d = blob[: 3 * gather_cuda.DESC].reshape(3, gather_cuda.DESC)
    f = {k: i for i, k in enumerate(gather_cuda.FIELDS)}
    out, one = 0, gather_cuda.ONE_PIECE_LOG
    for t, ((leaves, levels), idx) in enumerate(zip(trees, idxs)):
        assert d[t, f["leaves"]] == leaves.data_ptr() and d[t, f["out"]] == out
        assert d[t, f["llog"]] == one
        assert d[t, f["bs"]] == (0 if shared[t] else leaves.stride(0))
        nlev = len(levels) - 1
        lvl = blob[d[t, f["lvl"]]: d[t, f["lvl"]] + gather_cuda.LEVEL * nlev].reshape(
            nlev, gather_cuda.LEVEL)
        assert [tuple(r) for r in lvl] == [
            (lv.data_ptr(), one, 0 if shared[t] else lv.stride(0), 4) for lv in levels[:-1]]
        assert np.array_equal(blob[d[t, f["idx"]]: d[t, f["idx"]] + idx.size], idx.reshape(-1))
        out += d[t, f["total"]]
    assert total == out and most == d[:, f["total"]].max()
    assert blob.size == 3 * gather_cuda.DESC + sum(
        gather_cuda.LEVEL * (len(lv) - 1) + i.size for (_, lv), i in zip(trees, idxs))


FRI_ROUNDS = dict(proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2,
                  final_poly_bits=1)


def _square(builder, witness, config, **build_kw):
    b = builder.CircuitBuilder(config.CircuitConfig(
        zero_knowledge=True, fri_config=config.FriConfig(**FRI_ROUNDS)))
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    data = b.build(**build_kw)

    def pw(v):
        w = witness.PartialWitness()
        w.set_target(x, v)
        return w

    return data, pw


def test_batch_proofs_with_k10_through_the_shim(glib, monkeypatch):
    """A zk square circuit with FRI fold rounds, a batch of 2, its query
    gather through K10's host build (one call a batch: the four oracles,
    the shared one among them, and every fold round's tree): byte-equal to
    the JAX host path's proofs."""
    calls = []

    def via_k10(trees, idxs, shared, colmajor):
        calls.append(len(trees))
        return gather_cuda.gather(trees, idxs, shared, colmajor, lib=glib)

    monkeypatch.setattr(fd, "_gather_plain", via_k10)
    ref, ref_pw = _square(j_builder, j_witness, j_config)
    want = [j_bytes(j_prove(ref, ref_pw(v), use_device=False)) for v in (3, 7)]
    data, pw = _square(t_builder, t_witness, t_config, device="cpu")
    rounds = len(data.common.config.fri_config.reduction_arities(data.common.degree_bits))
    proofs = prove_batch(data, [pw(3), pw(7)], device="cpu")
    assert [t_bytes(p) for p in proofs] == want
    assert calls == [4 + rounds]
