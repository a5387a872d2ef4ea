"""The sharded proof's trees on the kernels' paths, built for the host.

K10 over row-sharded trees: csrc/gather.cuh compiled with g++ behind the
host copy of gather.cu's C interface of tests/test_torch_gather_kernel.py,
driven through ``fri_device._gather_pieces(..., lib=shim)`` on CPU pieces
(E = 2 and 4; column-major oracle pieces read as strided views, row-major
FRI pieces, the levels above the shards' roots on one piece, indices 0,
N - 1 and repeated, words with the top bit set) and held to the plain
version, ``_take_all`` with ``prover_sharded._take_sharded``; then a
sharded zk proof with FRI fold rounds whose query gather goes through the
shim, byte-equal to the JAX host path.  ``merkle.sharded_tree`` (a
``hash_tree`` a shard) against ``sharded_merkle_levels`` and the JAX
package's ``device_merkle_levels`` at E = 1 to 8, cap heights above and
below log2 E.  Every comparison is integer equality.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from test_torch_gather_kernel import SHIM

import zk_circuits_torch.iop.builder as t_builder
import zk_circuits_torch.iop.witness as t_witness
import zk_circuits_torch.plonk.config as t_config
import zk_circuits_tpu.iop.builder as j_builder
import zk_circuits_tpu.iop.witness as j_witness
import zk_circuits_tpu.plonk.config as j_config
from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.fri import fri_device as fd
from zk_circuits_torch.fri import gather_cuda
from zk_circuits_torch.hash import merkle as tmerkle
from zk_circuits_torch.parallel import mesh as tmesh
from zk_circuits_torch.plonk import prover_sharded as ps
from zk_circuits_torch.utils import nvcc
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.hash import merkle as jmerkle
from zk_circuits_tpu.plonk.prover import prove as j_prove
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes

U64 = np.uint64
P = 2**64 - 2**32 + 1
CPU = torch.device("cpu")

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def glib():
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"k10_sharded_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "k10_shim.cc"
    src.write_text(SHIM)
    so = build / "libk10shim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(nvcc.CSRC),
                    "-o", str(so), str(src)], check=True)
    yield gather_cuda.bind(ctypes.CDLL(str(so)))
    shutil.rmtree(build, ignore_errors=True)


def _words(rng, *shape) -> torch.Tensor:
    """Any u64 words, the first 2^64 - 1, as int64."""
    x = rng.integers(0, 2**64 - 1, shape, dtype=U64, endpoint=True)
    x.reshape(-1)[:1] = 2**64 - 1
    return torch.from_numpy(x.view(np.int64))


def _levels(rng, n: int, e: int, cap_height: int) -> list:
    """Random digests in the piece structure of ``merkle.sharded_tree``
    over n leaves on e shards: each level E pieces of (m / E, 4) down to
    one row a piece, then (where E > 2^cap_height) one piece a level down
    to the cap."""
    levels, m = [], n
    while m >= (1 << cap_height):
        if m >= e:
            buf = _words(rng, e, m // e + 1, 4)   # pieces of one buffer, a row apart
            levels.append([buf[s, : m // e] for s in range(e)])
        else:
            levels.append([_words(rng, m, 4)])
        m //= 2
    return levels


def _sharded_trees(rng, e: int, cap_height: int) -> tuple:
    """One proof's trees as the sharded prover hands them to the gather:
    two column-major oracles ((w, N / E) pieces, strided views of wider
    buffers, as ``commit_sharded`` slices the padding off) and two FRI
    trees ((m / E, 2A) row-major pieces); (trees, idxs, colmajor)."""
    n = 64
    trees, idxs, colmajor = [], [], []
    for w in (5, 9):
        buf = _words(rng, e, w + 3, n // e)
        trees.append(([buf[s, :w] for s in range(e)], _levels(rng, n, e, cap_height)))
        colmajor.append(True)
    idx = rng.integers(0, n, 7)
    idx[:3] = [0, n - 1, 0]
    idxs += [idx, idx]
    for a_bits, m in ((2, 16), (1, 8)):
        pieces = [_words(rng, m // e, 2 << a_bits) for _ in range(e)]
        trees.append((pieces, _levels(rng, m, e, min(cap_height, m.bit_length() - 1))))
        colmajor.append(False)
        idxs.append(idx % m)
    return trees, idxs, colmajor


def _take(shards, idx, colmajor):
    return ps._take_sharded(shards, idx, colmajor, CPU)


@pytest.mark.parametrize("cap_height", [0, 1, 3])
@pytest.mark.parametrize("e", [2, 4])
def test_k10_over_sharded_trees_matches_take_sharded(glib, e, cap_height):
    """K10's host build over row-sharded pieces, one call for every tree:
    the plain version's words (``_take_all`` with ``_take_sharded``), the
    same split per tree through ``gather_trees``."""
    trees, idxs, colmajor = _sharded_trees(np.random.default_rng(31 + 10 * e + cap_height),
                                           e, cap_height)
    assert any(len(lv) == 1 for lv in trees[0][1]) == (e > 1 << cap_height)
    got, widths = fd._gather_pieces(trees, idxs, colmajor, lib=glib)
    want, want_widths = fd._take_all(trees, idxs, colmajor, _take)
    assert widths == want_widths == [5, 9, 8, 4]
    assert torch.equal(got, want)
    opened = fd._split(tgf.to_u64(got), trees, idxs, widths)
    for (rows, sibs), t, (leaves, levels), cm in zip(
            fd.gather_trees(trees, idxs, tuple(colmajor), _take), idxs, trees, colmajor):
        whole = torch.cat(leaves, dim=1 if cm else 0)
        assert np.array_equal(rows, tgf.to_u64(whole[:, t].t() if cm else whole[t]))
        assert sibs.shape == (len(t), len(levels) - 1, 4)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(
        opened, fd.gather_trees(trees, idxs, tuple(colmajor), _take)))


def test_k10_sharded_blob_and_refusals(glib):
    """A sharded tree's blob: the leaf matrix's E piece addresses in row
    order with log2 of a piece's rows, a one-piece level with
    ONE_PIECE_LOG; pieces of different shapes, and a number of pieces that
    is no power of two, refused."""
    trees, idxs, colmajor = _sharded_trees(np.random.default_rng(41), 4, 0)
    shaped = [i.reshape(1, -1) for i in idxs]
    blob, _, _ = gather_cuda.describe(trees, shaped, [True] * 4, colmajor)
    f = {k: i for i, k in enumerate(gather_cuda.FIELDS)}
    d = blob[: gather_cuda.DESC]
    assert list(blob[d[f["leaves"]]: d[f["leaves"]] + 4]) == [p.data_ptr() for p in trees[0][0]]
    assert d[f["llog"]] == 4   # 16 rows a piece
    lv = blob[d[f["lvl"]]:].reshape(-1, gather_cuda.LEVEL)[: d[f["nlev"]]]
    assert [r[1] for r in lv] == [4, 3, 2, 1, 0, gather_cuda.ONE_PIECE_LOG]
    bad = [(trees[0][0][:3], trees[0][1])] + trees[1:]
    with pytest.raises(ValueError, match="power"):
        gather_cuda.gather(bad, shaped, [True] * 4, colmajor, lib=glib)
    odd = [([*trees[0][0][:3], trees[0][0][3][:, :8]], trees[0][1])] + trees[1:]
    with pytest.raises(ValueError, match="pieces"):
        gather_cuda.gather(odd, shaped, [True] * 4, colmajor, lib=glib)


def test_sharded_proof_gathers_through_k10(glib, monkeypatch):
    """``prove_sharded`` of the zk square circuit with FRI fold rounds on
    four CPU shards, its query gather (every oracle and fold round's tree
    in one call) through K10's host build in place of the plain takes:
    byte-equal to the JAX host path's proof."""
    calls = []

    def via_k10(trees, idxs, colmajor, take):
        calls.append(len(trees))
        return fd._gather_pieces(trees, idxs, colmajor, lib=glib)

    fri = dict(proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2,
               final_poly_bits=1)
    proofs = []
    for builder, witness, config in ((j_builder, j_witness, j_config),
                                     (t_builder, t_witness, t_config)):
        b = builder.CircuitBuilder(config.CircuitConfig(
            zero_knowledge=True, fri_config=config.FriConfig(**fri)))
        x = b.add_virtual_target()
        b.register_public_input(b.square(x))
        pw = witness.PartialWitness()
        pw.set_target(x, 7)
        proofs.append((b, pw))
    (jb, jpw), (tb, tpw) = proofs
    want = j_bytes(j_prove(jb.build(), jpw, use_device=False))
    data = tb.build(device="cpu")
    monkeypatch.setattr(fd, "_take_all", via_k10)
    proof = ps.prove_sharded(data, tpw, tmesh.make_mesh(4, device="cpu"))
    rounds = len(data.common.config.fri_config.reduction_arities(data.common.degree_bits))
    assert calls == [4 + rounds]
    assert t_bytes(proof) == want


_JAX_LEVELS = {}


def _jax_levels(leaves: np.ndarray, cap_height: int) -> list:
    """The JAX package's ``device_merkle_levels`` at ``cap_height``: the
    levels of its whole tree (cap height 0, built once) with 2^cap_height
    digests or more, which is where its level loop stops."""
    key = leaves.tobytes()
    if key not in _JAX_LEVELS:
        _JAX_LEVELS[key] = [jgf.to_u64(lv) for lv in
                            jmerkle.device_merkle_levels(jgf.from_u64(leaves), 0)]
    return [lv for lv in _JAX_LEVELS[key] if lv.shape[0] >= 1 << cap_height]


@pytest.mark.parametrize("cap_height", [0, 1, 3])
@pytest.mark.parametrize("e", [1, 2, 4, 8])
def test_sharded_tree_matches_level_loop_and_jax(e, cap_height):
    """``sharded_tree`` over each shard's strided leaf rows (a ``hash_tree``
    a shard at the local cap height, the roots joined on the first shard
    where E > 2^cap_height): the levels, piece by piece, of
    ``sharded_merkle_levels`` over the shards' leaf digests, and, joined,
    the JAX package's ``device_merkle_levels`` of the whole matrix."""
    leaves = np.random.default_rng(5).integers(0, P, (32, 9), dtype=U64)
    cols = tgf.from_u64(np.ascontiguousarray(leaves.T))   # column-major, as the LDE
    shards = [cols[:, s * 32 // e: (s + 1) * 32 // e].t() for s in range(e)]
    got = tmerkle.sharded_tree(shards, cap_height)
    plain = tmerkle.sharded_merkle_levels([tmerkle.leaf_digests(t) for t in shards],
                                          cap_height)
    want = _jax_levels(leaves, cap_height)
    assert len(got) == len(plain) == len(want)
    for lv, pl, w in zip(got, plain, want):
        assert [tuple(p.shape) for p in lv] == [tuple(p.shape) for p in pl]
        assert all(torch.equal(a, b) for a, b in zip(lv, pl))
        assert np.array_equal(tgf.to_u64(tmesh.gather(lv, dim=0)), w)
    assert len(got[-1]) == (1 if e > 1 << cap_height else e)
