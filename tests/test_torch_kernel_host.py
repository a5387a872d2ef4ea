"""The arithmetic the CUDA leaf kernel runs, built for the host.

csrc/goldilocks.cuh and csrc/poseidon.cuh are __host__ __device__ code;
here they are compiled with g++ behind a small C shim and checked against
the numpy golden models (host/gl.py, host/poseidon.py) of both packages,
so the field and permutation code is tested before any card runs it.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.utils import nvcc
from zk_circuits_tpu.host import gl as jgl
from zk_circuits_tpu.host import poseidon as jpos

SHIM = r"""
#include "poseidon.cuh"
static const uint64_t RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;
extern "C" {
void shim_mul(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_mul(a[i], b[i]);
}
void shim_add(const uint64_t* a, const uint64_t* b, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_add(a[i], b[i]);
}
void shim_reduce(const uint64_t* lo, const uint64_t* hi, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_reduce128(lo[i], hi[i]);
}
void shim_canon(const uint64_t* a, uint64_t* out, long n) {
  for (long i = 0; i < n; i++) out[i] = gl_canon(a[i]);
}
void shim_permute(uint64_t* states, long n) {
  for (long i = 0; i < n; i++) poseidon_permute(states + 12 * i, RC);
}
}
"""

P = jgl.P_INT
U64 = np.uint64


@pytest.fixture(scope="module")
def lib():
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel headers for the host"
    build = nvcc.BUILD_DIR / f"host_shim_{os.getpid()}"
    build.mkdir(parents=True, exist_ok=True)
    poseidon_cuda.write_constants_header(build)
    src = build / "shim.cc"
    src.write_text(SHIM)
    so = build / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(nvcc.CSRC), "-I", str(build),
                    "-o", str(so), str(src)], check=True)
    yield ctypes.CDLL(str(so))
    shutil.rmtree(build, ignore_errors=True)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _edge_and_random(rng, n):
    edge = np.array([0, 1, 2, P - 1, P - 2, P, P + 1, 2**32 - 1, 2**32,
                     2**63, 2**64 - 1, 2**64 - 2], dtype=U64)
    return np.concatenate([edge, rng.integers(0, 2**64 - 1, n, dtype=U64,
                                              endpoint=True)])


def _ref_mod(x):
    return np.array([int(v) % P for v in np.ravel(x)], dtype=U64).reshape(np.shape(x))


def test_mul_and_reduce_match_host(lib):
    rng = np.random.default_rng(11)
    a = _edge_and_random(rng, 2000)
    b = np.roll(_edge_and_random(rng, 2000), 5)
    out = np.empty_like(a)
    lib.shim_mul(_ptr(a), _ptr(b), _ptr(out), ctypes.c_long(a.size))
    # gl_mul is non-canonical and exact for any u64 inputs
    want = np.array([int(x) * int(y) % P for x, y in zip(a, b)], dtype=U64)
    assert np.array_equal(_ref_mod(out), want)
    ca, cb = _ref_mod(a), _ref_mod(b)
    lib.shim_mul(_ptr(ca), _ptr(cb), _ptr(out), ctypes.c_long(a.size))
    assert np.array_equal(_ref_mod(out), jgl.mul(ca, cb))

    lo = _edge_and_random(rng, 2000)
    hi = np.roll(_edge_and_random(rng, 2000), 3)
    lib.shim_reduce(_ptr(lo), _ptr(hi), _ptr(out), ctypes.c_long(lo.size))
    want = np.array([(int(x) + (int(y) << 64)) % P for x, y in zip(lo, hi)],
                    dtype=U64)
    assert np.array_equal(_ref_mod(out), want)


def test_add_and_canon_match_host(lib):
    rng = np.random.default_rng(12)
    a = _ref_mod(_edge_and_random(rng, 2000))
    b = np.roll(a, 7)
    out = np.empty_like(a)
    lib.shim_add(_ptr(a), _ptr(b), _ptr(out), ctypes.c_long(a.size))
    assert np.array_equal(out, jgl.add(a, b))
    x = _edge_and_random(rng, 2000)
    lib.shim_canon(_ptr(x), _ptr(out), ctypes.c_long(x.size))
    assert np.array_equal(out, _ref_mod(x))
    assert (out < U64(P)).all()


def test_permutation_matches_host(lib):
    rng = np.random.default_rng(13)
    states = rng.integers(0, P, (64, 12), dtype=U64)
    states[0] = 0
    states[1] = P - 1
    want = jpos.permute(states.copy())
    got = np.ascontiguousarray(states.copy())
    lib.shim_permute(_ptr(got), ctypes.c_long(states.shape[0]))
    assert np.array_equal(_ref_mod(got), want)
    # non-canonical lanes (2^64 - 1 = 2^32 - 2 mod p) hash like their residue
    nc = np.full((1, 12), 2**64 - 1, dtype=U64)
    lib.shim_permute(_ptr(nc), ctypes.c_long(1))
    assert np.array_equal(_ref_mod(nc[0]),
                          jpos.permute(np.full(12, 2**32 - 2, dtype=U64)))
