"""The port's host runtime: ctypes loader and numpy wrappers of
csrc/host_native.cpp.

Counterpart of the JAX package's ``native`` module, built from the port's
own sources: g++ with OpenMP compiles csrc/host_native.cpp, on the field
and permutation headers the CUDA kernels include, into
``zk_circuits_torch/_build`` at first use (utils/nvcc.py,
``build_host_library``).  host/gl.py, host/poseidon.py, hash/merkle.py and
ntt/ntt.py route through it, so the Fiat-Shamir challenger, the circuit
build, the host witness and the host verifier run native code; their numpy
bodies stay beside it, for the tests, under ``_np``/``_plain`` names.

There is no fallback: a missing compiler or a failed build raises with the
compiler's output.  Every result is canonical.  Loops over rows run on
``torch.get_num_threads()`` OpenMP threads.  ``calls`` counts the calls of
each wrapper.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..utils import nvcc

HEADERS = ("goldilocks.cuh", "poseidon.cuh")
SOURCE = "host_native.cpp"
FUNCTIONS = ("zkh_gl_add", "zkh_gl_sub", "zkh_gl_mul", "zkh_gl_inv", "zkh_gl_powers",
             "zkh_poseidon_permute", "zkh_hash_leaves", "zkh_compress_level",
             "zkh_hash_no_pad_batch", "zkh_ntt", "zkh_coset_lde")

calls: dict = {}
build_log = ""    # g++'s output of the last build
_LIB = None
_LOCK = threading.Lock()          # the build and load
_COUNT_LOCK = threading.Lock()    # the counters


def build():
    """Compile csrc/host_native.cpp (cached by the hash of its sources);
    returns the library's path."""
    global build_log
    from ..hash.poseidon_cuda import write_constants_header

    hdr = write_constants_header(nvcc.BUILD_DIR)
    lib, log = nvcc.build_host_library("host_native", SOURCE, HEADERS, (hdr,))
    if log:
        build_log = log
    return lib


def _lib():
    """The library, built and loaded once (under a lock: callers on several
    threads may ask at once)."""
    global _LIB
    lib = _LIB
    if lib is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                p, i64, i, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64
                for name in ("zkh_gl_add", "zkh_gl_sub", "zkh_gl_mul"):
                    getattr(lib, name).argtypes = [p, p, p, i64]
                lib.zkh_gl_inv.argtypes = [p, p, i64, i]
                lib.zkh_gl_powers.argtypes = [u64, p, i64]
                lib.zkh_poseidon_permute.argtypes = [p, i64, i]
                lib.zkh_hash_leaves.argtypes = [p, i64, i64, i, p, i]
                lib.zkh_compress_level.argtypes = [p, i64, p, i]
                lib.zkh_hash_no_pad_batch.argtypes = [p, i64, i64, p, i]
                lib.zkh_ntt.argtypes = [p, i64, i64, i, i]
                lib.zkh_coset_lde.argtypes = [p, i64, i64, i, u64, p, i]
                for name in FUNCTIONS:
                    getattr(lib, name).restype = None
                _LIB = lib
            lib = _LIB
    return lib


def available() -> bool:
    """True once the library is loaded; builds it first if need be (and
    raises if that fails)."""
    return _lib() is not None


def _count(name: str) -> None:
    with _COUNT_LOCK:
        calls[name] = calls.get(name, 0) + 1


def reset_calls() -> None:
    with _COUNT_LOCK:
        calls.clear()


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def _threads() -> int:
    return torch.get_num_threads()


def _rows(x: np.ndarray, what: str, width: int | None = None) -> None:
    """x must be a (rows, cols) matrix (of ``width`` columns if given)."""
    if x.ndim != 2 or (width is not None and x.shape[1] != width):
        cols = "" if width is None else f" of {width} columns"
        raise ValueError(f"{what}: expected a 2-D array{cols}, got shape {x.shape}")


def _power_of_two(n: int, what: str) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: the last axis must be a power of two, got {n}")


def _binary(name: str, a, b) -> np.ndarray:
    """An elementwise operation on a and b broadcast to one shape."""
    shape = np.broadcast_shapes(np.shape(a), np.shape(b))
    x = _c64(np.broadcast_to(np.asarray(a, np.uint64), shape))
    y = _c64(np.broadcast_to(np.asarray(b, np.uint64), shape))
    out = np.empty(shape, dtype=np.uint64)
    getattr(_lib(), "zkh_" + name)(x.ctypes.data, y.ctypes.data, out.ctypes.data, x.size)
    _count(name)
    return out


def gl_add(a, b) -> np.ndarray:
    """Elementwise Goldilocks sum (inputs broadcast)."""
    return _binary("gl_add", a, b)


def gl_sub(a, b) -> np.ndarray:
    return _binary("gl_sub", a, b)


def gl_mul(a, b) -> np.ndarray:
    return _binary("gl_mul", a, b)


def gl_inv(a) -> np.ndarray:
    """Elementwise inverse; inv(0) = 0."""
    x = _c64(a)
    out = np.empty(x.shape, dtype=np.uint64)
    _lib().zkh_gl_inv(x.ctypes.data, out.ctypes.data, x.size, _threads())
    _count("gl_inv")
    return out


def gl_powers(base: int, n: int) -> np.ndarray:
    """[1, base, ..., base^(n-1)]."""
    out = np.empty(n, dtype=np.uint64)
    _lib().zkh_gl_powers(int(base) % 2**64, out.ctypes.data, n)
    _count("gl_powers")
    return out


def poseidon_permute(states) -> np.ndarray:
    """(..., 12) -> (..., 12) permuted (a copy)."""
    s = np.array(states, dtype=np.uint64, order="C")   # always a copy
    if s.ndim < 1 or s.shape[-1] != 12:
        raise ValueError(f"poseidon_permute: expected (..., 12) states, got shape {s.shape}")
    _lib().zkh_poseidon_permute(s.ctypes.data, s.size // 12, _threads())
    _count("poseidon_permute")
    return s


def hash_leaves(leaves, or_noop: bool = True) -> np.ndarray:
    """(rows, cols) -> (rows, 4) digests (the Merkle leaf rule with or_noop)."""
    lv = _c64(leaves)
    _rows(lv, "hash_leaves")
    rows, cols = lv.shape
    out = np.empty((rows, 4), dtype=np.uint64)
    _lib().zkh_hash_leaves(lv.ctypes.data, rows, cols, int(or_noop), out.ctypes.data,
                           _threads())
    _count("hash_leaves")
    return out


def compress_level(digests) -> np.ndarray:
    """(2k, 4) -> (k, 4): each pair's two-to-one compression."""
    d = _c64(digests)
    _rows(d, "compress_level", 4)
    if d.shape[0] % 2:
        raise ValueError(f"compress_level: expected an even number of digests, got {d.shape[0]}")
    k = d.shape[0] // 2
    out = np.empty((k, 4), dtype=np.uint64)
    _lib().zkh_compress_level(d.ctypes.data, k, out.ctypes.data, _threads())
    _count("compress_level")
    return out


def hash_no_pad_batch(inputs) -> np.ndarray:
    """(n, len) -> (n, 4)."""
    x = _c64(inputs)
    _rows(x, "hash_no_pad_batch")
    n, length = x.shape
    out = np.empty((n, 4), dtype=np.uint64)
    _lib().zkh_hash_no_pad_batch(x.ctypes.data, n, length, out.ctypes.data, _threads())
    _count("hash_no_pad_batch")
    return out


def ntt(data, inverse: bool = False) -> np.ndarray:
    """NTT (or INTT) of every row along the last axis, a power of two,
    natural order."""
    x = np.array(data, dtype=np.uint64, order="C")     # always a copy
    n = x.shape[-1]
    _power_of_two(n, "ntt")
    _lib().zkh_ntt(x.ctypes.data, x.size // n, n, int(inverse), _threads())
    _count("ntt")
    return x


def coset_lde(coeffs, rate_bits: int, shift: int) -> np.ndarray:
    """(..., n) coefficients -> (..., n << rate_bits) values on the coset
    ``shift * <w>``."""
    c = _c64(coeffs)
    n = c.shape[-1]
    _power_of_two(n, "coset_lde")
    if rate_bits < 0:
        raise ValueError(f"coset_lde: rate_bits must be >= 0, got {rate_bits}")
    out = np.empty(c.shape[:-1] + (n << rate_bits,), dtype=np.uint64)
    _lib().zkh_coset_lde(c.ctypes.data, c.size // n, n, rate_bits, int(shift) % 2**64,
                         out.ctypes.data, _threads())
    _count("coset_lde")
    return out
