"""What provers on several threads of one process share, on the CPU.

The four kernel wrappers (K1 ``hash/poseidon_cuda.py``, K2
``parallel/exchange_cuda.py``, K3 ``iop/witness_cuda.py``, K4
``ntt/ntt_cuda.py``) build their
library once however many threads ask at first use, and their launch
counters (in all, by mode and by card) lose no count when threads launch
at once; ``PolynomialBatch.ensure_device`` copies the circuit's
commitment to a device once and hands every later caller that copy.
"""

import ctypes
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from zk_circuits_torch.fri.oracle import PolynomialBatch
from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.iop import witness_cuda
from zk_circuits_torch.ntt import ntt_cuda
from zk_circuits_torch.parallel import exchange_cuda

WRAPPERS = {"k1": (poseidon_cuda, "tree"), "k2": (exchange_cuda, "dft"),
            "k3": (witness_cuda, "walk"), "k4": (ntt_cuda, "lde")}


class _FakeLib(types.SimpleNamespace):
    """Stands for a loaded library: any symbol is a settable stub."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_library_built_once_under_threads(name, monkeypatch):
    mod = WRAPPERS[name][0]
    builds = []

    def slow_build():
        builds.append(1)
        time.sleep(0.05)
        return "lib.so"

    def cdll(path):
        lib = _FakeLib()
        lib.block_exchange_call_size = lambda: ctypes.sizeof(exchange_cuda._Call)
        lib.k4_call_size = lambda: ctypes.sizeof(ntt_cuda._Call)
        return lib

    monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setattr(mod, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(mod._lib())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [1] and len(got) == 8 and all(g is got[0] for g in got)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_launch_counts_from_threads_add_up(name):
    mod, kind = WRAPPERS[name]
    by_kind = getattr(mod, "launches_by_mode", None) or mod.launches_by_kernel
    mod.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def launch(card):
            for _ in range(2000):
                mod._count(kind, f"cuda:{card}")

        threads = [threading.Thread(target=launch, args=(i % 4,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert mod.launches == by_kind[kind] == 16 * 2000
    assert mod.launches_by_device == {f"cuda:{c}": 4 * 2000 for c in range(4)}
    mod.reset_launches()
    assert mod.launches == 0 and mod.launches_by_device == {}


def test_ensure_device_keeps_one_copy_per_device():
    coeffs = np.arange(32, dtype=np.uint64).reshape(2, 16)
    batch = PolynomialBatch.from_coeffs(coeffs, 1, 0, device="cpu")
    assert batch.ensure_device("cpu") is batch
    copy = batch.ensure_device("meta")
    assert copy is not batch and copy.device == torch.device("meta")
    assert batch.ensure_device(torch.device("meta")) is copy
    assert copy.num_polys == 2 and len(copy.levels_dev) == len(batch.levels_dev)
