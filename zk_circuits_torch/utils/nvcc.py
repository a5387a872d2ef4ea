"""Builds of the port's C++ and CUDA sources (csrc/).

Each kernel is one ``.cu`` file with a plain C interface, compiled by nvcc
for sm_90a into a shared library under ``zk_circuits_torch/_build`` at
first use and loaded with ctypes; the host runtime (csrc/host_native.cpp)
is compiled the same way by g++ with OpenMP.  A library is named by the
hash of its sources, so an unchanged source is never rebuilt and a changed
one is; each build writes a file of its own and renames it into place, so
processes that build at once each load a whole library.  Including
PyTorch's headers would cost minutes per build; these builds take seconds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


GXX_FLAGS = ["-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC"]


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: it is needed to build the port's host "
                           "runtime (csrc/host_native.cpp)")
    return found


def _library(stem: str, main: str, headers: tuple, generated: tuple,
             flags: tuple = ()) -> Path:
    """``_build/lib<stem>_<hash>.so``: the hash covers the sources, the
    headers (in csrc/), the generated files and ``flags``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in (*(CSRC / h for h in headers), *generated, CSRC / main):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def _compile(cmd: list, lib: Path, main: str) -> str:
    """Compile ``csrc/<main>`` with the compiler command ``cmd`` into a
    pid-named file, then rename it to ``lib``; returns the compiler's
    output, or raises with it."""
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cmd, "-o", str(tmp), str(CSRC / main)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"could not run {cmd[0]} on {main}: {e}") from e
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed on {main} ({res.returncode}):\n{log}")
    os.replace(tmp, lib)
    return log


def build_library(stem: str, main: str, headers: tuple[str, ...] = (),
                  generated: tuple[Path, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<main>`` with nvcc into ``_build/lib<stem>_<hash>.so``.

    ``headers`` (in csrc/) and ``generated`` (files in _build/) enter the
    hash.  Returns the library's path and nvcc's output (empty when the
    library was already built)."""
    lib = _library(stem, main, headers, generated)
    if lib.exists():
        return lib, ""
    return lib, _compile([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(BUILD_DIR)],
                         lib, main)


def build_host_library(stem: str, main: str, headers: tuple[str, ...] = (),
                       generated: tuple[Path, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<main>`` for the host with ``g++ -O3 -std=c++17
    -fopenmp -shared -fPIC`` into ``_build/lib<stem>_<hash>.so``, as
    ``build_library`` does with nvcc.  A missing compiler or a failed
    build raises RuntimeError with the compiler's output."""
    lib = _library(stem, main, headers, generated, tuple(GXX_FLAGS))
    if lib.exists():
        return lib, ""
    return lib, _compile([gxx(), *GXX_FLAGS, "-I", str(CSRC), "-I", str(BUILD_DIR)],
                         lib, main)
