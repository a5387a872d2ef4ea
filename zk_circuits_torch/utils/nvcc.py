"""nvcc builds of the port's CUDA sources (csrc/).

Each kernel is one ``.cu`` file with a plain C interface, compiled for
sm_90a into a shared library under ``zk_circuits_torch/_build`` at first
use and loaded with ctypes.  The library is named by the hash of its
sources, so an unchanged source is never rebuilt and a changed one is.
Including PyTorch's headers would cost minutes per build; these builds take
seconds.
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


def build_library(stem: str, main: str, headers: tuple[str, ...] = (),
                  generated: tuple[Path, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<main>`` into ``_build/lib<stem>_<hash>.so``.

    ``headers`` (in csrc/) and ``generated`` (files in _build/) enter the
    hash.  Returns the library's path and nvcc's output (empty when the
    library was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256()
    for path in (*(CSRC / h for h in headers), *generated, CSRC / main):
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(BUILD_DIR),
           "-o", str(tmp), str(CSRC / main)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {main} ({res.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, log
