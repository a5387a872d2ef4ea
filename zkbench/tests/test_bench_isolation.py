"""Nothing under zkbench/ imports JAX or the JAX package, and the reference
imports nothing of the program, compared by whole top-level names."""

from __future__ import annotations

import subprocess
import sys

from zkbench.harness import isolation

from .conftest import BENCH, ROOT


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "__pycache__" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not isolation.imported_names(path) & isolation.FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "zk_circuits_torch" not in isolation.imported_names(path), path
    code = ("import sys, pkgutil, importlib; sys.path.insert(0, %r)\n"
            "import zkbench.reference.zkref as z\n"
            "for m in pkgutil.walk_packages(z.__path__, 'zkbench.reference.zkref.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout
    assert "zk_circuits_torch" not in loaded and "jax" not in loaded


def test_names_are_compared_whole():
    assert isolation.forbidden_loaded(["zk_circuits_torch.plonk", "numpy"]) == []
    assert isolation.forbidden_loaded(["zk_circuits_tpu.plonk.prover"]) == ["zk_circuits_tpu"]
    assert isolation.forbidden_loaded(["jaxlib.xla_client", "jax_fake", "flax"]) == [
        "flax", "jaxlib"]
