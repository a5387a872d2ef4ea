"""The run loads neither JAX nor the JAX package.  Modules are compared by
their whole top-level name (the part before the first dot): the port's
name, zk_circuits_torch, begins with the JAX package's first letters, so
a test of prefixes would be wrong."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "zk_circuits_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)


def imported_names(path: Path) -> set:
    """The top-level names a source file imports (absolute imports only;
    a relative import stays inside its package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
    return out
