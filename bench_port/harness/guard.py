"""The guard against JAX and the JAX package: nothing the benchmark runs may
load ``jax``, ``jaxlib``, ``flax`` or ``shm3d``.  A module counts by its
top-level name, the part before the first dot, compared whole: the port
``shm3d_torch`` is not ``shm3d``."""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "shm3d"})
PROGRAM = "shm3d_torch"


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """The names in ``modules`` (e.g. ``sys.modules``) whose top level is
    forbidden, sorted."""
    return sorted(m for m in modules if top_level(m) in FORBIDDEN)


def imports_of(path: Path) -> List[str]:
    """Every module a Python file imports (absolute imports; a relative
    import stays inside its package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.append(node.args[0].value)
    return out
