"""Module guards of the benchmark.

Nothing the benchmark runs may load JAX or the JAX package ``vri_tpu``,
and the plain reference under ``perfbench/reference/`` may not load the
program (``vri_tpu_torch``) either.  Names are compared by their top-level
part (before the first dot) as whole words: ``vri_tpu_torch`` begins with
``vri_tpu`` and is not the JAX package.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

#: top-level module names no process of the benchmark may hold
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vri_tpu"})
#: what the plain reference may not import besides
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"vri_tpu_torch"}

REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """Sorted top-level names of ``modules`` (default ``sys.modules``)
    that are in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)


def reference_imports() -> dict[str, list[str]]:
    """Forbidden top-level imports of each source file of the reference,
    read from its syntax tree: {file name: [module, ...]} for the files
    that have any."""
    bad = {}
    for path in sorted(REFERENCE_DIR.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        found = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found.update(top_level(a.name) for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                found.add(top_level(node.module or ""))
        hits = sorted(found & FORBIDDEN_IN_REFERENCE)
        if hits:
            bad[path.name] = hits
    return bad
