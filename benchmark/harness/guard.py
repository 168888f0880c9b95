"""What a run may not have loaded: the JAX stack and the JAX package.
Names are compared whole by their top-level part (before the first dot),
so ``sailor_tpu_torch`` is not ``sailor_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sailor_tpu")
# the plain reference may not lean on the program either
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("sailor_tpu_torch",)


def loaded(names=FORBIDDEN, modules=None) -> list:
    """The loaded modules whose top-level name is one of ``names``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in names)


def imported_by(source: str) -> set:
    """Top-level names of the modules a Python source imports."""
    import ast

    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def reference_imports() -> list:
    """Files of the plain reference and the checks that import a barred
    package, with what they import."""
    import os

    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    found = []
    for folder in ("reference", "checks", "bounds"):
        d = os.path.join(bench, folder)
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    bad = imported_by(f.read()) & set(FORBIDDEN_IN_REFERENCE)
                if bad:
                    found.append(f"{folder}/{name}: {', '.join(sorted(bad))}")
    return found
