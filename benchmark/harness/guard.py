"""The packages the benchmark may never load: JAX and the JAX package.
Names are compared whole, by their top level (``rdmnet_tpu_torch`` is not
``rdmnet_tpu``)."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rdmnet_tpu")
# the reference may not reach the program either
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("rdmnet_tpu_torch",)


def loaded_forbidden(modules: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    """The modules of ``sys.modules`` (or ``modules``) whose top level is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if n.split(".", 1)[0] in forbidden)


def imported_names(path: Path) -> List[str]:
    """Every module name ``path`` imports, absolute or relative (relative
    ones resolved against the benchmark package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.append("benchmark")
            elif node.module:
                names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.append(node.args[0].value)
    return names


def forbidden_imports(path: Path, forbidden=FORBIDDEN) -> List[str]:
    return [n for n in imported_names(path) if n.split(".", 1)[0] in forbidden]
