"""What the benchmark imports, read from its sources by ``ast``: nothing
under portbench/ imports JAX or the JAX package, and the plain reference
imports nothing of the port either. Top-level module names are compared
whole: ``faster_rcnn_tpu_torch`` begins with ``faster_rcnn_tpu`` and is
another package."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "faster_rcnn_tpu"}
NOT_IN_REFERENCE = NEVER | {"faster_rcnn_tpu_torch", "chip_smoke"}


def top_level_imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports, relative imports
    resolved inside portbench."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else (node.module or "").split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(HERE), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sources(HERE / "reference"),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    got = top_level_imports(path)
    assert not got & NOT_IN_REFERENCE
    # within the benchmark, the reference reads only itself
    inner = [n for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.ImportFrom) and (n.module or "").startswith("portbench")]
    assert all(n.module.startswith("portbench.reference") for n in inner)


def test_names_compared_whole():
    """A module of the port is not taken for the JAX package."""
    assert "faster_rcnn_tpu_torch".split(".")[0] not in NEVER
    assert top_level_imports(HERE / "port.py") >= {"faster_rcnn_tpu_torch"}
