"""What the benchmark may import: no module under ``perfbench/`` imports
JAX or the JAX package ``repro`` the port was made from, or reads the
old ``benchmarks/`` folder, and the reference imports nothing of the
program either.  Top-level module names are compared whole, so the
port, ``repro_torch``, is not taken for ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from perfbench.harness.manifest import PERFBENCH

NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in PERFBENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PERFBENCH)) for p in SOURCES])
def test_no_jax_and_no_reference_package(path):
    assert not top_level_imports(path) & NEVER


def test_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path


def test_whole_names_are_compared():
    assert "repro_torch".split(".")[0] not in NEVER
    assert "repro.core".split(".")[0] in NEVER
