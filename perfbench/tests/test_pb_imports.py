"""No file under perfbench/ imports JAX or the JAX package, compared by
whole top-level module names (splatformer_tpu_torch is the port and
allowed, splatformer_tpu is not), and the reference imports nothing of the
port: it is torch, numpy and the standard library."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "splatformer_tpu"}
REFERENCE_ALLOWED = {"torch", "numpy", "perfbench"} | set(
    sys.stdlib_module_names)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = set(top_level_imports(path))
    assert names <= REFERENCE_ALLOWED, names - REFERENCE_ALLOWED
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "perfbench"):
            assert node.module.startswith("perfbench.reference"), node.module


def test_the_check_compares_whole_names():
    """splatformer_tpu_torch passes the whole-name check that
    splatformer_tpu fails."""
    assert "splatformer_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "splatformer_tpu.models".split(".")[0] in FORBIDDEN
