"""Nothing under bench_h100 imports JAX or the JAX package, compared by
whole top-level names (vegs_torch begins with vegs_t but is not vegs_tpu),
and the plain reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vegs_tpu"}


def imported_roots(path: Path) -> set:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=str)
def test_no_jax(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")), ids=str)
def test_reference_is_plain(path):
    roots = imported_roots(path)
    assert "vegs_torch" not in roots
    assert roots <= {"__future__", "math", "typing", "numpy", "torch"}


def test_whole_names():
    assert not {"vegs_torch"} & FORBIDDEN
    from bench_h100 import run

    assert run.FORBIDDEN == tuple(sorted(FORBIDDEN, key=("jax", "jaxlib", "flax",
                                                         "vegs_tpu").index))
