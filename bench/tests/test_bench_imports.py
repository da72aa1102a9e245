"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the reference
and the frozen arithmetic import nothing of the program."""
from __future__ import annotations

import ast
import sys

import pytest

from bench.core import cells, result

FILES = sorted(p for p in cells.BENCH.rglob("*.py"))


def imported(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(cells.BENCH)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("sub", ["reference", "work"])
def test_reference_and_work_import_nothing_of_the_program(sub):
    for path in (cells.BENCH / sub).rglob("*.py"):
        assert "repro_torch" not in imported(path), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import repro_torch  # noqa: F401  (its name begins with "repro")
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    loaded = {m.split(".")[0] for m in sys.modules}
    assert set(result.forbidden_modules()) == \
        loaded & set(result.FORBIDDEN)
    assert "jaxlib" in result.forbidden_modules()
    assert "repro_torch" not in result.forbidden_modules()
