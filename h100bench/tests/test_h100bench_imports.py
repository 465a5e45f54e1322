"""No module the benchmark runs is JAX or the JAX package, and the
reference takes nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from h100bench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "sph_pie_tpu"}
SOURCES = sorted(p for p in (REPO / "h100bench").rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    """The part before the first dot of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((REPO / "h100bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "sph_pie_torch" not in names
    local = {n.module for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.ImportFrom) and n.module and n.module.startswith("h100bench")}
    assert all(m.startswith("h100bench.reference") for m in local), local


def test_top_level_names_are_compared_whole():
    """The port's name begins with the JAX package's; only whole names match."""
    assert "sph_pie_torch".split(".")[0] not in FORBIDDEN
    assert "sph_pie_tpu.solvers".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    """A whole run at CPU size, in a fresh process: afterwards sys.modules
    holds none of the forbidden top-level names."""
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from h100bench import harness
from h100bench.tests.conftest import copy_bench, shrink
root = copy_bench(Path({str(tmp_path)!r}))
shrink(root)
harness.run("dam2d_4k.wcsph", 5, 0.2, True, bench=harness.Bench(root / "h100bench"), device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "sph_pie_torch" in loaded and not loaded & FORBIDDEN
