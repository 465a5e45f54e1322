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


CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(tmp_path, cell):
    """A whole run of each cell at CPU size, the check included, in a fresh
    process: afterwards sys.modules holds none of the forbidden top-level
    names."""
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from h100bench import harness
from h100bench.tests.conftest import copy_bench, shrink
root = copy_bench(Path({str(tmp_path)!r}))
shrink(root)
harness.run({cell!r}, 5, 0.2, True, bench=harness.Bench(root / "h100bench"), device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "sph_pie_torch" in loaded and not loaded & FORBIDDEN


def test_a_module_the_check_loads_stops_the_run(small, monkeypatch):
    """A forbidden module that first appears while the check runs, after
    the window, stops the run with no result; the reference module itself
    is loaded in the set-up, before the window."""
    import types

    from h100bench import harness, judge

    steps = judge.module(small.workload("dam2d_4k.wcsph"))
    calls = []

    def run(*args):
        calls.append("run")
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return steps.run(*args)

    def module(work):
        calls.append("module")
        return types.SimpleNamespace(run=run)

    def fault(drv):
        real = drv.step
        drv.step = lambda b: (calls.append("step"), real(b))[1]

    monkeypatch.setattr(judge, "module", module)
    with pytest.raises(SystemExit, match="flax"):
        harness.run("dam2d_4k.wcsph", 7, 0.1, False, bench=small, device="cpu", fault=fault)
    assert calls[0] == "module" and calls[-1] == "run" and "step" in calls
