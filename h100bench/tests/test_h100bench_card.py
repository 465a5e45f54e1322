"""The command on a machine without a card fails and prints no result;
on the card (marked ``card``) each cell runs and is correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from h100bench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def command(cell: str, seconds: int = 2, trace: int = 0, env=None):
    return subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", cell, "--seed", "3000000001",
         "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=REPO, timeout=900, env=env)


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(cell):
    """With no visible CUDA device the run exits non-zero, prints nothing on
    standard output and never falls back to the CPU."""
    out = command(cell, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = command(cell, trace=trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "check"
