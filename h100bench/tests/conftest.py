"""Fixtures of the benchmark's tests: the benchmark at CPU sizes, in a
copy, and the card where there is one.

    python -m pytest h100bench/tests          # on the CPU; card tests skip
    python -m pytest h100bench/tests -m card  # on a card
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from h100bench import harness  # noqa: E402
from h100bench.reference import geometry  # noqa: E402
from h100bench.scenes import block  # noqa: E402

# Particles of each configuration at CPU size.
SMALL = {"dam3d_1m": 3000, "dam2d_4k": 400}


def shrink(root: Path) -> None:
    """Cut the copy under ``root`` to CPU size: fewer particles (the sizes
    the files state follow), segments of 20 steps, checks of 3, a profiled
    slice of 5 steps in the second segment; where a workload has epochs,
    epochs of 8 steps, a warm-up through the first boundary and checks of
    11 steps, so that the check and the slice each cross a boundary."""
    for name, n in SMALL.items():
        path = root / "h100bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["n_target"] = n
        cfg["particles"] = block.lattice_sites(cfg)
        cfg["slots"] = geometry.grid(cfg).slots
        path.write_text(json.dumps(cfg))
    for path in (root / "h100bench" / "workloads").glob("*.json"):
        work = json.loads(path.read_text())
        work.update(segment_steps=20, warm_steps=2,
                    profile={"segment": 1, "from_step": 5, "steps": 5})
        work["check"]["steps"] = 3
        if "epoch_steps" in work:
            work.update(epoch_steps=8, warm_steps=9)
            work["check"]["steps"] = 11
        path.write_text(json.dumps(work))


def copy_bench(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``h100bench/`` under ``dest``."""
    shutil.copytree(REPO / "h100bench", dest / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> harness.Bench:
    root = copy_bench(tmp_path_factory.mktemp("small"))
    shrink(root)
    return harness.Bench(root / "h100bench")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return torch.device("cuda")
