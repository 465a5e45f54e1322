"""A configuration, a cell and a metric added as new files are picked up,
with no file of the benchmark edited (BENCHMARK.json gains their entries)."""

from __future__ import annotations

import hashlib
import json

from h100bench import harness
from h100bench.tests.conftest import copy_bench, shrink


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "h100bench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    root = copy_bench(tmp_path)
    shrink(root)
    before = digests(root)
    hb = root / "h100bench"
    cfg = json.loads((hb / "configs" / "dam2d_4k.json").read_text())
    cfg.update(name="dam2d_tall", fluid=[[0.0, 0.0], [0.3, 0.8]])
    from h100bench.reference import geometry
    from h100bench.scenes import block
    cfg["particles"] = block.lattice_sites(cfg)
    cfg["slots"] = geometry.grid(cfg).slots
    (hb / "configs" / "dam2d_tall.json").write_text(json.dumps(cfg))
    work = json.loads((hb / "workloads" / "dam2d_4k.wcsph.json").read_text())
    work["config"] = "dam2d_tall"
    (hb / "workloads" / "dam2d_tall.wcsph.json").write_text(json.dumps(work))
    (hb / "metrics" / "window_steps.py").write_text(
        'UNIT = "steps"\nLAYER = "step loop (solvers/wcsph_binned, solvers/pbf)"\n'
        'MOVES = "steps_per_s"\n\n\ndef read(r):\n    return r.steps\n')
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dam2d_tall", "source": cfg["source"],
                                "file": "h100bench/configs/dam2d_tall.json", "reduced": [],
                                "why": "a taller column"})
    manifest["workloads"].append({"name": "dam2d_tall.wcsph", "config": "dam2d_tall",
                                  "traffic": "wcsph", "chips": 1, "why": "a taller column"})
    for m in manifest["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append("dam2d_tall.wcsph")
    manifest["per_layer"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                                  "source": "host_clock", "layer": "step loop (solvers/"
                                  "wcsph_binned, solvers/pbf)", "moves": "steps_per_s",
                                  "workloads": ["dam2d_tall.wcsph"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    bench = harness.Bench(hb)
    result, _ = harness.run("dam2d_tall.wcsph", 7, 0.3, True, bench=bench, device="cpu")
    assert result["correct"] and result["metrics"]["window_steps"]["value"] > 0
    result, _ = harness.run("dam2d_tall.wcsph", 7, 0.3, False, bench=bench, device="cpu")
    assert set(result["metrics"]) == {"steps_per_s", "setup_s"}
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())
