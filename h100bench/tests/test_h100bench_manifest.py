"""``BENCHMARK.json`` against the contract it is written to, and every name
in it found as a file."""

from __future__ import annotations

import json
import re

import pytest

from h100bench import harness
from h100bench.tests.conftest import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
BENCH = harness.Bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRIC_KEYS = {"name", "unit", "better", "source"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "h100bench/run.py"]
    assert MANIFEST["paths"] == ["h100bench"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_check_fits_its_time():
    """2 + 14 x 24 runs of run_seconds + 60 s, 24 x 180 s of compiles and
    1200 s spare fit into 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer"):
        if key in entry:
            assert line(entry[key]), (key, entry[key])
    if "file" in entry:  # a configuration's source
        assert line(entry["source"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_unique_names():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    layer = metric in MANIFEST["per_layer"]
    keys = METRIC_KEYS | ({"layer", "moves"} if layer else {"bound"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if not layer:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    # the reader's own description repeats the manifest's
    mod = BENCH.module("metrics", metric["name"])
    assert mod.UNIT == metric["unit"]
    if layer:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = BENCH.cell(cell)
    assert entry["chips"] == 1 and line(entry["why"])
    work = BENCH.workload(cell)
    assert work["config"] == entry["config"]
    cfg = BENCH.config(work["config"])
    assert cfg["name"] == entry["config"]
    assert (BENCH.folder / "scenes" / f"{cfg['builder']}.py").is_file()
    assert hasattr(BENCH.module("traffic", work["driver"]), "Driver")
    for m in BENCH.end_to_end(cell) + BENCH.per_layer(cell):
        assert callable(BENCH.module("metrics", m["name"]).read)
    assert set(work["check"]["limits"]) >= {"lost", "pos_gap", "vel_gap", "rho_gap"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_layers_move(cell):
    """setup_s, one more end-to-end metric, one per-layer metric, and the
    end-to-end metric each per-layer one moves."""
    e2e = {m["name"] for m in BENCH.end_to_end(cell)}
    layers = BENCH.per_layer(cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"] == f"h100bench/configs/{config['name']}.json"
    cfg = json.loads((REPO / config["file"]).read_text())
    assert cfg["source"] == config["source"] and cfg["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])
