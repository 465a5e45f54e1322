"""The readers of the program's ``sph.*`` spans (``spans.py`` and the metrics
built on it): device time by the host's enqueues paired in order with the
device's operations, idle time under a span with its children, and nothing
read where the program opens no span or the pairing fails."""

from __future__ import annotations

import json

import pytest

from h100bench import harness, spans, tracing
from h100bench.tests.conftest import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
BENCH = harness.Bench()
READERS = ["wcsph_density_ms_per_step", "wcsph_forces_ms_per_step",
           "wcsph_integrate_ms_per_step", "pbf_predict_ms_per_step", "pbf_project_ms_per_step",
           "pbf_epilogue_ms_per_step", "rebin_ms", "rebin_check_idle_ms_per_step",
           "obstacle_ms_per_step", "epoch_boundary_ms"]

# One step by hand (us): a check whose second read fires a rebin, then the
# density phase; a runtime launch that calls the driver is one enqueue.
HOST = [
    ("h100bench.step", 0.0, 40.0),
    ("sph.rebin_check", 0.0, 19.0),
    ("cudaLaunchKernel", 1.0, 1.5),
    ("cudaMemcpyAsync", 3.0, 3.5),
    ("cudaStreamSynchronize", 3.5, 7.0),
    ("sph.rebin", 8.0, 18.0),
    ("cudaLaunchKernel", 11.0, 11.5),
    ("sph.density", 20.0, 30.0),
    ("cudaLaunchKernel", 21.0, 21.5),
    ("cudaLaunchKernel", 22.0, 24.0),
    ("cuLaunchKernel", 22.5, 23.0),
]
OPS = [("check", 2.0, 4.0), ("Memcpy DtoH", 5.0, 6.0), ("sort", 12.0, 15.0),
       ("density_runs", 25.0, 35.0), ("tait", 35.0, 40.0)]


# After it, the update (the kernel, then the clock's add) with an obstacle
# term before it, and an epoch boundary.
LATER_HOST = [
    ("sph.integrate", 41.0, 50.0),
    ("cudaLaunchKernel", 41.5, 42.0),
    ("cuLaunchKernel", 43.0, 43.5),
    ("cudaLaunchKernel", 44.0, 44.5),
    ("h100bench.epoch", 51.0, 60.0),
    ("cudaLaunchKernel", 52.0, 52.5),
    ("cuLaunchKernel", 53.0, 53.5),
]
LATER_OPS = [("elementwise obstacle", 42.0, 45.0),
             ("void (anonymous namespace)::integrate_slots<float, 3, 0>(Args<float>)", 45.0, 47.0),
             ("add", 47.0, 47.5), ("sort", 53.0, 57.0), ("expand_runs", 57.0, 58.0)]


def hand(ops=OPS, host=HOST, steps=1) -> tracing.Slice:
    return tracing.Slice(steps=steps, ops=list(ops), host=list(host), span_device_us={},
                         wall_us=40.0)


def reading(sl) -> harness.Reading:
    return harness.Reading(cfg={}, work={}, grid=None, n=0, steps=1, seconds=1.0, setup_s=0.0,
                           peak_bytes=0, slice=sl)


@pytest.mark.parametrize("name,want", [
    ("sph.rebin_check", (6.0, 1)),   # its rebin's sort included
    ("sph.rebin", (3.0, 1)),
    ("sph.density", (15.0, 1)),
    ("h100bench.step", (21.0, 1)),
])
def test_device_time_under_a_span(name, want):
    assert spans.device_us(hand(), name) == want


@pytest.mark.parametrize("name,want", [
    ("sph.rebin_check", (7.0, 1)),   # the gaps (4, 5) and (6, 12): its rebin's too
    ("sph.rebin", (6.0, 1)),
    ("sph.density", (10.0, 1)),      # the gap (15, 25), midpoint 20
])
def test_idle_time_under_a_span(name, want):
    assert spans.idle_us(hand(), name) == want


@pytest.mark.parametrize("sl", [
    hand(ops=OPS[:-1]),                                   # an operation without its enqueue
    hand(host=[h for h in HOST if h[0] != "cuLaunchKernel"] + [("cudaMemsetAsync", 26, 27)]),
    hand(ops=[]),                                         # no device operation (the CPU)
    hand(host=[h for h in HOST if not h[0].startswith("sph.")]),  # no span (the parent)
], ids=["op_unpaired", "enqueue_unpaired", "no_ops", "no_spans"])
def test_nothing_read_where_nothing_pairs(sl):
    assert spans.device_us(sl, "sph.density") is None


@pytest.mark.parametrize("reader", READERS)
def test_reader_without_slice_or_spans_reads_nothing(reader):
    mod = BENCH.module("metrics", reader)
    assert mod.read(reading(None)) is None
    parent = hand(host=[h for h in HOST if not h[0].startswith("sph.")])
    assert mod.read(reading(parent)) is None


@pytest.mark.parametrize("reader,want", [
    ("wcsph_density_ms_per_step", 0.015),
    ("rebin_ms", 0.003),
    ("rebin_check_idle_ms_per_step", 0.007),
])
def test_reader_on_the_hand_made_step(reader, want):
    assert BENCH.module("metrics", reader).read(reading(hand())) == pytest.approx(want)


@pytest.mark.parametrize("reader,want", [
    ("obstacle_ms_per_step", 0.0035),   # all under sph.integrate but the kernel
    ("wcsph_integrate_ms_per_step", 0.0055),
    ("epoch_boundary_ms", 0.005),
])
def test_reader_on_the_hand_made_update_and_boundary(reader, want):
    sl = hand(ops=OPS + LATER_OPS, host=HOST + LATER_HOST)
    assert BENCH.module("metrics", reader).read(reading(sl)) == pytest.approx(want)


@pytest.mark.parametrize("reader", READERS)
def test_reader_listed_where_its_span_opens(reader):
    """Each new metric lists the cells whose solver opens its span."""
    entry = next(m for m in MANIFEST["per_layer"] if m["name"] == reader)
    assert entry["source"] == "device_trace" and entry["workloads"]
    solvers = {BENCH.workload(c)["solver"]["name"] for c in entry["workloads"]}
    if reader.startswith("wcsph_"):
        assert solvers == {"wcsph"}
    elif reader.startswith("pbf_"):
        assert solvers == {"pbf"}


def test_cpu_profile_keeps_the_spans_on_the_host():
    """A step profiled on the CPU: ``tracing.reduce`` leaves every ``sph.*``
    event out of the device's operations and keeps the phases, in order, for
    ``spans`` to read."""
    from sph_pie_torch.scenes import builders as tb
    from sph_pie_torch.solvers import wcsph_binned

    s = tb.dam_break_2d(300, device="cpu")
    b = s.binned_state()
    prof = harness._profiler(False)
    with prof:
        wcsph_binned.step(s.params, s.bgrid, b)
    sl = tracing.reduce(prof, 1, 1.0)
    assert not [op for op in sl.ops if op[0].startswith("sph.")]
    got = [h[0] for h in sorted(sl.host, key=lambda h: h[1]) if h[0].startswith("sph.")]
    assert got == ["sph.rebin_check", "sph.density", "sph.forces", "sph.integrate"]
    assert spans.device_us(sl, "sph.density") is None  # nothing ran on a device


def test_traced_cpu_run_leaves_the_device_metrics_out(small):
    """On the CPU the readers find no device operation: the traced run's line
    leaves their metrics out and nothing raises."""
    result, _ = harness.run("dam3d_1m.wcsph", 2**33 + 5, 0.3, True, bench=small,
                            device="cpu")
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["dam3d_1m.wcsph", "dam3d_1m.pbf_frame",
                                  "dam3d_1m.wcsph_sphere"])
def test_traced_card_run_reads_the_spans(card, small, cell):
    """At CPU size on the card: every new metric of the cell reads a number,
    and the device time under the step's top-level spans is the slice's
    busy time (the frame aside)."""
    captured = []
    reduce = tracing.reduce

    def keep(prof, steps, wall_us):
        captured.append(reduce(prof, steps, wall_us))
        return captured[-1]

    tracing.reduce = keep
    try:
        result, _ = harness.run(cell, 2**33 + 5, 0.5, True, bench=small, device="cuda")
    finally:
        tracing.reduce = reduce
    listed = {m["name"] for m in MANIFEST["per_layer"]
              if m["name"] in READERS and cell in m["workloads"]}
    listed.discard("rebin_ms")  # a slice of 5 steps may hold no rebin
    assert listed <= set(result["metrics"])
    sl = captured[0]
    top = {"dam3d_1m.wcsph": ["sph.rebin_check", "sph.density", "sph.forces", "sph.integrate"],
           "dam3d_1m.pbf_frame": ["sph.rebin_check", "sph.predict", "sph.project",
                                  "sph.epilogue", "h100bench.frame"],
           "dam3d_1m.wcsph_sphere": ["sph.rebin_check", "sph.density", "sph.forces",
                                     "sph.integrate", "h100bench.epoch"]}[cell]
    under = sum(spans.device_us(sl, name)[0] for name in top)
    assert under == pytest.approx(sum(e - s for _, s, e in sl.ops), rel=1e-9)
