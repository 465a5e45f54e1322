"""One run of one cell: set-up, the measured window, the comparison, the
result line.

Everything is found by name. ``BENCHMARK.json`` (beside this folder) lists
the cells and which metrics each reports; a cell's file is
``workloads/<cell>.json`` (its configuration, traffic driver, parameters
and check), a configuration's ``configs/<name>.json`` (its sizes and its
``builder``, ``scenes/<builder>.py``), a driver's ``traffic/<driver>.py``
and a metric's reader ``metrics/<metric>.py``. A reader takes the run's
``Reading`` and returns a number, or None where it finds nothing to read;
the metric is then left out.

The window: the driver's segments back to back for ``seconds``, stopped at
the first step boundary after that. Set-up (imports, the kernel library,
inputs, the program's scene, the check's reference module, a warm-up
through the segment start, a rebin and the check's gathers) is all that
comes before it. Once the check is done, a run whose process holds JAX or
the JAX package stops with no result. ``--trace 1`` counts
the host syncs of the window's steps outside the profiled slice, profiles
the steps the workload's ``profile`` names, and keeps the window open until
that slice is done.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from h100bench import judge, roofline, tracing
from h100bench.reference import geometry, sph

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sph_pie_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``folder``."""

    def __init__(self, folder: Path = HERE, manifest: Path | None = None):
        self.folder = Path(folder)
        self.manifest = load_json(manifest or self.folder.parent / "BENCHMARK.json")
        self._modules: dict = {}

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return load_json(self.folder / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return load_json(self.folder / "configs" / f"{name}.json")

    def module(self, kind: str, name: str):
        """``<folder>/<kind>/<name>.py``, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = self.folder / kind / f"{name}.py"
            spec = importlib.util.spec_from_file_location(f"h100bench_{kind}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if cell in m["workloads"] or ("workloads" not in m and m["moves"] in moves)]


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""

    cfg: dict
    work: dict
    grid: geometry.Grid
    n: int                      # particles
    steps: int                  # steps in the window
    seconds: float              # the window's length
    setup_s: float
    peak_bytes: int             # allocator peak over the window
    step_ms: list[float] | None = None       # per step, from CUDA events
    syncs: int | None = None                 # host syncs over the window's
    sync_steps: int | None = None            # steps outside the profiled slice
    rebins: int | None = None                # rebins over the window
    slice: tracing.Slice | None = None       # the profiled steps
    pairs: float | None = None               # pairs in support, sampled in the slice


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def warm(drv, work: dict) -> None:
    """The segment start, steps through the first rebin (at least
    ``warm_steps``, at most a segment) and the check's gathers."""
    b = drv.begin()
    for k in range(work["segment_steps"]):
        b = drv.step(b)
        if k + 1 >= work["warm_steps"] and int(drv.rebins(b)) > 0:
            break
    drv.particles(b)
    drv.failed(b)
    drv.begin()


def run(cell: str, seed: int, seconds: float, trace: bool, *, bench: Bench | None = None,
        device: str = "cuda", t0: float | None = None, fault=None) -> tuple[dict, dict]:
    """(the result line's object, {number: (value, limit)}) of one run.
    ``fault`` (tests only) is called with the driver before the warm-up, to
    break the timed path."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or Bench()
    work = bench.workload(cell)
    cfg = bench.config(work["config"])
    metrics = bench.per_layer(cell) if trace else bench.end_to_end(cell)
    readers = {m["name"]: bench.module("metrics", m["name"]) for m in metrics}
    dev = torch.device(device)
    builder = bench.module("scenes", cfg["builder"])
    inp = builder.inputs(cfg, seed, dev)
    drv = bench.module("traffic", work["driver"]).Driver(cfg, work, builder, inp, spans=trace)
    judge.module(work)
    if fault is not None:
        fault(drv)
    warm(drv, work)
    _sync(dev)
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    events = [] if any(getattr(r, "STEP_EVENTS", False) for r in readers.values()) and cuda \
        else None
    prof_cfg = work["profile"]
    check_steps = work["check"]["steps"]
    syncs: list[int] = []
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    rebins = torch.zeros((), dtype=torch.int64, device=dev)
    snap, snap_rebins, samples, sl, prof = None, 0, [], None, None
    steps = segments = 0

    setup_s = time.perf_counter() - t0
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    start = time.perf_counter()
    with tracing.counting_syncs(syncs) if trace and cuda else contextlib.nullcontext():
        done = False
        seg_ends = []
        while not done:
            b = drv.begin()
            for k in range(work["segment_steps"]):
                profiling = trace and segments == prof_cfg["segment"]
                if profiling and k == prof_cfg["from_step"]:
                    samples.append(drv.particles(b)["pos"])
                    _sync(dev)
                    if cuda:  # the warnings would slow the profiled host
                        torch.cuda.set_sync_debug_mode("default")
                    prof = _profiler(cuda)
                    prof.__enter__()
                    prof_start, prof_steps = time.perf_counter(), 0
                b = drv.step(b)
                steps += 1
                if events is not None:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                if prof is not None and sl is None:
                    prof_steps += 1
                if segments == 0 and k + 1 == check_steps:
                    snap = drv.particles(b)
                    snap_rebins = drv.rebins(b)
                    if drv.frame is not None:
                        snap["frame"] = drv.last_frame
                # The window closes once the check's state is taken and, in a
                # traced run, the profiled slice is done.
                done = (time.perf_counter() - start >= seconds and snap is not None
                        and (not trace or sl is not None))
                if prof is not None and sl is None and prof_steps == prof_cfg["steps"]:
                    _sync(dev)
                    wall_us = (time.perf_counter() - prof_start) * 1e6
                    prof.__exit__(None, None, None)
                    if cuda:
                        torch.cuda.set_sync_debug_mode("warn")
                    sl = tracing.reduce(prof, prof_steps, wall_us)
                    samples.append(drv.particles(b)["pos"])
                if done:
                    break
            failed += drv.failed(b)
            rebins += drv.rebins(b)
            segments += 1
            seg_ends.append(time.perf_counter() - start)
        _sync(dev)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    step_ms = None
    if events is not None:
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    g = geometry.grid(cfg)
    reading = Reading(cfg=cfg, work=work, grid=g, n=inp.pos.shape[0], steps=steps,
                      seconds=window_s, setup_s=setup_s, peak_bytes=peak, step_ms=step_ms)
    if trace:
        reading.syncs = sum(syncs) if cuda else None
        reading.sync_steps = steps - (sl.steps if sl is not None else 0)
        reading.rebins = int(rebins)
        reading.slice = sl
    # The program's state goes before the reference runs: a process's peak
    # never falls again, and the reference's would set it.
    del b, drv
    if cuda:
        torch.cuda.empty_cache()
    if trace and samples:
        h = sph.physics(cfg).h
        reading.pairs = sum(roofline.pairs_in_support(s, h) for s in samples) / len(samples)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(reading)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    limits = work["check"]["limits"]
    judge_t0 = time.perf_counter()
    nums = judge.numbers(cfg, work, inp, snap) if snap is not None else {}
    judge_s = time.perf_counter() - judge_t0
    # After the check too, so that what the check loads is seen as well.
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"h100bench: modules loaded in this process that the benchmark must "
                         f"not run: {found}")
    check = {k: (nums.get(k), v) for k, v in limits.items()}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": bench.cell(cell)["chips"],
                   "memory_peak_bytes": max(setup_peak, peak)}
    if cuda:
        _, limit = card_line().rsplit(",", 1)
        device_info["power_limit_w"] = float(limit.strip().split()[0])
    if trace and sl is not None:
        device_info["busy_s"] = sl.busy_us() * 1e-6
        device_info["window_s"] = sl.wall_us * 1e-6
    result = {"correct": judge.verdict(limits, nums), "attempted": segments,
              "failed": int(failed), "metrics": values, "device": device_info,
              "rebins_before_check": int(snap_rebins),
              "segment_ends_s": seg_ends, "judge_s": judge_s,
              "result_s": time.perf_counter() - t0}
    if trace and sl is not None and sl.ops:
        result["breakdown"] = tracing.breakdown(sl)
    return result, check


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)
