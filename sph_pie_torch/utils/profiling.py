"""Tracing and step timing.

``device_trace`` is a ``torch.profiler`` window (host and, where there is a
card, device activity), ``annotate`` a named span inside it, and
``StepTimer`` a rolling registry of phase times: by CUDA events on a card,
by the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def device_trace(log_dir: str | Path | None = None):
    """``torch.profiler`` window; yields the profile (``events()``,
    ``key_averages()``). With ``log_dir`` a Chrome trace is written there
    as ``trace.json`` when the window closes."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """Named span for a host-side phase (shows in the profile)."""
    return torch.profiler.record_function(name)


def _cuda_devices(x) -> set[torch.device]:
    """The CUDA devices of the tensors in ``x`` (a tensor, a dataclass,
    a sequence or a mapping of them)."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.device.type == "cuda" else set()
    if isinstance(x, dict):
        x = list(x.values())
    elif hasattr(x, "__dataclass_fields__"):
        x = [getattr(x, k) for k in x.__dataclass_fields__]
    if isinstance(x, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in x)) if x else set()
    return set()


class StepTimer:
    """Rolling stats of repeated phases.

    ``with timer.time("step", device) as out: out["result"] = ...``. On a
    CUDA ``device`` the phase is timed by CUDA events on that device's
    current stream (device time of the work enqueued inside the block);
    otherwise by the host clock, read after a synchronise of any CUDA
    device that ``out["result"]`` lives on."""

    def __init__(self, window: int = 200):
        self.window = window
        self._samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, device: torch.device | str | None = None):
        dev = torch.device(device) if device is not None else None
        events = None
        if dev is not None and dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        out: dict = {}
        try:
            yield out
        finally:
            if events is not None:
                events[1].record(torch.cuda.current_stream(dev))
                events[1].synchronize()
                dt = events[0].elapsed_time(events[1]) / 1e3
            else:
                for d in _cuda_devices(out.get("result")):
                    torch.cuda.synchronize(d)
                dt = time.perf_counter() - t0
            buf = self._samples.setdefault(name, [])
            buf.append(dt)
            del buf[: -self.window]

    def stats(self) -> dict:
        out = {}
        for name, xs in self._samples.items():
            out[name] = {
                "count": len(xs),
                "mean_ms": statistics.fmean(xs) * 1e3,
                "p50_ms": statistics.median(xs) * 1e3,
                "max_ms": max(xs) * 1e3,
            }
        return out
