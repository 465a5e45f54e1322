"""Tracing: the program's named spans and the profiler window that records
them.

``annotate`` is the one span the program opens around each phase of its
step (``sph.<phase>``). It records only while a ``torch.profiler`` window
is open, so a span always lands on the profiler's clock, in the same
timeline as the device work it launched; with no profiler recording it is
one shared no-op context and costs a check of the profiler's state.
``device_trace`` is such a window (host and, where there is a card,
device activity).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(log_dir: str | Path | None = None):
    """``torch.profiler`` window; yields the profile (``events()``,
    ``key_averages()``). With ``log_dir`` a Chrome trace is written there
    as ``trace.json`` when the window closes.

    The operator's way to see the program's phases: around a few steps it
    records every ``sph.*`` span beside the kernels each launched."""
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
    """A named span of the profile (``record_function``) while a profiler
    is recording; otherwise the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
