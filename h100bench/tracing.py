"""What a traced run reads besides the clock: host syncs, and the device's
work in a profiled slice of the window.

``counting_syncs`` is frozen from ``chip_smoke.py``: torch's sync debug
mode warns at each implicit device-to-host sync, and the warnings are
counted. ``Slice`` reduces a ``torch.profiler`` window, as ``chip_smoke.py``'s
``device_profile`` does, to the device's operations (kernels, copies,
sets) with their intervals, the device time under each of the harness's
spans, and the host's operations, which name the device's idle gaps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import warnings

import torch


@contextlib.contextmanager
def counting_syncs(counts: list[int]):
    """Count implicit device-to-host syncs (torch's sync debug mode warns
    at each one) inside the block; appends the count to ``counts``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts.append(sum("synchroniz" in str(w.message) for w in caught))


@dataclasses.dataclass
class Slice:
    steps: int
    ops: list[tuple[str, float, float]]    # device operations: name, start, end (us)
    host: list[tuple[str, float, float]]   # host operations: name, start, end (us)
    span_device_us: dict[str, float]       # device time under each harness span
    wall_us: float                         # the slice's length by the host clock

    def busy_us(self) -> float:
        """The union of the device operations' intervals."""
        busy, end = 0.0, float("-inf")
        for a, b in sorted((s, e) for _, s, e in self.ops):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    def matching(self, patterns) -> list[tuple[str, float, float]]:
        """Device operations whose name matches any regular expression."""
        rx = [re.compile(p) for p in patterns]
        return [op for op in self.ops if any(r.search(op[0]) for r in rx)]

    def gaps(self) -> list[tuple[float, float]]:
        """Intervals in the slice in which no device operation ran."""
        out, end = [], None
        for a, b in sorted((s, e) for _, s, e in self.ops):
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out

    def idle_by_host(self) -> dict[str, float]:
        """Idle seconds by the innermost host operation running at each
        gap's midpoint: one sweep, the gaps and the host operations in time
        order, a stack of the operations that have started."""
        host = sorted(self.host, key=lambda x: x[1])
        out: dict[str, float] = {}
        stack: list[tuple[str, float, float]] = []
        k = 0
        for a, b in self.gaps():
            t = 0.5 * (a + b)
            while k < len(host) and host[k][1] <= t:
                stack.append(host[k])
                k += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            name = stack[-1][0] if stack else "(no host operation)"
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
        return out


def reduce(prof, steps: int, wall_us: float) -> Slice:
    """The slice of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, host, spans = [], [], {}
    for e in prof.events():
        t = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("h100bench.")):
                ops.append(t)
        else:
            host.append(t)
            if e.name.startswith("h100bench."):
                dev_us = getattr(e, "device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(e, "cuda_time_total", 0.0)
                spans[e.name] = spans.get(e.name, 0.0) + dev_us
    return Slice(steps=steps, ops=ops, host=host, span_device_us=spans, wall_us=wall_us)


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, [name, seconds] each, ``top`` of each."""
    by_op: dict[str, float] = {}
    for name, s, e in sl.ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6

    def rank(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rank(by_op), "idle_gaps": rank(sl.idle_by_host())}
