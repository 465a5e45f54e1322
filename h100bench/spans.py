"""The program's own spans (``sph.<phase>``, opened by
``sph_pie_torch.utils.profiling.annotate`` while a profiler records) in a
profiled slice (``tracing.Slice``).

The slice keeps the host's operations and the device's, each with its
interval on the profiler's clock, but not which host call enqueued which
device operation. The port runs on one stream, on which the device runs its
operations in the order the host enqueued them: the k-th device operation by
start is the k-th enqueue by the host (a kernel launch, a copy or a set of
the CUDA runtime or driver). ``device_us`` pairs them so, and a span's
device time is that of the operations enqueued inside it, its child spans
included. The pairing holds only where both counts agree; elsewhere it
gives None. (The profiler's own ``device_time_total`` of a span leaves out
the kernels the program launches from its own library, outside any torch
operation.)

``idle_us`` gives the slice's idle time (no device operation running)
whose midpoint falls inside a span, as ``Slice.idle_by_host`` does for the
host's innermost operation.
"""

from __future__ import annotations

import bisect
import re

# The CUDA runtime and driver calls that enqueue one device operation each.
ENQUEUE = re.compile(r"^cu(da)?(Launch\w*Kernel\w*|Memcpy\w*|Memset\w*)$")


def _intervals(sl, name: str) -> list[tuple[float, float]]:
    return sorted((s, e) for n, s, e in sl.host if n == name)


def _enqueues(sl) -> list[float]:
    """Start times of the host's enqueues, outermost only (a runtime call
    that calls the driver is one enqueue)."""
    out, end = [], float("-inf")
    for s, e in sorted((s, e) for n, s, e in sl.host if ENQUEUE.match(n)):
        if s >= end:
            out.append(s)
            end = e
    return out


def _paired(sl, name):
    """(the spans named ``name``, the host's enqueue starts, the device
    operations by start) where they pair; None otherwise."""
    spans = _intervals(sl, name)
    starts = _enqueues(sl)
    if not spans or not sl.ops or len(starts) != len(sl.ops):
        return None
    return spans, starts, sorted(sl.ops, key=lambda op: op[1])


def device_us(sl, name: str) -> tuple[float, int] | None:
    """(device microseconds of the work enqueued inside the spans named
    ``name``, the number of those spans) in the slice; None where the slice
    has no such span, no device operation, or enqueues and device
    operations that do not pair."""
    got = _paired(sl, name)
    if got is None:
        return None
    spans, starts, ops = got
    cum = [0.0]
    for _, s, e in ops:
        cum.append(cum[-1] + (e - s))
    us = 0.0
    for a, b in spans:
        us += cum[bisect.bisect_right(starts, b)] - cum[bisect.bisect_left(starts, a)]
    return us, len(spans)


def ops_in(sl, name: str) -> tuple[list[tuple[str, float, float]], int] | None:
    """(the device operations enqueued inside the spans named ``name``, the
    number of those spans); None where ``device_us`` gives None."""
    got = _paired(sl, name)
    if got is None:
        return None
    spans, starts, ops = got
    out = []
    for a, b in spans:
        out += ops[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]
    return out, len(spans)


def idle_us(sl, name: str) -> tuple[float, int] | None:
    """(idle microseconds of the slice whose gap midpoint lies inside a span
    named ``name``, the number of those spans); None where there is none."""
    spans = _intervals(sl, name)
    if not spans or not sl.ops:
        return None
    firsts = [a for a, _ in spans]
    us = 0.0
    for a, b in sl.gaps():
        t = 0.5 * (a + b)
        k = bisect.bisect_right(firsts, t) - 1
        if k >= 0 and spans[k][1] >= t:
            us += b - a
    return us, len(spans)
