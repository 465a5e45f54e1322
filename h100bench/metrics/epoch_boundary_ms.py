"""Device time of one epoch boundary: the work enqueued inside the
harness's ``h100bench.epoch`` spans (``neighbors/binned.unbin`` and
``bin_state``: the gathers, the sort and the placement) in the profiled
slice, over their number, ms (``spans.device_us``)."""

from h100bench import spans

UNIT = "ms"
LAYER = "bin / rebin (neighbors/binned, neighbors/expand, csrc/expand.cu)"
MOVES = "particle_steps_per_s"
SPAN = "h100bench.epoch"


def read(r):
    got = spans.device_us(r.slice, SPAN) if r.slice is not None else None
    return got[0] / 1e3 / got[1] if got else None
