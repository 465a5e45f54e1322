"""Device time of one emission: the work enqueued inside the program's
``sph.emit`` spans (``scenes/emitter.emit_due``: the due mask and the
selects of pos, vel, mass and active over every row) in the profiled
slice, over their number, ms (``spans.device_us``). None where the
program opens no such span."""

from h100bench import spans

UNIT = "ms"
LAYER = "bin / rebin (neighbors/binned, neighbors/expand, csrc/expand.cu)"
MOVES = "steps_per_s"
SPAN = "sph.emit"


def read(r):
    got = spans.device_us(r.slice, SPAN) if r.slice is not None else None
    return got[0] / 1e3 / got[1] if got else None
