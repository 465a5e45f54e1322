"""Idle device time of the profiled slice whose gap midpoint falls inside
the program's ``sph.rebin_check`` spans (``maybe_rebin``'s host reads and
the rebin it fires), ms a step (``spans.idle_us``)."""

from h100bench import spans

UNIT = "ms/step"
LAYER = "step loop (solvers/wcsph_binned, solvers/pbf)"
MOVES = "particle_steps_per_s"
SPAN = "sph.rebin_check"


def read(r):
    got = spans.idle_us(r.slice, SPAN) if r.slice is not None else None
    return got[0] / 1e3 / r.slice.steps if got else None
