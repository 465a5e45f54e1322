"""Device time of the work enqueued inside the program's ``sph.epilogue``
spans (``solvers/pbf.step``: from the last rebin check to the returned
state, the velocity, the density+XSPH fold and the clamps) in the
profiled slice, ms a step (``spans.device_us``: the device operations
paired with the host's enqueues in order)."""

from h100bench import spans

UNIT = "ms/step"
LAYER = "PBF folds (neighbors/pbf_folds, csrc/pbf.cu)"
MOVES = "particle_steps_per_s"
SPAN = "sph.epilogue"


def read(r):
    got = spans.device_us(r.slice, SPAN) if r.slice is not None else None
    return got[0] / 1e3 / r.slice.steps if got else None
