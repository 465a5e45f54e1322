"""Device time of the work enqueued inside the program's ``sph.forces``
spans (``solvers/wcsph_binned.step``: the per-slot terms and the forces
fold; gravity, the walls and the obstacles are in ``sph.integrate``) in the
profiled slice, ms a step
(``spans.device_us``: the device operations paired with the host's
enqueues in order)."""

from h100bench import spans

UNIT = "ms/step"
LAYER = "WCSPH pair kernels (neighbors/density, neighbors/forces, csrc/density.cu, csrc/forces.cu)"
MOVES = "particle_steps_per_s"
SPAN = "sph.forces"


def read(r):
    got = spans.device_us(r.slice, SPAN) if r.slice is not None else None
    return got[0] / 1e3 / r.slice.steps if got else None
