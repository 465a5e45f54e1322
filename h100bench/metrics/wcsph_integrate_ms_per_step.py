"""Device time of the work enqueued inside the program's ``sph.integrate``
spans (``solvers/wcsph_binned.step``: the obstacle term, then one
``integrate_slots`` launch for gravity, the walls, symplectic Euler, the
speed clamp, XSPH and ``travel``, and the clock) in the profiled slice,
ms a step (``spans.device_us``: the device operations paired with the
host's enqueues in order)."""

from h100bench import spans

UNIT = "ms/step"
LAYER = "step loop (solvers/wcsph_binned, solvers/pbf)"
MOVES = "particle_steps_per_s"
SPAN = "sph.integrate"


def read(r):
    got = spans.device_us(r.slice, SPAN) if r.slice is not None else None
    return got[0] / 1e3 / r.slice.steps if got else None
