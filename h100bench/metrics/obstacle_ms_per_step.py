"""Device time of the work enqueued inside the program's ``sph.integrate``
spans that is not the ``integrate_slots`` kernel, in the profiled slice, ms
a step: the obstacle term (``scenes/obstacles.accel``, torch over every
slot), the kernel's scratch fill and the clock's add (``spans.ops_in``).
A few microseconds where the scene has no obstacle."""

import re

from h100bench import spans

UNIT = "ms/step"
LAYER = "step loop (solvers/wcsph_binned, solvers/pbf)"
MOVES = "particle_steps_per_s"
SPAN = "sph.integrate"
KERNEL = re.compile(r"^void \(anonymous namespace\)::integrate_slots<")


def read(r):
    got = spans.ops_in(r.slice, SPAN) if r.slice is not None else None
    if not got:
        return None
    us = sum(e - s for name, s, e in got[0] if not KERNEL.search(name))
    return us / 1e3 / r.slice.steps
