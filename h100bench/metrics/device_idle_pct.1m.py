"""The share of the profiled slice's wall time in which no device
operation ran (the union of their intervals from the profiler's trace)."""

UNIT = "%"
LAYER = "device"
MOVES = "particle_steps_per_s"


def read(r):
    if r.slice is None or not r.slice.ops:
        return None
    return 100.0 * (1.0 - r.slice.busy_us() / r.slice.wall_us)
