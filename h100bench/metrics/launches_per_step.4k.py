"""Device operations (kernels, copies, sets) in the profiled slice, a step."""

UNIT = "launches/step"
LAYER = "device"
MOVES = "steps_per_s"


def read(r):
    if r.slice is None or not r.slice.ops:
        return None
    return len(r.slice.ops) / r.slice.steps
