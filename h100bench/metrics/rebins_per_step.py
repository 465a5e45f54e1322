"""Rebins fired over the window (each segment's ``n_rebins`` at its end;
the segments' first binnings are not counted), a step."""

UNIT = "rebins/step"
LAYER = "bin / rebin (neighbors/binned, neighbors/expand, csrc/expand.cu)"
MOVES = "particle_steps_per_s"


def read(r):
    return r.rebins / r.steps if r.rebins is not None and r.steps else None
