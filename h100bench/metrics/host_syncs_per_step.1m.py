"""Implicit device-to-host syncs over the window's steps outside the
profiled slice (torch's sync debug mode, whose warnings would slow the
slice's host), a step."""

UNIT = "syncs/step"
LAYER = "step loop (solvers/wcsph_binned, solvers/pbf)"
MOVES = "particle_steps_per_s"


def read(r):
    return r.syncs / r.sync_steps if r.syncs is not None and r.sync_steps else None
