"""Device time of every operation in the profiled slice that is not one of
the program's own kernels (``csrc/``): torch's elementwise, reduction,
sort and copy work, ms a step."""

import re

UNIT = "ms/step"
LAYER = "step loop (solvers/wcsph_binned, solvers/pbf)"
MOVES = "particle_steps_per_s"
# The program's kernels: every __global__ of sph_pie_torch/csrc, each in
# the file's anonymous namespace.
CSRC = r"^void \(anonymous namespace\)::(cell_flags|density_runs|density_every_slot|" \
       r"forces_runs|expand_runs|expand_slots|pbf_runs|pbf_walk|center_slab_\w+|" \
       r"forces_mma_runs|integrate_slots)<"


def read(r):
    if r.slice is None or not r.slice.ops:
        return None
    rx = re.compile(CSRC)
    us = sum(e - s for name, s, e in r.slice.ops if not rx.search(name))
    return us / 1e3 / r.slice.steps
