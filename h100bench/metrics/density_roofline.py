"""The least time of the density fold's work (``roofline.density_bound``:
the configuration's slots, every particle occupied, the pairs in support
averaged over the states at the profiled slice's start and end) over the
mean device time of a ``density_runs`` launch in the slice, in %."""

from h100bench import roofline

UNIT = "%"
LAYER = "WCSPH pair kernels (neighbors/density, neighbors/forces, csrc/density.cu, csrc/forces.cu)"
MOVES = "particle_steps_per_s"
PATTERNS = [r"^void \(anonymous namespace\)::density_runs<"]


def read(r):
    ops = r.slice.matching(PATTERNS) if r.slice is not None else []
    if not ops or not r.pairs:
        return None
    us = sum(e - s for _, s, e in ops) / len(ops)
    es = 4 if r.cfg["dtype"] == "float32" else 8
    least, _ = roofline.density_bound(r.grid.slots, r.n, r.cfg["dim"], es, r.pairs)
    return 100.0 * least * 1e3 / us
