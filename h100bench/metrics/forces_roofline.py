"""The least time of the forces fold's work (``roofline.forces_bound``,
with cohesion and XSPH as the configuration states them; the slots and
pairs as ``density_roofline``) over the mean device time of a
``forces_runs`` launch in the profiled slice, in %."""

from h100bench import roofline

UNIT = "%"
LAYER = "WCSPH pair kernels (neighbors/density, neighbors/forces, csrc/density.cu, csrc/forces.cu)"
MOVES = "particle_steps_per_s"
PATTERNS = [r"^void \(anonymous namespace\)::forces_runs<"]


def read(r):
    ops = r.slice.matching(PATTERNS) if r.slice is not None else []
    if not ops or not r.pairs:
        return None
    us = sum(e - s for _, s, e in ops) / len(ops)
    es = 4 if r.cfg["dtype"] == "float32" else 8
    least, _ = roofline.forces_bound(r.grid.slots, r.n, r.cfg["dim"], es, r.pairs,
                                     r.cfg["surface_tension"] > 0, r.cfg["xsph_eps"] > 0)
    return 100.0 * least * 1e3 / us
