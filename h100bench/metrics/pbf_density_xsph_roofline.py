"""PBF's density+XSPH fold: its least time (``roofline.pbf_bounds``; the
slots and pairs as ``density_roofline``) over the mean device time of a
launch in the profiled slice, in %."""

from h100bench import roofline

UNIT = "%"
LAYER = "PBF folds (neighbors/pbf_folds, csrc/pbf.cu)"
MOVES = "particle_steps_per_s"
PATTERNS = [r"^void \(anonymous namespace\)::pbf_\w+<[^>]*DensityXsphOp"]


def read(r):
    ops = r.slice.matching(PATTERNS) if r.slice is not None else []
    if not ops or not r.pairs:
        return None
    us = sum(e - s for _, s, e in ops) / len(ops)
    es = 4 if r.cfg["dtype"] == "float32" else 8
    least = roofline.pbf_bounds(r.grid.slots, r.n, r.cfg["dim"], es, r.pairs)
    return 100.0 * least["density_xsph"][0] * 1e3 / us
