"""PBF's lambda and dx folds together: the sum of their least times
(``roofline.pbf_bounds``; the slots and pairs as ``density_roofline``,
the pairs of the step-start states standing for the projections' moved
ones) over the sum of the mean device times of a lambda launch and a dx
launch in the profiled slice, in %."""

from h100bench import roofline

UNIT = "%"
LAYER = "PBF folds (neighbors/pbf_folds, csrc/pbf.cu)"
MOVES = "particle_steps_per_s"
PATTERNS = {"lambda": [r"^void \(anonymous namespace\)::pbf_\w+<[^>]*LambdaOp"],
            "dx": [r"^void \(anonymous namespace\)::pbf_\w+<[^>]*DxOp"]}


def read(r):
    if r.slice is None or not r.pairs:
        return None
    es = 4 if r.cfg["dtype"] == "float32" else 8
    least = roofline.pbf_bounds(r.grid.slots, r.n, r.cfg["dim"], es, r.pairs)
    bound_ms = us = 0.0
    for op, patterns in PATTERNS.items():
        ops = r.slice.matching(patterns)
        if not ops:
            return None
        us += sum(e - s for _, s, e in ops) / len(ops)
        bound_ms += least[op][0]
    return 100.0 * bound_ms * 1e3 / us
