"""All particle-steps of the window over the window's whole time, segment
starts included (host clock around the synchronised window)."""

UNIT = "particle-steps/s"


def read(r):
    return r.n * r.steps / r.seconds
