"""All steps of the window over the window's whole time, segment starts
included (host clock around the synchronised window)."""

UNIT = "steps/s"


def read(r):
    return r.steps / r.seconds
