"""From the process's start to the window's: imports, the kernel library
(built at a checkout's first run), the inputs, the program's scene and the
warm-up."""

UNIT = "s"


def read(r):
    return r.setup_s
