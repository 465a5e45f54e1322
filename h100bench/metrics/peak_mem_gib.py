"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), in GiB."""

UNIT = "GiB"


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
