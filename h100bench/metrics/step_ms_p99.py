"""The 99th percentile over every step of the window of the time between
its end and the previous step's end (a segment's first step includes the
segment's binning), from one CUDA event recorded after each step and read
after the window. The 99th and not the 95th: a rebin step takes ~10 ms
against ~5.7 at 1M, and rebins are ~5% of the WCSPH cell's steps, so the
95th percentile falls between the two kinds of step and flips with the
seed; the 99th lies among the rebin steps, the stalls a viewer sees."""

import statistics

UNIT = "ms"
STEP_EVENTS = True


def read(r):
    if not r.step_ms or len(r.step_ms) < 1000:
        return None
    return statistics.quantiles(r.step_ms, n=100)[98]
