"""Device time of the work launched inside the harness's span around each
frame (``render/splat.render_binned_u8`` and the sum a viewer reads) in the
profiled slice, ms a step."""

UNIT = "ms/step"
LAYER = "frame (render/splat)"
MOVES = "particle_steps_per_s"
SPAN = "h100bench.frame"


def read(r):
    if r.slice is None or not r.slice.span_device_us.get(SPAN):
        return None
    return r.slice.span_device_us[SPAN] / 1e3 / r.slice.steps
