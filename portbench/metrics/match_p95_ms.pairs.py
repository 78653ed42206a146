"""95th percentile (nearest rank), in ms, of a batch's time from submission
to its matches on the host, over the window's batches that completed while
the profiler was off: a traced run leaves out its profiled slice, where the
profiler's host cost slows the loop."""

import math


def read(ctx):
    lat = sorted(ctx.window.get("latency_off_s", ()))
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
