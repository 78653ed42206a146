"""K5's share of its byte bound in the traced solve: every
``sorted_gather_rows`` call's bytes (``roofline.gather_bytes``) over the
memory rate, over the device time of the operations inside those calls."""

from portbench import roofline


def read(ctx):
    calls = ctx.calls.get("gather")
    if not calls or ctx.trace is None:
        return None
    device_s = ctx.trace["device_s_in"].get("gather")
    if not device_s:
        return None
    least = sum(roofline.bound_s(roofline.gather_bytes(*c))[0] for c in calls)
    return 100.0 * least / device_s
