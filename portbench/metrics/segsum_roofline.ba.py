"""K4's share of its byte bound in the traced solve: every
``sorted_segment_sum`` call's bytes (``roofline.segsum_bytes``) over the
memory rate, over the device time of the operations inside those calls."""

from portbench import roofline


def read(ctx):
    calls = ctx.calls.get("segsum")
    if not calls or ctx.trace is None:
        return None
    device_s = ctx.trace["device_s_in"].get("segsum")
    if not device_s:
        return None
    least = sum(roofline.bound_s(roofline.segsum_bytes(*c))[0] for c in calls)
    return 100.0 * least / device_s
