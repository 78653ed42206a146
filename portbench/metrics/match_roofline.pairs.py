"""K1's share of its roofline: the least time the card could take for the
matching work of the traced ``match_batch`` calls (``roofline.match_work``)
over the device time of every operation launched inside those calls."""

from portbench import roofline


def read(ctx):
    calls = ctx.calls.get("match_batch")
    if not calls or ctx.trace is None:
        return None
    device_s = ctx.trace["device_s_in"].get("match_batch")
    if not device_s:
        return None
    least = 0.0
    for live_a, live_b, cap_a, cap_b, dim, fast in calls:
        ops, n_bytes, peak = roofline.match_work(live_a, live_b, cap_a, cap_b, dim, fast)
        least += roofline.bound_s(n_bytes, ops, peak)[0]
    return 100.0 * least / device_s
