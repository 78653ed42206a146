"""Device milliseconds a PCG iteration: the device time of the operations
launched inside the traced ``pcg_solve`` calls over the iterations they
ran."""


def read(ctx):
    iters = sum(ctx.calls.get("pcg_solve", ()))
    if not iters or ctx.trace is None:
        return None
    device_s = ctx.trace["device_s_in"].get("pcg_solve")
    return 1e3 * device_s / iters if device_s else None
