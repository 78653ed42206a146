"""Milliseconds an LM iteration: the untraced window solves' time over the
LM iterations they ran (``BAResult.iters``)."""


def read(ctx):
    w = ctx.window
    pairs = [(s, i) for s, i, t in zip(w.get("solve_s", ()), w.get("lm_iters", ()),
                                       w.get("traced", ())) if not t]
    iters = sum(i for _, i in pairs)
    return 1e3 * sum(s for s, _ in pairs) / iters if iters else None
