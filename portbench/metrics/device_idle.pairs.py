"""Idle share of the device in the traced slice: 1 - (union of kernel,
copy and fill intervals) / the slice, in percent."""

from portbench.trace import idle_percent


def read(ctx):
    return idle_percent(ctx.trace) if ctx.trace else None
