"""Set-up seconds: process start to the window's first timed operation."""


def read(ctx):
    return ctx.setup_s
