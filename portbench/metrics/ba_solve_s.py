"""Seconds a bundle-adjustment solve takes: the window's time over the
solves it completed."""


def read(ctx):
    w = ctx.window
    return w["seconds"] / w["solves"] if w.get("solves") else None
