"""Pairs matched a second: pairs whose matches reached the host within the
window, over the window's seconds."""


def read(ctx):
    w = ctx.window
    return w["pairs"] / w["seconds"] if w.get("pairs") else None
