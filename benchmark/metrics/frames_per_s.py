"""Frames rendered to host arrays in the window over the window."""


def read(ctx):
    r = ctx["result"]
    return r["frames"] / r["window_s"]
