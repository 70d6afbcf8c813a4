"""Rays trained in the window over the window: the configuration's rays a
step times the steps of every dispatch the window made, over the host's
time from the window's start to the sync after its last dispatch."""


def read(ctx):
    r = ctx["result"]
    return r["steps"] * r["rays"] / r["window_s"]
