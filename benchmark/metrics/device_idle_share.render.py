"""The device's idle share of the profiler window: 1 - (the union of its
kernels, copies and sets) / (the window).  The profiler slows the host, so
where the host paces the loop this reads higher than without it."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr and tr["window_s"] else None
