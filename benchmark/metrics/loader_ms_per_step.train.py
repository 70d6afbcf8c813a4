"""Host time in the loader a step: the benchmark's span around each
``next()`` of the Trainer's ray stream, summed over the traced run's
window after its profiler window, over the steps made there."""


def read(ctx):
    r, u = ctx["result"], ctx["result"]["untraced"]
    loader = r["spans"].get("loader")
    return 1e3 * sum(loader) / u["count"] if u and loader and u["count"] else None
