"""Host time a step in ``Trainer._dispatch`` outside the loader: stacking
the batches, their copy to the card and the enqueue of ``train_many``
(with any wait for a full launch queue), from the benchmark's spans of the
traced run's window after its profiler window."""


def read(ctx):
    r, u = ctx["result"], ctx["result"]["untraced"]
    dispatch, loader = r["spans"].get("dispatch"), r["spans"].get("loader", [])
    if not (u and dispatch and u["count"]):
        return None
    return 1e3 * (sum(dispatch) - sum(loader)) / u["count"]
