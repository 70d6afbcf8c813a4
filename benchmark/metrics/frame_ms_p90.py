"""The 90th percentile of every frame's time in the window, each from the
call of ``Trainer._render_full`` to the host arrays it returns."""

from common import quantile


def read(ctx):
    return 1e3 * quantile(ctx["result"]["frame_times"], 0.9)
