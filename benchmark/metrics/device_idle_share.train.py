"""The device's idle share of the profiler window: 1 - (the union of its
kernels, copies and sets) / (the window).

Read under the profiler, which records the host's activity too (its CUDA
activity alone recorded no device time on the card): that slows the host,
so where the host paces the loop this share is the profiled loop's, not the
untraced one's (``vanilla_train``: a step of 12.1 ms under the profiler
against 7.9 ms without, and an idle share of ~53% where the untraced step
times imply ~20%).  Compare it only with other traced runs of the same
harness; it moves with the profiler's host cost as well as the program's."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr and tr["window_s"] else None
