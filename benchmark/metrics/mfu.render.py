"""The whole frame's share of the card's bf16 peak: the model FLOPs of the
frames the traced run rendered after its profiler window
(``flops/<config>.py``, the frames' own rays) over the host's time for
them, without the profiler's cost to the host."""

from common import PEAK_BF16_FLOPS


def read(ctx):
    u = ctx["result"]["untraced"]
    if not u or not u["count"] or u["seconds"] <= 0:
        return None
    return 100.0 * u["count"] * ctx["flops"].frame_flops() / u["seconds"] / PEAK_BF16_FLOPS
