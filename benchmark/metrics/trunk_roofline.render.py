"""The eval trunks' share of their roofline: the least time the card could
take for the traced frames' MLP work (both levels at 2 flops a
multiply-add, on the frame's own rays, not on the padded rows,
``flops/<config>.py``) at the bf16 peak, over the device time of the eval
kernels found by name in the trace (rows 1 and 10)."""

from common import PEAK_BF16_FLOPS, kernel_seconds

KERNELS = ("mlp_eval_kernel", "art_eval_kernel")


def read(ctx):
    tr, r = ctx["trace"], ctx["result"]
    t = kernel_seconds(tr, KERNELS) if tr else None
    if not t or not r["traced"]:
        return None
    return 100.0 * r["traced"] * ctx["flops"].frame_flops() / PEAK_BF16_FLOPS / t
