"""The training levels' share of their roofline: the least time the card
could take for the traced steps' level work (both levels, forward and
backward, 6 flops a multiply-add on the sample rows, ``flops/<config>.py``)
at the bf16 peak, over the device time of the level kernels found by name
in the trace (rows 3 and 9 of the port's kernel table)."""

from common import PEAK_BF16_FLOPS, kernel_seconds

KERNELS = ("sm90_train_fwd", "composite_kernel", "sm90_train_bwd", "wgrad_kernel",
           "art_train_fwd", "art_composite_kernel", "art_train_bwd")


def read(ctx):
    tr, r = ctx["trace"], ctx["result"]
    t = kernel_seconds(tr, KERNELS) if tr else None
    if not t or not r["traced"]:
        return None
    return 100.0 * r["traced"] * ctx["flops"].train_step_flops() / PEAK_BF16_FLOPS / t
