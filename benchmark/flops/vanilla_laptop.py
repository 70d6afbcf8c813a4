"""Model FLOPs of ``vanilla_laptop``, from its shapes alone.

A sample row of the NeRF MLP costs, in multiply-adds, its dense layers at
the function's own widths (63 encoded xyz channels, 27 encoded view
channels, no padding): the 8 x 256 trunk with the encoded input read again
at layer 5, the density head, the 256 bottleneck, one 128-wide view layer
and the rgb head: 593,408.  A ray has 64 + 1 coarse rows and 64 + 1 + 128
fine rows.  Training counts 6 flops a multiply-add (the forward, the input
gradient and the weight gradient), rendering 2.
"""

XYZ, VIEW = 3 * (2 * 10 + 1), 3 * (2 * 4 + 1)
MACS_PER_ROW = (XYZ * 256 + 4 * 256 * 256 + (256 + XYZ) * 256 + 2 * 256 * 256
                + 256 + 256 * 256 + (256 + VIEW) * 128 + 128 * 3)
COARSE_ROWS, FINE_ROWS = 64 + 1, 64 + 1 + 128
RAYS_PER_STEP = 2048
FRAME_RAYS = 640 * 480


def level_flops(rays: int, rows_per_ray: int, train: bool) -> float:
    return float(rays) * rows_per_ray * MACS_PER_ROW * (6 if train else 2)


def train_step_flops() -> float:
    return sum(level_flops(RAYS_PER_STEP, r, True) for r in (COARSE_ROWS, FINE_ROWS))


def frame_flops() -> float:
    return sum(level_flops(FRAME_RAYS, r, False) for r in (COARSE_ROWS, FINE_ROWS))
