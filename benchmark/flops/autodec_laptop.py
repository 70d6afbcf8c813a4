"""Model FLOPs of ``autodec_laptop``, from its shapes alone.

A sample row of the articulated MLP costs, in multiply-adds, its dense
layers on the columns that vary from row to row: the deformation MLP on xyz
(3 channels; the shape and articulation codes are one step's constants and
enter as a bias), 3 x 128 x 128 and the 3-vector head, the trunk on the 63
encoded channels (the shape code again a bias) with them read again at
layer 5, the density head and bottleneck, the 4 x 128 view branch on the
bottleneck and 27 view channels (the appearance code a bias) and the rgb
head: 692,480.  A ray has 64 + 1 coarse rows and 64 + 1 + 128 fine rows.
Training counts 6 flops a multiply-add, rendering 2.
"""

XYZ, VIEW = 3 * (2 * 10 + 1), 3 * (2 * 4 + 1)
DEFORM = 3 * 128 + 3 * 128 * 128 + 128 * 3
TRUNK = XYZ * 256 + 4 * 256 * 256 + (256 + XYZ) * 256 + 2 * 256 * 256
HEADS = 256 + 256 * 256 + (256 + VIEW) * 128 + 3 * 128 * 128 + 128 * 3
MACS_PER_ROW = DEFORM + TRUNK + HEADS
COARSE_ROWS, FINE_ROWS = 64 + 1, 64 + 1 + 128
RAYS_PER_STEP = 4096
FRAME_RAYS = 320 * 240


def level_flops(rays: int, rows_per_ray: int, train: bool) -> float:
    return float(rays) * rows_per_ray * MACS_PER_ROW * (6 if train else 2)


def train_step_flops() -> float:
    return sum(level_flops(RAYS_PER_STEP, r, True) for r in (COARSE_ROWS, FINE_ROWS))


def frame_flops() -> float:
    return sum(level_flops(FRAME_RAYS, r, False) for r in (COARSE_ROWS, FINE_ROWS))
