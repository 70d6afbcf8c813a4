"""The control, the plain reference computed in fp8 (the precision below
the configurations' bf16), comes out not correct under each cell's limits:
tiny on the CPU here, at the cells' own sizes on the card (``-m cuda``).
The program's readings on the same seeds pass."""

from __future__ import annotations

import os

import pytest
import torch

from conftest import BENCH, cells, tiny_overrides

CELLS = cells()
TRAIN = cells("train")


def _calibrate(cell, seeds, device, overrides, data_root):
    from run import cell_run

    with cell_run(cell, seeds[0], overrides=overrides, data_root=data_root) as (run, ov, drv):
        return run["limits"], list(drv.calibrate(run, torch.device(device), seeds, ov))


def _assert_separates(limits, lines):
    for line in lines:
        assert all(line["program"][k] <= lim for k, lim in limits.items()), line
        assert any(line["control"][k] > lim for k, lim in limits.items()), line


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_tiny(cell, data_root):
    overrides = tiny_overrides(cell)
    if cell in TRAIN:
        # 32 + 64 samples a ray: at 8 + 16 the fp8 control's gradients come
        # within the training limits on some seeds
        overrides.update(N_samples=32, N_importance=64)
    limits, lines = _calibrate(cell, [3, 4], "cpu", overrides, data_root)
    _assert_separates(limits, lines)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs the port's kernels")
    limits, lines = _calibrate(cell, [101, 102, 103], "cuda", None, os.path.join(BENCH, "data"))
    _assert_separates(limits, lines)
