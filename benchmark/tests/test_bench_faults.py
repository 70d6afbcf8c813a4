"""A run whose timed path is broken underneath comes out not correct: once
for each fault a cell can have.  Tiny CPU runs on the plain route, and the
training faults at the cells' own sizes on the card (``-m cuda``); the
skipped part of a run is only the look for a card."""

from __future__ import annotations

import contextlib

import pytest
import torch

from conftest import cells

TRAIN_CELLS = cells("train")


def _state_unchanged(tc):
    system = tc.tr.system
    many, one = system.train_many, system.train_step

    def broken_many(state, superbatch, key=None):
        _, metrics = many(state, superbatch, key)
        return state, metrics

    def broken_one(state, batch, key=None, draws=None):
        _, metrics = one(state, batch, key, draws)
        return state, metrics

    system.train_many, system.train_step = broken_many, broken_one


@contextlib.contextmanager
def _half_batch():
    """Every step's gradient taken over the first half of each microbatch's
    rays, the mean over the rest: both callers of ``accumulated_grads``
    (a dispatch of several steps, and of one) see it."""
    from aon_tpu_torch.parallel.mesh import RAY_KEYS
    from aon_tpu_torch.train import microbatch, systems

    inner = microbatch.accumulated_grads

    def broken(loss_fn, params, batch, *args, **kwargs):
        m = batch["rays_o"].shape[-2] // 2
        half = {k: (v[..., :m, :] if v.ndim >= 2 and v.shape[-1] == 3 else v[..., :m])
                if k in RAY_KEYS else v for k, v in batch.items()}
        return inner(loss_fn, params, half, *args, **kwargs)

    microbatch.accumulated_grads = systems.accumulated_grads = broken
    try:
        yield
    finally:
        microbatch.accumulated_grads = systems.accumulated_grads = inner


def _altered_answer(rc):
    inner = rc.tr._render_full

    def broken(params, frame, is_test=False):
        out = dict(inner(params, frame, is_test=is_test))
        out["comp_rgb"] = out["comp_rgb"] + 0.05
        return out

    rc.tr._render_full = broken


def test_state_left_unchanged_is_not_correct(tiny_run):
    for cell in TRAIN_CELLS:
        out = tiny_run(cell, hooks=_state_unchanged)
        assert not out["correct"], cell
        assert out["checks"]["change_ratio"]["value"] > 10


def test_half_batch_is_not_correct(tiny_run):
    for cell in TRAIN_CELLS:
        with _half_batch():
            out = tiny_run(cell)
        assert not out["correct"], (cell, out["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_batch_is_not_correct_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs the port's kernels")
    import run as bench_run

    for seed in (201, 202, 203):
        with _half_batch():
            out = bench_run.run_cell(cell, seed, 1.0, False, device="cuda")
        assert not out["correct"], (cell, seed, out["checks"])
        print(cell, seed, {k: v["value"] for k, v in out["checks"].items()}, flush=True)


def test_altered_answer_is_not_correct(tiny_run):
    for cell in cells("render"):
        out = tiny_run(cell, hooks=_altered_answer)
        assert not out["correct"], cell
        assert any(c["value"] > c["limit"] for c in out["checks"].values()), cell
