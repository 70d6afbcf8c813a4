"""Host-path profile of the articulated systems' training step (port of
``scripts/profile_ae_host.py``): where the time between the bench's rate on
one staged batch and a real run's rate goes.

The trainer's step loop is: T x ``next(it)`` (host batch assembly: ray
gather, source images, masks) -> ``stack_step_batches`` (host stack and copy
to the card) -> ``train_many`` (T optimizer steps).  Each stage is timed
alone on the config's real dataset through the port's ``Trainer``:

    python -m aon_tpu_torch.scripts.profile_ae_host --config configs/quality_laptop_ae_aabb24.json

Stages (rates in rays/s at the config's ray_batch_size):
  iterator   -- ``next(it)`` alone, with ``bg_scale`` / ``interval_ramp``
                injected as the trainer injects them
  stage      -- stack_step_batches on pre-drawn batches, synchronized per
                dispatch
  dispatch   -- train_many on ONE staged super-batch, re-dispatched, each
                dispatch ended by reading the loss back
  end2end    -- the trainer's loop shape (iterate + stage + dispatch)

``host_share_if_serial`` = (iterator + stage) / (iterator + stage +
dispatch).  On the card the report also carries the device's idle share of
one more dispatch of the ``dispatch`` and of the ``end2end`` loop under
``torch.profiler`` (``utils/profiling.py::device_idle``; the timed loops run
without it), and the card's name and power limit.  Further arguments are the
CLI's config flags.  Runs on ``cuda``; ``main(argv, device="cpu")`` takes the
plain route.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

from aon_tpu_torch.parallel.mesh import stack_step_batches
from aon_tpu_torch.train.trainer import Trainer, inject_ramps
from aon_tpu_torch.utils.config import get_config
from aon_tpu_torch.utils.device import DeviceLike, card_name, resolve_device
from aon_tpu_torch.utils.profiling import device_idle

IDLE_DISPATCHES = 1  # dispatches of each loop under the profiler (its trace of
# the encoder's thousands of launches takes tens of seconds to read)


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--dispatches", type=int, default=12,
                    help="timed dispatches per stage (after 2 warmups)")
    args, overrides = ap.parse_known_args(argv)
    cfg = get_config(["--config", args.config] + overrides)
    device = resolve_device(device)

    tr = Trainer(cfg, device=device)
    t_disp = max(1, cfg.steps_per_dispatch)
    rays_per_step = cfg.ray_batch_size
    rays_per_dispatch = rays_per_step * t_disp
    it = tr._train_iterator()
    generator = tr.step_generator(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def draw(step0):
        batches = [next(it) for _ in range(t_disp)]
        for j, b in enumerate(batches):
            inject_ramps(cfg, b, step0 + j)
        return batches

    def stage(batches):
        return stack_step_batches(batches, microbatch=cfg.microbatch_rays, device=device)

    def dispatch(state, staged):
        state, m = tr.system.train_many(state, staged, generator)
        _ = m["train/loss"].item()  # forced readback, as the trainer's log step
        return state

    n = args.dispatches
    report = {"config": args.config, "exp_type": cfg.exp_type,
              "steps_per_dispatch": t_disp, "ray_batch_size": rays_per_step,
              "card": card_name(device)}

    # -- iterator alone ----------------------------------------------------
    draw(0)  # warm the frame cache
    t0 = time.perf_counter()
    pre_drawn = [draw(i * t_disp) for i in range(n)]
    dt = time.perf_counter() - t0
    report["iterator_rays_per_sec"] = n * rays_per_dispatch / dt
    report["iterator_ms_per_dispatch"] = 1e3 * dt / n

    # -- staging (stack + copy to the card) on the pre-drawn batches -------
    staged = stage(pre_drawn[0])
    sync()
    t0 = time.perf_counter()
    for bs in pre_drawn:
        staged = stage(bs)
        sync()  # per dispatch: no copy may overlap the next stage's timing
    dt = time.perf_counter() - t0
    report["stage_rays_per_sec"] = n * rays_per_dispatch / dt
    report["stage_ms_per_dispatch"] = 1e3 * dt / n

    # -- dispatch on ONE staged batch (the bench's contract) ---------------
    state = dispatch(tr.state, staged)  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        state = dispatch(state, staged)
    dt = time.perf_counter() - t0
    report["dispatch_rays_per_sec"] = n * rays_per_dispatch / dt
    report["dispatch_ms_per_dispatch"] = 1e3 * dt / n

    # -- end-to-end trainer loop shape -------------------------------------
    t0 = time.perf_counter()
    for i in range(n):
        state = dispatch(state, stage(draw((n + i) * t_disp)))
    dt = time.perf_counter() - t0
    report["end2end_rays_per_sec"] = n * rays_per_dispatch / dt
    report["end2end_ms_per_dispatch"] = 1e3 * dt / n

    host_ms = report["iterator_ms_per_dispatch"] + report["stage_ms_per_dispatch"]
    dev_ms = report["dispatch_ms_per_dispatch"]
    report["host_share_if_serial"] = host_ms / (host_ms + dev_ms)

    # -- the device's idle share of each device loop -----------------------
    with device_idle(device) as window:
        for _ in range(IDLE_DISPATCHES):
            state = dispatch(state, staged)
    report["dispatch_device_idle_share"] = window["device_idle_share"]
    with device_idle(device) as window:
        for i in range(IDLE_DISPATCHES):
            state = dispatch(state, stage(draw((2 * n + i) * t_disp)))
    report["end2end_device_idle_share"] = window["device_idle_share"]
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
