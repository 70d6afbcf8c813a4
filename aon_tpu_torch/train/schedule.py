"""Learning-rate schedule: log-lerp with sin-delay warmup (port of
``aon_tpu/train/schedule.py``).

Contract of reference ``models/vanilla_nerf/model.py:391-419``:

  delay_rate = mult + (1 - mult) * sin(pi/2 * clip(step/delay_steps, 0, 1))
  t = clip(step / max_steps, 0, 1)
  lr = delay_rate * exp(log(lr_init) * (1 - t) + log(lr_final) * t)

A plain function of the host-side step counter, computed in float32 step by
step as the JAX schedule computes it, so the two agree value for value.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def nerf_lr_schedule(
    lr_init: float = 5.0e-4,
    lr_final: float = 5.0e-6,
    lr_delay_steps: int = 2500,
    lr_delay_mult: float = 0.01,
    max_steps: int = 100000,
) -> Callable[[int], float]:
    f32 = np.float32
    log_init, log_final = f32(math.log(lr_init)), f32(math.log(lr_final))

    def schedule(step: int) -> float:
        step = f32(step)
        if lr_delay_steps > 0:
            ramp = np.clip(step / f32(lr_delay_steps), f32(0), f32(1))
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * math.pi) * ramp, dtype=f32)
        else:
            delay_rate = f32(1)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        scaled = np.exp(log_init * (f32(1) - t) + log_final * t, dtype=f32)
        return float(f32(delay_rate * scaled))

    return schedule
