"""Benchmark: ARTICULATED (auto-decoder) training throughput on the card --
the latent-conditioned deformation NeRF hot path (port of
``scripts/bench_art.py``; reference model_autodecoder.py + sapien_multi
4096-ray items).

    python -m aon_tpu_torch.scripts.bench_art [--batch 4096] [--fused v3|v2]
        [--steps_per_dispatch 8]

One seeded host batch (``rng(0)`` unit rays from radius-4 origins, uniform
targets, instance 0, articulation 1), ``stack_step_batches`` of T copies as
microbatches of the config's ``microbatch_rays``; 2 warm dispatches of
``train_many``, then 4 timed ones, each ended by reading the loss back.
``--fused v3`` trains through row 9 (the articulated level) and row 2, ``v2``
through rows 10, 11 and 2.  Prints the card's name and power limit, then one
line ``{"metric": "art_train_rays_per_sec", "value", "unit", "fused"}``.
Runs on ``cuda``; ``main(argv, device="cpu")`` takes the plain route.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from aon_tpu_torch.parallel.mesh import stack_step_batches
from aon_tpu_torch.train.systems import AutoDecoderSystem
from aon_tpu_torch.utils.config import Config
from aon_tpu_torch.utils.device import DeviceLike, card_name, resolve_device

WARMUP_DISPATCHES, TIMED_DISPATCHES = 2, 4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--fused", default="v3", choices=["v3", "v2"])
    ap.add_argument("--steps_per_dispatch", type=int, default=8)
    return ap


def bench_config(batch: int, fused: str) -> Config:
    return Config(exp_type="vanilla_autodecoder", batch_size=batch, compute_dtype="bfloat16",
                  fused_train=fused)


def host_batch(batch: int) -> Dict[str, np.ndarray]:
    g = np.random.default_rng(0)
    d = g.normal(size=(batch, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "rays_o": (d * -4.0).astype(np.float32),
        "rays_d": d,
        "viewdirs": d,
        "target": g.uniform(size=(batch, 3)).astype(np.float32),
        "instance_id": np.array(0),
        "articulation_id": np.array(1),
    }


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda") -> dict:
    """Print the card and the rate line; return the line's record with the
    unrounded rate, the dispatches' losses and the seconds timed."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    print(json.dumps({"card": card_name(device)}), flush=True)
    cfg = bench_config(args.batch, args.fused)
    system = AutoDecoderSystem(cfg, near=2.0, far=6.0, white_bkgd=False, device=device)
    state = system.init_state(torch.Generator(device=device).manual_seed(0))
    T = args.steps_per_dispatch
    super_b = stack_step_batches([host_batch(args.batch)] * T, cfg.microbatch_rays, device)

    def dispatch(state, i):
        state, m = system.train_many(state, super_b, torch.Generator(device=device).manual_seed(i))
        return state, m["train/loss"].item()  # forced readback

    losses = []
    for i in range(WARMUP_DISPATCHES):
        state, loss = dispatch(state, 1 + i)
        losses.append(loss)
    t0 = time.perf_counter()
    for i in range(TIMED_DISPATCHES):
        state, loss = dispatch(state, 11 + i)
        losses.append(loss)
    dt = time.perf_counter() - t0
    rays_per_sec = args.batch * T * TIMED_DISPATCHES / dt
    rec = {"metric": "art_train_rays_per_sec", "value": rays_per_sec, "unit": "rays/s",
           "fused": args.fused}
    print(json.dumps(dict(rec, value=round(rays_per_sec, 1))), flush=True)
    return dict(rec, losses=losses, seconds=dt, steps=T * TIMED_DISPATCHES)


if __name__ == "__main__":
    main()
