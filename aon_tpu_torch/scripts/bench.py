"""Benchmark: NeRF training throughput (rays/s) of the port (port of
``bench.py``).

    python -m aon_tpu_torch.scripts.bench [--N_samples 16] [--N_importance 32]
        [--batch 32768] [--tight {occ,aabb} | --no_tight] [--reference_contract]
        [--headline_only]

Prints the JAX bench's lines, one JSON object each:

  {"metric": "train_rays_per_sec", "value": N, "unit": "rays/s", "vs_baseline": R}

for the vanilla system, then, unless ``--headline_only``, the same line as
``train_rays_per_sec_autodecoder`` for the auto-decoder and as
``train_rays_per_sec_ae`` for the auto-encoder.  ``vs_baseline`` divides by
the JAX bench's constant ``REFERENCE_RAYS_PER_SEC``, the reference's nominal
single-GPU rate.

Defaults are the JAX bench's production contract: vanilla at 32,768 rays a
step with 16 coarse + 32 fine samples and per-ray occupancy intervals
(``_synthetic_batch(tight="occ")``); the auto-decoder at its 4,096-ray batch
with 24 + 48 samples and AABB intervals, and the auto-encoder at the same
contract with a random (1, 3, 240, 320) source image, joint angle 0.5 rad and
a mask of ``uniform > 0.5`` (the JAX bench's ``bench_ae``, at the config's
default relu sigma).  ``--reference_contract`` runs the reference's 64 + 128
samples on [2, 6] for every system.

Timing: each system trains on one synthetic batch repeated for T = 8 steps
per ``train_many`` call (``stack_step_batches``, microbatches of the config's
``microbatch_rays``); 2 warm-up calls, then 4 timed ones, each ended by
``torch.cuda.synchronize()``.  Rays/s = rays per step x 8 x 4 over the host
clock of the timed calls.  Runs on the card unless ``device="cpu"`` is
passed to ``main``, where the systems take their plain PyTorch route.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from aon_tpu_torch.core import prng
from aon_tpu_torch.parallel.mesh import stack_step_batches
from aon_tpu_torch.train.systems import AutoDecoderSystem, VanillaSystem, build_system
from aon_tpu_torch.utils.config import Config
from aon_tpu_torch.utils.device import DeviceLike, resolve_device

# The JAX bench's normalization constant for vs_baseline (bench.py): the
# reference's estimated rate on its quoted hardware, not a measurement.
REFERENCE_RAYS_PER_SEC = 25000.0
STEPS_PER_DISPATCH, WARMUP_DISPATCHES, TIMED_DISPATCHES = 8, 2, 4


def _synthetic_batch(batch: int, tight, seed: int = 0):
    """Random unit rays from radius-4 origins; with ``tight``, per-ray
    intervals matching the measured laptop-scene distribution — cost
    depends only on sample count, the values just have to be realistic.

    tight="aabb": scene-box slab intervals (mean span ~0.65 around t=3.7).
    tight="occ":  occupancy-grid-refined intervals.  Measured on
      data/laptop_single train rays: t_near mean 3.73 [p5 3.11, p95 4.41],
      span mean 0.19 [p5 0.04, p95 0.69] (aon_tpu/data/occgrid.py); the
      lognormal below is an APPROXIMATION of that distribution (its own
      p95 is ~0.57) — throughput depends only on the sample count, which
      is identical, not on the interval values.
    """
    g = np.random.default_rng(seed)
    d = g.normal(size=(batch, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = {
        "rays_o": (d * -4.0).astype(np.float32),
        "rays_d": d,
        "viewdirs": d,
        "target": g.uniform(size=(batch, 3)).astype(np.float32),
    }
    if tight == "occ":
        tn = g.normal(3.73, 0.4, size=batch).clip(3.0, 4.5).astype(np.float32)
        span = g.lognormal(np.log(0.13), 0.9, size=batch).clip(0.03, 1.37)
        b["t_near"] = tn
        b["t_far"] = (tn + span).astype(np.float32)
    elif tight:  # "aabb" (or legacy True)
        tn = g.uniform(3.2, 3.6, size=batch).astype(np.float32)
        b["t_near"] = tn
        b["t_far"] = tn + g.uniform(0.4, 0.9, size=batch).astype(np.float32)
    return b


def _time_train_many(system, host_batch, microbatch: int, device: torch.device) -> dict:
    """Rays/s of ``system.train_many`` on ``host_batch`` repeated for
    STEPS_PER_DISPATCH steps per call, and what the calls saw."""
    super_b = stack_step_batches([host_batch] * STEPS_PER_DISPATCH, microbatch, device)
    # the JAX bench's keys: init from key 0, dispatch i from fold_in(key 1, i)
    state = system.init_state(prng.key(0))
    key = prng.key(1)

    def dispatch(state, i):
        state, metrics = system.train_many(state, super_b, prng.fold_in(key, i))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return state, metrics["train/loss"]

    losses = []
    for i in range(WARMUP_DISPATCHES):
        state, loss = dispatch(state, i)
        losses.append(loss)
    t0 = time.perf_counter()
    for i in range(TIMED_DISPATCHES):
        state, loss = dispatch(state, 10 + i)
        losses.append(loss)
    seconds = time.perf_counter() - t0
    rays = host_batch["rays_o"].shape[0]
    steps = STEPS_PER_DISPATCH * TIMED_DISPATCHES
    return {"rays_per_s": rays * steps / seconds, "ms_per_step": 1e3 * seconds / steps,
            "rays_per_step": rays, "microbatch": min(microbatch, rays),
            "steps_per_dispatch": STEPS_PER_DISPATCH, "timed_dispatches": TIMED_DISPATCHES,
            "dispatch_losses": [v.item() for v in losses], "final_step": state.step}


def bench_vanilla(args, device: torch.device) -> dict:
    cfg = Config(batch_size=args.batch, compute_dtype="bfloat16",
                 N_samples=args.N_samples, N_importance=args.N_importance)
    system = VanillaSystem(cfg, near=2.0, far=6.0, white_bkgd=True, device=device)
    host_batch = _synthetic_batch(args.batch, tight=args.tight)
    return _time_train_many(system, host_batch, cfg.microbatch_rays, device)


def bench_autodecoder(args, device: torch.device) -> dict:
    batch = 4096  # the articulated ray_batch_size contract
    cfg = Config(ray_batch_size=batch, batch_size=batch, compute_dtype="bfloat16",
                 N_samples=args.N_samples, N_importance=args.N_importance, N_max_objs=8)
    system = AutoDecoderSystem(cfg, near=2.0, far=6.0, white_bkgd=False, device=device)
    host_batch = _synthetic_batch(batch, tight=args.tight, seed=1)
    host_batch["instance_id"] = np.int32(0)
    host_batch["articulation_id"] = np.int32(1)
    return _time_train_many(system, host_batch, cfg.microbatch_rays, device)


def ae_batch(batch: int, tight, img_wh=(320, 240)) -> Dict[str, np.ndarray]:
    """The auto-encoder's bench batch: ``_synthetic_batch`` with an instance
    mask of ``uniform > 0.5``, a random (1, 3, H, W) source image and joint
    angle 0.5 rad, drawn as the JAX bench's ``bench_ae`` draws them."""
    g = np.random.default_rng(2)
    host_batch = _synthetic_batch(batch, tight=tight, seed=2)
    host_batch["instance_mask"] = (g.uniform(size=batch) > 0.5).astype(np.float32)
    host_batch["src_imgs"] = g.normal(size=(1, 3, img_wh[1], img_wh[0])).astype(np.float32)
    host_batch["deg"] = np.float32(0.5)
    return host_batch


def bench_ae(args, device: torch.device) -> dict:
    batch = 4096
    cfg = Config(exp_type="vanilla_ae_art", ray_batch_size=batch, batch_size=batch,
                 compute_dtype="bfloat16", img_wh=[320, 240],
                 N_samples=args.N_samples, N_importance=args.N_importance)
    system = build_system(cfg, near=2.0, far=6.0, white_bkgd=False, device=device)
    return _time_train_many(system, ae_batch(batch, args.tight), cfg.microbatch_rays, device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # defaults: the production equal-PSNR contract of the JAX bench
    p.add_argument("--N_samples", type=int, default=16)
    p.add_argument("--N_importance", type=int, default=32)
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--tight", nargs="?", const="occ", default="occ", choices=["aabb", "occ"],
                   help="per-ray interval distribution (default and bare const: occ; pass "
                        "--tight aabb explicitly for the looser slab-only contract)")
    p.add_argument("--no_tight", dest="tight", action="store_false")
    p.add_argument("--reference_contract", action="store_true",
                   help="benchmark the reference's 64+128-sample [2,6] recipe")
    p.add_argument("--headline_only", action="store_true",
                   help="skip the articulated/AE informational rates")
    return p


def _line(metric: str, rays_per_s: float) -> str:
    return json.dumps({"metric": metric, "value": round(rays_per_s, 1), "unit": "rays/s",
                       "vs_baseline": round(rays_per_s / REFERENCE_RAYS_PER_SEC, 3)})


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda") -> Dict[str, dict]:
    """Run the bench and print its lines; returns each system's measurement
    (rays/s, ms per step, the loss of every call) with its contract."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    if args.reference_contract:
        args.N_samples, args.N_importance, args.tight = 64, 128, False

    def contract(a):
        return {"samples": [a.N_samples, a.N_importance], "tight": a.tight}

    results = {"vanilla": dict(bench_vanilla(args, device), **contract(args))}
    print(_line("train_rays_per_sec", results["vanilla"]["rays_per_s"]), flush=True)
    if args.headline_only:
        return results
    # each articulated system at the contract its equal-PSNR evidence gates
    # (the JAX bench's choice): 24 + 48 samples with AABB intervals
    art_args = argparse.Namespace(**vars(args))
    if not args.reference_contract:
        art_args.N_samples, art_args.N_importance, art_args.tight = 24, 48, "aabb"
    for name, fn in (("autodecoder", bench_autodecoder), ("ae", bench_ae)):
        results[name] = dict(fn(art_args, device), **contract(art_args))
        print(_line(f"train_rays_per_sec_{name}", results[name]["rays_per_s"]), flush=True)
    return results


if __name__ == "__main__":
    main()
