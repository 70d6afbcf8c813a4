"""The auto-encoder's device-side split: where does its training step's time
go? (port of ``scripts/roofline_ae.py``)

The auto-encoder's step is the auto-decoder's two-level NeRF body (the same
``ArticulatedNeRF`` levels, latents folded into the kernels' biases) plus the
ResNet-34 encoder's forward and backward (reference resnet_encoder.py:292-531)
and the masked-MSE / BCE epilogue.  Four stages, each timed over
``--dispatches`` dispatches ended by a readback of one scalar:

  ae_full        -- the auto-encoder's ``train_many`` dispatch (the bench's
                    contract: T = 8 steps of 4,096 rays, 24 + 48 samples on
                    AABB intervals, bf16 NeRF levels, the encoder in float32)
  enc_fwd        -- T encoder (+ joint-state head) forwards on the bench's
                    (1, 3, 240, 320) source image
  enc_fwd_bwd    -- the same with the backward to the encoder's and the
                    head's weights
  autodec_body   -- the auto-decoder's ``train_many`` at the same contract:
                    the NeRF body without the encoder

Derived: ``encoder_share_of_ae_step`` = enc_fwd_bwd / ae_full,
``nerf_body_share_estimate`` = autodec_body / ae_full,
``rays_per_sec_if_encoder_free`` = rays per dispatch / (ae_full -
enc_fwd_bwd) and its ratio to the bench's ``REFERENCE_RAYS_PER_SEC``.

FLOPs per dispatch: the encoder's from ``torch.utils.flop_counter.
FlopCounterMode`` over one dispatch of each encoder stage (two a multiply-add
of every convolution's whole window and every matmul, not the norms and
elementwise work; the JAX script's XLA ``cost_analysis`` counts only the taps
inside the unpadded input, plus the elementwise work); the NeRF levels' from
the kernels' multiply-adds per sample row (``ART_MACS_PER_SAMPLE``) times the
rows, x2 for a multiply-add and x3 for the forward and the two backward
products (the custom kernels are invisible to the counter).

    python -m aon_tpu_torch.scripts.roofline_ae [--N_samples 24 --N_importance 48]
        [--tight aabb|occ] [--dispatches 6] [--out results/torch_roofline_ae.json]

Writes the report (with the card's name and power limit) to ``--out`` and
prints it.  Runs on ``cuda``; ``main(argv, device="cpu")`` takes the plain
route, and ``measure`` takes a smaller contract for a check.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from aon_tpu_torch.core import prng
from aon_tpu_torch.ops.fused_mlp import MLP_MACS_PER_SAMPLE
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.parallel.mesh import stack_step_batches
from aon_tpu_torch.scripts.bench import REFERENCE_RAYS_PER_SEC, _synthetic_batch, ae_batch
from aon_tpu_torch.train.systems import AutoDecoderSystem, build_system
from aon_tpu_torch.utils.config import Config
from aon_tpu_torch.utils.device import DeviceLike, card_name, resolve_device

# Multiply-adds per sample row of the articulated level kernels: the vanilla
# MLP's plus the deformation's 3x128 + 3 x 128x128 + 128x3 (49,920) and the
# view branch's three further 128x128 layers (49,152); the latent codes'
# products are folded into per-step biases, once a step, not per row.
ART_MACS_PER_SAMPLE = MLP_MACS_PER_SAMPLE + 49920 + 49152
WARMUP_DISPATCHES = 2
BATCH, STEPS_PER_DISPATCH, IMG_WH = 4096, 8, (320, 240)  # the bench's contract


def _timed(fn: Callable[[], torch.Tensor], n: int) -> float:
    """Seconds per call of ``fn`` over ``n`` calls, each ended by reading its
    scalar back, after one warm call."""
    fn().item()
    t0 = time.perf_counter()
    for _ in range(n):
        fn().item()
    return (time.perf_counter() - t0) / n


def _flops(fn: Callable[[], torch.Tensor]) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def nerf_level_flops(batch: int, steps: int, n_coarse: int, n_fine: int) -> float:
    """Forward and backward flops of both levels' MLPs over one dispatch."""
    rows = batch * ((n_coarse + 1) + (n_coarse + 1 + n_fine))
    return 3 * 2.0 * ART_MACS_PER_SAMPLE * rows * steps


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--N_samples", type=int, default=24)
    ap.add_argument("--N_importance", type=int, default=48)
    ap.add_argument("--tight", default="aabb", choices=["aabb", "occ"])
    ap.add_argument("--dispatches", type=int, default=6)
    ap.add_argument("--out", default="results/torch_roofline_ae.json")
    return ap


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda") -> dict:
    return measure(build_parser().parse_args(argv), device)


def measure(args: argparse.Namespace, device: DeviceLike = "cuda", batch: int = BATCH,
            steps_per_dispatch: int = STEPS_PER_DISPATCH, img_wh=IMG_WH) -> dict:
    """The report of ``main`` for the parsed ``args``, at ``batch`` rays a step,
    ``steps_per_dispatch`` steps a dispatch and ``img_wh`` source images."""
    device = resolve_device(device)
    T, n = steps_per_dispatch, args.dispatches
    rays_per_dispatch = batch * T
    report = {
        "contract": f"{args.N_samples}+{args.N_importance} {args.tight}, "
                    f"{batch}-ray steps, T={T}, bf16 levels, float32 encoder",
        "card": card_name(device),
    }

    def train_many_fn(system, host_batch, microbatch):
        superbatch = stack_step_batches([host_batch] * T, microbatch, device)
        # the JAX script's keys: init from key 0, warm-up dispatch i from
        # fold_in(key 1, i), every timed dispatch from fold_in(key 1, 99)
        state = system.init_state(prng.key(0))
        for i in range(WARMUP_DISPATCHES):
            state, m = system.train_many(state, superbatch, prng.fold_in(prng.key(1), i))
            m["train/loss"].item()
        timed_key = prng.fold_in(prng.key(1), 99)
        holder = {"state": state}

        def step():
            holder["state"], m = system.train_many(holder["state"], superbatch, timed_key)
            return m["train/loss"]

        return step, holder

    # ---- the auto-encoder's full step --------------------------------------
    cfg = Config(exp_type="vanilla_ae_art", ray_batch_size=batch, batch_size=batch,
                 compute_dtype="bfloat16", img_wh=list(img_wh),
                 N_samples=args.N_samples, N_importance=args.N_importance)
    system = build_system(cfg, near=2.0, far=6.0, white_bkgd=False, device=device)
    hb = ae_batch(batch, args.tight, img_wh=tuple(img_wh))
    full_step, holder = train_many_fn(system, hb, cfg.microbatch_rays)
    t_full = _timed(full_step, n)
    report["ae_full_ms_per_dispatch"] = 1e3 * t_full
    report["ae_full_rays_per_sec"] = rays_per_dispatch / t_full

    # ---- the encoder forward alone (T applications a dispatch) -------------
    params = holder["state"].params
    enc_params = {k: v.detach() for k, v in mlp_params(params, "encoder").items()}
    js_params = {k: v.detach() for k, v in mlp_params(params, "joint_state").items()}
    src = torch.from_numpy(hb["src_imgs"]).to(device)

    def encode_sum(p_enc, p_js):
        total = torch.zeros((), device=device)
        for _ in range(T):
            lat = torch.func.functional_call(system.encoder, p_enc, (src,))
            ps = torch.func.functional_call(system.joint_state, p_js, (lat["articulation"],))
            total = total + sum(v.float().sum() for v in lat.values()) + ps.float().sum()
        return total

    def enc_fwd():
        with torch.no_grad():
            return encode_sum(enc_params, js_params)

    t_enc_fwd = _timed(enc_fwd, n)
    report["enc_fwd_ms_per_dispatch"] = 1e3 * t_enc_fwd
    report["enc_fwd_flops_per_dispatch"] = _flops(enc_fwd)

    # ---- the encoder forward and backward ----------------------------------
    def enc_fwd_bwd():
        leaves = {k: v.requires_grad_(True) for k, v in {**enc_params, **js_params}.items()}
        with torch.enable_grad():
            val = encode_sum({k: leaves[k] for k in enc_params}, {k: leaves[k] for k in js_params})
            grads = torch.autograd.grad(val, list(leaves.values()))
        for v in leaves.values():
            v.requires_grad_(False)
        return val.detach() + sum(g.abs().sum() for g in grads) * 0.0

    t_enc_bwd = _timed(enc_fwd_bwd, n)
    report["enc_fwd_bwd_ms_per_dispatch"] = 1e3 * t_enc_bwd
    report["enc_fwd_bwd_flops_per_dispatch"] = _flops(enc_fwd_bwd)
    report["nerf_levels_flops_per_dispatch"] = nerf_level_flops(
        batch, T, args.N_samples, args.N_importance)

    # ---- the auto-decoder body at the same contract (the NeRF floor) -------
    cfg_ad = Config(ray_batch_size=batch, batch_size=batch, compute_dtype="bfloat16",
                    N_samples=args.N_samples, N_importance=args.N_importance, N_max_objs=8)
    sys_ad = AutoDecoderSystem(cfg_ad, near=2.0, far=6.0, white_bkgd=False, device=device)
    hb_ad = _synthetic_batch(batch, tight=args.tight, seed=1)
    hb_ad["instance_id"] = np.int32(0)
    hb_ad["articulation_id"] = np.int32(1)
    ad_step, _ = train_many_fn(sys_ad, hb_ad, cfg_ad.microbatch_rays)
    t_ad = _timed(ad_step, n)
    report["autodec_body_ms_per_dispatch"] = 1e3 * t_ad
    report["autodec_body_rays_per_sec"] = rays_per_dispatch / t_ad

    # ---- derived -------------------------------------------------------------
    report["encoder_share_of_ae_step"] = t_enc_bwd / t_full
    report["nerf_body_share_estimate"] = t_ad / t_full
    t_res = max(t_full - t_enc_bwd, 1e-9)
    report["rays_per_sec_if_encoder_free"] = rays_per_dispatch / t_res
    report["vs_baseline_if_encoder_free"] = (
        report["rays_per_sec_if_encoder_free"] / REFERENCE_RAYS_PER_SEC)
    report["_analysis"] = (
        "The AE step = the auto-decoder NeRF body + ResNet-34 fwd/bwd + "
        "masked-MSE/BCE epilogue. The encoder share bounds what encoder "
        "optimizations can recover; the rate without the encoder is the "
        "ceiling that the NeRF body sets.")
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
