#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printed as one JSON line on stdout (nothing else goes there):

  device   the card (torch, and `nvidia-smi --query-gpu=name,power.limit`);
  build    nvcc builds every kernel of aon_tpu_torch/ops/csrc for sm_90a;
  kernel   each kernel on the card at its paths' shapes (render: 61,440 rays
           x 65 and x 193 samples for the eval MLP, a 61,440-ray resample with
           the one shared row of eval quantiles; training: 2,048 rays x 65 and
           x 193 for the level, the MLP backward and the eval MLP with the
           bf16-rounded float32 packing of the v2 forward, and a 2,048-ray
           resample with per-ray sorted random quantiles), held against its
           plain PyTorch twin on the same inputs, timed with CUDA events
           (median) beside the twin and a library yardstick (the same function
           as bf16 torch calls, under autograd for the training kernels) that
           the port never calls, and beside its bound on the H100;
  posenc   the in-kernel encoding's range reduction at the 2^9 frequency;
  path     build_system on configs/quality_laptop_vanilla_refsched.json at
           full width with seeded random weights, one cold frame and then two
           timed 640x480 frames through render_frame (chunk 61440), launch
           counts per frame, output
           checks, and a strided subset of rays against the plain float32
           VanillaNeRF path on the card;
  train    the same config on an in-memory analytic scene (8 views of
           160x120): TRAIN_STEPS_V3 steps of 2,048 rays through
           system.train_step on the v3 route, TRAIN_STEPS_V2 on the v2 route
           from the same start; ms per step, rays/s, launches per step, the
           loss curve, and the first step's loss and gradients of both routes
           against the plain float32 route with the same injected draws; then
           MANY_STEPS x MANY_MICRO stacked microbatches through
           system.train_many on both routes, held against train_step on the
           same rays, ray ids and generator state;
  art_kernel  the three articulated kernels (forward, MLP backward, fused
           level) on configs/quality_laptop_autodec.json's MLP with seeded
           weights and codes, at their paths' shapes (forward: 61,440 rays x 65
           and x 193 of a render chunk and 2,048 x 65 / x 193 of the v2
           forward; backward and level: 2,048 x 65 and x 193 with t sampled as
           a step samples it; the level also with the auto-encoder's arguments
           and with a white background), each against its plain twin, timed
           beside the twin, the bf16 library chain and the bound;
  art_path three 640x480 frames (one cold, two timed) through
           AutoDecoderSystem.render_chunk at chunk 61440, two (instance,
           articulation) pairs and one is_test midpoint id, launch counts per
           frame, and the first chunk against the plain float32 path;
  art_train  ART_STEPS_V3 + ART_STEPS_V2 steps of 4,096 rays as 2 microbatches
           of 2,048 on an in-memory articulated analytic scene, one (instance,
           articulation) pair per step; ms per step, exact launch counts, the
           loss curve, the first step against the plain float32 route, code
           rows no step indexed unchanged, and train_many against train_step;
  kernels  every kernel of the paths with its launches, error, times and bound;

with --profile, two ``profile`` lines as well: torch.profiler over five warm v3
steps of the vanilla and of the auto-decoder system, device time by kernel
name and the device's idle share of the window;

and last {"ok": true, "device": {...}}.  Any failing phase prints its error
and exits 1.  Needs one CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

CONFIG = "configs/quality_laptop_vanilla_refsched.json"
CHUNK_RAYS = 61440
N_COARSE, N_FINE = 64, 128
# multiply-adds per sample at the function's own widths (63 position and 27
# view channels): 63x256 + 7x256x256 (w1-w4, w5a, w6, w7) + 63x256 (w5b)
# + 256x256 (bottleneck) + 256 (density) + 283x128 (view) + 128x3.  The
# kernel's zero padding of K to 64 and 32 is its own overhead, not the bound's.
MLP_MACS_PER_SAMPLE = 593408
MLP_BIASES = 2436  # 8x256 trunk + 256 bottleneck + 1 density + 128 view + 3 rgb
FOVY_DEG = 35.0  # the SAPIEN laptop dataset's camera (datagen/data_gen.py)

# tolerances, with the reason for each; the MLP kernel's against its twin are
# TWIN_TOL_MAX and TWIN_TOL_MEAN of aon_tpu_torch/ops/fused_mlp_train.py
TOL_RESAMPLE = 1e-6  # same f32 operations in the same order: bit-identical expected
TOL_POSENC_TWIN = 1e-6  # an ulp of the sine
TOL_POSENC_EXACT = 2e-3  # float32 range reduction at ~3000 rad (the TPU suite's bound)
# bf16 kernel path against the float32 module: the MLP's bf16 rounding moves
# the coarse weights and so the fine samples
TOL_PATH = {"comp_rgb": 3e-2, "acc": 3e-2, "depth": 2.5e-1}
TOL_ACC = 1e-5  # acc = sum of weights <= 1 up to float32 rounding

TRAIN_RAYS = 2048  # the config's batch_size
TRAIN_STEPS_V3, TRAIN_STEPS_V2 = 60, 6
SCENE_VIEWS, SCENE_WH = 8, (160, 120)
# the loss after the v3 steps against the loss at step 0, on the schedule's
# warmup (lr 5e-6 rising to ~2e-5)
TRAIN_LOSS_FALL = 0.6
# the kernel routes' first-step loss and gradients against the plain float32
# module with the same draws: bf16 operands in every product, and the bf16
# coarse weights move the fine samples (max and mean measures of
# fused_mlp_train.grad_errors, per parameter tensor)
TOL_STEP_LOSS = 2e-2  # relative; the JAX suite's rtol on the fused loss
TOL_STEP_GRAD_MAX, TOL_STEP_GRAD_MEAN = 0.1, 0.2  # seen on an H100: 0.040 and 0.099
# the two kernel routes against each other: the same bf16 roundings, but v2's
# compositing backward is autograd's and its sums run in another order
TOL_ROUTES_GRAD_MAX, TOL_ROUTES_GRAD_MEAN = 0.1, 0.02  # seen: 0.0012 and 0.0034
# train_many: steps per call and stacked microbatches per step (of
# TRAIN_RAYS / MANY_MICRO rays each).  Against train_step on the same rays,
# ray ids and generator state only the atomicAdd order of the kernels differs;
# Adam turns that into up to the lr (~5e-6) where a gradient entry is as small
# as its eps
MANY_STEPS, MANY_MICRO = 2, 2
TOL_MANY_LOSS = 1e-4  # relative; seen on an H100: 2.1e-7 to 5.1e-6
# parameters after MANY_STEPS Adam steps.  An early Adam step moves an entry by
# lr * g / (|g| + 1e-8), so the rare entry whose gradient is within the
# atomicAdd noise of zero (~1e-8) may go either way by up to lr: the largest
# difference is held to 2 lr a step (seen: 1.1e-7 in most runs, 6.6e-6 = 1.3 lr
# in one), and the mean over all entries, which a systematic difference would
# move, to TOL_MANY_PARAMS_MEAN
TOL_MANY_PARAMS_LR = 2.0
TOL_MANY_PARAMS_MEAN = 1e-8

# ---- the auto-decoder (articulated NeRF + code library)
ART_CONFIG = "configs/quality_laptop_autodec.json"
ART_IMG_WH = (640, 480)  # the eval frame of the other paths
# multiply-adds per sample at the function's own widths: the vanilla MLP's, with
# the 4x128 deformation prefix (3x128 + 3x128x128 + 128x3) and views_1..3
ART_MACS_PER_SAMPLE = MLP_MACS_PER_SAMPLE + 49920 + 49152  # 692,480
ART_BIASES = MLP_BIASES + 4 * 128 + 3 + 3 * 128
ART_MICRO = 2  # ray_batch_size 4096 as microbatches of microbatch_rays 2048
ART_STEPS_V3, ART_STEPS_V2 = 40, 6
ART_SCENE = dict(n_instances=2, n_articulations=3, n_views=4)
# bf16 kernel path against the float32 module on the first chunk of a frame:
# as TOL_PATH, and the deformation's first layer rounds xyz to bf16, which
# the encoding amplifies.  acc is 1 up to rounding on every ray: on a black
# background the 1e10 tail makes the last sample opaque
TOL_ART_PATH = {"comp_rgb": 2e-2, "acc": 1e-3, "depth": 1e-1}  # seen: 1.5e-3, 1.0e-6, 1.0e-2
# The loss on one fixed batch with fixed draws (the first-step comparison's)
# after the v3 steps, against before them.  The steps run on the schedule's
# warmup (lr 5e-6 rising to 1.7e-5) and each sees another (instance,
# articulation) pair, so the per-step losses are not comparable with each other
ART_LOSS_FALL = 0.99
# first step against the plain float32 route, by direction (cosine over the
# named group of tensors): with a live deformation two correct implementations
# do not agree entry by entry (tests/test_fused_art.py of the JAX package holds
# its own kernels to cosines of 0.95 / 0.8 / 0.5).  Seen on an H100: 0.99999,
# 0.873, 0.9992
TOL_ART_STEP_COS = {"trunk": 0.99, "deform": 0.6, "codes": 0.95}
# the two kernel routes against each other, as TOL_ROUTES_GRAD_*, with the
# deformation's phase amplification on top: seen 0.012 and 0.011
TOL_ART_ROUTES_GRAD_MAX, TOL_ART_ROUTES_GRAD_MEAN = 0.1, 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def launches_are(launches, **want) -> bool:
    """Whether a run's launch counts are exactly ``want``, and 0 for every
    kernel it does not name."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_mlp(torch, packed, consts, samples, viewdirs, encode_plain):
    """Yardstick only: the same layer chain as bf16 cuBLAS calls."""
    B, S, _ = samples.shape
    bf = torch.bfloat16
    enc = encode_plain(samples.reshape(-1, 3), consts["s_pos"], consts["p_pos"]).to(bf)
    venc = encode_plain(torch.repeat_interleave(viewdirs, S, 0), consts["s_view"],
                        consts["p_view"]).to(bf)
    w = {k: v.to(bf) for k, v in packed.items()}
    h = torch.relu(torch.addmm(w["b0"], enc, w["w0"]))
    for i in (1, 2, 3, 4):
        h = torch.relu(torch.addmm(w[f"b{i}"], h, w[f"w{i}"]))
    h = torch.relu(torch.addmm(w["b5"], h, w["w5a"]) + enc @ w["w5b"])
    for i in (6, 7):
        h = torch.relu(torch.addmm(w[f"b{i}"], h, w[f"w{i}"]))
    sigma = torch.addmm(w["bd"], h, w["wd"])
    bott = torch.addmm(w["bb"], h, w["wb"])
    v = torch.relu(torch.addmm(w["bv"], bott, w["wva"]) + venc @ w["wvb"])
    return torch.addmm(w["brgb"], v, w["wrgb"]), sigma


def library_level(torch, packed, consts, t_vals, rays_o, rays_d, viewdirs, target, encode_plain,
                  cotangent=None):
    """Yardstick only: one training level as bf16 cuBLAS calls under autograd
    (forward chain, compositing, loss, backward); with ``cotangent`` (B, S, 4)
    the MLP alone, differentiated against it."""
    B, S = t_vals.shape
    samples = rays_o[:, None, :] + t_vals[..., None] * rays_d[:, None, :]
    w = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in packed.items()}
    rgb, sigma = library_mlp(torch, w, consts, samples, viewdirs, encode_plain)
    rgb, sigma = rgb.float().reshape(B, S, 3), sigma.float().reshape(B, S)
    if cotangent is not None:
        loss = (rgb * cotangent[..., :3]).sum() + (sigma * cotangent[..., 3]).sum()
    else:
        dist = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
        alpha = 1.0 - torch.exp(-torch.relu(sigma) * dist)
        trans = torch.cumprod(torch.clamp_min(1.0 - alpha, 0.0) + 1e-10, -1)
        wgt = alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        comp = (wgt[..., None] * torch.sigmoid(rgb)).sum(1) + (1.0 - wgt.sum(-1, keepdim=True))
        loss = ((comp - target) ** 2).mean()
    return torch.autograd.grad(loss, list(w.values()))


def library_art_mlp(torch, packed, consts, samples, viewdirs, encode_plain):
    """Yardstick only: the articulated MLP's layer chain as bf16 cuBLAS calls
    (``packed``: effective weights, biases (1, C))."""
    B, S, _ = samples.shape
    bf = torch.bfloat16
    w = {k: (v.to(bf) if k.startswith("w") else v.to(bf).reshape(-1)) for k, v in packed.items()}
    x = samples.reshape(-1, 3)
    h = torch.relu(torch.addmm(w["bd0"], x.to(bf), w["wd0x"][:3]))
    for i in (1, 2, 3):
        h = torch.relu(torch.addmm(w[f"bd{i}"], h, w[f"wd{i}"]))
    xp = x + torch.addmm(w["bdo"], h, w["wdo"])[:, :3].float()
    enc = encode_plain(xp, consts["s_pos"], consts["p_pos"]).to(bf)
    venc = encode_plain(torch.repeat_interleave(viewdirs, S, 0), consts["s_view"],
                        consts["p_view"]).to(bf)
    h = torch.relu(torch.addmm(w["b0"], enc, w["w0"]))
    for i in (1, 2, 3, 4):
        h = torch.relu(torch.addmm(w[f"b{i}"], h, w[f"w{i}"]))
    h = torch.relu(torch.addmm(w["b5"], h, w["w5a"]) + enc @ w["w5b"])
    for i in (6, 7):
        h = torch.relu(torch.addmm(w[f"b{i}"], h, w[f"w{i}"]))
    sigma = torch.addmm(w["bdn"], h, w["wdn"])
    bott = torch.addmm(w["bb"], h, w["wb"])
    v = torch.relu(torch.addmm(w["bv"], bott, w["wva"]) + venc @ w["wvb"])
    for i in (1, 2, 3):
        v = torch.relu(torch.addmm(w[f"bv{i}"], v, w[f"wv{i}"]))
    return torch.addmm(w["brgb"], v, w["wrgb"]), sigma


def library_art_level(torch, packed, consts, t_vals, rays_o, rays_d, viewdirs, target, loss_w,
                      encode_plain, cotangent=None):
    """Yardstick only: one articulated training level as bf16 cuBLAS calls
    under autograd (the auto-decoder's head activations, compositing, weighted
    loss, backward); with ``cotangent`` (B, S, 4) the MLP alone."""
    B, S = t_vals.shape
    samples = rays_o[:, None, :] + t_vals[..., None] * rays_d[:, None, :]
    w = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in packed.items()}
    rgb, sigma = library_art_mlp(torch, w, consts, samples, viewdirs, encode_plain)
    rgb, sigma = rgb.float().reshape(B, S, 3), sigma.float().reshape(B, S)
    if cotangent is not None:
        loss = (rgb * cotangent[..., :3]).sum() + (sigma * cotangent[..., 3]).sum()
    else:
        dist = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
        alpha = 1.0 - torch.exp(-torch.nn.functional.softplus(sigma - 1.0) * dist)
        trans = torch.cumprod(torch.clamp_min(1.0 - alpha, 0.0) + 1e-10, -1)
        wgt = alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        comp = (wgt[..., None] * (torch.sigmoid(rgb) * 1.002 - 0.001)).sum(1)
        loss = (loss_w[:, None] * (comp - target) ** 2).sum()
    return torch.autograd.grad(loss, list(w.values()), allow_unused=True)


def library_resample(torch, t_vals, bins, cdf, u):
    """Yardstick only: searchsorted inverse CDF + torch.sort of the union."""
    n = cdf.shape[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    lo, hi = (idx - 1).clamp(0, n - 1), idx.clamp(0, n - 1)
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b0, b1 = bins.gather(-1, lo), bins.gather(-1, hi)
    denom = c1 - c0
    t = torch.where(denom > 0, ((u - c0) / denom).clamp(0, 1), torch.zeros_like(u))
    return torch.sort(torch.cat([t_vals, b0 + t * (b1 - b0)], -1), -1).values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace five warm v3 train steps with torch.profiler")
    args = ap.parse_args(argv)

    phase = "device"
    try:
        import numpy as np
        import torch

        if not torch.cuda.is_available():
            raise PhaseFailed("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
        if not (ROOT / "aon_tpu_torch" / "ops" / "csrc").is_dir():
            raise PhaseFailed(f"no aon_tpu_torch package beside {Path(__file__).name}: "
                              "run it from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        from aon_tpu_torch.core.rays import create_spheric_poses, get_ray_directions, get_rays
        from aon_tpu_torch.core.sampling import eval_quantiles, pdf_cdf, sample_along_rays
        from aon_tpu_torch.data.analytic import analytic_scene
        from aon_tpu_torch.eval.render import render_frame
        from aon_tpu_torch.data.analytic import articulated_scene
        from aon_tpu_torch.ops import _build, fused_art
        from aon_tpu_torch.ops.fused_mlp import (
            make_posenc_constants,
            pack_vanilla_mlp_params,
            pack_vanilla_mlp_params_f32,
            round_packed,
        )
        from aon_tpu_torch.ops.fused_mlp_train import (
            GRAD_TOL_MEAN_REL,
            GRAD_TOL_REL,
            TWIN_TOL_MAX,
            TWIN_TOL_MEAN,
            encode_plain,
            fused_mlp_bwd_xyz,
            fused_mlp_bwd_xyz_plain,
            fused_nerf_mlp_xyz_eval,
            fused_nerf_mlp_xyz_eval_plain,
            grad_errors,
            posenc_in_kernel,
        )
        from aon_tpu_torch.ops.render_fused import mlp_params
        from aon_tpu_torch.ops.resample import (
            resample_union,
            resample_union_plain,
            sorted_uniform,
        )
        from aon_tpu_torch.ops.train_fused_level import (
            fused_level_train_grads,
            fused_level_train_grads_plain,
        )
        from aon_tpu_torch.ops.train_fused_level_art import (
            fused_level_train_art_grads,
            fused_level_train_art_grads_plain,
        )
        from aon_tpu_torch.train.microbatch import accumulated_grads
        from aon_tpu_torch.train.systems import build_system
        from aon_tpu_torch.utils.config import get_config

        # what the ``kernels`` line carries of every kernel's record
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        # the plain twins are float32 references: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        card = smi[0] if smi else name  # name and power limit, beside every number
        emit({"phase": "device", "name": name, "nvidia_smi": smi[0] if smi else None,
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})

        phase = "build"
        t0 = time.perf_counter()
        logs = _build.build()
        for src in _build.KERNEL_SOURCES:
            _build.library(src)
        emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "arch": "sm_90a",
              "sources": [f"aon_tpu_torch/ops/csrc/{s}.cu" for s in _build.KERNEL_SOURCES],
              "flags": " ".join(_build.NVCC_FLAGS),
              "ptxas": {k: [ln.strip() for ln in v.splitlines()
                            if "registers" in ln or "spill" in ln] for k, v in logs.items()}})

        # ---------------------------------------------------------- kernels
        phase = "kernel:fused_nerf_mlp_xyz_eval"
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cfg = get_config(["--config", str(ROOT / CONFIG)])
        system = build_system(cfg, 2.0, 6.0, cfg.white_back, device=dev)
        params = system.init_params(gen)
        packed = pack_vanilla_mlp_params(mlp_params(params, "fine_mlp"))
        consts = make_posenc_constants(cfg.N_emb_xyz, cfg.N_emb_dir, device=dev)
        dirs = torch.nn.functional.normalize(
            torch.randn(CHUNK_RAYS, 3, generator=gen, device=dev), dim=-1)
        origins = -4.0 * dirs + 0.3 * torch.randn(CHUNK_RAYS, 3, generator=gen, device=dev)

        def mlp_eval_record(packed_bf, samples, vdirs):
            """One ``kernel`` line of the eval MLP against its twin, checked."""
            n_rays, n_samples = samples.shape[:2]
            rgb, sigma = fused_nerf_mlp_xyz_eval(packed_bf, consts, samples, vdirs)
            torch.cuda.synchronize()
            rgb_p, sigma_p = fused_nerf_mlp_xyz_eval_plain(packed_bf, consts, samples, vdirs)
            err = torch.cat([(rgb - rgb_p).reshape(-1), (sigma - sigma_p).reshape(-1)]).abs()
            rows = n_rays * n_samples
            flops = 2.0 * MLP_MACS_PER_SAMPLE * rows
            # xyz in, rgb + sigma out per sample; viewdirs per ray; bf16 weights, f32 biases
            nbytes = (rows * (12 + 16) + n_rays * 12 + 2 * MLP_MACS_PER_SAMPLE
                      + 4 * MLP_BIASES)
            args_ = (packed_bf, consts, samples, vdirs)
            rec = {
                "phase": "kernel", "name": "fused_nerf_mlp_xyz_eval",
                "shape": f"{n_rays}x{n_samples}", "rows": rows,
                "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                "tol_max": TWIN_TOL_MAX, "tol_mean": TWIN_TOL_MEAN,
                "finite": bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()),
                "ms": time_ms(torch, lambda: fused_nerf_mlp_xyz_eval(*args_), 5),
                "plain_ms": time_ms(torch, lambda: fused_nerf_mlp_xyz_eval_plain(*args_), 3),
                "library_ms": time_ms(torch, lambda: library_mlp(torch, *args_, encode_plain), 3),
                "flop": flops, "bytes": nbytes,
                "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
                             else "bytes"),
                "card": card,
            }
            rec["tflops"] = flops / rec["ms"] / 1e9
            emit(rec)
            require(rec["finite"], "non-finite MLP kernel output")
            require(rec["max_abs_err"] <= TWIN_TOL_MAX and rec["mean_abs_err"] <= TWIN_TOL_MEAN,
                    f"MLP kernel disagrees with its twin at {rec['shape']}")
            return rec

        mlp_rows = {}
        for n_samples in (N_COARSE + 1, N_COARSE + 1 + N_FINE):
            _, samples = sample_along_rays(origins, dirs, n_samples - 1, 2.0, 6.0)
            mlp_rows[n_samples] = mlp_eval_record(packed, samples.contiguous(), dirs)
            del samples
        torch.cuda.empty_cache()

        phase = "posenc"
        xs = (torch.rand(4096, 3, generator=gen, device=dev) * 12 - 6).contiguous()
        rec = {"phase": "posenc", "max_abs_x": 6.0, "top_frequency": 2 ** (cfg.N_emb_xyz - 1)}
        for s, p in (("s_pos", "p_pos"), ("s_view", "p_view")):
            got = posenc_in_kernel(xs, consts[s], consts[p])
            pre = (xs.double().cpu().numpy() @ consts[s].double().cpu().numpy()[:3]
                   + consts[p].double().cpu().numpy())
            exact = np.where(np.arange(pre.shape[1]) < 3, pre, np.sin(pre))
            rec[f"{s}_err_twin"] = (got - encode_plain(xs, consts[s], consts[p])).abs().max().item()
            rec[f"{s}_err_exact"] = float(np.abs(got.cpu().numpy() - exact).max())
        rec.update(tol_twin=TOL_POSENC_TWIN, tol_exact=TOL_POSENC_EXACT)
        emit(rec)
        require(max(rec["s_pos_err_twin"], rec["s_view_err_twin"]) <= TOL_POSENC_TWIN
                and max(rec["s_pos_err_exact"], rec["s_view_err_exact"]) <= TOL_POSENC_EXACT,
                "in-kernel encoding outside its tolerance")

        phase = "kernel:resample_union"

        def resample_record(t_vals, bins, cdf, u):
            """One ``kernel`` line of the resample against its twin, checked;
            ``u`` is one shared row expanded over the rays, or a row per ray."""
            n_rays, n_t = t_vals.shape
            n_b, n_u = bins.shape[-1], u.shape[-1]
            got = resample_union(t_vals, bins, cdf, u)
            torch.cuda.synchronize()
            want = resample_union_plain(t_vals, bins, cdf, u)
            u_rows = u.contiguous()  # searchsorted takes per-row quantiles
            shared = u.stride(0) == 0
            nbytes = 4 * (n_rays * (n_t + 2 * n_b + n_t + n_u) + (n_u if shared else n_rays * n_u))
            # comparisons: a binary search per fine sample and per merged element
            ops = n_rays * (n_u * (math.log2(n_b) + math.log2(n_t) + 8) + n_t * math.log2(n_u))
            rec = {
                "phase": "kernel", "name": "resample_union", "shape": f"{n_rays}x{n_t}+{n_u}",
                "quantiles": "one shared row" if shared else "a sorted random row per ray",
                "max_abs_err": (got - want).abs().max().item(), "tol": TOL_RESAMPLE,
                "sorted": bool((got[:, 1:] >= got[:, :-1]).all()),
                "ms": time_ms(torch, lambda: resample_union(t_vals, bins, cdf, u), 20, warmup=3),
                "plain_ms": time_ms(torch, lambda: resample_union_plain(t_vals, bins, cdf, u), 5),
                "library_ms": time_ms(
                    torch, lambda: library_resample(torch, t_vals, bins, cdf, u_rows), 5),
                "bytes": nbytes, "ops": ops,
                "bound_ms": 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS),
                "bound_by": ("bytes" if nbytes / PEAK_BYTES >= ops / PEAK_F32_FLOPS
                             else "operations"),
                "card": card,
            }
            rec["gbps"] = nbytes / rec["ms"] / 1e6
            emit(rec)
            require(rec["sorted"] and rec["max_abs_err"] <= TOL_RESAMPLE,
                    f"resample kernel disagrees with its twin at {rec['shape']}")
            return rec

        t_vals, _ = sample_along_rays(origins, dirs, N_COARSE, 2.0, 6.0)
        bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).contiguous()
        weights = torch.rand(CHUNK_RAYS, N_COARSE - 1, generator=gen, device=dev) ** 4
        weights[::97] = 0.0  # empty rays: the eps padding path
        cdf = pdf_cdf(weights).contiguous()
        u = eval_quantiles(N_FINE, device=dev).expand(CHUNK_RAYS, N_FINE)
        resample_rec = resample_record(t_vals, bins, cdf, u)
        del t_vals, bins, weights, cdf, u
        torch.cuda.empty_cache()

        # ------------------------------------------------- training kernels
        phase = "kernel:training"
        counters = {"fused_nerf_mlp_xyz_eval": fused_nerf_mlp_xyz_eval,
                    "resample_union": resample_union,
                    "fused_level_train_grads": fused_level_train_grads,
                    "fused_mlp_bwd_xyz": fused_mlp_bwd_xyz,
                    "art_mlp_fwd": fused_art.art_mlp_fwd,
                    "art_mlp_bwd": fused_art.art_mlp_bwd,
                    "fused_level_train_art_grads": fused_level_train_art_grads}
        n_params = MLP_MACS_PER_SAMPLE + MLP_BIASES
        ro, rd = origins[:TRAIN_RAYS].contiguous(), dirs[:TRAIN_RAYS].contiguous()
        target = torch.rand(TRAIN_RAYS, 3, generator=gen, device=dev)
        train_rows = {}
        # sample positions as a step makes them: stratified random coarse
        # samples, then (below) their union with the resampled fine ones
        t_lvl, _ = sample_along_rays(ro, rd, N_COARSE, 2.0, 6.0, randomized=True, generator=gen)
        for level, n_samples in (("coarse_mlp", N_COARSE + 1), ("fine_mlp", N_COARSE + 1 + N_FINE)):
            packed32 = pack_vanilla_mlp_params_f32(mlp_params(params, level))
            samples = (ro[:, None, :] + t_lvl[..., None] * rd[:, None, :]).contiguous()
            rows = TRAIN_RAYS * n_samples
            cot = torch.randn(TRAIN_RAYS, n_samples, 4, generator=gen, device=dev) / rows
            # forward and two backward products per layer
            flops = 3 * 2.0 * MLP_MACS_PER_SAMPLE * rows
            level_args = (packed32, consts, t_lvl, ro, rd, rd, target, True)
            bwd_args = (packed32, consts, samples, rd, cot)
            runs = (
                # t and weights (B, S), four (B, 3) ray arrays, f32 params in, f32 grads out
                ("fused_level_train_grads", fused_level_train_grads,
                 fused_level_train_grads_plain, level_args,
                 4 * (2 * rows + 4 * 3 * TRAIN_RAYS + 2 * n_params + 1),
                 lambda: library_level(torch, packed32, consts, t_lvl, ro, rd, rd, target,
                                       encode_plain)),
                # xyz and g (B, S, 3 + 4), viewdirs, f32 params in, f32 grads out
                ("fused_mlp_bwd_xyz", fused_mlp_bwd_xyz, fused_mlp_bwd_xyz_plain, bwd_args,
                 4 * (7 * rows + 3 * TRAIN_RAYS + 2 * n_params),
                 lambda: library_level(torch, packed32, consts, t_lvl, ro, rd, rd, target,
                                       encode_plain, cotangent=cot)),
            )
            for kname, fn, fn_plain, fn_args, nbytes, library in runs:
                got = fn(*fn_args)
                torch.cuda.synchronize()
                want = fn_plain(*fn_args)
                again = fn(*fn_args)
                rec = {"phase": "kernel", "name": kname, "shape": f"{TRAIN_RAYS}x{n_samples}",
                       "rows": rows}
                if kname == "fused_level_train_grads":
                    (sq, wgt, grads), (sq_p, wgt_p, grads_p), grads2 = got, want, again[2]
                    rec.update(weights_max_abs_err=(wgt - wgt_p).abs().max().item(),
                               sq_err_rel_err=abs(sq.item() - sq_p.item()) / sq_p.item(),
                               tol_forward=TWIN_TOL_MAX)
                    fwd_ok = (rec["weights_max_abs_err"] <= TWIN_TOL_MAX
                              and rec["sq_err_rel_err"] <= TWIN_TOL_MAX
                              and bool(torch.isfinite(wgt).all()))
                else:
                    grads, grads_p, grads2, fwd_ok = got, want, again, True
                max_rel, mean_rel = grad_errors(grads, grads_p)
                rec.update({
                    "max_abs_err": max_rel, "mean_rel_err": mean_rel,
                    "err_is": "per gradient tensor, relative to its max (mean) magnitude; worst",
                    "tol_max": GRAD_TOL_REL, "tol_mean": GRAD_TOL_MEAN_REL,
                    "repeat_max_rel": grad_errors(grads2, grads)[0],
                    "finite": all(bool(torch.isfinite(v).all()) for v in grads.values()),
                    "ms": time_ms(torch, lambda: fn(*fn_args), 7, warmup=2),
                    "plain_ms": time_ms(torch, lambda: fn_plain(*fn_args), 3),
                    "library_ms": time_ms(torch, library, 3),
                    "flop": flops, "bytes": nbytes,
                    "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
                    "bound_by": ("operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
                                 else "bytes"),
                    "card": card,
                })
                rec["tflops"] = flops / rec["ms"] / 1e9
                emit(rec)
                require(rec["finite"] and fwd_ok, f"{kname}: forward outputs off at {rec['shape']}")
                require(max_rel <= GRAD_TOL_REL and mean_rel <= GRAD_TOL_MEAN_REL,
                        f"{kname} disagrees with its twin at {rec['shape']}")
                train_rows[kname, n_samples] = rec
                del got, want, again, grads, grads_p, grads2
            # the eval MLP as the v2 forward launches it: the float32 packing
            # of training, rounded to bf16 for the launch
            train_rows["fused_nerf_mlp_xyz_eval", n_samples] = mlp_eval_record(
                round_packed(packed32), samples, rd)
            if level == "coarse_mlp":
                # the resample as a step calls it: the coarse level's own
                # weights (a few rays emptied: the eps padding path) and a
                # sorted random row of quantiles per ray
                wgt = fused_level_train_grads(*level_args)[1][:, 1:-1].clone()
                wgt[::97] = 0.0
                bins = (0.5 * (t_lvl[:, 1:] + t_lvl[:, :-1])).contiguous()
                cdf = pdf_cdf(wgt).contiguous()
                u = sorted_uniform(torch.rand(TRAIN_RAYS, N_FINE + 1, generator=gen, device=dev))
                require(bool((u[:, 1:] >= u[:, :-1]).all()) and u.stride(0) == N_FINE,
                        "sorted_uniform rows are not ascending per-ray rows")
                train_rows["resample_union", n_samples] = resample_record(t_lvl, bins, cdf, u)
                t_next = resample_union(t_lvl, bins, cdf, u)
                del wgt, bins, cdf, u
            del samples, cot, level_args, bwd_args, runs
            t_lvl = t_next
        torch.cuda.empty_cache()

        # ------------------------------------------------------------- path
        phase = "path"
        W, H = cfg.img_wh
        focal = 0.5 * H / math.tan(math.radians(FOVY_DEG) / 2)
        directions = get_ray_directions(H, W, focal)
        poses = create_spheric_poses()
        frames = []
        for pose in (poses[0], poses[10]):
            o, vd, d = get_rays(directions, pose[:3], output_view_dirs=True)
            frames.append({"rays_o": o, "rays_d": d, "viewdirs": vd})

        def chunk_fn(rays):
            return system.render_chunk(params, rays)

        # frame 0 is rendered once more, first: a run's first frame pays first-use
        # costs and is reported apart as the cold frame
        fused_nerf_mlp_xyz_eval.launches = 0
        resample_union.launches = 0
        outs, frame_ms, per_frame = [], [], []
        for frame in (frames[0], *frames):
            m0, r0 = fused_nerf_mlp_xyz_eval.launches, resample_union.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(render_frame(chunk_fn, frame, chunk=cfg.chunk, device=dev))
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            per_frame.append([fused_nerf_mlp_xyz_eval.launches - m0, resample_union.launches - r0])
        path_launches = {"fused_nerf_mlp_xyz_eval": fused_nerf_mlp_xyz_eval.launches,
                         "resample_union": resample_union.launches}
        cold_ms, frame_ms = frame_ms[0], frame_ms[1:]

        n_rays = W * H
        chunks = math.ceil(n_rays / cfg.chunk)
        checks = {
            "finite": all(bool(np.isfinite(o[k]).all()) for o in outs for k in o),
            "shapes": all(o["comp_rgb"].shape == (n_rays, 3) and o["acc"].shape == (n_rays,)
                          and o["depth"].shape == (n_rays,) for o in outs),
            "acc_in_0_1": all(bool((o["acc"] >= -TOL_ACC).all() and (o["acc"] <= 1 + TOL_ACC).all())
                              for o in outs),
            "launches_per_frame": all(pf == [2 * chunks, chunks] for pf in per_frame),
        }

        # a strided subset of frame 0 against the plain float32 module path
        cfg_plain = get_config(["--config", str(ROOT / CONFIG)])
        cfg_plain.use_pallas, cfg_plain.compute_dtype = False, "float32"
        plain_system = build_system(cfg_plain, 2.0, 6.0, cfg_plain.white_back, device=dev)
        idx = np.arange(0, n_rays, 601)[:512]
        sub = {k: v[idx] for k, v in frames[0].items()}
        ref = {k: v.cpu().numpy() for k, v in plain_system.render_chunk(params, sub).items()}
        path_err = {k: float(np.abs(outs[0][k][idx] - ref[k]).max()) for k in TOL_PATH}
        checks["subset_vs_plain"] = all(path_err[k] <= TOL_PATH[k] for k in TOL_PATH)
        emit({
            "phase": "path", "config": CONFIG,
            "frames": len(frames), "img_wh": [W, H], "chunk": cfg.chunk, "chunks_per_frame": chunks,
            "samples": [cfg.N_samples, cfg.N_importance], "launches_per_frame": per_frame,
            "launches": path_launches, "cold_ms": cold_ms, "ms_per_frame": frame_ms,
            "rays_per_s": [n_rays / (ms / 1e3) for ms in frame_ms],
            "subset_rays": len(idx), "subset_max_abs_err": path_err, "tol": TOL_PATH,
            "acc_range": [float(min(o["acc"].min() for o in outs)),
                          float(max(o["acc"].max() for o in outs))],
            "mean_rgb": [float(o["comp_rgb"].mean()) for o in outs],
            "checks": checks, "card": card,
        })
        require(all(checks.values()), f"path checks failed: {checks}")
        del outs, frames

        # ------------------------------------------------------------ train
        phase = "train"
        scene = {k: torch.from_numpy(v).to(dev)
                 for k, v in analytic_scene(SCENE_VIEWS, *SCENE_WH, seed=args.seed).items()}
        n_scene = scene["rays_o"].shape[0]

        def batch_of(generator):
            idx = torch.randint(n_scene, (TRAIN_RAYS,), generator=generator, device=dev)
            return {k: v[idx] for k, v in scene.items()}

        def route_system(**overrides):
            c = get_config(["--config", str(ROOT / CONFIG)])
            for k, v in overrides.items():
                setattr(c, k, v)
            return build_system(c, 2.0, 6.0, c.white_back, device=dev)

        systems = {"v3": system, "v2": route_system(fused_train="v2"),
                   "plain": route_system(use_pallas=False, compute_dtype="float32")}
        state0 = system.init_state(torch.Generator(device=dev).manual_seed(args.seed + 1))

        # first step of every route from the same state, batch and draws
        gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
        batch0 = batch_of(gen)
        draws = {"t_rand": torch.rand(TRAIN_RAYS, N_COARSE + 1, generator=gen, device=dev),
                 "u": sorted_uniform(torch.rand(TRAIN_RAYS, N_FINE + 1, generator=gen, device=dev))}
        first = {r: accumulated_grads(sy.loss_fn, state0.params, batch0, None, draws)
                 for r, sy in systems.items()}

        def step_errors(a, b):
            loss_rel = abs(first[a][0].item() - first[b][0].item()) / abs(first[b][0].item())
            max_rel, mean_rel = grad_errors(first[a][2], first[b][2])
            return {"loss_rel": loss_rel, "grad_max_rel": max_rel, "grad_mean_rel": mean_rel}

        first_step = {"loss": {r: first[r][0].item() for r in first},
                      "v3_vs_plain": step_errors("v3", "plain"),
                      "v2_vs_plain": step_errors("v2", "plain"),
                      "v3_vs_v2": step_errors("v3", "v2")}
        del first

        def run_route(sy, state, batch_fn, steps, rays_per_step, route):
            """``steps`` optimizer steps through ``sy.train_step`` on
            ``batch_fn(generator, step)``, each timed by CUDA events."""
            g = torch.Generator(device=dev).manual_seed(args.seed + 3)
            for c in counters.values():
                c.launches = 0
            metrics, events = [], [torch.cuda.Event(enable_timing=True)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events[0].record()
            for i in range(steps):
                state, m = sy.train_step(state, batch_fn(g, i), g)
                metrics.append(m)
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            enqueue_s = time.perf_counter() - t0  # the host never waited for the card
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            warm = statistics.median(step_ms[1:])
            losses = [m["train/loss"].item() for m in metrics]
            return state, {
                "route": route, "steps": steps, "first_step_ms": step_ms[0], "ms_per_step": warm,
                "rays_per_s": rays_per_step / (warm / 1e3), "wall_s": wall_s,
                "enqueue_s": enqueue_s, "launches": launches,
                "launches_per_step": {k: v / steps for k, v in launches.items()},
                "loss": {str(i): losses[i] for i in range(0, steps, 10)},
                "loss_last": losses[-1],
                # means over the first and the last six steps (one cycle of the
                # articulated scene's pairs)
                "loss_mean_first_last": [statistics.fmean(losses[:6]), statistics.fmean(losses[-6:])],
                "psnr1_first_last": [metrics[0]["train/psnr1"].item(),
                                     metrics[-1]["train/psnr1"].item()],
                "lr_first_last": [sy.lr_schedule(0), sy.lr_schedule(steps - 1)],
                "final_step": state.step,
                "finite": all(math.isfinite(x) for x in losses),
            }

        def vanilla_batch(g, _step):
            return batch_of(g)

        state_v3, v3 = run_route(systems["v3"], state0, vanilla_batch, TRAIN_STEPS_V3, TRAIN_RAYS,
                                 "v3")
        _, v2 = run_route(systems["v2"], state0, vanilla_batch, TRAIN_STEPS_V2, TRAIN_RAYS, "v2")

        def run_many(sy, state0, superbatch, route):
            """The superbatch (ray entries (T, k, m, ...), any other entry one
            per step) through train_many, then the same rays through
            train_step with the ray ids train_many attaches and the generator
            at the same state."""
            t_steps, k, m = superbatch["rays_o"].shape[:3]
            for c in counters.values():
                c.launches = 0
            g = torch.Generator(device=dev).manual_seed(args.seed + 6)
            state, metrics = sy.train_many(state0, superbatch, g)
            torch.cuda.synchronize()
            launches = {k_: c.launches for k_, c in counters.items()}  # read before the comparison
            g = torch.Generator(device=dev).manual_seed(args.seed + 6)
            ray_ids = torch.arange(k * m, device=dev).reshape(k, m)
            ref, losses = state0, []
            for t in range(t_steps):
                batch = dict({k_: v[t] for k_, v in superbatch.items()}, ray_ids=ray_ids)
                ref, step_metrics = sy.train_step(ref, batch, g)
                losses.append(step_metrics["train/loss"].item())
            mean_loss, last_loss = metrics["train/loss"].item(), metrics["train/loss_last"].item()
            want_mean = sum(losses) / len(losses)
            return {
                "route": route, "steps": t_steps, "microbatches": k,
                "rays_per_microbatch": m, "launches": launches,
                "loss_mean": mean_loss, "loss_last": last_loss, "psnr1": metrics["train/psnr1"].item(),
                "train_step_losses": losses,
                "loss_mean_rel_err": abs(mean_loss - want_mean) / want_mean,
                "loss_last_rel_err": abs(last_loss - losses[-1]) / losses[-1],
                "params_max_abs_diff": max((state.params[k_] - ref.params[k_]).abs().max().item()
                                           for k_ in ref.params),
                "params_mean_abs_diff": (
                    sum((state.params[k_] - ref.params[k_]).abs().sum().item() for k_ in ref.params)
                    / sum(v.numel() for v in ref.params.values())),
                "params_max_abs_limit": TOL_MANY_PARAMS_LR * sum(
                    sy.lr_schedule(t) for t in range(t_steps)),
                "final_step": state.step,
            }

        def many_ok(r):
            return (r["loss_mean_rel_err"] <= TOL_MANY_LOSS
                    and r["loss_last_rel_err"] <= TOL_MANY_LOSS
                    and r["params_max_abs_diff"] <= r["params_max_abs_limit"]
                    and r["params_mean_abs_diff"] <= TOL_MANY_PARAMS_MEAN
                    and r["final_step"] == MANY_STEPS and math.isfinite(r["loss_last"]))

        g = torch.Generator(device=dev).manual_seed(args.seed + 5)
        idx = torch.randint(n_scene, (MANY_STEPS, MANY_MICRO, TRAIN_RAYS // MANY_MICRO),
                            generator=g, device=dev)
        superbatch = {k: v[idx] for k, v in scene.items()}
        many = {route: run_many(systems[route], state0, superbatch, route)
                for route in ("v3", "v2")}
        levels = 2 * MANY_STEPS * MANY_MICRO
        params_finite = all(bool(torch.isfinite(v).all()) for v in state_v3.params.values())
        checks = {
            "finite": v3["finite"] and v2["finite"] and params_finite,
            "loss_falls": v3["loss_last"] < TRAIN_LOSS_FALL * v3["loss"]["0"],
            "v3_launches": launches_are(
                v3["launches"], fused_level_train_grads=2 * TRAIN_STEPS_V3,
                resample_union=TRAIN_STEPS_V3),
            "v2_launches": launches_are(
                v2["launches"], fused_nerf_mlp_xyz_eval=2 * TRAIN_STEPS_V2,
                fused_mlp_bwd_xyz=2 * TRAIN_STEPS_V2, resample_union=TRAIN_STEPS_V2),
            "steps_counted": v3["final_step"] == TRAIN_STEPS_V3,
            "many_launches": (
                launches_are(many["v3"]["launches"], fused_level_train_grads=levels,
                             resample_union=levels // 2)
                and launches_are(many["v2"]["launches"], fused_nerf_mlp_xyz_eval=levels,
                                 fused_mlp_bwd_xyz=levels, resample_union=levels // 2)),
            "many_vs_train_step": all(many_ok(r) for r in many.values()),
            "same_first_loss": abs(v2["loss"]["0"] - v3["loss"]["0"]) <= TOL_STEP_LOSS * v3["loss"]["0"],
            "first_step_vs_plain": all(
                first_step[k]["loss_rel"] <= TOL_STEP_LOSS
                and first_step[k]["grad_max_rel"] <= TOL_STEP_GRAD_MAX
                and first_step[k]["grad_mean_rel"] <= TOL_STEP_GRAD_MEAN
                for k in ("v3_vs_plain", "v2_vs_plain")),
            "v3_vs_v2": (first_step["v3_vs_v2"]["loss_rel"] <= TOL_STEP_LOSS
                         and first_step["v3_vs_v2"]["grad_max_rel"] <= TOL_ROUTES_GRAD_MAX
                         and first_step["v3_vs_v2"]["grad_mean_rel"] <= TOL_ROUTES_GRAD_MEAN),
        }
        emit({
            "phase": "train", "config": CONFIG, "rays_per_step": TRAIN_RAYS,
            "samples": [cfg.N_samples, cfg.N_importance],
            "scene": {"views": SCENE_VIEWS, "wh": list(SCENE_WH), "rays": n_scene},
            "v3": v3, "v2": v2, "first_step": first_step, "train_many": many,
            "tol": {"many_loss_rel": TOL_MANY_LOSS, "many_params_max_lr": TOL_MANY_PARAMS_LR,
                    "many_params_mean_abs": TOL_MANY_PARAMS_MEAN,
                    "loss_rel": TOL_STEP_LOSS, "grad_vs_plain": [TOL_STEP_GRAD_MAX, TOL_STEP_GRAD_MEAN],
                    "grad_v3_vs_v2": [TOL_ROUTES_GRAD_MAX, TOL_ROUTES_GRAD_MEAN],
                    "loss_fall": TRAIN_LOSS_FALL},
            "checks": checks, "card": card,
        })
        require(all(checks.values()), f"train checks failed: {checks}")
        train_launches = {k: v3["launches"][k] + v2["launches"][k]
                          + sum(r["launches"][k] for r in many.values()) for k in counters}

        del superbatch
        torch.cuda.empty_cache()

        # ------------------------------------------- articulated kernels
        phase = "art_kernel"
        cfg_art = get_config(["--config", str(ROOT / ART_CONFIG)])

        def art_route_system(**overrides):
            c = get_config(["--config", str(ROOT / ART_CONFIG)])
            for k, v in overrides.items():
                setattr(c, k, v)
            return build_system(c, 2.0, 6.0, c.white_back, device=dev)

        art_systems = {"v3": art_route_system(), "v2": art_route_system(fused_train="v2"),
                       "plain": art_route_system(use_pallas=False, compute_dtype="float32")}
        art_system = art_systems["v3"]
        art_state0 = art_system.init_state(torch.Generator(device=dev).manual_seed(args.seed + 7))
        art_params = art_state0.params
        latents = {k: v.detach() for k, v in art_system._latents(
            art_params, {"instance_id": 1, "articulation_id": 2}).items()}
        n_art_params = ART_MACS_PER_SAMPLE + ART_BIASES

        def bound_of(flops, nbytes):
            by_ops = flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
            return {"flop": flops, "bytes": nbytes, "bound_by": "operations" if by_ops else "bytes",
                    "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)}

        def art_fwd_record(packed_art, samples, vdirs, path):
            """One ``kernel`` line of the articulated forward against its twin, checked."""
            n_rays, n_samples = samples.shape[:2]
            rows = n_rays * n_samples
            args_ = (packed_art, consts, samples, vdirs)
            rgb, sigma = fused_art.art_mlp_fwd(*args_)
            torch.cuda.synchronize()
            rgb_p, sigma_p = fused_art.art_mlp_fwd_plain(*args_)
            err = torch.cat([(rgb - rgb_p).reshape(-1), (sigma - sigma_p).reshape(-1)]).abs()
            # xyz in, rgb + sigma out per sample; viewdirs per ray; bf16 weights, f32 biases
            rec = {
                "phase": "kernel", "name": "art_mlp_fwd", "path": path,
                "shape": f"{n_rays}x{n_samples}", "rows": rows,
                "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                "tol_max": fused_art.TWIN_TOL_MAX, "tol_mean": fused_art.TWIN_TOL_MEAN,
                "finite": bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()),
                "ms": time_ms(torch, lambda: fused_art.art_mlp_fwd(*args_), 5),
                "plain_ms": time_ms(torch, lambda: fused_art.art_mlp_fwd_plain(*args_), 3),
                "library_ms": time_ms(
                    torch, lambda: library_art_mlp(torch, *args_, encode_plain), 3),
                **bound_of(2.0 * ART_MACS_PER_SAMPLE * rows,
                           rows * (12 + 16) + n_rays * 12 + 2 * ART_MACS_PER_SAMPLE
                           + 4 * ART_BIASES),
                "card": card,
            }
            rec["tflops"] = rec["flop"] / rec["ms"] / 1e9
            emit(rec)
            require(rec["finite"], "non-finite articulated MLP kernel output")
            require(rec["max_abs_err"] <= fused_art.TWIN_TOL_MAX
                    and rec["mean_abs_err"] <= fused_art.TWIN_TOL_MEAN,
                    f"art_mlp_fwd disagrees with its twin at {rec['shape']}")
            return rec

        art_rows = {}
        packed_fine = fused_art.fold_latents(mlp_params(art_params, "model.fine_mlp"), latents)
        for n_samples in (N_COARSE + 1, N_COARSE + 1 + N_FINE):
            _, samples = sample_along_rays(origins, dirs, n_samples - 1, 2.0, 6.0)
            art_rows["art_mlp_fwd", "render", n_samples] = art_fwd_record(
                packed_fine, samples.contiguous(), dirs, "render chunk")
            del samples
        torch.cuda.empty_cache()

        art_level_modes = {
            "autodecoder": dict(white_bkgd=False, rgb_padding=0.001, density_bias=-1.0,
                                bce_weight=0.0, sigma_act="softplus_bias"),
            # the auto-encoder's arguments (its slice launches this kernel as it is)
            "autoencoder": dict(white_bkgd=False, rgb_padding=0.0, density_bias=0.0,
                                bce_weight=0.5, sigma_act="relu"),
            "white_bkgd": dict(white_bkgd=True, rgb_padding=0.001, density_bias=-1.0,
                               bce_weight=0.0, sigma_act="softplus_bias"),
        }
        art_target = target * (torch.rand(TRAIN_RAYS, 1, generator=gen, device=dev) > 0.5)
        art_mask = (art_target.sum(-1) > 0).float()
        lw_uniform = torch.full((TRAIN_RAYS,), 1.0 / (3.0 * TRAIN_RAYS), device=dev)
        lw_masked = (art_mask / (3.0 * art_mask.sum()).clamp_min(1.0)).contiguous()
        t_lvl, _ = sample_along_rays(ro, rd, N_COARSE, 2.0, 6.0, randomized=True, generator=gen)
        for level, n_samples in (("coarse_mlp", N_COARSE + 1), ("fine_mlp", N_COARSE + 1 + N_FINE)):
            packed_art = fused_art.fold_latents(mlp_params(art_params, f"model.{level}"), latents)
            samples = (ro[:, None, :] + t_lvl[..., None] * rd[:, None, :]).contiguous()
            rows = TRAIN_RAYS * n_samples
            cot = torch.randn(TRAIN_RAYS, n_samples, 4, generator=gen, device=dev) / rows
            flops = 3 * 2.0 * ART_MACS_PER_SAMPLE * rows  # forward and two backward products
            level_args = (packed_art, consts, t_lvl, ro, rd, rd, art_target)
            bwd_args = (packed_art, consts, samples, rd, cot)
            runs = [
                # xyz and g (B, S, 3 + 4), viewdirs, f32 params in, f32 grads out
                ("art_mlp_bwd", "", fused_art.art_mlp_bwd, fused_art.art_mlp_bwd_plain, bwd_args, {},
                 4 * (7 * rows + 3 * TRAIN_RAYS + 2 * n_art_params),
                 lambda: library_art_level(torch, packed_art, consts, t_lvl, ro, rd, rd,
                                           art_target, lw_uniform, encode_plain, cotangent=cot)),
            ]
            for mode, kw in art_level_modes.items():
                if mode != "autodecoder" and level == "coarse_mlp":
                    continue  # the other two argument sets once, at the fine shape
                lw = lw_masked if mode == "autoencoder" else lw_uniform
                runs.append(
                    # t and weights (B, S); o, d, viewdirs, target (B, 3); loss_w, mask, acc (B);
                    # f32 params in, f32 grads out
                    ("fused_level_train_art_grads", mode, fused_level_train_art_grads,
                     fused_level_train_art_grads_plain, (*level_args, lw, art_mask), kw,
                     4 * (2 * rows + (4 * 3 + 3) * TRAIN_RAYS + 2 * n_art_params + 1),
                     (lambda lw=lw: library_art_level(torch, packed_art, consts, t_lvl, ro, rd, rd,
                                                      art_target, lw, encode_plain))
                     if mode == "autodecoder" else None))
            for kname, mode, fn, fn_plain, fn_args, kw, nbytes, library in runs:
                got = fn(*fn_args, **kw)
                torch.cuda.synchronize()
                want = fn_plain(*fn_args, **kw)
                again = fn(*fn_args, **kw)
                rec = {"phase": "kernel", "name": kname, "shape": f"{TRAIN_RAYS}x{n_samples}",
                       "rows": rows}
                if kname == "fused_level_train_art_grads":
                    (ph, wgt, acc, grads), (ph_p, wgt_p, acc_p, grads_p) = got, want
                    grads2 = again[3]
                    rec.update(arguments=dict(kw, mode=mode),
                               weights_max_abs_err=(wgt - wgt_p).abs().max().item(),
                               acc_max_abs_err=(acc - acc_p).abs().max().item(),
                               acc_mean=acc_p.mean().item(),
                               photo_loss_rel_err=abs(ph.item() - ph_p.item()) / ph_p.item(),
                               tol_forward=fused_art.TWIN_TOL_MAX)
                    fwd_ok = (rec["weights_max_abs_err"] <= fused_art.TWIN_TOL_MAX
                              and rec["acc_max_abs_err"] <= fused_art.TWIN_TOL_MAX
                              and rec["photo_loss_rel_err"] <= fused_art.TWIN_TOL_MAX
                              and bool(torch.isfinite(wgt).all()))
                else:
                    grads, grads_p, grads2, fwd_ok = got, want, again, True
                max_rel, mean_rel = grad_errors(grads, grads_p)
                rec.update({
                    "max_abs_err": max_rel, "mean_rel_err": mean_rel,
                    "err_is": "per gradient tensor, relative to its max (mean) magnitude; worst",
                    "tol_max": fused_art.GRAD_TOL_REL, "tol_mean": fused_art.GRAD_TOL_MEAN_REL,
                    "repeat_max_rel": grad_errors(grads2, grads)[0],
                    "finite": all(bool(torch.isfinite(v).all()) for v in grads.values()),
                    "ms": time_ms(torch, lambda: fn(*fn_args, **kw), 7, warmup=2),
                    "plain_ms": time_ms(torch, lambda: fn_plain(*fn_args, **kw), 3),
                    "library_ms": time_ms(torch, library, 3) if library is not None else None,
                    **bound_of(flops, nbytes), "card": card,
                })
                rec["tflops"] = flops / rec["ms"] / 1e9
                emit(rec)
                require(rec["finite"] and fwd_ok, f"{kname}: forward outputs off at {rec['shape']}")
                require(max_rel <= fused_art.GRAD_TOL_REL
                        and mean_rel <= fused_art.GRAD_TOL_MEAN_REL,
                        f"{kname} ({mode}) disagrees with its twin at {rec['shape']}")
                art_rows[kname, mode, n_samples] = rec
                del got, want, again, grads, grads_p, grads2
            # the forward as the v2 route launches it
            art_rows["art_mlp_fwd", "train", n_samples] = art_fwd_record(
                packed_art, samples, rd, "v2 forward")
            if level == "coarse_mlp":
                # the fine level's t: the union with the resample of this level's own weights
                wgt = fused_level_train_art_grads(
                    *level_args, lw_uniform, art_mask, **art_level_modes["autodecoder"])[1]
                bins = (0.5 * (t_lvl[:, 1:] + t_lvl[:, :-1])).contiguous()
                u = sorted_uniform(torch.rand(TRAIN_RAYS, N_FINE + 1, generator=gen, device=dev))
                t_next = resample_union(t_lvl, bins, pdf_cdf(wgt[:, 1:-1]).contiguous(), u)
                del wgt, bins, u
            del samples, cot, level_args, bwd_args, runs, packed_art
            t_lvl = t_next
        del packed_fine
        torch.cuda.empty_cache()

        # --------------------------------------------------------- art path
        phase = "art_path"
        W, H = ART_IMG_WH
        frames = []
        for pose in (poses[0], poses[10]):
            o, vd, d = get_rays(directions, pose[:3], output_view_dirs=True)
            frames.append({"rays_o": o, "rays_d": d, "viewdirs": vd})

        def art_chunk_fn(rays, **ids):
            return art_system.render_chunk(art_params, rays, **ids)

        # (frame, instance, articulation, is_test): the first is the cold frame;
        # with is_test, id 3 is the midpoint of the learned codes 1 and 2
        renders = ((frames[0], 0, 1, False), (frames[0], 0, 1, False), (frames[1], 1, 2, False),
                   (frames[1], 0, 3, True))
        for c in counters.values():
            c.launches = 0
        outs, frame_ms, per_frame = [], [], []
        for frame, inst, art_id, is_test in renders:
            before = {k: c.launches for k, c in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(render_frame(art_chunk_fn, frame, chunk=cfg_art.chunk, device=dev,
                                     instance_id=inst, articulation_id=art_id, is_test=is_test))
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            per_frame.append({k: c.launches - before[k] for k, c in counters.items()})
        art_path_launches = {k: c.launches for k, c in counters.items()}
        cold_ms, frame_ms = frame_ms[0], frame_ms[1:]
        n_rays = W * H
        chunks = math.ceil(n_rays / cfg_art.chunk)
        checks = {
            "finite": all(bool(np.isfinite(o[k]).all()) for o in outs for k in o),
            "shapes": all(o["comp_rgb"].shape == (n_rays, 3) and o["acc"].shape == (n_rays,)
                          and o["depth"].shape == (n_rays,) for o in outs),
            "acc_in_0_1": all(bool((o["acc"] >= -TOL_ACC).all() and (o["acc"] <= 1 + TOL_ACC).all())
                              for o in outs),
            "launches_per_frame": all(
                launches_are(pf, art_mlp_fwd=2 * chunks, resample_union=chunks)
                for pf in per_frame),
            # another instance, articulation or midpoint code renders another image
            "ids_matter": (float(np.abs(outs[2]["comp_rgb"] - outs[3]["comp_rgb"]).max()) > 1e-4
                           and float(np.abs(outs[0]["comp_rgb"] - outs[1]["comp_rgb"]).max())
                           == 0.0),
        }
        # the first chunk of the cold frame against the plain float32 module, in pieces
        first = {k: torch.from_numpy(v[:cfg_art.chunk]).to(dev) for k, v in frames[0].items()}
        ref = {k: [] for k in TOL_ART_PATH}
        for i in range(0, cfg_art.chunk, 4096):
            piece = art_systems["plain"].render_chunk(
                art_params, {k: v[i:i + 4096] for k, v in first.items()}, 0, 1)
            for k in ref:
                ref[k].append(piece[k])
        ref = {k: torch.cat(v).cpu().numpy() for k, v in ref.items()}
        path_err = {k: float(np.abs(outs[0][k][:cfg_art.chunk] - ref[k]).max()) for k in ref}
        path_mean_err = {k: float(np.abs(outs[0][k][:cfg_art.chunk] - ref[k]).mean()) for k in ref}
        checks["first_chunk_vs_plain"] = all(path_err[k] <= TOL_ART_PATH[k] for k in ref)
        emit({
            "phase": "art_path", "config": ART_CONFIG, "frames": len(renders) - 1,
            "img_wh": [W, H], "chunk": cfg_art.chunk, "chunks_per_frame": chunks,
            "samples": [cfg_art.N_samples, cfg_art.N_importance],
            "renders": [{"instance_id": i, "articulation_id": a, "is_test": t}
                        for _, i, a, t in renders],
            "launches_per_frame": per_frame, "launches": art_path_launches, "cold_ms": cold_ms,
            "ms_per_frame": frame_ms, "rays_per_s": [n_rays / (ms / 1e3) for ms in frame_ms],
            "first_chunk_rays": cfg_art.chunk, "first_chunk_max_abs_err": path_err,
            "first_chunk_mean_abs_err": path_mean_err, "tol": TOL_ART_PATH,
            "acc_range": [float(min(o["acc"].min() for o in outs)),
                          float(max(o["acc"].max() for o in outs))],
            "mean_rgb": [float(o["comp_rgb"].mean()) for o in outs],
            "checks": checks, "card": card,
        })
        require(all(checks.values()), f"art_path checks failed: {checks}")
        del outs, frames, first, ref
        torch.cuda.empty_cache()

        # -------------------------------------------------------- art train
        phase = "art_train"
        art_scene = {k: torch.from_numpy(v).to(dev) for k, v in articulated_scene(
            **ART_SCENE, w=SCENE_WH[0], h=SCENE_WH[1], seed=args.seed).items()}
        n_pairs, n_pair_rays = art_scene["rays_o"].shape[:2]
        n_art = ART_SCENE["n_articulations"]
        micro_rays = cfg_art.microbatch_rays
        art_rays = ART_MICRO * micro_rays
        require(art_rays == cfg_art.ray_batch_size, "the step is not the config's ray batch")

        def art_batch(generator, step):
            """One (instance, articulation) pair per step, cycling through the scene's."""
            pair = step % n_pairs
            idx = torch.randint(n_pair_rays, (ART_MICRO, micro_rays), generator=generator,
                                device=dev)
            return dict({k: v[pair][idx] for k, v in art_scene.items()},
                        instance_id=pair // n_art, articulation_id=pair % n_art)

        gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
        batch0 = {k: torch.as_tensor(v, device=dev) for k, v in art_batch(gen, 4).items()}
        draws = {"t_rand": torch.rand(ART_MICRO, micro_rays, N_COARSE + 1, generator=gen, device=dev),
                 "u": sorted_uniform(torch.rand(ART_MICRO, micro_rays, N_FINE + 1, generator=gen,
                                                device=dev))}
        first = {r: accumulated_grads(sy.loss_fn, art_params, batch0, None, draws)
                 for r, sy in art_systems.items()}
        code_rows = {"code_library.embedding_instance_shape.weight": 4 // n_art,
                     "code_library.embedding_instance_appearance.weight": 4 // n_art,
                     "code_library.embedding_instance_articulation.weight": 4 % n_art}
        groups = {"trunk": [k for k in art_params if k.startswith("model.")
                            and ".deform_" not in k],
                  "deform": [k for k in art_params if ".deform_" in k],
                  "codes": list(code_rows)}

        def cosine(a, b, names):
            va = torch.cat([a[k].reshape(-1) for k in names])
            vb = torch.cat([b[k].reshape(-1) for k in names])
            return (va @ vb / (va.norm() * vb.norm())).item()

        def art_step_errors(a, b):
            la, lb = first[a][0].item(), first[b][0].item()
            max_rel, mean_rel = grad_errors(first[a][2], first[b][2])
            return {"loss_rel": abs(la - lb) / abs(lb), "grad_max_rel": max_rel,
                    "grad_mean_rel": mean_rel,
                    "cos": {g: cosine(first[a][2], first[b][2], names)
                            for g, names in groups.items()}}

        first_step = {"loss": {r: first[r][0].item() for r in first},
                      "reg": {r: first[r][1]["reg"].item() for r in first},
                      "v3_vs_plain": art_step_errors("v3", "plain"),
                      "v2_vs_plain": art_step_errors("v2", "plain"),
                      "v3_vs_v2": art_step_errors("v3", "v2")}
        # only the indexed rows of the code tables carry a gradient
        first_step["unindexed_code_rows_zero"] = all(
            not first[r][2][name][torch.arange(len(first[r][2][name]), device=dev) != row].any()
            and bool(first[r][2][name][row].any())
            for r in first for name, row in code_rows.items())
        loss_before = first["v3"][0].item()
        del first

        art_state_v3, art_v3 = run_route(art_systems["v3"], art_state0, art_batch, ART_STEPS_V3,
                                         art_rays, "v3")
        _, art_v2 = run_route(art_systems["v2"], art_state0, art_batch, ART_STEPS_V2, art_rays, "v2")
        loss_after = accumulated_grads(art_systems["v3"].loss_fn, art_state_v3.params, batch0, None,
                                       draws)[0].item()
        # rows of the code tables that no step indexed have not moved
        used = {"code_library.embedding_instance_shape.weight": ART_SCENE["n_instances"],
                "code_library.embedding_instance_appearance.weight": ART_SCENE["n_instances"],
                "code_library.embedding_instance_articulation.weight": n_art}
        rows_kept = all(torch.equal(art_state_v3.params[k][n:], art_state0.params[k][n:])
                        and bool((art_state_v3.params[k][:n] != art_state0.params[k][:n]).any(1).all())
                        for k, n in used.items())

        g = torch.Generator(device=dev).manual_seed(args.seed + 9)
        pair_of_step = torch.tensor([1, 5], device=dev)
        idx = torch.randint(n_pair_rays, (MANY_STEPS, ART_MICRO, micro_rays), generator=g, device=dev)
        superbatch = {k: torch.stack([v[int(p)][idx[t]] for t, p in enumerate(pair_of_step)])
                      for k, v in art_scene.items()}
        superbatch.update(instance_id=pair_of_step // n_art, articulation_id=pair_of_step % n_art)
        art_many = {route: run_many(art_systems[route], art_state0, superbatch, route)
                    for route in ("v3", "v2")}
        levels = 2 * MANY_STEPS * ART_MICRO
        per_v3 = 2 * ART_MICRO  # level launches (and forward or backward launches) per step
        checks = {
            "finite": art_v3["finite"] and art_v2["finite"] and all(
                bool(torch.isfinite(v).all()) for v in art_state_v3.params.values()),
            "loss_falls": (loss_after < ART_LOSS_FALL * loss_before
                           and art_v3["loss_mean_first_last"][1] < art_v3["loss_mean_first_last"][0]),
            "v3_launches": launches_are(
                art_v3["launches"], fused_level_train_art_grads=per_v3 * ART_STEPS_V3,
                resample_union=ART_MICRO * ART_STEPS_V3),
            "v2_launches": launches_are(
                art_v2["launches"], art_mlp_fwd=per_v3 * ART_STEPS_V2,
                art_mlp_bwd=per_v3 * ART_STEPS_V2, resample_union=ART_MICRO * ART_STEPS_V2),
            "steps_counted": art_v3["final_step"] == ART_STEPS_V3,
            "many_launches": (
                launches_are(art_many["v3"]["launches"], fused_level_train_art_grads=levels,
                             resample_union=levels // 2)
                and launches_are(art_many["v2"]["launches"], art_mlp_fwd=levels,
                                 art_mlp_bwd=levels, resample_union=levels // 2)),
            "many_vs_train_step": all(many_ok(r) for r in art_many.values()),
            "first_step_vs_plain": all(
                first_step[k]["loss_rel"] <= TOL_STEP_LOSS
                and all(first_step[k]["cos"][g] >= TOL_ART_STEP_COS[g] for g in groups)
                for k in ("v3_vs_plain", "v2_vs_plain")),
            "v3_vs_v2": (first_step["v3_vs_v2"]["loss_rel"] <= TOL_STEP_LOSS
                         and first_step["v3_vs_v2"]["grad_max_rel"] <= TOL_ART_ROUTES_GRAD_MAX
                         and first_step["v3_vs_v2"]["grad_mean_rel"] <= TOL_ART_ROUTES_GRAD_MEAN),
            "unindexed_code_rows": first_step["unindexed_code_rows_zero"] and rows_kept,
        }
        emit({
            "phase": "art_train", "config": ART_CONFIG, "rays_per_step": art_rays,
            "microbatches": ART_MICRO, "rays_per_microbatch": micro_rays,
            "samples": [cfg_art.N_samples, cfg_art.N_importance],
            "scene": dict(ART_SCENE, wh=list(SCENE_WH), pairs=n_pairs, rays_per_pair=n_pair_rays),
            "v3": art_v3, "v2": art_v2, "first_step": first_step, "train_many": art_many,
            "same_batch_loss_before_after": [loss_before, loss_after],
            "tol": {"many_loss_rel": TOL_MANY_LOSS, "many_params_max_lr": TOL_MANY_PARAMS_LR,
                    "many_params_mean_abs": TOL_MANY_PARAMS_MEAN,
                    "loss_rel": TOL_STEP_LOSS, "cos_vs_plain": TOL_ART_STEP_COS,
                    "grad_v3_vs_v2": [TOL_ART_ROUTES_GRAD_MAX, TOL_ART_ROUTES_GRAD_MEAN],
                    "loss_fall": ART_LOSS_FALL},
            "checks": checks, "card": card,
        })
        require(all(checks.values()), f"art_train checks failed: {checks}")
        art_train_launches = {k: art_v3["launches"][k] + art_v2["launches"][k]
                              + sum(r["launches"][k] for r in art_many.values()) for k in counters}

        if args.profile:
            phase = "profile"
            from torch.profiler import ProfilerActivity, profile

            def profile_steps(sy, state, batch_fn, label, n_steps=5):
                g = torch.Generator(device=dev).manual_seed(args.seed + 4)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for i in range(n_steps):
                        state, _ = sy.train_step(state, batch_fn(g, i), g)
                    torch.cuda.synchronize()
                    window_ms = 1e3 * (time.perf_counter() - t0)
                by_kernel = sorted(((e.key, e.device_time_total / 1e3, e.count)
                                    for e in prof.key_averages()
                                    if e.device_time_total > 0 and e.device_type.name == "CUDA"),
                                   key=lambda r: -r[1])
                busy_ms = sum(r[1] for r in by_kernel)
                require(busy_ms > 0, "torch.profiler recorded no device time")
                emit({"phase": "profile", "system": label, "route": "v3", "steps": n_steps,
                      "window_ms": window_ms, "device_busy_ms": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / window_ms,
                      "ms_per_step_by_kernel": [{"kernel": k[:80], "ms": ms / n_steps,
                                                 "launches_per_step": n / n_steps}
                                                for k, ms, n in by_kernel[:12]],
                      "other_kernels_ms_per_step": sum(r[1] for r in by_kernel[12:]) / n_steps,
                      "card": card})

            profile_steps(system, state_v3, vanilla_batch, "vanilla")
            profile_steps(art_system, art_state_v3, art_batch, "autodecoder")

        phase = "kernels"
        fine = mlp_rows[N_COARSE + 1 + N_FINE]

        def train_entry(kname, replaces):
            big, small = (train_rows[kname, n] for n in (N_COARSE + 1 + N_FINE, N_COARSE + 1))
            return {"name": kname, "route": "cuda",
                    "source": "aon_tpu_torch/ops/csrc/level_train.cu", "replaces": replaces,
                    "launches": train_launches[kname], "shape": big["shape"],
                    **{k: big[k] for k in keys}, "err_is": big["err_is"],
                    "coarse": {k: small[k] for k in ("shape",) + keys}}

        entries = [
            {"name": "fused_nerf_mlp_xyz_eval", "route": "cuda",
             "source": "aon_tpu_torch/ops/csrc/fused_mlp_eval.cu",
             "replaces": "aon_tpu/ops/fused_mlp_train.py:297",
             "launches": path_launches["fused_nerf_mlp_xyz_eval"]
             + train_launches["fused_nerf_mlp_xyz_eval"],
             "launches_by_path": {"render": path_launches["fused_nerf_mlp_xyz_eval"],
                                  "train": train_launches["fused_nerf_mlp_xyz_eval"]},
             "shape": fine["shape"], **{k: fine[k] for k in keys},
             "coarse": {k: mlp_rows[N_COARSE + 1][k] for k in ("shape",) + keys},
             "train": [{k: train_rows["fused_nerf_mlp_xyz_eval", n][k] for k in ("shape",) + keys}
                       for n in (N_COARSE + 1, N_COARSE + 1 + N_FINE)]},
            {"name": "resample_union", "route": "cuda",
             "source": "aon_tpu_torch/ops/csrc/resample.cu",
             "replaces": "aon_tpu/ops/resample_pallas.py:85",
             "launches": path_launches["resample_union"] + train_launches["resample_union"],
             "launches_by_path": {"render": path_launches["resample_union"],
                                  "train": train_launches["resample_union"]},
             "shape": resample_rec["shape"], **{k: resample_rec[k] for k in keys},
             "train": {k: train_rows["resample_union", N_COARSE + 1][k]
                       for k in ("shape", "quantiles") + keys}},
            train_entry("fused_level_train_grads", "aon_tpu/ops/train_fused_level.py:79"),
            train_entry("fused_mlp_bwd_xyz", "aon_tpu/ops/fused_mlp_train.py:320"),
        ]

        def art_entry(kname, replaces, mode=""):
            big, small = (art_rows[kname, mode, n] for n in (N_COARSE + 1 + N_FINE, N_COARSE + 1))
            return {"name": kname, "route": "cuda", "source": "aon_tpu_torch/ops/csrc/art.cu",
                    "replaces": replaces, "launches": art_train_launches[kname],
                    "shape": big["shape"], **{k: big[k] for k in keys},
                    "err_is": big["err_is"],
                    "coarse": {k: small[k] for k in ("shape",) + keys}}

        fwd_fine = art_rows["art_mlp_fwd", "render", N_COARSE + 1 + N_FINE]
        entries += [
            {"name": "art_mlp_fwd", "route": "cuda", "source": "aon_tpu_torch/ops/csrc/art.cu",
             "replaces": "aon_tpu/ops/fused_art.py:187",
             "launches": art_path_launches["art_mlp_fwd"] + art_train_launches["art_mlp_fwd"],
             "launches_by_path": {"render": art_path_launches["art_mlp_fwd"],
                                  "train": art_train_launches["art_mlp_fwd"]},
             "shape": fwd_fine["shape"], **{k: fwd_fine[k] for k in keys},
             "coarse": {k: art_rows["art_mlp_fwd", "render", N_COARSE + 1][k]
                        for k in ("shape",) + keys},
             "train": [{k: art_rows["art_mlp_fwd", "train", n][k] for k in ("shape",) + keys}
                       for n in (N_COARSE + 1, N_COARSE + 1 + N_FINE)]},
            art_entry("art_mlp_bwd", "aon_tpu/ops/fused_art.py:220"),
            dict(art_entry("fused_level_train_art_grads",
                           "aon_tpu/ops/train_fused_level_art.py:60", "autodecoder"),
                 other_arguments=[
                     {k: art_rows["fused_level_train_art_grads", mode, N_COARSE + 1 + N_FINE][k]
                      for k in ("shape", "arguments", "max_abs_err", "mean_rel_err", "ms",
                                "plain_ms")}
                     for mode in ("autoencoder", "white_bkgd")]),
        ]
        # kernel 2 also serves the auto-decoder's paths
        entries[1]["launches"] += (art_path_launches["resample_union"]
                                   + art_train_launches["resample_union"])
        entries[1]["launches_by_path"].update(art_render=art_path_launches["resample_union"],
                                              art_train=art_train_launches["resample_union"])
        require(all(e["launches"] > 0 for e in entries), "a kernel of the path never launched")
        emit({"kernels": entries, "card": card})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception as exc:  # report the failing phase, then exit non-zero
        traceback.print_exc(file=sys.stderr)
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        return 1


if __name__ == "__main__":
    sys.exit(main())
