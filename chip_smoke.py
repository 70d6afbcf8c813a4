#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--seeds K] [--profile] [--parent DIR]

Phases, each printed as one JSON line on stdout (nothing else goes there):

  device   the card (torch, and `nvidia-smi --query-gpu=name,power.limit`);
  build    nvcc builds every kernel of aon_tpu_torch/ops/csrc for sm_90a;
  kernel   each kernel on the card at its paths' shapes (render: 61,440 rays
           x 65 and x 193 samples for the eval MLP from raw coordinates and
           from per-sample and per-ray encodings, a 61,440-ray resample with
           the one shared row of eval quantiles; training: 2,048 rays x 65 and
           x 193 for the level, the MLP backward from raw coordinates and from
           encodings and the eval MLP with the bf16-rounded float32 packing of
           the v2 forward (and at x 193 from encodings, as fused_mlp_train's
           forward), and a 2,048-ray resample with per-ray sorted random
           quantiles; geometry: 512 x 128 grid points for the eval MLP of
           extract_geometry), held against its plain PyTorch twin on the same
           inputs, timed with CUDA events (median) beside the twin and a
           library yardstick (the same function as bf16 torch calls, under
           autograd for the training kernels) that the port never calls, and
           beside its bound on the H100;
  wgrad    the training kernels' weight gradients alone (train_sm90.cuh's
           MN-major wgmma operands) on random blocked workspaces of the fine
           level's 395,264 rows, against torch.matmul, timed;
  level_split  the device time of each of a training level's four stages
           (forward, compositing, backward data path, weight gradients; by
           kernel name under torch.profiler) at 2,048 x 193 and x 49 beside
           each stage's flop bound and workspace bytes at the HBM rate, for
           this tree and, with --parent DIR, for another checkout
           (aon_tpu_torch/scripts/level_split.py);
  art_level_split  the same for the articulated level (row 9) at 2,048 x 193
           and x 73, with --parent DIR also for the other checkout;
  posenc   the in-kernel encoding's range reduction at the 2^9 frequency, and
           kernel table row 14 (the TPU suite's range-reduction test): its
           256 x 3 inputs through each of the kernels' three encoders, column
           by column against the twin and the exact sine, timed at 256 x 64
           and at one 65,536-point extraction block;
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
           beside the twin, the bf16 library chain and the bound; then rows 3,
           2 and 9 at the bench's shapes: the first 2,048 rays of each bench
           batch, t stratified in their per-ray intervals and then resampled
           (vanilla 17 and 49 samples on occupancy intervals, the auto-decoder
           25 and 73 on AABB intervals);
  art_path three 640x480 frames (one cold, two timed) through
           AutoDecoderSystem.render_chunk at chunk 61440, two (instance,
           articulation) pairs and one is_test midpoint id, launch counts per
           frame, and the first chunk against the plain float32 path;
  art_train  ART_STEPS_V3 + ART_STEPS_V2 steps of 4,096 rays as 2 microbatches
           of 2,048 on an in-memory articulated analytic scene, one (instance,
           articulation) pair per step; ms per step, exact launch counts, the
           loss curve, the first step against the plain float32 route, code
           rows no step indexed unchanged, and train_many against train_step;
  ops_api  the public kernel API (aon_tpu_torch.ops) on pre-encoded inputs of
           2,048 rays x 65 samples with the trained vanilla state: a training
           level through fused_mlp_train under autograd and the fine MLP
           through fused_nerf_mlp and fused_nerf_mlp_per_ray, exact launch
           counts, against the raw-coordinate entry points on the same samples;
  geometry extract_geometry.main at its default settings (a 160^3 grid, 65,536
           points per query) on the trained vanilla and auto-decoder states,
           saved and restored through train.checkpoint (the auto-decoder also
           at a midpoint code): exact launch counts, the sigma grid and its
           occupancy against the plain twins' on the same points, the three
           files parsed, and the wall time split into restore, query, mesh and
           write;
  bench_kernels  the port's kernel bench (aon_tpu_torch/scripts/bench_kernels.py)
           with every variant, its lines re-emitted with exact launch counts;
           then each variant of rows 12 (three bodies) and 13 (three
           encoders) against its twin on 65,536 rows, timed at the bench's
           2^18 rows beside the twin, the library chain and the bound (with
           the eval kernel's tile, grid, share of the bf16 peak and L2 weight
           rate); the two-stream body against the base body bit for bit; and
           a ``trunk_grid_sweep`` line: rows 12 base and 2s at 2^20 rows on
           33, 66 and 132 persistent blocks;
  bench    the port's bench.py at its defaults (vanilla 32,768 rays at 16 + 32
           samples on occupancy intervals, the auto-decoder 4,096 at 24 + 48
           on AABB intervals) and at --reference_contract --headline_only:
           its lines, rays/s and ms per step, exact launches, the loss of the
           repeated batch falling, and the first step of the interval path on
           one 2,048-ray microbatch of each bench batch against the plain
           float32 route, beside the plain route in bf16 against float32 (what
           bf16 rounding alone does to the same gradients);
  kernels  every kernel of the paths with its launches, error, times and bound
           (rows 1-13, rows 12 and 13 by variant, and row 14's check);

with --seeds K > 1, a ``sweep`` line for each further seed and one that sums
them up: the articulated kernels' training checks, the checks at the bench's
shapes and the bench's interval first step, untimed, on the weights and
draws of seeds seed+1 .. seed+K-1 (every check must pass on every seed);

with --profile, two ``profile`` lines as well: torch.profiler over five warm v3
steps of the vanilla and of the auto-decoder system, device time by kernel
name and the device's idle share of the window;

and last {"ok": true, "device": {...}}.  Any failing phase prints its error
and exits 1.  Needs one CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

CONFIG = "configs/quality_laptop_vanilla_refsched.json"
CHUNK_RAYS = 61440
N_COARSE, N_FINE = 64, 128
# the vanilla MLP's multiply-adds per sample are the port's
# MLP_MACS_PER_SAMPLE (aon_tpu_torch/ops/fused_mlp.py), which the kernel
# bench's TFLOP/s count too
MLP_BIASES = 2436  # 8x256 trunk + 256 bottleneck + 1 density + 128 view + 3 rgb
FOVY_DEG = 35.0  # the SAPIEN laptop dataset's camera (datagen/data_gen.py)

# tolerances, with the reason for each; the MLP kernel's against its twin are
# TWIN_TOL_MAX and TWIN_TOL_MEAN of aon_tpu_torch/ops/fused_mlp_train.py
TOL_RESAMPLE = 1e-6  # same f32 operations in the same order: bit-identical expected
# the weight gradients alone against torch.matmul on random bf16 workspaces,
# the largest error relative to the largest entry: each block sums its ~58k
# rows in the tensor cores' f32 accumulator, whose rounding grows with the
# chain (1.6e-4 at 395,264 rows on an H100); a layout fault moves entries by
# their own size
TOL_WGRAD_REL = 1e-3
TOL_POSENC_TWIN = 1e-6  # an ulp of the sine
TOL_POSENC_EXACT = 2e-3  # float32 range reduction at ~3000 rad (the TPU suite's bound)
# the doubling encoder against its twin: nine doublings carry an ulp of the
# first sine up by 2^9
TOL_POSENC_ENCODER_TWIN = 1e-4
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
# the first step on the bench's occupancy intervals (0.19 long on average):
# there the fine samples move with the coarse weights' last bits, and the
# plain route in bf16 lies as far from the float32 route as the kernels do
# (max / mean measures 0.04-0.29 / 0.08-0.21 over 12 seeds of weights and
# draws on an H100, the kernel route within 1.11x / 1.07x of it).  The kernel
# route is held to this many times the plain bf16 route's distance
TOL_INTERVAL_VS_BF16 = 1.5
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
# multiply-adds per sample the articulated MLP adds to the vanilla one's: the
# 4x128 deformation prefix (3x128 + 3x128x128 + 128x3) and views_1..3
ART_EXTRA_MACS = 49920 + 49152
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
# the kernel bench's bf16acc body against its base body on the same inputs,
# mean absolute difference: at least this many times the bf16acc kernel's
# mean error against its own twin, so that its check tells the two roundings
# apart (the twins lie 1.0e-3 apart on 16,384 of these rows on the CPU; the
# kernel was 1.5e-5 from its twin on an H100)
BF16ACC_SEPARATION = 10.0

# ---- the bench's contracts (aon_tpu_torch/scripts/bench.py): system, rays
# per step, interval kind, _synthetic_batch seed, samples per level
BENCH_CONTRACTS = (("vanilla", 32768, "occ", 0, (16, 32)),
                   ("autodecoder", 4096, "aabb", 1, (24, 48)))

# ---- geometry extraction (aon_tpu_torch/scripts/extract_geometry.py) at its
# default, full-width settings: a 160^3 grid queried 65,536 points at a time
GEO_RES, GEO_CHUNK = 160, 65536
GEO_BOUNDS = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
# the kernel's occupancy against its twin's: voxels whose sigma lies within
# the kernel / twin noise of the threshold may flip; at most this share of
# the grid's voxels may
TOL_OCC_SHARE = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def worst_tensors(got, want, skip=()) -> dict:
    """The gradient tensors (but those in ``skip``) with the largest max and
    mean relative errors (the measures of ``fused_mlp_train.grad_errors``)
    and those errors."""
    tiny = 1e-30
    names = [k for k in want if k not in skip]
    max_rel = {k: ((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(tiny)).item()
               for k in names}
    mean_rel = {k: ((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(tiny)).item()
                for k in names}
    k_max, k_mean = max(max_rel, key=max_rel.get), max(mean_rel, key=mean_rel.get)
    return {"max": [k_max, max_rel[k_max]], "mean": [k_mean, mean_rel[k_mean]]}


def geometry_files_ok(out_dir, out) -> bool:
    """Whether the point cloud and the mesh an extraction wrote parse and
    hold what it reported (``out``: occupied, verts, tris)."""
    ply = (out_dir / "points.ply").read_text().splitlines()
    obj = (out_dir / "mesh.obj").read_text().splitlines()
    faces = [ln.split()[1:] for ln in obj if ln.startswith("f ")]
    return (f"element vertex {out['occupied']}" in ply
            and len(ply) == ply.index("end_header") + 1 + out["occupied"]
            and sum(ln.startswith("v ") for ln in obj) == out["verts"]
            and len(faces) == out["tris"]
            and all(1 <= int(i) <= out["verts"] for f in faces for i in f))


def launches_are(launches, **want) -> bool:
    """Whether a run's launch counts are exactly ``want``, and 0 for every
    kernel it does not name."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def ptxas_spills(log: str, kernel: str) -> dict:
    """Spill bytes (stores + loads) of each instance of ``kernel`` in a
    ``-Xptxas -v`` log, by mangled name."""
    spills, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "spill stores" in line:
            if kernel in name:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                spills[name] = sum(nums[1:3])  # stack frame, spill stores, spill loads
            name = None
    return spills


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
    enc = encode_plain(samples.reshape(-1, 3), consts["s_pos"], consts["p_pos"])
    venc = encode_plain(torch.repeat_interleave(viewdirs, S, 0), consts["s_view"],
                        consts["p_view"])
    return library_mlp_enc(torch, packed, enc, venc)


def library_mlp_enc(torch, packed, enc, venc):
    """Yardstick only: the layer chain as bf16 cuBLAS calls on given
    per-sample encodings."""
    bf = torch.bfloat16
    enc, venc = enc.to(bf), venc.to(bf)
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


def library_mlp_vjp(torch, packed, enc, venc, cotangent):
    """Yardstick only: the weight gradients of ``library_mlp_enc`` for the
    cotangent (N, 4), under autograd."""
    w = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in packed.items()}
    rgb, sigma = library_mlp_enc(torch, w, enc, venc)
    loss = (rgb.float() * cotangent[:, :3]).sum() + (sigma.float() * cotangent[:, 3:]).sum()
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
                      encode_plain, cotangent=None, mask=None, white_bkgd=False,
                      rgb_padding=0.001, density_bias=-1.0, bce_weight=0.0,
                      sigma_act="softplus_bias"):
    """Yardstick only: one articulated training level as bf16 cuBLAS calls
    under autograd (head activations, compositing, weighted loss, the opacity
    BCE where ``bce_weight`` is set, backward; the level kernel's arguments,
    the auto-decoder's by default); with ``cotangent`` (B, S, 4) the MLP
    alone."""
    B, S = t_vals.shape
    samples = rays_o[:, None, :] + t_vals[..., None] * rays_d[:, None, :]
    w = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in packed.items()}
    rgb, sigma = library_art_mlp(torch, w, consts, samples, viewdirs, encode_plain)
    rgb, sigma = rgb.float().reshape(B, S, 3), sigma.float().reshape(B, S)
    if cotangent is not None:
        loss = (rgb * cotangent[..., :3]).sum() + (sigma * cotangent[..., 3]).sum()
    else:
        dist = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
        sigma = (torch.nn.functional.softplus(sigma + density_bias)
                 if sigma_act == "softplus_bias" else torch.relu(sigma))
        alpha = 1.0 - torch.exp(-sigma * dist)
        trans = torch.cumprod(torch.clamp_min(1.0 - alpha, 0.0) + 1e-10, -1)
        wgt = alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        rgb = torch.sigmoid(rgb) * (1.0 + 2.0 * rgb_padding) - rgb_padding
        comp, acc = (wgt[..., None] * rgb).sum(1), wgt.sum(-1)
        if white_bkgd:
            comp = comp + (1.0 - acc[:, None])
        loss = (loss_w[:, None] * (comp - target) ** 2).sum()
        if bce_weight:
            loss = loss + bce_weight * torch.nn.functional.binary_cross_entropy_with_logits(
                acc, mask)
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
    ap.add_argument("--seeds", type=int, default=1,
                    help="also run the articulated, bench-shape and interval checks on this "
                         "many seeds in all")
    ap.add_argument("--parent", default=None,
                    help="a checkout of another tree: its level split beside this tree's")
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
        from aon_tpu_torch.ops import _build, bench_variants, fused_art, train_sm90
        from aon_tpu_torch.ops.fused_mlp import (
            ENCODERS,
            EVAL_SLAB_BYTES,
            EVAL_TILE_ROWS,
            MLP_MACS_PER_SAMPLE,
            fused_nerf_mlp,
            fused_nerf_mlp_per_ray,
            fused_nerf_mlp_per_ray_plain,
            fused_nerf_mlp_plain,
            fused_nerf_mlp_xyz,
            fused_nerf_mlp_xyz_plain,
            launch_blobs,
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
            fused_mlp_bwd,
            fused_mlp_bwd_plain,
            fused_mlp_bwd_xyz,
            fused_mlp_bwd_xyz_plain,
            fused_mlp_train,
            fused_nerf_mlp_xyz_eval,
            fused_nerf_mlp_xyz_eval_plain,
            grad_errors,
            posenc_in_kernel,
        )
        from aon_tpu_torch.core.rendering import volumetric_rendering
        from aon_tpu_torch.scripts import bench as port_bench
        from aon_tpu_torch.scripts import bench_kernels as port_bench_kernels
        from aon_tpu_torch.scripts import extract_geometry, level_split
        from aon_tpu_torch.train.checkpoint import CheckpointManager
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
        from aon_tpu_torch.train.systems import (
            ART_TABLE,
            AutoDecoderSystem,
            VanillaSystem,
            build_system,
        )
        from aon_tpu_torch.utils.config import Config, get_config

        # what the ``kernels`` line carries of every kernel's record
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        # and of the eval kernel's rows (1, 5, 7, 8, 12, 13): its launch and
        # the rates at the measured time
        eval_keys = ("tflops", "pct_bf16_peak", "tile_rows", "grid", "cluster", "l2_weight_bytes",
                     "l2_tb_s")
        # the plain twins are float32 references: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        art_macs = MLP_MACS_PER_SAMPLE + ART_EXTRA_MACS  # 692,480
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        card = smi[0] if smi else kind  # name and power limit, beside every number
        emit({"phase": "device", "name": kind, "nvidia_smi": smi[0] if smi else None,
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})

        phase = "build"
        t0 = time.perf_counter()
        logs = _build.build()
        for src in _build.KERNEL_SOURCES:
            _build.library(src)
            logs.setdefault(src, _build.library_path(src).with_suffix(".log").read_text())
        eval_spills = ptxas_spills(logs["fused_mlp_eval"], "mlp_eval_kernel")
        # the vanilla training kernels of train_sm90.cuh: the forward's three
        # stagings, the backward and the weight gradients
        train_spills = ptxas_spills(logs["level_train"], "sm90")
        # the articulated kernels of art_sm90.cuh: the eval forward, the
        # training forward's and backward's two stagings each, the compositing
        # and the weight gradients over the articulated workspaces
        art_spills = ptxas_spills(logs["art"], "")
        emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "arch": "sm_90a",
              "sources": [f"aon_tpu_torch/ops/csrc/{s}.cu" for s in _build.KERNEL_SOURCES],
              "flags": " ".join(_build.NVCC_FLAGS),
              "ptxas": {k: [ln.strip() for ln in v.splitlines()
                            if "registers" in ln or "spill" in ln] for k, v in logs.items()},
              "warnings": {k: [ln.strip() for ln in v.splitlines() if "warning" in ln.lower()]
                           for k, v in logs.items()},
              "eval_kernel_spills": eval_spills, "train_kernel_spills": train_spills,
              "art_kernel_spills": art_spills})
        require(len(eval_spills) == 7 and not any(eval_spills.values()),
                "the eval kernel's seven instances must build without spills")
        require(len(train_spills) == 5 and not any(train_spills.values()),
                "the training kernels' five instances must build without spills")
        require(len(art_spills) == 7 and not any(art_spills.values()),
                "the articulated kernels' seven instances must build without spills")

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

        def forward_record(kname, fn, fn_plain, args_, library, rows, in_bytes, kw=None,
                           **extra):
            """One ``kernel`` line of a vanilla MLP forward entry (the eval
            kernel, rows 1, 5, 7, 8) against its twin, checked; ``in_bytes``
            are the inputs it stages, ``kw`` the entry's own arguments (the
            hoisted blobs)."""
            kw = kw or {}
            rgb, sigma = fn(*args_, **kw)
            torch.cuda.synchronize()
            rgb_p, sigma_p = fn_plain(*args_)
            err = torch.cat([(rgb - rgb_p).reshape(-1), (sigma - sigma_p).reshape(-1)]).abs()
            flops = 2.0 * MLP_MACS_PER_SAMPLE * rows
            # inputs, rgb + sigma out per sample, bf16 weights, f32 biases
            nbytes = in_bytes + rows * 16 + 2 * MLP_MACS_PER_SAMPLE + 4 * MLP_BIASES
            rec = {
                "phase": "kernel", "name": kname, **extra, "rows": rows,
                "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                "tol_max": TWIN_TOL_MAX, "tol_mean": TWIN_TOL_MEAN,
                "finite": bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()),
                "ms": time_ms(torch, lambda: fn(*args_, **kw), 5),
                "plain_ms": time_ms(torch, lambda: fn_plain(*args_), 3),
                "library_ms": time_ms(torch, library, 3),
                "flop": flops, "bytes": nbytes,
                "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
                             else "bytes"),
                "card": card,
            }
            rec.update(port_bench_kernels.eval_fields(rows, rec["ms"], dev))
            emit(rec)
            require(rec["finite"], f"non-finite {kname} output")
            require(rec["max_abs_err"] <= TWIN_TOL_MAX and rec["mean_abs_err"] <= TWIN_TOL_MEAN,
                    f"{kname} disagrees with its twin at {rec['shape']}")
            return rec

        def bound_of(flops, nbytes):
            by_ops = flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
            return {"flop": flops, "bytes": nbytes, "bound_by": "operations" if by_ops else "bytes",
                    "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)}

        def grad_record(kname, fn, fn_plain, fn_args, *, shape, rows, flops, nbytes, library,
                        kw=None, art=False, timed=True, strict=True, **extra):
            """One ``kernel`` line of a training kernel (a level or an MLP
            backward) against its twin on the same inputs, checked (unless
            ``strict`` is off: then its ``ok`` says): every gradient tensor by
            the max and mean measures (the articulated kernels' deformation
            gradients by direction and size instead), and a level's
            compositing weights, acc and loss; timed beside the twin, the
            library yardstick and the bound unless ``timed`` is off."""
            kw = kw or {}
            got = fn(*fn_args, **kw)
            torch.cuda.synchronize()
            want = fn_plain(*fn_args, **kw)
            again = fn(*fn_args, **kw)
            grads, grads_p, grads2 = (got, want, again) if isinstance(got, dict) else (
                got[-1], want[-1], again[-1])
            rec = {"phase": "kernel", "name": kname, **extra, "shape": shape, "rows": rows}
            twin_tol = fused_art.TWIN_TOL_MAX if art else TWIN_TOL_MAX
            fwd_ok = True
            if not isinstance(got, dict):  # a level: (loss, weights, [acc,] grads)
                loss_key = "photo_loss_rel_err" if art else "sq_err_rel_err"
                rec.update({"weights_max_abs_err": (got[1] - want[1]).abs().max().item(),
                            loss_key: abs(got[0].item() - want[0].item()) / want[0].item(),
                            "tol_forward": twin_tol})
                fwd = [rec["weights_max_abs_err"], rec[loss_key]]
                if art:
                    rec.update(acc_max_abs_err=(got[2] - want[2]).abs().max().item(),
                               acc_mean=want[2].mean().item())
                    fwd.append(rec["acc_max_abs_err"])
                fwd_ok = max(fwd) <= twin_tol and bool(torch.isfinite(got[1]).all())
            if art:
                max_rel, mean_rel = fused_art.grad_errors(grads, grads_p)
                tol = (fused_art.GRAD_TOL_REL, fused_art.GRAD_TOL_MEAN_REL)
                direction = fused_art.deform_direction(grads, grads_p)
                rec.update(deform={k: list(v) for k, v in direction.items()},
                           # the entry measures the deformation is not held to
                           deform_worst=worst_tensors(grads, grads_p, [
                               k for k in grads_p if k not in fused_art.DEFORM_GRADS]),
                           deform_min_cos=min(c for c, _ in direction.values()),
                           deform_max_norm_off=max(abs(r - 1.0) for _, r in direction.values()),
                           tol_deform=[fused_art.DEFORM_COS, fused_art.DEFORM_NORM])
                close = fused_art.grads_close(grads, grads_p)
                err_is = ("per gradient tensor outside the deformation, relative to its max "
                          "(mean) magnitude; worst")
            else:
                max_rel, mean_rel = grad_errors(grads, grads_p)
                tol = (GRAD_TOL_REL, GRAD_TOL_MEAN_REL)
                close = max_rel <= tol[0] and mean_rel <= tol[1]
                err_is = "per gradient tensor, relative to its max (mean) magnitude; worst"
            rec.update({
                "max_abs_err": max_rel, "mean_rel_err": mean_rel, "err_is": err_is,
                "tol_max": tol[0], "tol_mean": tol[1],
                "repeat_max_rel": grad_errors(grads2, grads)[0],
                "worst": worst_tensors(grads, grads_p, fused_art.DEFORM_GRADS if art else ()),
                "finite": all(bool(torch.isfinite(v).all()) for v in grads.values()),
                **bound_of(flops, nbytes), "card": card,
            })
            if timed:
                rec.update(ms=time_ms(torch, lambda: fn(*fn_args, **kw), 7, warmup=2),
                           plain_ms=time_ms(torch, lambda: fn_plain(*fn_args, **kw), 3),
                           library_ms=time_ms(torch, library, 3))
                rec["tflops"] = flops / rec["ms"] / 1e9
            rec["ok"] = rec["finite"] and fwd_ok and close
            emit(rec)
            if strict:
                where = f"{kname} {extra.get('arguments', {}).get('mode', '')} at {shape}"
                require(rec["finite"] and fwd_ok, f"{where}: forward outputs off")
                require(close, f"{where} disagrees with its twin")
            return rec

        def mlp_eval_record(packed_bf, samples, vdirs, kname="fused_nerf_mlp_xyz_eval"):
            """Kernel 1 (or 8, the same function from the same inputs) on raw
            samples and per-ray viewdirs; timed with the blobs packed once,
            as extract_geometry packs them for row 8."""
            n_rays, n_samples = samples.shape[:2]
            fns = {"fused_nerf_mlp_xyz_eval": (fused_nerf_mlp_xyz_eval,
                                               fused_nerf_mlp_xyz_eval_plain),
                   "fused_nerf_mlp_xyz": (fused_nerf_mlp_xyz, fused_nerf_mlp_xyz_plain)}[kname]
            args_ = (packed_bf, consts, samples, vdirs)
            return forward_record(
                kname, *fns, args_, lambda: library_mlp(torch, *args_, encode_plain),
                n_rays * n_samples, n_rays * n_samples * 12 + n_rays * 12,
                kw={"blobs": launch_blobs(packed_bf)}, shape=f"{n_rays}x{n_samples}")

        def encodings(samples, vdirs):
            """Per-sample (N, 64) and per-ray (B, 32) float32 encodings, as a
            caller of the encoded-input entry points makes them."""
            x, block = samples.reshape(-1, 3), 1 << 20
            enc = torch.empty(x.shape[0], 64, device=dev)
            for i in range(0, x.shape[0], block):
                enc[i:i + block] = encode_plain(x[i:i + block], consts["s_pos"], consts["p_pos"])
            return enc, encode_plain(vdirs, consts["s_view"], consts["p_view"])

        def enc_records(packed_bf, samples, vdirs):
            """Kernels 5 (per-sample view encodings) and 7 (per-ray) on the
            encodings of the samples, against their twins."""
            n_rays, n_samples = samples.shape[:2]
            rows = n_rays * n_samples
            enc, venc = encodings(samples, vdirs)
            venc_rows = torch.repeat_interleave(venc, n_samples, 0)
            flat = (packed_bf, enc, venc_rows)
            per_ray = (packed_bf, enc.view(n_rays, n_samples, 64), venc)
            out = {
                "fused_nerf_mlp": forward_record(
                    "fused_nerf_mlp", fused_nerf_mlp, fused_nerf_mlp_plain, flat,
                    lambda: library_mlp_enc(torch, packed_bf, enc, venc_rows), rows,
                    rows * (64 + 32) * 4, shape=f"{n_rays}x{n_samples}"),
                "fused_nerf_mlp_per_ray": forward_record(
                    "fused_nerf_mlp_per_ray", fused_nerf_mlp_per_ray,
                    fused_nerf_mlp_per_ray_plain, per_ray,
                    lambda: library_mlp_enc(torch, packed_bf, enc,
                                            torch.repeat_interleave(venc, n_samples, 0)),
                    rows, rows * 64 * 4 + n_rays * 32 * 4, shape=f"{n_rays}x{n_samples}"),
            }
            del enc, venc, venc_rows, flat, per_ray
            torch.cuda.empty_cache()
            return out

        mlp_rows, enc_rows = {}, {}
        for n_samples in (N_COARSE + 1, N_COARSE + 1 + N_FINE):
            _, samples = sample_along_rays(origins, dirs, n_samples - 1, 2.0, 6.0)
            samples = samples.contiguous()
            mlp_rows[n_samples] = mlp_eval_record(packed, samples, dirs)
            for kname, rec in enc_records(packed, samples, dirs).items():
                enc_rows[kname, "render", n_samples] = rec
            del samples
        torch.cuda.empty_cache()

        # kernel 8 at the extraction's block: 65,536 grid points as 512 x 128
        # with one viewdir (extract_geometry.py --chunk 65536)
        phase = "kernel:fused_nerf_mlp_xyz"
        geo_block = torch.rand(GEO_CHUNK // 128, 128, 3, generator=gen, device=dev) * 3.0 - 1.5
        geo_vdir = torch.tensor([[0.0, 0.0, -1.0]], device=dev).expand(GEO_CHUNK // 128, 3)
        xyz_rec = mlp_eval_record(packed, geo_block, geo_vdir.contiguous(), "fused_nerf_mlp_xyz")
        del geo_block, geo_vdir

        phase = "posenc"
        posenc_in_kernel.launches = 0
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

        # Kernel table row 14, the TPU suite's range-reduction test
        # (tests_tpu/test_kernel_parity.py): its 256 x 3 inputs, uniform in
        # [-6, 6) from numpy seed 1, through each encoder of the kernels,
        # column by column against the twin and the exact sine
        phase = "posenc:row14"
        x14 = torch.from_numpy(np.random.default_rng(1).uniform(-6, 6, (256, 3)).astype(
            np.float32)).to(dev)
        row14 = {"phase": "posenc", "check": "tests_tpu/test_kernel_parity.py:62", "rows": 256,
                 "encoders": {}, "tol_exact": TOL_POSENC_EXACT,
                 "tol_twin": {"elementwise": TOL_POSENC_TWIN, "mxu": TOL_POSENC_TWIN,
                              "doubling": TOL_POSENC_ENCODER_TWIN}}
        for encoder in ENCODERS:
            for s, p in (("s_pos", "p_pos"), ("s_view", "p_view")):
                got = posenc_in_kernel(x14, consts[s], consts[p], encoder)
                col_err = (got - bench_variants.encode_plain(x14, consts[s], consts[p], encoder)
                           ).abs().max(0).values
                n_real = 3 * (1 + 2 * (cfg.N_emb_xyz if s == "s_pos" else cfg.N_emb_dir))
                pre = (x14.double().cpu().numpy() @ consts[s].double().cpu().numpy()[:3]
                       + consts[p].double().cpu().numpy())
                exact = np.where(np.arange(pre.shape[1]) < 3, pre, np.sin(pre))[:, :n_real]
                pad_cols = torch.arange(n_real, got.shape[1], device=dev)
                # the doubling encoder's padding columns carry the raw coordinates
                pad_want = (x14[:, (pad_cols - 3) % 3] if encoder == "doubling"
                            else torch.zeros(256, len(pad_cols), device=dev))
                row14["encoders"][f"{encoder}/{s}"] = {
                    "err_twin": col_err.max().item(), "worst_column": int(col_err.argmax()),
                    "err_exact": float(np.abs(got[:, :n_real].cpu().numpy() - exact).max()),
                    "padding_exact": bool(torch.equal(got[:, n_real:], pad_want))}
        row14["launches"] = posenc_in_kernel.launches
        # its time at the check's shape and at one extraction block of 65,536
        # points, beside the twin and the same encoding as one chain of torch
        # calls (no range reduction): 12 B in and 256 B out per row
        row14["timed"] = []
        for n in (256, GEO_CHUNK):
            xt = (torch.rand(n, 3, generator=gen, device=dev) * 12 - 6).contiguous()
            col = torch.arange(64, device=dev)

            def library_posenc(xt=xt):
                pre = torch.addmm(consts["p_pos"], xt, consts["s_pos"][:3])
                return torch.where(col < 3, pre, torch.sin(pre))

            nbytes = n * (12 + 256) + 5 * 64 * 4
            row14["timed"].append({
                "shape": f"{n}x64",
                "ms": time_ms(torch, lambda: posenc_in_kernel(xt, consts["s_pos"], consts["p_pos"]),
                              20, warmup=3),
                "plain_ms": time_ms(torch, lambda: encode_plain(xt, consts["s_pos"],
                                                                consts["p_pos"]), 5),
                "library_ms": time_ms(torch, library_posenc, 5),
                "bytes": nbytes, "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes"})
        row14["card"] = card
        emit(row14)
        require(all(e["err_twin"] <= (TOL_POSENC_ENCODER_TWIN if k.startswith("doubling")
                                      else TOL_POSENC_TWIN)
                    and e["err_exact"] <= TOL_POSENC_EXACT and e["padding_exact"]
                    for k, e in row14["encoders"].items()),
                "an encoder of row 14 is outside its tolerance")

        phase = "kernel:resample_union"

        def resample_record(t_vals, bins, cdf, u, timed=True, **extra):
            """One ``kernel`` line of the resample against its twin, checked
            (timed unless ``timed`` is off); ``u`` is one shared row expanded
            over the rays, or a row per ray."""
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
                "phase": "kernel", "name": "resample_union", **extra,
                "shape": f"{n_rays}x{n_t}+{n_u}",
                "quantiles": "one shared row" if shared else "a sorted random row per ray",
                "max_abs_err": (got - want).abs().max().item(), "tol": TOL_RESAMPLE,
                "sorted": bool((got[:, 1:] >= got[:, :-1]).all()),
                "bytes": nbytes, "ops": ops,
                "bound_ms": 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS),
                "bound_by": ("bytes" if nbytes / PEAK_BYTES >= ops / PEAK_F32_FLOPS
                             else "operations"),
                "card": card,
            }
            if timed:
                rec.update(
                    ms=time_ms(torch, lambda: resample_union(t_vals, bins, cdf, u), 20, warmup=3),
                    plain_ms=time_ms(torch, lambda: resample_union_plain(t_vals, bins, cdf, u), 5),
                    library_ms=time_ms(
                        torch, lambda: library_resample(torch, t_vals, bins, cdf, u_rows), 5))
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
                    "fused_nerf_mlp": fused_nerf_mlp,
                    "fused_nerf_mlp_per_ray": fused_nerf_mlp_per_ray,
                    "fused_nerf_mlp_xyz": fused_nerf_mlp_xyz,
                    "fused_mlp_bwd": fused_mlp_bwd,
                    "resample_union": resample_union,
                    "fused_level_train_grads": fused_level_train_grads,
                    "fused_mlp_bwd_xyz": fused_mlp_bwd_xyz,
                    "art_mlp_fwd": fused_art.art_mlp_fwd,
                    "art_mlp_bwd": fused_art.art_mlp_bwd,
                    "fused_level_train_art_grads": fused_level_train_art_grads,
                    **{fn.__name__: fn for fn in (*bench_variants.MLP_BODY.values(),
                                                  *bench_variants.XYZ_BODY.values())}}
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
            # kernel 6 on the samples' encodings, as fused_mlp_train's backward
            # gets them
            enc, venc = encodings(samples, rd)
            enc_bwd_args = (packed32, enc, torch.repeat_interleave(venc, n_samples, 0),
                            cot.reshape(rows, 4))
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
                # enc, venc and g (N, 64 + 32 + 4), f32 params in, f32 grads out
                ("fused_mlp_bwd", fused_mlp_bwd, fused_mlp_bwd_plain, enc_bwd_args,
                 4 * (100 * rows + 2 * n_params),
                 lambda: library_mlp_vjp(torch, *enc_bwd_args)),
            )
            for kname, fn, fn_plain, fn_args, nbytes, library in runs:
                train_rows[kname, n_samples] = grad_record(
                    kname, fn, fn_plain, fn_args, shape=f"{TRAIN_RAYS}x{n_samples}", rows=rows,
                    flops=flops, nbytes=nbytes, library=library)
            # the eval MLP as the v2 forward launches it: the float32 packing
            # of training, rounded to bf16 for the launch
            train_rows["fused_nerf_mlp_xyz_eval", n_samples] = mlp_eval_record(
                round_packed(packed32), samples, rd)
            del enc, venc, enc_bwd_args
            if level == "fine_mlp":
                # kernels 5 and 7 as fused_mlp_train's forward launches them
                for kname, rec in enc_records(round_packed(packed32), samples, rd).items():
                    enc_rows[kname, "train", n_samples] = rec
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

        # the weight gradients alone on random workspaces of the fine level's
        # rows: the MN-major wgmma operands against torch.matmul
        phase = "wgrad"
        n_pad = train_sm90.padded_rows(TRAIN_RAYS * (N_COARSE + 1 + N_FINE))
        ws_act = torch.randn(n_pad // 64, train_sm90.ACT_CHUNKS, 64, 64, generator=gen,
                             device=dev).bfloat16()
        ws_grad = torch.randn(n_pad // 64, train_sm90.GRAD_CHUNKS, 64, 64, generator=gen,
                              device=dev).bfloat16()
        got = train_sm90.weight_grads(ws_act, ws_grad)
        torch.cuda.synchronize()
        want = train_sm90.weight_grads_plain(ws_act, ws_grad)
        wgrad_flops = 2.0 * n_pad * level_split.STAGE_MACS["weight_grads"]
        rec = {"phase": "wgrad", "rows": n_pad, "items": int(train_sm90.items_on(n_pad, dev)[1]),
               "max_abs_err": (got - want).abs().max().item(),
               "max_rel_err": ((got - want).abs().max() / want.abs().max()).item(),
               "tol_rel": TOL_WGRAD_REL,
               "entries_written_as_plain": bool(torch.equal(got == 0, want == 0)),
               "ms": time_ms(torch, lambda: train_sm90.weight_grads(ws_act, ws_grad), 7, warmup=2),
               "plain_ms": time_ms(torch, lambda: train_sm90.weight_grads_plain(ws_act, ws_grad), 3),
               **bound_of(wgrad_flops, ws_act.numel() * 2 + ws_grad.numel() * 2),
               "card": card}
        rec["tflops"] = wgrad_flops / rec["ms"] / 1e9
        emit(rec)
        require(rec["max_rel_err"] <= TOL_WGRAD_REL and rec["entries_written_as_plain"],
                "the weight gradients disagree with torch.matmul")
        del ws_act, ws_grad, got, want
        torch.cuda.empty_cache()

        # the level's four stages by device time, at the fine level's and the
        # bench's fine sample counts, for this tree and (--parent) another
        phase = "level_split"
        split = {"phase": "level_split", "tree": level_split.measure([N_COARSE + 1 + N_FINE, 49]),
                 "card": card}
        if args.parent:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "aon_tpu_torch" / "scripts" / "level_split.py"),
                 "--root", str(Path(args.parent).resolve()), "--samples",
                 str(N_COARSE + 1 + N_FINE), "49"], capture_output=True, text=True, timeout=600)
            require(proc.returncode == 0, f"level_split of the parent failed: {proc.stderr[-2000:]}")
            split["parent"] = json.loads(proc.stdout.strip().splitlines()[-1])
        emit(split)

        # the same for the articulated level (row 9), at the fine level's and
        # the bench's fine sample counts
        phase = "art_level_split"
        art_samples = [N_COARSE + 1 + N_FINE, 73]
        split = {"phase": "art_level_split",
                 "tree": level_split.measure(art_samples, art=True), "card": card}
        if args.parent:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "aon_tpu_torch" / "scripts" / "level_split.py"),
                 "--root", str(Path(args.parent).resolve()), "--art", "--samples",
                 *map(str, art_samples)], capture_output=True, text=True, timeout=600)
            require(proc.returncode == 0,
                    f"art_level_split of the parent failed: {proc.stderr[-2000:]}")
            split["parent"] = json.loads(proc.stdout.strip().splitlines()[-1])
        emit(split)

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
        n_art_params = art_macs + ART_BIASES

        def art_fwd_record(packed_art, samples, vdirs, path, timed=True):
            """One ``kernel`` line of the articulated forward against its twin,
            checked (timed unless ``timed`` is off)."""
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
                **bound_of(2.0 * art_macs * rows,
                           rows * (12 + 16) + n_rays * 12 + 2 * art_macs
                           + 4 * ART_BIASES),
                "card": card,
            }
            if timed:
                rec.update(
                    ms=time_ms(torch, lambda: fused_art.art_mlp_fwd(*args_), 5),
                    plain_ms=time_ms(torch, lambda: fused_art.art_mlp_fwd_plain(*args_), 3),
                    library_ms=time_ms(
                        torch, lambda: library_art_mlp(torch, *args_, encode_plain), 3))
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
        del packed_fine
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

        def art_train_checks(seed, timed=True, strict=True):
            """Rows 9 (with each argument set), 11 and 10 at the training
            shapes, 2,048 rays x 65 and x 193 samples with t sampled as a step
            samples it, against their twins, on the weights, codes, rays and
            draws of ``seed``; the records by (kernel, arguments, samples)."""
            gen = torch.Generator(device=dev).manual_seed(seed + 17)
            params_s = art_system.init_params(torch.Generator(device=dev).manual_seed(seed + 7))
            lat = {k: v.detach() for k, v in art_system._latents(
                params_s, {"instance_id": 1, "articulation_id": 2}).items()}
            rd = torch.nn.functional.normalize(
                torch.randn(TRAIN_RAYS, 3, generator=gen, device=dev), dim=-1)
            ro = (-4.0 * rd + 0.3 * torch.randn(TRAIN_RAYS, 3, generator=gen, device=dev))
            target = torch.rand(TRAIN_RAYS, 3, generator=gen, device=dev)
            target = target * (torch.rand(TRAIN_RAYS, 1, generator=gen, device=dev) > 0.5)
            mask = (target.sum(-1) > 0).float()
            lw_uniform = torch.full((TRAIN_RAYS,), 1.0 / (3.0 * TRAIN_RAYS), device=dev)
            lw_masked = (mask / (3.0 * mask.sum()).clamp_min(1.0)).contiguous()
            t_lvl, _ = sample_along_rays(ro, rd, N_COARSE, 2.0, 6.0, randomized=True,
                                         generator=gen)
            recs = {}
            for level in ("coarse_mlp", "fine_mlp"):
                packed_art = fused_art.fold_latents(mlp_params(params_s, f"model.{level}"), lat)
                n_samples = t_lvl.shape[1]
                samples = (ro[:, None, :] + t_lvl[..., None] * rd[:, None, :]).contiguous()
                rows = TRAIN_RAYS * n_samples
                cot = torch.randn(TRAIN_RAYS, n_samples, 4, generator=gen, device=dev) / rows
                level_args = (packed_art, consts, t_lvl, ro, rd, rd, target)
                runs = [
                    # xyz and g (B, S, 3 + 4), viewdirs, f32 params in, f32 grads out
                    ("art_mlp_bwd", "", fused_art.art_mlp_bwd, fused_art.art_mlp_bwd_plain,
                     (packed_art, consts, samples, rd, cot), {},
                     4 * (7 * rows + 3 * TRAIN_RAYS + 2 * n_art_params),
                     lambda: library_art_level(torch, packed_art, consts, t_lvl, ro, rd, rd,
                                               target, lw_uniform, encode_plain, cotangent=cot)),
                ]
                for mode, kw in art_level_modes.items():
                    if mode != "autodecoder" and level == "coarse_mlp":
                        continue  # the other two argument sets once, at the fine shape
                    lw = lw_masked if mode == "autoencoder" else lw_uniform
                    runs.append(
                        # t and weights (B, S); o, d, viewdirs, target (B, 3); loss_w, mask,
                        # acc (B); f32 params in, f32 grads out
                        ("fused_level_train_art_grads", mode, fused_level_train_art_grads,
                         fused_level_train_art_grads_plain, (*level_args, lw, mask), kw,
                         4 * (2 * rows + (4 * 3 + 3) * TRAIN_RAYS + 2 * n_art_params + 1),
                         lambda lw=lw, kw=kw: library_art_level(
                             torch, packed_art, consts, t_lvl, ro, rd, rd, target, lw,
                             encode_plain, mask=mask, **kw)))
                for kname, mode, fn, fn_plain, fn_args, kw, nbytes, library in runs:
                    extra = {"arguments": dict(kw, mode=mode)} if mode else {}
                    recs[kname, mode, n_samples] = grad_record(
                        kname, fn, fn_plain, fn_args, kw=kw, shape=f"{TRAIN_RAYS}x{n_samples}",
                        rows=rows, flops=3 * 2.0 * art_macs * rows,  # forward, two backward
                        nbytes=nbytes, library=library, art=True, timed=timed, strict=strict,
                        seed=seed, **extra)
                # the forward as the v2 route launches it
                recs["art_mlp_fwd", "train", n_samples] = art_fwd_record(
                    packed_art, samples, rd, "v2 forward", timed=timed)
                if level == "coarse_mlp":
                    # the fine level's t: the union with the resample of this level's own weights
                    wgt = fused_level_train_art_grads(
                        *level_args, lw_uniform, mask, **art_level_modes["autodecoder"])[1]
                    bins = (0.5 * (t_lvl[:, 1:] + t_lvl[:, :-1])).contiguous()
                    u = sorted_uniform(torch.rand(TRAIN_RAYS, N_FINE + 1, generator=gen,
                                                  device=dev))
                    t_lvl = resample_union(t_lvl, bins, pdf_cdf(wgt[:, 1:-1]).contiguous(), u)
                del samples, cot, level_args, runs, packed_art
            torch.cuda.empty_cache()
            return recs

        art_train0 = art_train_checks(args.seed)
        art_rows.update(art_train0)

        # ------------------------------------------------ bench shapes
        # rows 3, 2 and 9 as the bench's steps launch them: the first
        # microbatch of each bench batch, t stratified in its per-ray
        # intervals, then the union with the resample of the coarse level's
        # weights
        phase = "kernel:bench_shapes"

        def bench_shape_checks(seed, timed=True, strict=True):
            """Rows 3 and 9, and row 2 between their levels, on the first
            2,048 rays of each bench batch (vanilla 17 + 32 samples on
            occupancy intervals, white background; the auto-decoder 25 + 48 on
            AABB intervals), against their twins, on the weights and draws of
            ``seed``; the records by (kernel, samples)."""
            gen = torch.Generator(device=dev).manual_seed(seed + 14)
            recs = {}
            for system_name, n_rays, tight, batch_seed, (n_c, n_f) in BENCH_CONTRACTS:
                hb = port_bench._synthetic_batch(n_rays, tight, seed=batch_seed)
                b = {k: torch.from_numpy(v[:TRAIN_RAYS]).to(dev) for k, v in hb.items()}
                ro, rd, vd, tg = b["rays_o"], b["rays_d"], b["viewdirs"], b["target"]
                contract = f"{system_name} bench, {tight} intervals"
                t_lvl, _ = sample_along_rays(ro, rd, n_c, b["t_near"], b["t_far"],
                                             randomized=True, generator=gen)
                vanilla = system_name == "vanilla"
                if vanilla:
                    p = system.init_params(torch.Generator(device=dev).manual_seed(seed + 1))
                else:
                    p = art_system.init_params(torch.Generator(device=dev).manual_seed(seed + 7))
                    lat = {k: v.detach() for k, v in art_system._latents(
                        p, {"instance_id": 0, "articulation_id": 1}).items()}
                    lw = torch.full((TRAIN_RAYS,), 1.0 / (3.0 * TRAIN_RAYS), device=dev)
                    ones = torch.ones(TRAIN_RAYS, device=dev)
                for level in ("coarse_mlp", "fine_mlp"):
                    n_samples = t_lvl.shape[1]
                    rows = TRAIN_RAYS * n_samples
                    if vanilla:
                        packed_l = pack_vanilla_mlp_params_f32(mlp_params(p, level))
                        kname, fn, fn_plain, kw = ("fused_level_train_grads", fused_level_train_grads,
                                                   fused_level_train_grads_plain, {})
                        fn_args = (packed_l, consts, t_lvl, ro, rd, vd, tg, True)
                        macs, n_p = MLP_MACS_PER_SAMPLE, n_params
                        library = (lambda packed_l=packed_l, t=t_lvl: library_level(
                            torch, packed_l, consts, t, ro, rd, vd, tg, encode_plain))
                    else:
                        packed_l = fused_art.fold_latents(mlp_params(p, f"model.{level}"), lat)
                        kname, fn, fn_plain = ("fused_level_train_art_grads",
                                               fused_level_train_art_grads,
                                               fused_level_train_art_grads_plain)
                        kw = art_level_modes["autodecoder"]
                        fn_args = (packed_l, consts, t_lvl, ro, rd, vd, tg, lw, ones)
                        macs, n_p = art_macs, n_art_params
                        library = (lambda packed_l=packed_l, t=t_lvl: library_art_level(
                            torch, packed_l, consts, t, ro, rd, vd, tg, lw, encode_plain,
                            mask=ones, **art_level_modes["autodecoder"]))
                    recs[kname, n_samples] = grad_record(
                        kname, fn, fn_plain, fn_args, kw=kw, shape=f"{TRAIN_RAYS}x{n_samples}",
                        rows=rows, flops=3 * 2.0 * macs * rows,
                        # t and weights (B, S); o, d, viewdirs, target [, loss_w, mask,
                        # acc] per ray; f32 params in, f32 grads out
                        nbytes=4 * (2 * rows + (12 if vanilla else 15) * TRAIN_RAYS
                                    + 2 * n_p + 1),
                        library=library, art=not vanilla, timed=timed, strict=strict,
                        seed=seed, contract=contract)
                    if level == "coarse_mlp":
                        wgt = fn(*fn_args, **kw)[1]
                        bins = (0.5 * (t_lvl[:, 1:] + t_lvl[:, :-1])).contiguous()
                        cdf = pdf_cdf(wgt[:, 1:-1]).contiguous()
                        u = sorted_uniform(torch.rand(TRAIN_RAYS, n_f + 1, generator=gen,
                                                      device=dev))
                        recs["resample_union", n_samples] = resample_record(
                            t_lvl, bins, cdf, u, timed=timed, seed=seed, contract=contract)
                        t_lvl = resample_union(t_lvl, bins, cdf, u)
                    del packed_l, fn_args
            torch.cuda.empty_cache()
            return recs

        bench_shape_rows = bench_shape_checks(args.seed)

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

        # ---------------------------------------------------------- ops_api
        # The public kernel API (aon_tpu_torch.ops) as a caller drives it on
        # pre-encoded inputs, with the trained vanilla state: a coarse training
        # level through fused_mlp_train (kernels 5 and 6) under autograd, and
        # the fine MLP on the same samples through fused_nerf_mlp and
        # fused_nerf_mlp_per_ray (5 and 7).  Held against the raw-coordinate
        # entry points (kernels 1 and 4) on the same samples, which encode in
        # the kernel what the caller encoded here.
        phase = "ops_api"
        g = torch.Generator(device=dev).manual_seed(args.seed + 10)
        batch = batch_of(g)
        rd, vd, tgt = (batch[k].contiguous() for k in ("rays_d", "viewdirs", "target"))
        n_api = N_COARSE + 1
        t_api, samples = sample_along_rays(batch["rays_o"], rd, N_COARSE, 2.0, 6.0)
        samples = samples.contiguous()
        leaves = {k: v.clone().requires_grad_(True) for k, v in pack_vanilla_mlp_params_f32(
            mlp_params(state_v3.params, "coarse_mlp")).items()}
        packed_fine = pack_vanilla_mlp_params(mlp_params(state_v3.params, "fine_mlp"))
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, venc = encodings(samples, vd)
        venc_rows = torch.repeat_interleave(venc, n_api, 0)
        rgb, sigma = fused_mlp_train(leaves, enc, venc_rows)
        comp = volumetric_rendering(torch.sigmoid(rgb.view(TRAIN_RAYS, n_api, 3)),
                                    torch.relu(sigma.view(TRAIN_RAYS, n_api, 1)), t_api, rd,
                                    white_bkgd=True)[0]
        loss = ((comp - tgt) ** 2).mean()
        g_rgb, g_sigma, *api_grads = torch.autograd.grad(loss, [rgb, sigma, *leaves.values()])
        api_grads = dict(zip(leaves, api_grads))
        with torch.no_grad():
            flat = fused_nerf_mlp(packed_fine, enc, venc_rows)
            per_ray = fused_nerf_mlp_per_ray(packed_fine, enc.view(TRAIN_RAYS, n_api, 64), venc)
        torch.cuda.synchronize()
        api_ms = 1e3 * (time.perf_counter() - t0)
        api_launches = {k: c.launches for k, c in counters.items()}
        # the raw-coordinate entry points on the same samples (comparisons,
        # not part of the run above)
        weights32 = {k: v.detach() for k, v in leaves.items()}
        ref_out = fused_nerf_mlp_xyz_eval(round_packed(weights32), consts, samples, vd)
        ref_grads = fused_mlp_bwd_xyz(weights32, consts, samples, vd,
                                      torch.cat([g_rgb, g_sigma], -1).view(TRAIN_RAYS, n_api, 4))
        ref_fine = fused_nerf_mlp_xyz_eval(packed_fine, consts, samples, vd)

        def out_errors(got, want):
            err = torch.cat([(a.reshape(-1) - b.reshape(-1)) for a, b in zip(got, want)]).abs()
            return {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item()}

        api = {"train_forward_vs_xyz": out_errors((rgb, sigma), ref_out),
               "render_vs_xyz": out_errors(flat, ref_fine)}
        api["train_grads_vs_xyz"] = dict(zip(("max_rel", "mean_rel"),
                                             grad_errors(api_grads, ref_grads)))
        checks = {
            "launches": launches_are(api_launches, fused_nerf_mlp=2, fused_nerf_mlp_per_ray=1,
                                     fused_mlp_bwd=1),
            "finite": math.isfinite(loss.item()) and all(
                bool(torch.isfinite(v).all()) for v in api_grads.values()),
            "outputs_vs_xyz": all(e["max_abs_err"] <= TWIN_TOL_MAX
                                  and e["mean_abs_err"] <= TWIN_TOL_MEAN
                                  for e in (api["train_forward_vs_xyz"], api["render_vs_xyz"])),
            "grads_vs_xyz": (api["train_grads_vs_xyz"]["max_rel"] <= GRAD_TOL_REL
                             and api["train_grads_vs_xyz"]["mean_rel"] <= GRAD_TOL_MEAN_REL),
            # the view row gathered per ray is the flat row: the same values
            "per_ray_equals_flat": bool(torch.equal(per_ray[0].reshape(-1, 3), flat[0])
                                        and torch.equal(per_ray[1].reshape(-1, 1), flat[1])),
        }
        emit({"phase": "ops_api", "rays": TRAIN_RAYS, "samples": n_api, "loss": loss.item(),
              "ms": api_ms, "launches": api_launches, "errors": api,
              "tol": {"outputs": [TWIN_TOL_MAX, TWIN_TOL_MEAN],
                      "grads": [GRAD_TOL_REL, GRAD_TOL_MEAN_REL]},
              "checks": checks, "card": card})
        require(all(checks.values()), f"ops_api checks failed: {checks}")
        del enc, venc, venc_rows, rgb, sigma, comp, flat, per_ray, ref_out, ref_fine, leaves
        torch.cuda.empty_cache()

        # --------------------------------------------------------- geometry
        # extract_geometry.main on the trained states of both systems, saved
        # and restored through the port's CheckpointManager, at the script's
        # default settings (160^3 points, 65,536 per query); the auto-decoder
        # once more at a midpoint code of the interpolated table
        phase = "geometry"
        geo_dir = Path(tempfile.mkdtemp(prefix="aon_geometry_"))
        cwd = os.getcwd()
        geo_recs = {}
        voxel = (GEO_BOUNDS[3] - GEO_BOUNDS[0]) / GEO_RES
        centers = extract_geometry.voxel_centers(
            np.asarray(GEO_BOUNDS[:3]), voxel, GEO_RES).reshape(-1, 3).astype(np.float32)
        queries = math.ceil(GEO_RES ** 3 / GEO_CHUNK)
        try:
            os.chdir(geo_dir)
            for label, config, sy, state, counter, ids in (
                    ("vanilla", CONFIG, system, state_v3, "fused_nerf_mlp_xyz", []),
                    ("autodecoder", ART_CONFIG, art_system, art_state_v3, "art_mlp_fwd",
                     ["--instance", "1", "--articulation", "2"]),
                    ("autodecoder_midpoint", ART_CONFIG, art_system, art_state_v3,
                     "art_mlp_fwd", ["--instance", "0", "--articulation", "1", "--interpolated"])):
                cfg_json = json.loads((ROOT / config).read_text())
                cfg_json["output_path"] = str(geo_dir / "results")
                cfg_path = geo_dir / Path(config).name
                cfg_path.write_text(json.dumps(cfg_json))
                run_dir = geo_dir / "results" / cfg_json["exp_name"]
                ckpt = CheckpointManager(str(run_dir))
                if not (run_dir / "last.ckpt").exists():  # both auto-decoder runs share it
                    ckpt.save_last(state, epoch=0)
                restored = ckpt.restore(sy.init_state(torch.Generator(device=dev).manual_seed(0)))
                bit_exact = restored.step == state.step and all(
                    torch.equal(getattr(restored, part)[k], getattr(state, part)[k])
                    for part in ("params", "mu", "nu") for k in state.params)
                flags = ["--config", str(cfg_path), "--resolution", str(GEO_RES),
                         "--chunk", str(GEO_CHUNK), "--bounds", *map(str, GEO_BOUNDS),
                         "--out", f"geometry_{label}", *ids]
                for c in counters.values():
                    c.launches = 0
                printed = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):  # stdout carries JSON lines only
                    out = extract_geometry.main(flags)
                wall_s = time.perf_counter() - t0
                launches = {k: c.launches for k, c in counters.items()}
                # the plain twins over the same points, on the card
                trainer = types.SimpleNamespace(cfg=get_config(["--config", str(cfg_path)]),
                                                state=restored, system=sy)
                twin = extract_geometry.density_color_fn(
                    trainer, extract_geometry.build_parser().parse_args(flags), plain=True)
                want = np.concatenate([
                    twin(torch.from_numpy(centers[i:i + GEO_CHUNK]).to(dev))[0].cpu().numpy()
                    for i in range(0, len(centers), GEO_CHUNK)])
                out_dir = geo_dir / out["out_dir"]
                z = np.load(out_dir / "density_grid.npz")
                sigma_k = z["sigma"].reshape(-1)
                err = np.abs(sigma_k - want)
                thr = float(z["threshold"])
                occ_twin = int((want > thr).sum())
                flipped = int(((sigma_k > thr) != (want > thr)).sum())
                files_ok = geometry_files_ok(out_dir, out)
                lines = printed.getvalue().splitlines()
                # The auto threshold may leave a grid of seeded, briefly trained
                # weights empty: the occupancy is also held at the twin grid's
                # 99th percentile, where a threshold cuts through the field, and
                # the saved grid is re-thresholded there through --from_grid,
                # which meshes ~41k voxels
                thr99 = float(np.quantile(want, 0.99))
                flipped99 = int(((sigma_k > thr99) != (want > thr99)).sum())
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    regrid = extract_geometry.main(["--from_grid", str(out_dir / "density_grid.npz"),
                                                    "--threshold", repr(thr99)])
                regrid["wall_s"] = time.perf_counter() - t0
                tol = ((TWIN_TOL_MAX, TWIN_TOL_MEAN) if label == "vanilla"
                       else (fused_art.TWIN_TOL_MAX, fused_art.TWIN_TOL_MEAN))
                checks = {
                    "restored_bit_exact": bit_exact,
                    "launches": launches_are(launches, **{counter: queries}),
                    "sigma_vs_twin": float(err.max()) <= tol[0] and float(err.mean()) <= tol[1],
                    "occupancy_vs_twin": max(flipped, flipped99) <= TOL_OCC_SHARE * GEO_RES ** 3,
                    "grid_file": (z["sigma"].shape == (GEO_RES,) * 3
                                  and np.allclose(z["bounds"].reshape(-1), GEO_BOUNDS)
                                  and math.isclose(float(z["voxel"]), voxel)
                                  and bool(np.isfinite(z["sigma"]).all())),
                    "ply_obj_files": files_ok,
                    "printed": (sum(ln.startswith("queried ") for ln in lines) == queries
                                and lines[-1].startswith(f"occupied {out['occupied']}/")),
                    "from_grid": (regrid["occupied"] == int((sigma_k > thr99).sum()) > 0
                                  and regrid["tris"] > 0 and geometry_files_ok(out_dir, regrid)),
                }
                rec = {"phase": "geometry", "system": label, "config": config, "flags": ids,
                       "resolution": GEO_RES, "chunk": GEO_CHUNK, "points": out["points"],
                       "queries": out["queries"], "launches": launches, "wall_s": wall_s,
                       "seconds": out["seconds"], "occupied": out["occupied"],
                       "occupied_twin": occ_twin, "flipped": flipped, "verts": out["verts"],
                       "tris": out["tris"], "threshold": thr,
                       "p99": {"threshold": thr99, "flipped": flipped99,
                               **{k: regrid[k] for k in ("occupied", "verts", "tris", "wall_s")}},
                       "sigma_max": float(sigma_k.max()),
                       "sigma_max_abs_err": float(err.max()),
                       "sigma_mean_abs_err": float(err.mean()),
                       "tol": {"sigma": list(tol), "occupancy_share": TOL_OCC_SHARE},
                       "checks": checks, "card": card}
                emit(rec)
                require(all(checks.values()), f"geometry ({label}) checks failed: {checks}")
                geo_recs[label] = rec
        finally:
            os.chdir(cwd)
            shutil.rmtree(geo_dir, ignore_errors=True)
        torch.cuda.empty_cache()

        # ----------------------------------------------------- bench_kernels
        # The port's kernel bench (aon_tpu_torch/scripts/bench_kernels.py),
        # every variant at its own shapes: rows 1 and 4 through the training
        # entries, row 12 (three bodies) and row 13 (three encoders); then each
        # row-12 and row-13 variant against its twin on 65,536 rows
        phase = "bench_kernels"
        for c in counters.values():
            c.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):  # its lines are re-emitted below
            bk_lines = {line["variant"]: line for line in port_bench_kernels.main([], device=dev)}
        bk_launches = {k: c.launches for k, c in counters.items()}
        for line in bk_lines.values():
            emit({"phase": "bench_kernels", **line, "card": card})

        def bk_calls(*names):  # a warm-up launch and the timed ones, per variant
            return sum(1 + bk_lines[n]["calls"] for n in names)

        parts = {n for n, v in port_bench_kernels.VARIANTS.items() if v[0] == "parts"}
        fwd_parts = {n for n in parts if "fwd" in port_bench_kernels.VARIANTS[n][2]["part"]}
        want_bk = {
            "fused_nerf_mlp_xyz_eval": bk_calls(*fwd_parts, "train512"),
            "fused_mlp_bwd_xyz": bk_calls(*(n for n in parts if "bwd" in
                                            port_bench_kernels.VARIANTS[n][2]["part"]), "train512"),
            "mlp_body_base": bk_calls("body_base512"),
            "mlp_body_2s": bk_calls("body_2s512", "body_2s1024"),
            "mlp_body_bf16acc": bk_calls("body_bf16acc512"),
            **{f"xyz_body_{e}": bk_calls(v) for e, v in (
                ("elementwise", "xyzbody_base512"), ("mxu", "xyzbody_mxu512"),
                ("doubling", "xyzbody_doubling512"))}}
        n_twin, n_bench = 65536, port_bench_kernels.ROWS["fwd"]
        packed_b = pack_vanilla_mlp_params(port_bench_kernels.mlp_params(dev))
        g = torch.Generator(device=dev).manual_seed(args.seed + 12)
        variant_in = {n: {"enc": torch.randn(n, 64, generator=g, device=dev),
                          "venc": torch.randn(n, 32, generator=g, device=dev),
                          "xyz": torch.randn(n, 3, generator=g, device=dev),
                          "vdir": torch.randn(n, 3, generator=g, device=dev)}
                      for n in (n_twin, n_bench)}
        variant_rows, outs = {}, {}
        for row, names in ((12, bench_variants.BODIES), (13, ENCODERS)):
            for vname in names:
                if row == 12:
                    fn, kname = bench_variants.MLP_BODY[vname], f"mlp_body_{vname}"
                    variant = {"base": "body_base512", "2s": "body_2s512",
                               "bf16acc": "body_bf16acc512"}[vname]

                    def run(x, fn=fn):
                        return fn(packed_b, x["enc"], x["venc"])

                    def plain(x, vname=vname):
                        return bench_variants.mlp_body_plain(x["enc"], x["venc"], packed_b, vname)

                    def library(x):
                        return library_mlp_enc(torch, packed_b, x["enc"], x["venc"])

                    in_bytes = (64 + 32) * 4
                else:
                    fn, kname = bench_variants.XYZ_BODY[vname], f"xyz_body_{vname}"
                    variant = {"elementwise": "xyzbody_base512", "mxu": "xyzbody_mxu512",
                               "doubling": "xyzbody_doubling512"}[vname]

                    def run(x, fn=fn):
                        return fn(packed_b, consts, x["xyz"], x["vdir"])

                    def plain(x, vname=vname):
                        return bench_variants.xyz_body_plain(packed_b, consts, x["xyz"], x["vdir"],
                                                             vname)

                    def library(x):
                        return library_mlp(torch, packed_b, consts, x["xyz"][:, None], x["vdir"],
                                           encode_plain)

                    in_bytes = 24
                got = run(variant_in[n_twin])
                torch.cuda.synchronize()
                want = plain(variant_in[n_twin])
                outs[kname] = got
                err = torch.cat([(a - b).reshape(-1) for a, b in zip(got, want)]).abs()
                flops = 2.0 * MLP_MACS_PER_SAMPLE * n_bench
                nbytes = n_bench * (in_bytes + 16) + 2 * MLP_MACS_PER_SAMPLE + 4 * MLP_BIASES
                x_bench = variant_in[n_bench]
                rec = {"phase": "kernel", "name": kname, "row": row, "variant": variant,
                       "shape": f"{n_bench}", "twin_rows": n_twin,
                       "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                       "tol_max": TWIN_TOL_MAX, "tol_mean": TWIN_TOL_MEAN,
                       "finite": all(bool(torch.isfinite(t).all()) for t in got),
                       "ms": bk_lines[variant]["ms_per_call"],
                       "plain_ms": time_ms(torch, lambda: plain(x_bench), 3),
                       "library_ms": time_ms(torch, lambda: library(x_bench), 3),
                       **bound_of(flops, nbytes), "card": card}
                rec.update(port_bench_kernels.eval_fields(n_bench, rec["ms"], dev))
                emit(rec)
                require(rec["finite"] and rec["max_abs_err"] <= TWIN_TOL_MAX
                        and rec["mean_abs_err"] <= TWIN_TOL_MEAN,
                        f"{kname} disagrees with its twin")
                variant_rows[kname] = rec
        two_stream_diff = max((a - b).abs().max().item() for a, b in zip(
            outs["mlp_body_2s"], outs["mlp_body_base"]))
        # the bf16acc body's check tells its rounding from the base body's:
        # the two bodies' outputs lie further apart than bf16acc from its twin
        gap = torch.cat([(a - b).reshape(-1) for a, b in zip(
            outs["mlp_body_bf16acc"], outs["mlp_body_base"])]).abs()
        bf16acc_err = variant_rows["mlp_body_bf16acc"]["mean_abs_err"]
        checks = {"lines": set(bk_lines) == set(port_bench_kernels.VARIANTS),
                  "launches": launches_are(bk_launches, **want_bk),
                  "two_stream_bit_identical_to_base": two_stream_diff == 0.0,
                  "bf16acc_apart_from_base": (gap.mean().item() > TWIN_TOL_MEAN and gap.mean().item()
                                              >= BF16ACC_SEPARATION * bf16acc_err)}
        emit({"phase": "bench_kernels", "launches": bk_launches, "launches_want": want_bk,
              "two_stream_vs_base_max_abs_diff": two_stream_diff,
              "bf16acc_vs_base": {"max_abs_diff": gap.max().item(),
                                  "mean_abs_diff": gap.mean().item(),
                                  "bf16acc_vs_twin_mean_abs_err": bf16acc_err,
                                  "separation_min": BF16ACC_SEPARATION},
              "checks": checks, "card": card})
        require(all(checks.values()), f"bench_kernels checks failed: {checks}")
        del gap

        # What binds the eval kernel: row 12's base and two-stream bodies on
        # 2^20 rows with a quarter, half and all of the SMs as persistent
        # blocks (the launcher's own grid argument).  If L2's weight stream
        # bound the card, the time per tile and block would fall with fewer
        # blocks; if it stays, each SM's own pipeline binds.
        enc_s = torch.randn(1 << 20, 64, generator=g, device=dev)
        venc_s = torch.randn(1 << 20, 32, generator=g, device=dev)
        blobs_s = launch_blobs(packed_b)
        out_s = (torch.empty(1 << 20, 3, device=dev), torch.empty(1 << 20, 1, device=dev))
        lib = _build.library("fused_mlp_eval")
        sweep = []
        for body in ("base", "2s"):
            for grid in (33, 66, 132):
                def launch(body=body, grid=grid):
                    _build.check(lib.aon_mlp_body_launch(
                        enc_s.data_ptr(), venc_s.data_ptr(), blobs_s[0].data_ptr(),
                        blobs_s[1].data_ptr(), out_s[0].data_ptr(), out_s[1].data_ptr(),
                        1 << 20, bench_variants.BODIES.index(body), grid,
                        torch.cuda.current_stream(dev).cuda_stream), "grid sweep")

                ms = time_ms(torch, launch, 5, warmup=2)
                tiles = (1 << 20) // EVAL_TILE_ROWS
                sweep.append({"body": body, "grid": grid, "ms": ms,
                              "us_per_tile_per_block": 1e3 * ms * grid / tiles,
                              "l2_tb_s": tiles * EVAL_SLAB_BYTES / (ms * 1e-3) / 1e12})
        emit({"phase": "trunk_grid_sweep", "rows": 1 << 20, "runs": sweep, "card": card})
        del enc_s, venc_s, blobs_s, out_s
        del variant_in, outs, packed_b
        torch.cuda.empty_cache()

        # ------------------------------------------------------------- bench
        # The port's bench.py at its defaults (the production contract:
        # vanilla 32,768 rays at 16 + 32 samples with occupancy intervals, the
        # auto-decoder 4,096 at 24 + 48 with AABB intervals), then at
        # --reference_contract --headline_only; exact launches, the loss of
        # the repeated batch falling; and the first step of the interval path
        # on one 2,048-ray microbatch of the bench's own batch against the
        # plain float32 route
        phase = "bench"
        bench_runs, bench_launches = {}, {}
        for label, flags in (("production", []),
                             ("reference_contract", ["--reference_contract", "--headline_only"])):
            for c in counters.values():
                c.launches = 0
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                res = port_bench.main(flags, device=dev)
            bench_launches[label] = {k: c.launches for k, c in counters.items()}
            lines = [json.loads(ln) for ln in printed.getvalue().splitlines()]
            bench_runs[label] = (res, lines)
            emit({"phase": "bench", "contract": label, "flags": flags, "lines": lines,
                  "results": res, "launches": bench_launches[label], "card": card})

        def bench_launches_want(res):
            """Launches of the bench's dispatches: per step, two levels and a
            resample per microbatch."""
            want = {}
            calls = port_bench.WARMUP_DISPATCHES + port_bench.TIMED_DISPATCHES
            for system, level in (("vanilla", "fused_level_train_grads"),
                                  ("autodecoder", "fused_level_train_art_grads")):
                if system in res:
                    r = res[system]
                    micro = calls * r["steps_per_dispatch"] * r["rays_per_step"] // r["microbatch"]
                    want[level] = 2 * micro
                    want["resample_union"] = want.get("resample_union", 0) + micro
            return want

        def interval_first_step(seed):
            """The first step of the interval path (the v3 kernel route) on the
            first 2,048 rays of each bench batch against the plain float32
            route, with the weights and draws of ``seed``; beside it, the
            plain route in bf16 against float32 on the same inputs: what bf16
            rounding alone does to the same gradients."""
            out = {}
            for system_name, n_rays, tight, batch_seed, samples in BENCH_CONTRACTS:
                hb = port_bench._synthetic_batch(n_rays, tight, seed=batch_seed)
                batch = {k: torch.from_numpy(v[:TRAIN_RAYS]).to(dev) for k, v in hb.items()}
                kw = dict(N_samples=samples[0], N_importance=samples[1], compute_dtype="bfloat16")
                route_cfg = (("v3", {}), ("plain", dict(use_pallas=False, compute_dtype="float32")),
                             ("plain_bf16", dict(use_pallas=False)))
                if system_name == "vanilla":
                    routes = {r: VanillaSystem(Config(**{**kw, **o}), 2.0, 6.0, True, device=dev)
                              for r, o in route_cfg}
                else:
                    batch.update(instance_id=torch.tensor(0, device=dev),
                                 articulation_id=torch.tensor(1, device=dev))
                    routes = {r: AutoDecoderSystem(Config(**{**kw, **o}, N_max_objs=8), 2.0, 6.0,
                                                   False, device=dev)
                              for r, o in route_cfg}
                g = torch.Generator(device=dev).manual_seed(seed + 13)
                params0 = routes["v3"].init_params(g)
                draws = {"t_rand": torch.rand(TRAIN_RAYS, samples[0] + 1, generator=g, device=dev),
                         "u": sorted_uniform(torch.rand(TRAIN_RAYS, samples[1] + 1, generator=g,
                                                        device=dev))}
                first = {r: accumulated_grads(sy.loss_fn, params0, batch, None, draws)
                         for r, sy in routes.items()}
                # The articulation and shape codes enter the deformation field
                # (fold_latents folds both into its first bias; the shape code
                # also into the trunk's), so their gradients carry the
                # deformation's phase noise, which the short AABB intervals
                # weigh more than the [2, 6] ladder of the art_train phase
                # does; the plain route in bf16 shows the same against
                # float32 (PERF.md).  They are held with the deformation's
                # tensors, the appearance code (the view layer's only) at the
                # codes' limit.
                deform_codes = [ART_TABLE, "code_library.embedding_instance_shape.weight"]
                names = {"trunk": [k for k in params0 if k.startswith("model.")
                                   and ".deform_" not in k],
                         "deform": [k for k in params0 if ".deform_" in k] + deform_codes,
                         "codes": [k for k in params0 if k.startswith("code_library.")
                                   and k not in deform_codes]}

                def against_plain(r):
                    a, b = first[r], first["plain"]
                    max_rel, mean_rel = grad_errors(a[2], b[2])
                    cmp = {"loss_rel": abs(a[0].item() - b[0].item()) / abs(b[0].item()),
                           "grad_max_rel": max_rel, "grad_mean_rel": mean_rel}
                    if system_name != "vanilla":
                        cmp["cos"] = {grp: cosine(a[2], b[2], ks) for grp, ks in names.items()}
                        cmp["cos_by_code_table"] = {k: cosine(a[2], b[2], [k])
                                                    for k in params0 if k.startswith("code_library.")}
                    return cmp

                rec = {"seed": seed, "loss": {r: first[r][0].item() for r in first},
                       **against_plain("v3"), "plain_bf16_vs_plain": against_plain("plain_bf16"),
                       "interval_mean_span": float((hb["t_far"] - hb["t_near"])[:TRAIN_RAYS].mean())}
                if system_name == "vanilla":
                    bf16 = rec["plain_bf16_vs_plain"]
                    rec["ok"] = (rec["loss_rel"] <= TOL_STEP_LOSS
                                 and rec["grad_max_rel"] <= TOL_INTERVAL_VS_BF16 * bf16["grad_max_rel"]
                                 and rec["grad_mean_rel"]
                                 <= TOL_INTERVAL_VS_BF16 * bf16["grad_mean_rel"])
                else:
                    rec["ok"] = rec["loss_rel"] <= TOL_STEP_LOSS and all(
                        rec["cos"][grp] >= TOL_ART_STEP_COS[grp] for grp in names)
                out[system_name] = rec
                del first, routes
            torch.cuda.empty_cache()
            return out

        interval_first = interval_first_step(args.seed)
        prod, ref = bench_runs["production"][0], bench_runs["reference_contract"][0]
        checks = {
            "schema": [ln.get("metric") for ln in bench_runs["production"][1]] == [
                "train_rays_per_sec", "train_rays_per_sec_autodecoder", "train_rays_per_sec_ae"]
            and [ln.get("metric") for ln in bench_runs["reference_contract"][1]] == [
                "train_rays_per_sec"]
            and all(set(ln) == {"metric", "value", "unit", "vs_baseline"}
                    for ln in bench_runs["production"][1][:2] + bench_runs["reference_contract"][1]),
            "losses_finite_and_falling": all(
                all(math.isfinite(x) for x in r["dispatch_losses"])
                and r["dispatch_losses"][-1] < r["dispatch_losses"][0]
                for res in (prod, ref) for r in res.values()),
            "launches": (launches_are(bench_launches["production"], **bench_launches_want(prod))
                         and launches_are(bench_launches["reference_contract"],
                                          **bench_launches_want(ref))),
            "first_step_vs_plain": all(r["ok"] for r in interval_first.values()),
        }
        emit({"phase": "bench", "summary": {
                  label: {system: {k: r[k] for k in ("rays_per_s", "ms_per_step", "samples",
                                                     "tight", "rays_per_step", "microbatch")}
                          for system, r in bench_runs[label][0].items()}
                  for label in bench_runs},
              "first_step_interval_vs_plain": interval_first,
              "tol": {"loss_rel": TOL_STEP_LOSS,
                      "vanilla_grad_vs_plain_over_bf16_plain": TOL_INTERVAL_VS_BF16,
                      "autodecoder_cos_vs_plain": TOL_ART_STEP_COS},
              "checks": checks, "card": card})
        require(all(checks.values()), f"bench checks failed: {checks}")

        # ------------------------------------------------------------ sweep
        # the articulated kernels' training checks, the checks at the bench's
        # shapes and the bench's interval first step on further seeds of
        # weights, codes, rays and draws, untimed
        phase = "sweep"

        def sweep_line(seed, art, shapes, interval):
            """What one seed's checks read: per gradient check the two
            measures and the worst tensor, and the deformation's direction and
            size; the interval first step's errors and cosines."""
            grad_recs = {**{f"{k}/{m or 'cotangent'}/{n}": r for (k, m, n), r in art.items()
                            if k != "art_mlp_fwd"},
                         **{f"{k}/bench/{n}": r for (k, n), r in shapes.items()
                            if k != "resample_union"}}
            return {
                "phase": "sweep", "seed": seed,
                "grads": {name: {"max": r["max_abs_err"], "mean": r["mean_rel_err"],
                                 "worst_mean": r["worst"]["mean"],
                                 "ok": r["ok"],
                                 **({"deform_worst_mean": r["deform_worst"]["mean"],
                                     "deform_min_cos": r["deform_min_cos"],
                                     "deform_max_norm_off": r["deform_max_norm_off"]}
                                    if "deform" in r else {})}
                          for name, r in grad_recs.items()},
                "art_mlp_fwd_max_abs_err": max(r["max_abs_err"] for (k, *_), r in art.items()
                                               if k == "art_mlp_fwd"),
                "resample_max_abs_err": max(r["max_abs_err"] for (k, _), r in shapes.items()
                                            if k == "resample_union"),
                "interval": {
                    name: {r: {k: cmp[k] for k in ("loss_rel", "grad_max_rel", "grad_mean_rel",
                                                     "cos", "cos_by_code_table") if k in cmp}
                           for r, cmp in (("v3", rec), ("plain_bf16", rec["plain_bf16_vs_plain"]))}
                    for name, rec in interval.items()},
                "card": card}

        sweep, failed = [], []
        if args.seeds > 1:
            sweep.append(sweep_line(args.seed, art_train0, bench_shape_rows, interval_first))
        for seed in range(args.seed + 1, args.seed + args.seeds):
            art, shapes = (art_train_checks(seed, timed=False, strict=False),
                           bench_shape_checks(seed, timed=False, strict=False))
            interval = interval_first_step(seed)
            sweep.append(sweep_line(seed, art, shapes, interval))
            emit(sweep[-1])
            failed += [f"seed {seed}: {r['name']} {r.get('arguments', {}).get('mode', '')} "
                       f"{r['shape']}" for r in (*art.values(), *shapes.values())
                       if not r.get("ok", True)]
            failed += [f"seed {seed}: interval first step, {name}"
                       for name, r in interval.items() if not r["ok"]]
        if args.seeds > 1:
            summary = {}
            for check in sweep[0]["grads"]:
                recs = [ln["grads"][check] for ln in sweep]
                summary[check] = {"max": max(r["max"] for r in recs),
                                 "mean": max(r["mean"] for r in recs),
                                 "worst_mean_tensors": sorted({r["worst_mean"][0] for r in recs})}
                if "deform_min_cos" in recs[0]:
                    summary[check].update(
                        deform_min_cos=min(r["deform_min_cos"] for r in recs),
                        deform_max_norm_off=max(r["deform_max_norm_off"] for r in recs))
            cos_range = {
                f"{name}/{route}/{k}": [min(ln["interval"][name][route][group][k] for ln in sweep),
                                        max(ln["interval"][name][route][group][k] for ln in sweep)]
                for name in ("autodecoder",) for route in ("v3", "plain_bf16")
                for group in ("cos", "cos_by_code_table")
                for k in sweep[0]["interval"][name][route][group]}
            emit({"phase": "sweep", "seeds": [ln["seed"] for ln in sweep], "grads": summary,
                  "autodecoder_interval_cos_min_max": cos_range,
                  "tol": {"grad": [fused_art.GRAD_TOL_REL, fused_art.GRAD_TOL_MEAN_REL],
                          "deform": [fused_art.DEFORM_COS, fused_art.DEFORM_NORM],
                          "vanilla_grad": [GRAD_TOL_REL, GRAD_TOL_MEAN_REL],
                          "interval_cos": TOL_ART_STEP_COS,
                          "vanilla_interval_over_bf16_plain": TOL_INTERVAL_VS_BF16},
                  "failed": failed, "card": card})
            require(not failed, f"checks failed on further seeds: {failed}")

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
             "shape": fine["shape"], **{k: fine[k] for k in keys + eval_keys},
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
                                "plain_ms", "library_ms")}
                     for mode in ("autoencoder", "white_bkgd")]),
        ]

        def enc_entry(kname, replaces):
            big = enc_rows[kname, "render", N_COARSE + 1 + N_FINE]
            return {"name": kname, "route": "cuda",
                    "source": "aon_tpu_torch/ops/csrc/fused_mlp_eval.cu", "replaces": replaces,
                    "launches": api_launches[kname],
                    "launches_by_path": {"ops_api": api_launches[kname]},
                    "shape": big["shape"], **{k: big[k] for k in keys + eval_keys},
                    "coarse": {k: enc_rows[kname, "render", N_COARSE + 1][k]
                               for k in ("shape",) + keys},
                    "train": {k: enc_rows[kname, "train", N_COARSE + 1 + N_FINE][k]
                              for k in ("shape",) + keys}}

        geo_launches = {"fused_nerf_mlp_xyz": geo_recs["vanilla"]["launches"]["fused_nerf_mlp_xyz"],
                        "art_mlp_fwd": sum(r["launches"]["art_mlp_fwd"] for r in geo_recs.values())}
        entries += [
            enc_entry("fused_nerf_mlp", "aon_tpu/ops/fused_mlp.py:186"),
            dict(train_entry("fused_mlp_bwd", "aon_tpu/ops/fused_mlp_train.py:113"),
                 launches=api_launches["fused_mlp_bwd"],
                 launches_by_path={"ops_api": api_launches["fused_mlp_bwd"]}),
            enc_entry("fused_nerf_mlp_per_ray", "aon_tpu/ops/fused_mlp.py:197"),
            {"name": "fused_nerf_mlp_xyz", "route": "cuda",
             "source": "aon_tpu_torch/ops/csrc/fused_mlp_eval.cu",
             "entry": "aon_mlp_xyz_per_ray_launch",
             "replaces": "aon_tpu/ops/fused_mlp.py:223",
             "launches": geo_launches["fused_nerf_mlp_xyz"],
             "launches_by_path": {"geometry": geo_launches["fused_nerf_mlp_xyz"]},
             "shape": xyz_rec["shape"], **{k: xyz_rec[k] for k in keys + eval_keys}},
        ]
        # kernel 2 also serves the auto-decoder's paths
        entries[1]["launches"] += (art_path_launches["resample_union"]
                                   + art_train_launches["resample_union"])
        entries[1]["launches_by_path"].update(art_render=art_path_launches["resample_union"],
                                              art_train=art_train_launches["resample_union"])
        art_fwd = next(e for e in entries if e["name"] == "art_mlp_fwd")
        art_fwd["launches"] += geo_launches["art_mlp_fwd"]
        art_fwd["launches_by_path"]["geometry"] = geo_launches["art_mlp_fwd"]

        # the benchmark entry points: the kernel bench launches rows 1 and 4,
        # the bench rows 2, 3 and 9
        by_name = {e["name"]: e for e in entries}
        for kname, path, n in (
                ("fused_nerf_mlp_xyz_eval", "bench_kernels", bk_launches["fused_nerf_mlp_xyz_eval"]),
                ("fused_mlp_bwd_xyz", "bench_kernels", bk_launches["fused_mlp_bwd_xyz"]),
                *((k, "bench", sum(bench_launches[c][k] for c in bench_launches))
                  for k in ("resample_union", "fused_level_train_grads",
                            "fused_level_train_art_grads"))):
            e = by_name[kname]
            e.setdefault("launches_by_path", {"train": e["launches"]})
            e["launches"] += n
            e["launches_by_path"][path] = n
        # and their checks at the bench's shapes
        for kname in ("resample_union", "fused_level_train_grads", "fused_level_train_art_grads"):
            by_name[kname]["bench_shapes"] = [
                {k: r[k] for k in ("contract", "shape") + keys}
                for (n, _), r in bench_shape_rows.items() if n == kname]

        def variant_entry(kname):
            rec = variant_rows[kname]
            row12 = rec["row"] == 12
            return {"name": kname, "row": rec["row"], "variant": rec["variant"], "route": "cuda",
                    "source": "aon_tpu_torch/ops/csrc/fused_mlp_eval.cu",
                    "entry": "aon_mlp_body_launch" if row12 else "aon_mlp_xyz_body_launch",
                    "replaces": "scripts/bench_kernels.py:" + ("148" if row12 else "386"),
                    "launches": bk_launches[kname],
                    "launches_by_path": {"bench_kernels": bk_launches[kname]},
                    "shape": rec["shape"], **{k: rec[k] for k in keys + eval_keys}}

        entries += [variant_entry(k) for k in variant_rows]
        timed14 = row14["timed"][-1]  # at one extraction block
        entries.append({
            "name": "posenc_in_kernel", "row": 14, "route": "cuda",
            "source": "aon_tpu_torch/ops/csrc/fused_mlp_eval.cu", "entry": "aon_posenc_launch",
            "replaces": "tests_tpu/test_kernel_parity.py:62", "check_only": True,
            "launches": row14["launches"], "launches_by_path": {"posenc": row14["launches"]},
            "shape": timed14["shape"],
            "max_abs_err": max(e["err_twin"] for e in row14["encoders"].values()),
            **{k: timed14[k] for k in keys if k != "max_abs_err"},
            "check_shape": row14["timed"][0]})
        require(len(entries) == 18, "the kernels line lists kernel table rows 1-13 (rows 12 and "
                "13 by variant) and row 14's check")
        require(all(e["launches"] > 0 for e in entries), "a kernel of the path never launched")
        emit({"kernels": entries, "card": card})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception as exc:  # report the failing phase, then exit non-zero
        traceback.print_exc(file=sys.stderr)
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        return 1


if __name__ == "__main__":
    sys.exit(main())
