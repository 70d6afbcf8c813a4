#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--seeds K] [--profile] [--parent DIR]

Phases, each printed as one JSON line on stdout (nothing else goes there):

  device   the card (torch, and `nvidia-smi --query-gpu=name,power.limit`);
  build    nvcc builds every kernel of aon_tpu_torch/ops/csrc for sm_90a;
  prng     the threefry draws (aon_tpu_torch/ops/csrc/prng.cu): jax.random's
           values for key, split, fold_in, uniform and the per-ray rows
           (PRNG_GOLDEN, computed with JAX on a CPU), on the card and the
           CPU; then the kernel, per ray and flat, against core/prng.py's
           plain twin bit for bit at the training draws' shapes (vanilla
           2,048 x 17 / x 33, the auto-decoder 4,096 x 25 / x 49, the
           reference contract 61,440 x 65 / x 129), timed (host-clocked, and
           on the device with the calls queued behind a sleep kernel) beside
           the twin and its bound;
  kernel_times  rows 2 (both entries) and 14 (each encoder) at the paths'
           shapes by device time (torch.profiler, over 100 warm calls),
           host-clocked time (an event pair around one call, the median) and
           back-to-back time (100 calls between two events), and the kernels
           one sample_pdf_fused call launches (eval and randomized
           quantiles), for this tree and, with --parent DIR, for another
           checkout, each in a process of its own
           (aon_tpu_torch/scripts/kernel_times.py); fused_resample must
           launch one kernel a call, by its wrapper's count and the trace's;
  kernel   each kernel on the card at its paths' shapes (render: 61,440 rays
           x 65 and x 193 samples for the eval MLP from raw coordinates and
           from per-sample and per-ray encodings, a 61,440-ray resample with
           the one shared row of eval quantiles (both of kernel 2's entries:
           at the record's top level resample_union from a CDF against its
           twin; under its fused_resample key the main paths' entry, from the
           strided weights window with its CDF built in the kernel, against
           pdf_cdf_ordered + the twin, with the CDF order held to pdf_cdf's
           on the CDF itself); the fit phase's render: the eval MLP from raw
           coordinates at 61,440 x 17 and x 49 and the resample at 61,440 x
           (17 + 32) on per-ray intervals with the eval quantiles, checked
           and (the MLP) timed; the fit_art phase's render: the resample at
           61,440 x (25 + 48) the same way, checked; training: 2,048 rays x 65 and
           x 193 for the level, the MLP backward from raw coordinates and from
           encodings and the eval MLP with the bf16-rounded float32 packing of
           the v2 forward (and at x 193 from encodings, as fused_mlp_train's
           forward), and a 2,048-ray resample with per-ray sorted random
           quantiles; geometry: 512 x 128 grid points for the eval MLP of
           extract_geometry), held against its plain PyTorch twin on the same
           inputs, timed with CUDA events (median) beside the twin and a
           library yardstick (the same function as bf16 torch calls, under
           autograd for the training kernels) that the port never calls, and
           beside its bound on the H100; rows 2 and 14 with their
           host-clocked ``ms``, ``device_ms`` and ``events_ms`` from the
           kernel_times line at the same shape;
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
           and at one 65,536-point extraction block (each encoder's times
           from the kernel_times line);
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
           same rays, ray ids and keys;
  art_kernel  the three articulated kernels (forward, MLP backward, fused
           level) on configs/quality_laptop_autodec.json's MLP with seeded
           weights and codes, at their paths' shapes (forward: 61,440 rays x 65
           and x 193 of a render chunk, x 25 and x 73 on per-ray intervals of
           the fit_art phase's render chunk, and 2,048 x 65 / x 193 of the v2
           forward; backward and level: 2,048 x 65 and x 193 with t sampled as
           a step samples it; the level also with the auto-encoder's reference
           arguments and with a white background), each against its plain
           twin, timed beside the twin, the bf16 library chain and the bound;
           row 9 with the auto-encoder quality config's arguments (softplus
           sigma, density bias -1, opacity BCE 0.5, no rgb padding) on the
           auto-encoder's weights and encoding, at 2,048 x 65 / x 193 and at
           the fit_ae path's 2,048 x 25 / x 73 on per-ray intervals, inputs
           from a generator of its own; then rows 3,
           2 and 9 at the bench's shapes: the first 2,048 rays of each bench
           batch, t stratified in their per-ray intervals and then resampled
           (vanilla 17 and 49 samples on occupancy intervals, the auto-decoder
           25 and 73 on AABB intervals); then the occ8 config's shapes
           (configs/quality_laptop_vanilla_refsched_occ8.json, 8 + 16
           samples): rows 3 and 2 the same way at 2,048 x 9, 16 fine draws
           and x 25 on the bench's occupancy intervals with a white
           background, and row 1 at 61,440 x 9 and x 25 on occupancy
           intervals, each against its twin and timed;
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
  fit      the CLI's main path (aon_tpu_torch.run.main -> Trainer.fit, validate,
           test) on configs/quality_laptop_vanilla_refsched_occ16.json over a
           640x480 SAPIEN-layout fixture with depth that the port's
           make_fixture_dataset writes (6 train, 2 val, 2 test frames),
           overriding only root_dir, run_max_steps, num_epochs,
           limit_val_batches and output_path: the train loader's seconds cold
           and from the occupancy-interval cache, 400 steps of 2,048 rays on
           occupancy intervals (16 + 32 samples) through train_many in
           dispatches of 8 and one 640x480 validation (rays/s and ms per step
           over each epoch, host included; exact launches of rows 3, 2 and 1;
           the loss of the run's first batch with fixed draws falling from
           the initial weights to the fitted ones), the device's idle share
           over four dispatches of the same loop under torch.profiler, a
           resume from last.ckpt for 16 more steps (the fitted weights
           restored bit for bit, the step count continuing, a fresh ray
           stream, the val PSNR held), --run_eval --render_name smoke (results.json, the jpgs
           decoded by utils/imageio.py) and extract_geometry at 160^3 with the
           dataset's bounds (63 launches of row 8); and whether PIL imports;
  fit_art  the same CLI for the auto-decoder on
           configs/quality_laptop_autodec_24k_aabb24.json (24 + 48 samples on
           AABB intervals, 4,096 rays a step as two microbatches of 2,048) over
           a 320x240 --multi fixture (2 instances x 10 degrees x 3 train
           frames, one instance with a test_spheric split), overriding only
           root_dir, output_path, run_max_steps, samples_per_epoch and
           num_epochs: the articulated loader's scene AABB cold and cached,
           its frames decoded cold and from the frame cache, a 4,096-ray item;
           400 steps in dispatches of 8 and one validation of five frames
           (rays/s, ms per step, exact launches of rows 9, 2 and 10, the fixed
           batch's loss falling, val PSNR above the initial weights'), the
           idle share over four dispatches, a resume of 16 steps (the weights
           restored bit for bit), --run_eval (the 19-frame sweep, its jpgs
           and video), render_sweep (19 codes under one camera),
           eval_per_instance (per_instance.json) and extract_geometry with
           the dataset's bounds (63 launches of row 10), each with its exact
           launches;
  fit_art_objover  the same CLI on the same fixture with
           configs/quality_scissors_autodec_objover.json's arguments (64 + 128
           samples on raw intervals, obj_ray_oversample 0.5, so row 9 takes
           per-ray loss_w, a black background) and laptop4's
           art_code_smoothness 0.001: 400 steps in dispatches of 8 and one
           validation of five frames (rays/s, exact launches of rows 9, 2 and
           10, loss_w in the items, the fixed batch's loss falling, val PSNR
           above the initial weights'), checked as fit_art's line;
  fit_ae   the same CLI for the auto-encoder on
           configs/quality_laptop_ae_aabb24.json (a ResNet-34 encoder on
           320x240 source frames, 24 + 48 samples on AABB intervals, 4,096
           rays a step as two microbatches, softplus sigma, opacity BCE 0.5)
           over the fit_art fixture, overriding only root_dir, output_path,
           run_max_steps, samples_per_epoch and num_epochs: 240 steps in
           dispatches of 8 and one validation of five frames with the
           joint-state metrics (rays/s, ms per step, exact launches of rows 9,
           2 and 10, the loss and the joint-state loss over the run's first
           eight batches falling, val PSNR above the initial weights'), the
           encoder's forward and backward ms per microbatch (cuDNN, apart from
           the step), the idle share over four dispatches, a resume of 16 steps
           (every weight restored bit for bit, the encoder's included),
           --run_eval (19 frames, each encoding its own image) and
           extract_geometry with the dataset's bounds, each with its exact
           launches;
  fit_ae_raw  the auto-encoder's own config, configs/quality_laptop_ae.json
           (64 + 128 samples on raw intervals, relu sigma, 4,096 rays a step),
           through the same CLI on fit_ae's fixture, overriding only
           root_dir, output_path, run_max_steps, samples_per_epoch and
           num_epochs: FIT_AE_RAW_STEPS steps and one validation (rays/s,
           exact launches of rows 9, 2 and 10, the loss and the joint-state
           loss over the run's first eight batches falling as fit_ae's, val
           PSNR and the joint-state metrics finite);
  lpips    VGG16-LPIPS (aon_tpu_torch/eval/lpips.py) of two 640x480 frames on
           the card, on synthetic weights that the port's
           make_synthetic_lpips_weights writes under build/ at the start of
           the fit phase (every --run_eval from there on reports LPIPS beside
           "lpips_weights": "synthetic"), against the same module on the CPU
           in float32, and its ms per frame pair; then
           configs/lpips_synth_demo.json through the CLI (fit, --run_eval) on
           a fixture of the port's script, LPIPS in its results.json;
  optim    the optimizer factories: radam with a cosine schedule and a
           one-epoch warmup, 8 updates of the vanilla MLPs' tensors on the
           card against the CPU, then a 200-step CLI fit with them on a
           320x240 fixture (the loss falling, rows 3 and 2 launched);
  dp       data parallelism (aon_tpu_torch/parallel/): the vanilla and the
           auto-encoder quality configs' full step at their batch and samples
           (multihost_train_demo), one step compared and a few timed under
           torch.profiler, on one rank over NCCL and on two ranks of the card
           over gloo (NCCL takes one rank a device), each rank a process of
           its own, against one process: loss, parameters, ms per step and
           each rank's idle share; and a 640x480 frame rendered by each
           rank's block and gathered (multihost_eval_demo) against one
           process's;
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
           samples on occupancy intervals, the auto-decoder and the
           auto-encoder 4,096 at 24 + 48 on AABB intervals) and at
           --reference_contract --headline_only:
           its lines, rays/s and ms per step, exact launches, the loss of the
           repeated batch falling, and the first step of the interval path on
           one 2,048-ray microbatch of each bench batch against the plain
           float32 route, beside the plain route in bf16 against float32 (what
           bf16 rounding alone does to the same gradients);
  scripts  the port's last scripts through their main() on the card:
           bench_eval's reference contract (640x480 seeded rays, 64 + 128
           samples, chunks 30,720 / 61,440 / 153,600 / 307,200; frame ms and
           peak device memory, exact launches of rows 1 and 2) and its
           production mode on configs/quality_laptop_vanilla_refsched_occ16.json
           over a fixture like the fit phase's; bench_art at --fused v3 (rows
           9, 2) and v2 (rows 10, 11, 2); profile_ae_host (--dispatches 3) and
           roofline_ae (its default contract) on configs/quality_laptop_ae_aabb24.json
           over a fixture like the fit_ae phase's; demo_sphere at 120x160 on
           the card against the CPU under the same draws; analyze_gt_ceiling on
           a lo/hi pair the phase writes; visualize_cameras on the fit fixture;
           one line each, with the card, and the phase's launches by kernel;
  kernels  every kernel of the paths with its launches, error, times and bound
           (rows 1-13, rows 12 and 13 by variant, row 14's check, and the
           threefry draws with their launches on every training path);

with --seeds K > 1, a ``sweep`` line for each further seed and one that sums
them up: the articulated kernels' training checks, the checks at the bench's
shapes and at the occ8 config's and the bench's interval first step, untimed, on the weights and
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
import dataclasses
import importlib.util
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
# the threefry draws: 32-bit integer operations, at the CUDA cores' float32
# rate (the data sheet gives no integer rate; the card's int32 lanes are no
# faster, so this bound is a floor): a threefry-2x32 block is 20 rounds of an
# add, a rotate and a xor plus 14 of its key schedule, a uniform 4 more
PEAK_INT32_OPS = PEAK_F32_FLOPS
THREEFRY_OPS, UNIT_OPS = 74, 4
# (rays, uniforms a ray) of the training draws: the vanilla and auto-decoder
# quality configs' coarse and fine draws, and the reference contract's
PRNG_SHAPES = ((2048, 17), (2048, 33), (4096, 25), (4096, 49), (61440, 65), (61440, 129))
# jax.random on JAX 0.9 (jax_threefry_partitionable on), computed on a CPU
# with JAX (the card's machine has none): key words, and uniforms as float32 bits
PRNG_GOLDEN = {
    "fold_in(key(0), 2**31)": [917456828, 636652529],
    "fold_in(key(7), 12345)": [3187294848, 248916179],
    "split(key(1), 3)": [[507451445, 1853169794], [1948878966, 4237131848],
                         [2441914641, 3819641963]],
    "uniform(key(0), (4,))": [1064475214, 1064993846, 1051337244, 1055913296],
    "uniform(fold_in(key(42), 7), (2, 3))": [1058870020, 1056835660, 1057982622, 1058968326,
                                             1057282088, 1057256636],
    "per_ray(key(0), [0, 2**31-1], 2)": [1062707686, 1044038008, 1063849462, 1060252750],
}

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
# the fused entry's CDF order (pdf_cdf_ordered, the kernel's) against
# pdf_cdf's, on the CDF itself: the same float32 steps, the 63-term sums in
# another order, a few ulps of values in [0, 1].  The samples are not held to
# pdf_cdf's: where a bin's mass is tiny the inverse CDF magnifies an ulp of
# the CDF up to the bin's width (the records carry that distance, and the same
# distance between pdf_cdf taken on the host and on the card)
TOL_CDF_ORDER = 1e-6
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
# ray ids and keys only the atomicAdd order of the kernels differs;
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
# ---- the fit phase: aon_tpu_torch.run.main on the occupancy-interval quality
# config over a 640x480 fixture (aon_tpu_torch/scripts/make_fixture_dataset.py)
FIT_CONFIG = "configs/quality_laptop_vanilla_refsched_occ16.json"
FIT_COARSE, FIT_FINE = 16, 32  # FIT_CONFIG's N_samples and N_importance
FIT_VIEWS = 6  # train frames; the fixture writes 2 val and 2 test frames
FIT_STEPS, FIT_RESUME_STEPS = 400, 16  # whole dispatches of the config's 8 steps
# val PSNR after the resumed dispatches against the first run's.  The resumed
# steps run at the end of the 416-step lr horizon (lr ~1.3e-6): seen 8.7427 ->
# 8.7351 dB on an H100, where the run's initial weights render 4.28 dB.
# Whether the resume restored the trained weights at all is held bit for bit
# (the fit record's resume_restores_params)
TOL_RESUME_PSNR_DROP = 0.1
# the loss of one fixed batch with fixed draws (the run's first batch) under
# the fitted weights against under the run's initial weights: seen 0.628 ->
# 0.148 (0.237) on an H100.  The 400 steps run at the start of the 2,500-step
# lr delay, on an lr horizon of 400 steps
FIT_LOSS_FALL = 0.5
FIT_PROFILE_DISPATCHES = 4  # dispatches of the fit loop under torch.profiler

# ---- the fit_art phase: the same CLI on the auto-decoder's quality config
# over a 320x240 --multi fixture (2 instances x 10 degrees x FIT_ART_VIEWS)
FIT_ART_CONFIG = "configs/quality_laptop_autodec_24k_aabb24.json"
FIT_ART_COARSE, FIT_ART_FINE = 24, 48  # FIT_ART_CONFIG's N_samples and N_importance
FIT_ART_VIEWS = 3  # train frames per degree directory
FIT_ART_STEPS, FIT_ART_RESUME_STEPS = 400, 16  # whole dispatches of 8 steps
# the loss of the run's first batch with fixed draws, fitted against initial
# weights (the fit phase's measure); the 400 steps run at the start of the
# 2,500-step lr delay on a 400-step horizon
FIT_ART_LOSS_FALL = 0.8
# ---- and the scissors objover config's arguments on the same fixture: 64 +
# 128 samples on raw intervals, obj_ray_oversample 0.5 (per-ray loss_w into
# row 9), a black background, with laptop4's art_code_smoothness; fit_art's
# run length (its lr horizon its own), its loss held as fit_art's (on an H100
# the fixed batch's loss fell to 0.92 of its start in 240 steps, 0.43 in 400)
FIT_OBJOVER_CONFIG = "configs/quality_scissors_autodec_objover.json"
FIT_OBJOVER_SMOOTHNESS = 0.001  # configs/quality_laptop4_autodec.json's
FIT_OBJOVER_STEPS = 400

# ---- the fit_ae phase: the same CLI on the auto-encoder's quality config
# over the fit_art phase's fixture
FIT_AE_CONFIG = "configs/quality_laptop_ae_aabb24.json"
FIT_AE_COARSE, FIT_AE_FINE = 24, 48  # FIT_AE_CONFIG's N_samples and N_importance
# whole dispatches of 8 steps; fewer than the other fits', as an AE step
# takes ~4x an auto-decoder step (host-bound: PERF.md section 5)
FIT_AE_STEPS, FIT_AE_RESUME_STEPS = 240, 16
# the loss and the joint-state loss over the run's first dispatch of batches
# with fixed draws, fitted against initial weights; the steps run at the
# start of the 2,500-step lr delay on a horizon of their own count, where the
# opacity BCE sits near its all-background plateau: seen 1.355 -> 0.976
# (0.72) after 400 steps on an H100, the joint-state part 0.282 -> 0.003
FIT_AE_LOSS_FALL = 0.95
ENCODER_REPS = 10  # timed encoder forward / backward passes
# ---- the fit_ae_raw phase: the auto-encoder's own config (64 + 128 samples
# on raw intervals, relu sigma) through the same CLI on fit_ae's fixture, cut
# only in depth (its lr horizon its own step count), its fixed batches' loss
# held as fit_ae's
FIT_AE_RAW_CONFIG = "configs/quality_laptop_ae.json"
FIT_AE_RAW_STEPS = 240

# ---- the occ8 vanilla config (8 + 16 samples on occupancy intervals: 9 and
# 25 a ray, which no other path gives rows 1, 2 and 3): its level checks on the
# bench's occupancy intervals, row 1 at the render chunk
OCC8_CONFIG = "configs/quality_laptop_vanilla_refsched_occ8.json"

# ---- the lpips, optim and dp phases: each draws from a generator of its own
LPIPS_WH = (640, 480)
# VGG16-LPIPS on the card against the same module on the CPU, both float32
# with TF32 off: the convolutions' sums run in another order (relative)
TOL_LPIPS_REL = 1e-4
LPIPS_REPS = 10
LPIPS_DEMO_CONFIG = "configs/lpips_synth_demo.json"
# radam + cosine + warmup on the card against the CPU, OPTIM_STEPS updates
# (the rectification starts at the sixth): an ulp of the tree's largest entry
# a step, where the card divides by a scalar through its reciprocal
OPTIM_STEPS = 8
OPTIM_FIT_STEPS = 200  # a CLI fit with that optimizer on a 320x240 fixture
# the mean logged loss of the fit's last five logs against its first five's
OPTIM_FIT_LOSS_FALL = 0.9
# the data-parallel step: FIT_CONFIG's and FIT_AE_CONFIG's batch and samples,
# one step compared and DP_TIMED_STEPS timed, on one rank over NCCL and on two
# ranks of the one card over gloo (NCCL takes one rank a device), against one
# process.  The loss is a mean over the rays in another order (relative);
# an Adam first step moves an entry by ~lr * sign(g), so an entry whose
# gradient lies within the noise of zero may go either way: each parameter
# difference is held to 2 lr plus two ulps of the entry (seen on the CPU: 2 lr
# + 0.14%), the mean to DP_PARAMS_MEAN_LR lr
# (one rank's rays alone, without the all-reduce, flip a large share)
TOL_DP_LOSS = 1e-4
DP_PARAMS_MEAN_LR = 0.05
DP_TIMED_STEPS = {"vanilla": 8, "ae": 2}
TOL_DP_FRAME = 1e-5  # the same kernels on the same rays: bit-identical expected
DP_TIMEOUT = 600  # seconds, each rank's process

# the kernel's occupancy against its twin's: voxels whose sigma lies within
# the kernel / twin noise of the threshold may flip; at most this share of
# the grid's voxels may
TOL_OCC_SHARE = 1e-4
# the scripts phase's analytic sphere, card against CPU on the same draws: one
# 8-bit level (a float32 value that rounds on either side of a level), but
# for a share of pixels: the sphere's surface is a step in density, and a
# sample within the two devices' rounding of |p| = 1 lies inside on one and
# outside on the other (and the fine samples follow the coarse weights)
TOL_SPHERE_LEVELS = 1
TOL_SPHERE_OFF_SHARE = 0.005
SCRIPTS_AE_DISPATCHES = 3  # profile_ae_host's timed dispatches in the scripts phase


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


def level_forward_check(torch, got, twin, t_vals, rays_d, target, *, white_bkgd, tol_raw,
                        tol_forward, loss_w=None, sigma_act="relu", density_bias=0.0,
                        rgb_padding=0.0, zeroed=None) -> dict:
    """A training level's forward, held in parts that leave no entry out.

    1. The kernel's raw outputs (``raw_rgb`` (B, S, 3), ``raw_sigma`` (B, S))
       against the twin's, at ``tol_raw`` (max, mean of the absolute error),
       the forward kernels' tolerance.  With ``zeroed`` (the kernel's and the
       twin's raw outputs of the same launch with the deformation's output
       layer zeroed) the max is held there and the mean on both launches:
       a live deformation's phase noise moves single raw outputs of the
       articulated level past the max (the encoding multiplies x' by up to
       2^9), as it moves its gradients, which are held by direction.
    2. The kernel's compositing ``weights`` (B, S), ``acc`` (B,) where it
       returns one and ``loss`` against the port's plain float32 compositing
       (``core/rendering.py::volumetric_rendering``) of the kernel's own raw
       outputs, through the level's sigma activation (``relu`` or
       ``softplus_bias``) and rgb padding, at ``tol_forward`` (the loss
       relative).  ``loss`` is the vanilla level's sum of squared errors or,
       with ``loss_w`` (B,), the articulated level's sum_r loss_w_r |err_r|^2.
    3. With ``zeroed``, the live launch's forward against the twin's through
       a map with no jump, at ``tol_forward``: with ``softplus_bias`` (sigma
       > 0 everywhere) its weights, acc and loss; with ``relu`` its outputs
       after the activations (rgb after the sigmoid and padding, sigma after
       the relu).

    The weights are not held to the twin's where sigma may be 0: on the 1e10
    last interval a relu compositing jumps at raw sigma = 0, where two bf16
    summation orders may land on either side and move one weight by the
    ray's transmittance.  ``got`` holds the kernel's outputs, ``twin`` the
    twin's (raw outputs, and with ``zeroed`` its weights, acc and loss).
    Returns the record's fields, with ``ok``."""
    from aon_tpu_torch.core.rendering import volumetric_rendering

    def raw_errors(k, t):
        return torch.cat([(k["raw_rgb"] - t["raw_rgb"]).abs().reshape(-1),
                          (k["raw_sigma"] - t["raw_sigma"]).abs().reshape(-1)])

    def activated(out):
        raw_sigma = out["raw_sigma"].float()
        if sigma_act == "softplus_bias":
            sigma = torch.nn.functional.softplus(raw_sigma + density_bias)
        elif sigma_act == "relu":
            sigma = torch.clamp_min(raw_sigma, 0.0)
        else:
            raise ValueError(f"unknown sigma_act: {sigma_act}")
        return (torch.sigmoid(out["raw_rgb"].float()) * (1.0 + 2.0 * rgb_padding) - rgb_padding,
                sigma)

    def loss_rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    live = raw_errors(got, twin)
    held = live if zeroed is None else raw_errors(*zeroed)
    rgb, sigma = activated(got)
    comp, acc, weights, _ = volumetric_rendering(rgb, sigma[..., None], t_vals, rays_d,
                                                 white_bkgd)
    sq_err = ((comp - target) ** 2).sum(dim=-1)
    loss = sq_err.sum() if loss_w is None else (sq_err * loss_w.reshape(-1)).sum()
    rec = {
        "raw_max_abs_err": held.max().item(), "raw_mean_abs_err": live.mean().item(),
        "tol_raw": list(tol_raw),
        "weights_max_abs_err": (got["weights"] - weights).abs().max().item(),
        "loss_rel_err": loss_rel(got["loss"], loss),
        "tol_forward": tol_forward,
        "forward_is": ("raw outputs against the twin's; weights, acc and loss against the "
                       "plain compositing of the kernel's raw outputs"),
    }
    fwd = [rec["weights_max_abs_err"], rec["loss_rel_err"]]
    if "acc" in got:
        rec.update(acc_max_abs_err=(got["acc"] - acc).abs().max().item(),
                   acc_mean=acc.mean().item())
        fwd.append(rec["acc_max_abs_err"])
    if zeroed is not None:
        if sigma_act == "softplus_bias":
            live_is = "weights, acc and loss against the twin's"
            live_fwd = [(got["weights"] - twin["weights"]).abs().max().item(),
                        (got["acc"] - twin["acc"]).abs().max().item(),
                        loss_rel(got["loss"], twin["loss"])]
        else:
            live_is = "rgb and sigma after the activations against the twin's"
            rgb_t, sigma_t = activated(twin)
            live_fwd = [(rgb - rgb_t).abs().max().item(), (sigma - sigma_t).abs().max().item()]
        rec.update(raw_max_is="deform_out zeroed", raw_zeroed_mean_abs_err=held.mean().item(),
                   raw_live_max_abs_err=live.max().item(), live_forward_is=live_is,
                   live_forward_max_err=max(live_fwd))
        fwd.append(rec["live_forward_max_err"])
    finite = all(bool(torch.isfinite(got[k]).all()) for k in ("raw_rgb", "raw_sigma", "weights"))
    rec["ok"] = (finite and rec["raw_max_abs_err"] <= tol_raw[0]
                 and rec["raw_mean_abs_err"] <= tol_raw[1]
                 and (zeroed is None or rec["raw_zeroed_mean_abs_err"] <= tol_raw[1])
                 and max(fwd) <= tol_forward)
    return rec


def config_contract(config, batch_seed: int = 0) -> tuple:
    """A vanilla quality config's level checks as an entry of
    BENCH_CONTRACTS: (system, rays a step, interval kind, _synthetic_batch
    seed, samples of each level)."""
    c = json.loads((ROOT / config).read_text())
    kind = "occ" if c.get("use_occgrid") else "aabb" if c.get("use_aabb") else None
    return ("vanilla", c["batch_size"], kind, batch_seed, (c["N_samples"], c["N_importance"]))


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


def queued_ms(torch, fn, reps: int = 50) -> float:
    """Device milliseconds a call of ``fn``: ``reps`` calls queued behind a
    sleep kernel (``torch.cuda._sleep``), so the card runs them back to back
    and the host's launch time hides behind the queue."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # tens of ms: longer than enqueuing the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def as_window(weights):
    """(B, n) weights as the window ``w[:, 1:-1]`` of a (B, n + 2) array,
    the strided view the render and training paths pass to the resample."""
    buf = weights.new_zeros(weights.shape[0], weights.shape[1] + 2)
    buf[:, 1:-1] = weights
    return buf[:, 1:-1]


def prng_golden_failures(torch, prng, device) -> list:
    """The PRNG_GOLDEN entries that the port's keys, the kernel's draws on
    ``device`` or the plain draws on the CPU miss."""
    bits = lambda t: t.cpu().reshape(-1).view(torch.int32).tolist()  # noqa: E731
    u32 = lambda vals: [v - (1 << 32) if v >= 1 << 31 else v for v in vals]  # noqa: E731
    k0 = prng.key(0)
    ids = torch.tensor([0, 2**31 - 1], device=device)
    got = {
        "fold_in(key(0), 2**31)": prng.fold_in(k0, 2**31).tolist(),
        "fold_in(key(7), 12345)": prng.fold_in(prng.key(7), 12345).tolist(),
        "split(key(1), 3)": prng.split(prng.key(1), 3).tolist(),
    }
    for where in (device, "cpu"):
        got[f"uniform(key(0), (4,)) on {where}"] = bits(prng.uniform(k0, (4,), device=where))
        got[f"uniform(fold_in(key(42), 7), (2, 3)) on {where}"] = bits(
            prng.uniform(prng.fold_in(prng.key(42), 7), (2, 3), device=where))
        got[f"per_ray(key(0), [0, 2**31-1], 2) on {where}"] = bits(
            prng.per_ray_uniform(k0, ids.to(where), 2))
    want = {name: (u32(v) if name.startswith(("uniform", "per_ray")) else v)
            for name, v in PRNG_GOLDEN.items()}
    return [name for name, v in got.items() if v != want[name.split(" on ")[0]]]


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
        from aon_tpu_torch import run as port_run
        from aon_tpu_torch.core import prng
        from aon_tpu_torch.models.init import seeded_params
        from aon_tpu_torch.ops.prng import threefry_uniform
        from aon_tpu_torch.core.rays import create_spheric_poses, get_ray_directions, get_rays
        from aon_tpu_torch.core.sampling import eval_quantiles, pdf_cdf, sample_along_rays
        from aon_tpu_torch.data.aabb import scene_aabb
        from aon_tpu_torch.data.analytic import analytic_scene
        from aon_tpu_torch.data.sapien import SapienDataset
        from aon_tpu_torch.data.sapien_multi import SapienDatasetMulti
        from aon_tpu_torch.eval import metrics as eval_metrics
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
        from aon_tpu_torch.scripts import (
            eval_per_instance,
            extract_geometry,
            kernel_times,
            level_split,
            make_fixture_dataset,
            make_synthetic_lpips_weights,
            multihost_eval_demo,
            multihost_train_demo,
            render_sweep,
        )
        from aon_tpu_torch.train.checkpoint import CheckpointManager
        from aon_tpu_torch.ops.render_fused import mlp_params
        from aon_tpu_torch.ops.resample import (
            fused_resample,
            pdf_cdf_ordered,
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
        from aon_tpu_torch.parallel.mesh import stack_step_batches
        from aon_tpu_torch.train.microbatch import accumulated_grads
        from aon_tpu_torch.train.trainer import inject_ramps
        from aon_tpu_torch.train.systems import (
            ART_TABLE,
            AutoDecoderSystem,
            VanillaSystem,
            build_system,
        )
        from aon_tpu_torch.utils.config import Config, get_config
        from aon_tpu_torch.utils.imageio import read_jpeg

        # what the ``kernels`` line carries of every kernel's record
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        # and of rows 2 and 14, the device's own time beside the host-clocked
        # ``ms`` (aon_tpu_torch/scripts/kernel_times.py)
        device_keys = ("device_ms", "events_ms")
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

        # the threefry draws: golden values of jax.random, and the kernel
        # against its plain twin bit for bit at the training draws' shapes
        phase = "prng"
        golden_missed = prng_golden_failures(torch, prng, dev)
        prng_rows = []
        for n_rays, n in PRNG_SHAPES:
            ids = torch.randint(0, 2**31 - 1, (n_rays,), device=dev, generator=torch.Generator(
                device=dev).manual_seed(args.seed + n_rays + n))
            key = prng.fold_in(prng.key(args.seed), n_rays * 1000 + n)
            got, flat = prng.per_ray_uniform(key, ids, n), prng.uniform(key, (n_rays, n), device=dev)
            want = prng.per_ray_uniform_plain(key, ids, n)
            flat_want = prng.uniform_plain(key, (n_rays, n), device=dev)
            ops = n_rays * THREEFRY_OPS + n_rays * n * (THREEFRY_OPS + UNIT_OPS)
            nbytes = n_rays * 8 + n_rays * n * 4  # the ids in, the uniforms out
            prng_rows.append({
                "shape": [n_rays, n], "bit_equal": bool(torch.equal(got, want)),
                "flat_bit_equal": bool(torch.equal(flat, flat_want)),
                "max_abs_err": max((got - want).abs().max().item(),
                                   (flat - flat_want).abs().max().item()),
                "ms": time_ms(torch, lambda: prng.per_ray_uniform(key, ids, n), 20),
                "device_ms": queued_ms(torch, lambda: prng.per_ray_uniform(key, ids, n)),
                "flat_ms": time_ms(torch, lambda: prng.uniform(key, (n_rays, n), device=dev), 20),
                "flat_device_ms": queued_ms(
                    torch, lambda: prng.uniform(key, (n_rays, n), device=dev)),
                "plain_ms": time_ms(torch, lambda: prng.per_ray_uniform_plain(key, ids, n), 5),
                "bound_ms": 1e3 * max(ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES),
                "bound_by": "operations" if ops / PEAK_INT32_OPS >= nbytes / PEAK_BYTES
                            else "bytes",
                "library_ms": None})  # no PyTorch call computes threefry
        emit({"phase": "prng", "golden": len(PRNG_GOLDEN), "golden_missed": golden_missed,
              "rows": prng_rows, "int32_ops_rate": PEAK_INT32_OPS, "card": card})
        require(not golden_missed, f"threefry golden values missed: {golden_missed}")
        require(all(r["bit_equal"] and r["flat_bit_equal"] for r in prng_rows),
                "the threefry kernel is not its plain twin bit for bit")

        # rows 2 and 14 by device time at the paths' shapes, and the kernels
        # one sample_pdf_fused call launches, for this tree and (--parent)
        # another, each in a fresh process: after many profiler sessions in
        # one process the card's trace can come back empty
        # (aon_tpu_torch/scripts/kernel_times.py).  The kernel records of
        # rows 2 and 14 take their ``ms``, ``device_ms`` and ``events_ms``
        # from this tree's run.
        phase = "kernel_times"

        def kernel_times_of(root):
            proc = subprocess.run(
                [sys.executable, str(ROOT / "aon_tpu_torch" / "scripts" / "kernel_times.py"),
                 "--root", str(root)], capture_output=True, text=True, timeout=600)
            require(proc.returncode == 0, f"kernel_times of {root} failed: {proc.stderr[-2000:]}")
            return json.loads(proc.stdout.strip().splitlines()[-1])

        times = {"phase": "kernel_times", "tree": kernel_times_of(ROOT), "card": card}
        if args.parent:
            times["parent"] = kernel_times_of(Path(args.parent).resolve())
        emit(times)
        kt_tree = times["tree"]

        def kt_times(entry, shape, encoder=None):
            """``ms``, ``device_ms``, ``events_ms`` and the launches per call
            of one entry at one shape, from this tree's kernel_times run."""
            found = [r for r in kt_tree[entry]
                     if r["shape"] == shape and r.get("encoder") == encoder]
            require(len(found) == 1, f"kernel_times has no one {entry} record at {shape}")
            return {k: found[0][k] for k in ("ms", "device_ms", "events_ms", "launches_per_call")}

        # fused_resample is one launch a call: its wrapper counts one, and
        # the trace holds no kernel or copy beside the resample's
        t_one = kernel_times.resample_inputs(
            torch, TRAIN_RAYS, N_COARSE + 1, N_FINE, False,
            torch.Generator(device=dev).manual_seed(args.seed))
        n0 = resample_union.launches
        fused_resample(*t_one)
        require(resample_union.launches - n0 == 1
                and all(e["launches_per_call"] == 1 for e in kt_tree["fused_resample"]),
                "fused_resample launched more than its one kernel")
        del t_one

        # ---------------------------------------------------------- kernels
        phase = "kernel:fused_nerf_mlp_xyz_eval"
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cfg = get_config(["--config", str(ROOT / CONFIG)])
        system = build_system(cfg, 2.0, 6.0, cfg.white_back, device=dev)
        params = seeded_params(system, gen)
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
                        kw=None, art=False, forward=None, timed=True, strict=True, **extra):
            """One ``kernel`` line of a training kernel (a level or an MLP
            backward) against its twin on the same inputs, checked (unless
            ``strict`` is off: then its ``ok`` says): every gradient tensor by
            the max and mean measures (the articulated kernels' deformation
            gradients by direction and size instead), and a level's forward
            by ``level_forward_check`` (its raw outputs against the twin's,
            its weights, acc and loss against the plain compositing of its
            own raw outputs, an articulated level's live forward against
            the twin's); timed beside the twin, the library yardstick
            and the bound unless ``timed`` is off.  A level gives
            ``forward``, the check's inputs: ``t_vals``, ``rays_d``,
            ``target`` and, for the vanilla level, ``white_bkgd`` or, for
            the articulated one, ``loss_w`` (its other arguments are in
            ``kw``); its packed weights come first in ``fn_args``."""
            kw = kw or {}
            level = forward is not None
            raws, raws_p = {}, {}
            got = fn(*fn_args, **kw, **({"raws": raws} if level else {}))
            torch.cuda.synchronize()
            want = fn_plain(*fn_args, **kw, **({"raws": raws_p} if level else {}))
            again = fn(*fn_args, **kw)
            grads, grads_p, grads2 = (got, want, again) if isinstance(got, dict) else (
                got[-1], want[-1], again[-1])
            rec = {"phase": "kernel", "name": kname, **extra, "shape": shape, "rows": rows}
            fwd_ok = True
            if level:  # (loss, weights, [acc,] grads)
                out, twin = (dict(r, loss=o[0], weights=o[1], **({"acc": o[2]} if art else {}))
                             for r, o in ((raws, got), (raws_p, want)))
                tol_raw = ((fused_art.TWIN_TOL_MAX, fused_art.TWIN_TOL_MEAN) if art
                           else (TWIN_TOL_MAX, TWIN_TOL_MEAN))
                zeroed, art_kw = None, {}
                if art:  # the same launch with the deformation's output layer zeroed
                    packed = fn_args[0]
                    still = dict(packed, wdo=torch.zeros_like(packed["wdo"]),
                                 bdo=torch.zeros_like(packed["bdo"]))
                    zeroed = ({}, {})
                    fn(still, *fn_args[1:], **kw, raws=zeroed[0])
                    fn_plain(still, *fn_args[1:], **kw, raws=zeroed[1])
                    art_kw = {k: kw[k] for k in ("white_bkgd", "sigma_act", "density_bias",
                                                 "rgb_padding")}
                check = level_forward_check(torch, out, twin, **forward, **art_kw,
                                            tol_raw=tol_raw, tol_forward=tol_raw[0],
                                            zeroed=zeroed)
                fwd_ok = check.pop("ok")
                rec.update(check)
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

        # row 1 also at the fit phase's render shapes (FIT_CONFIG's 16 + 32
        # samples); rows 5 and 7 at the render path's only
        mlp_rows, enc_rows = {}, {}
        for n_samples in (N_COARSE + 1, N_COARSE + 1 + N_FINE,
                          FIT_COARSE + 1, FIT_COARSE + 1 + FIT_FINE):
            _, samples = sample_along_rays(origins, dirs, n_samples - 1, 2.0, 6.0)
            samples = samples.contiguous()
            mlp_rows[n_samples] = mlp_eval_record(packed, samples, dirs)
            if n_samples in (N_COARSE + 1, N_COARSE + 1 + N_FINE):
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
            # host-clocked ``ms``, ``device_ms`` and ``events_ms`` of each
            # encoder from the kernel_times line; the top-level times are the
            # elementwise encoder's, the trunk's own
            by_encoder = {encoder: kt_times("posenc", f"{n}x64", encoder)
                          for encoder in ENCODERS}
            row14["timed"].append({
                "shape": f"{n}x64", **by_encoder["elementwise"],
                "plain_ms": time_ms(torch, lambda: encode_plain(xt, consts["s_pos"],
                                                                consts["p_pos"]), 5),
                "library_ms": time_ms(torch, library_posenc, 5),
                "bytes": nbytes, "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
                "encoders": by_encoder})
        row14["card"] = card
        emit(row14)
        require(all(e["err_twin"] <= (TOL_POSENC_ENCODER_TWIN if k.startswith("doubling")
                                      else TOL_POSENC_TWIN)
                    and e["err_exact"] <= TOL_POSENC_EXACT and e["padding_exact"]
                    for k, e in row14["encoders"].items()),
                "an encoder of row 14 is outside its tolerance")

        phase = "kernel:resample_union"

        def resample_record(t_vals, bins, weights, u, timed=True, **extra):
            """One ``kernel`` line of kernel 2, checked (timed unless ``timed``
            is off).  Its top level is ``resample_union``, the CDF entry, on
            pdf_cdf's CDF against its twin, as in every earlier record of
            row 2.  Under ``fused_resample`` is the main paths' entry (the
            CDF built in the kernel from ``weights``, the callers' strided
            window) against its twin ``pdf_cdf_ordered`` +
            ``resample_union_plain``, with that CDF order held to
            ``pdf_cdf``'s on the CDF, and with its own bound.  ``u`` is one
            shared row expanded over the rays, or a row per ray.  Each
            entry's ``ms``, ``device_ms`` and ``events_ms`` come from the
            kernel_times line at the same shape; ``plain_ms`` and
            ``library_ms`` are timed here."""
            n_rays, n_t = t_vals.shape
            n_b, n_u = bins.shape[-1], u.shape[-1]
            cdf = pdf_cdf(weights).contiguous()
            cdf_ordered = pdf_cdf_ordered(weights)
            got = fused_resample(t_vals, bins, weights, u)
            got_union = resample_union(t_vals, bins, cdf, u)
            torch.cuda.synchronize()
            want = resample_union_plain(t_vals, bins, cdf, u)
            want_ordered = resample_union_plain(t_vals, bins, cdf_ordered, u)
            # the twin on pdf_cdf's CDF taken on the host: torch's other order
            want_host = resample_union_plain(t_vals, bins, pdf_cdf(weights.cpu()).to(dev), u)
            u_rows = u.contiguous()  # searchsorted takes per-row quantiles
            shared = u.stride(0) == 0
            u_bytes = 4 * (n_u if shared else n_rays * n_u)
            # comparisons: a binary search per fine sample and per merged
            # element; the fused entry's CDF adds three operations per weight
            ops = n_rays * (n_u * (math.log2(n_b) + math.log2(n_t) + 8) + n_t * math.log2(n_u))
            ops_fused = ops + n_rays * 3 * (n_b - 1)

            def bound(nbytes, n_ops):
                return {"bytes": nbytes, "ops": n_ops,
                        "bound_ms": 1e3 * max(nbytes / PEAK_BYTES, n_ops / PEAK_F32_FLOPS),
                        "bound_by": ("bytes" if nbytes / PEAK_BYTES >= n_ops / PEAK_F32_FLOPS
                                     else "operations")}

            rec = {
                "phase": "kernel", "name": "resample_union", "entry": "resample_union", **extra,
                "shape": f"{n_rays}x{n_t}+{n_u}",
                "quantiles": "one shared row" if shared else "a sorted random row per ray",
                "max_abs_err": (got_union - want).abs().max().item(), "tol": TOL_RESAMPLE,
                "sorted": bool((got_union[:, 1:] >= got_union[:, :-1]).all()),
                # t, bins and the CDF in, the union out
                **bound(4 * n_rays * (n_t + 2 * n_b + n_t + n_u) + u_bytes, ops),
                "fused_resample": {
                    "max_abs_err": (got - want_ordered).abs().max().item(), "tol": TOL_RESAMPLE,
                    "cdf_order_err": (cdf_ordered - cdf).abs().max().item(),
                    "tol_cdf_order": TOL_CDF_ORDER,
                    # measured, not held: the samples against pdf_cdf's, and
                    # the same twin on pdf_cdf taken on the host against the
                    # card's
                    "samples_vs_pdf_cdf": {
                        "max_abs": (got - want).abs().max().item(),
                        "share_over_1e-4": ((got - want).abs() > 1e-4).float().mean().item(),
                        "host_vs_card_max_abs": (want_host - want).abs().max().item(),
                        "host_vs_card_share_over_1e-4":
                            ((want_host - want).abs() > 1e-4).float().mean().item()},
                    "sorted": bool((got[:, 1:] >= got[:, :-1]).all()),
                    # t, bins and the weights in, the union out
                    **bound(4 * n_rays * (n_t + n_b + (n_b - 1) + n_t + n_u) + u_bytes,
                            ops_fused)},
                "card": card,
            }
            if timed:
                for r, entry, plain, library in (
                        (rec, "resample_union", lambda: resample_union_plain(t_vals, bins, cdf, u),
                         lambda: library_resample(torch, t_vals, bins, cdf, u_rows)),
                        (rec["fused_resample"], "fused_resample",
                         lambda: resample_union_plain(t_vals, bins, pdf_cdf_ordered(weights), u),
                         lambda: library_resample(torch, t_vals, bins, pdf_cdf(weights), u_rows))):
                    r.update(kt_times(entry, rec["shape"]), plain_ms=time_ms(torch, plain, 5),
                             library_ms=time_ms(torch, library, 5))
                    r["gbps_device"] = r["bytes"] / r["device_ms"] / 1e6
                    r["pct_bound_device"] = 100.0 * r["bound_ms"] / r["device_ms"]
            emit(rec)
            fused = rec["fused_resample"]
            require(rec["sorted"] and fused["sorted"] and rec["max_abs_err"] <= TOL_RESAMPLE
                    and fused["max_abs_err"] <= TOL_RESAMPLE
                    and fused["cdf_order_err"] <= TOL_CDF_ORDER,
                    f"resample kernel disagrees with its twins at {rec['shape']}")
            return rec

        t_vals, _ = sample_along_rays(origins, dirs, N_COARSE, 2.0, 6.0)
        bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).contiguous()
        weights = torch.rand(CHUNK_RAYS, N_COARSE - 1, generator=gen, device=dev) ** 4
        weights[::97] = 0.0  # empty rays: the eps padding path
        u = eval_quantiles(N_FINE, device=dev).expand(CHUNK_RAYS, N_FINE)
        # as render_chunk passes them: the window weights[..., 1:-1] of the
        # coarse level's (B, 65) weights
        resample_rec = resample_record(t_vals, bins, as_window(weights), u)
        # and at the fit phase's render shape: FIT_COARSE + 1 samples on
        # per-ray intervals inside [2, 6] (occupancy intervals), FIT_FINE
        # eval quantiles
        near = 2.0 + 2.0 * torch.rand(CHUNK_RAYS, generator=gen, device=dev)
        far = near + (6.0 - near) * torch.rand(CHUNK_RAYS, generator=gen, device=dev).clamp_min(0.05)
        t_vals, _ = sample_along_rays(origins, dirs, FIT_COARSE, near, far)
        bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).contiguous()
        weights = torch.rand(CHUNK_RAYS, FIT_COARSE - 1, generator=gen, device=dev) ** 4
        weights[::97] = 0.0
        u = eval_quantiles(FIT_FINE, device=dev).expand(CHUNK_RAYS, FIT_FINE)
        resample_fit_rec = resample_record(t_vals, bins, as_window(weights), u, timed=False,
                                           path="fit")
        # and at the fit_art phase's: FIT_ART_COARSE + 1 samples on per-ray
        # (AABB) intervals, FIT_ART_FINE eval quantiles.  The fit_art shapes'
        # inputs come from a generator of their own, so every check after
        # them draws what it drew before they were added
        fit_art_gen = torch.Generator(device=dev).manual_seed(args.seed + 101)
        t_vals, _ = sample_along_rays(origins, dirs, FIT_ART_COARSE, near, far)
        bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).contiguous()
        weights = torch.rand(CHUNK_RAYS, FIT_ART_COARSE - 1, generator=fit_art_gen,
                             device=dev) ** 4
        weights[::97] = 0.0
        u = eval_quantiles(FIT_ART_FINE, device=dev).expand(CHUNK_RAYS, FIT_ART_FINE)
        resample_fit_art_rec = resample_record(t_vals, bins, as_window(weights), u, timed=False,
                                               path="fit_art")
        del t_vals, bins, weights, u, near, far
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
                    "threefry_uniform": threefry_uniform,
                    "fused_level_train_art_grads": fused_level_train_art_grads,
                    **{fn.__name__: fn for fn in (*bench_variants.MLP_BODY.values(),
                                                  *bench_variants.XYZ_BODY.values())}}
        n_params = MLP_MACS_PER_SAMPLE + MLP_BIASES
        ro, rd = origins[:TRAIN_RAYS].contiguous(), dirs[:TRAIN_RAYS].contiguous()
        target = torch.rand(TRAIN_RAYS, 3, generator=gen, device=dev)
        train_rows = {}
        # sample positions as a step makes them: stratified random coarse
        # samples, then (below) their union with the resampled fine ones
        t_lvl, _ = sample_along_rays(ro, rd, N_COARSE, 2.0, 6.0, randomized=True, t_rand=torch.rand(
            TRAIN_RAYS, N_COARSE + 1, generator=gen, device=dev))
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
                                       encode_plain),
                 dict(t_vals=t_lvl, rays_d=rd, target=target, white_bkgd=True)),
                # xyz and g (B, S, 3 + 4), viewdirs, f32 params in, f32 grads out
                ("fused_mlp_bwd_xyz", fused_mlp_bwd_xyz, fused_mlp_bwd_xyz_plain, bwd_args,
                 4 * (7 * rows + 3 * TRAIN_RAYS + 2 * n_params),
                 lambda: library_level(torch, packed32, consts, t_lvl, ro, rd, rd, target,
                                       encode_plain, cotangent=cot), None),
                # enc, venc and g (N, 64 + 32 + 4), f32 params in, f32 grads out
                ("fused_mlp_bwd", fused_mlp_bwd, fused_mlp_bwd_plain, enc_bwd_args,
                 4 * (100 * rows + 2 * n_params),
                 lambda: library_mlp_vjp(torch, *enc_bwd_args), None),
            )
            for kname, fn, fn_plain, fn_args, nbytes, library, forward in runs:
                train_rows[kname, n_samples] = grad_record(
                    kname, fn, fn_plain, fn_args, shape=f"{TRAIN_RAYS}x{n_samples}", rows=rows,
                    flops=flops, nbytes=nbytes, library=library, forward=forward)
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
                u = sorted_uniform(torch.rand(TRAIN_RAYS, N_FINE + 1, generator=gen, device=dev))
                require(bool((u[:, 1:] >= u[:, :-1]).all()) and u.stride(0) == N_FINE,
                        "sorted_uniform rows are not ascending per-ray rows")
                train_rows["resample_union", n_samples] = resample_record(
                    t_lvl, bins, as_window(wgt), u)
                t_next = fused_resample(t_lvl, bins, as_window(wgt), u)
                del wgt, bins, u
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
        state0 = dataclasses.replace(system.init_state(prng.key(0)), params=seeded_params(
            system, torch.Generator(device=dev).manual_seed(args.seed + 1)))

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
            ``batch_fn(generator, step)`` with the keys ``fold_in(key, step)``,
            each timed by CUDA events."""
            g = torch.Generator(device=dev).manual_seed(args.seed + 3)
            key = prng.key(args.seed + 3)
            for c in counters.values():
                c.launches = 0
            metrics, events = [], [torch.cuda.Event(enable_timing=True)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events[0].record()
            for i in range(steps):
                state, m = sy.train_step(state, batch_fn(g, i), prng.fold_in(key, i))
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
            train_step with the ray ids train_many attaches and the key that
            train_many gives step t, ``fold_in(key, t)``."""
            t_steps, k, m = superbatch["rays_o"].shape[:3]
            for c in counters.values():
                c.launches = 0
            key = prng.key(args.seed + 6)
            state, metrics = sy.train_many(state0, superbatch, key)
            torch.cuda.synchronize()
            launches = {k_: c.launches for k_, c in counters.items()}  # read before the comparison
            ray_ids = torch.arange(k * m, device=dev).reshape(k, m)
            ref, losses = state0, []
            for t in range(t_steps):
                batch = dict({k_: v[t] for k_, v in superbatch.items()}, ray_ids=ray_ids)
                ref, step_metrics = sy.train_step(ref, batch, prng.fold_in(key, t))
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
                resample_union=TRAIN_STEPS_V3, threefry_uniform=2 * TRAIN_STEPS_V3),
            "v2_launches": launches_are(
                v2["launches"], fused_nerf_mlp_xyz_eval=2 * TRAIN_STEPS_V2,
                fused_mlp_bwd_xyz=2 * TRAIN_STEPS_V2, resample_union=TRAIN_STEPS_V2,
                threefry_uniform=2 * TRAIN_STEPS_V2),
            "steps_counted": v3["final_step"] == TRAIN_STEPS_V3,
            "many_launches": (
                launches_are(many["v3"]["launches"], fused_level_train_grads=levels,
                             resample_union=levels // 2, threefry_uniform=levels)
                and launches_are(many["v2"]["launches"], fused_nerf_mlp_xyz_eval=levels,
                                 fused_mlp_bwd_xyz=levels, resample_union=levels // 2,
                                 threefry_uniform=levels)),
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
        art_state0 = dataclasses.replace(
            art_system.init_state(prng.key(0)), params=seeded_params(
                art_system, torch.Generator(device=dev).manual_seed(args.seed + 7)))
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
        # at the fit_art phase's render shapes: 24 + 1 and 24 + 1 + 48 samples
        # on per-ray intervals inside [2, 6] (AABB intervals)
        near = 2.0 + 2.0 * torch.rand(CHUNK_RAYS, generator=fit_art_gen, device=dev)
        far = near + (6.0 - near) * torch.rand(CHUNK_RAYS, generator=fit_art_gen,
                                               device=dev).clamp_min(0.05)
        for n_samples in (FIT_ART_COARSE + 1, FIT_ART_COARSE + 1 + FIT_ART_FINE):
            _, samples = sample_along_rays(origins, dirs, n_samples - 1, near, far)
            art_rows["art_mlp_fwd", "fit_art", n_samples] = art_fwd_record(
                packed_fine, samples.contiguous(), dirs, "fit_art render chunk")
            del samples
        del near, far
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
            # the auto-encoder quality config's (FIT_AE_CONFIG): its own checks
            # below, ae_level_checks, on a generator of their own
            "ae_quality": dict(white_bkgd=False, rgb_padding=0.0, density_bias=-1.0,
                               bce_weight=0.5, sigma_act="softplus_bias"),
        }

        def art_train_checks(seed, timed=True, strict=True):
            """Rows 9 (with each argument set), 11 and 10 at the training
            shapes, 2,048 rays x 65 and x 193 samples with t sampled as a step
            samples it, against their twins, on the weights, codes, rays and
            draws of ``seed``; the records by (kernel, arguments, samples)."""
            gen = torch.Generator(device=dev).manual_seed(seed + 17)
            params_s = seeded_params(art_system,
                                        torch.Generator(device=dev).manual_seed(seed + 7))
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
                                         t_rand=torch.rand(TRAIN_RAYS, N_COARSE + 1,
                                                           generator=gen, device=dev))
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
                                               target, lw_uniform, encode_plain, cotangent=cot),
                     None),
                ]
                for mode, kw in art_level_modes.items():
                    if mode == "ae_quality" or (mode != "autodecoder" and level == "coarse_mlp"):
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
                             encode_plain, mask=mask, **kw),
                         dict(t_vals=t_lvl, rays_d=rd, target=target, loss_w=lw)))
                for kname, mode, fn, fn_plain, fn_args, kw, nbytes, library, forward in runs:
                    extra = {"arguments": dict(kw, mode=mode)} if mode else {}
                    recs[kname, mode, n_samples] = grad_record(
                        kname, fn, fn_plain, fn_args, kw=kw, forward=forward,
                        shape=f"{TRAIN_RAYS}x{n_samples}",
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

        ae_cfg = get_config(["--config", str(ROOT / FIT_AE_CONFIG)])
        ae_system = build_system(ae_cfg, 2.0, 6.0, ae_cfg.white_back, device=dev)

        def ae_level_checks(seed, timed=True, strict=True):
            """Row 9 with the auto-encoder quality config's arguments
            (softplus_bias, density bias -1, opacity BCE 0.5, no rgb padding),
            never launched before this slice, at the training shapes (2,048 x
            65 and x 193 on [2, 6]) and at its own path's (2,048 x 25 and x 73
            on per-ray AABB-like intervals), t sampled and resampled as a step
            does: on the AE's seeded weights and the encoding of a random
            320x240 source, inputs from a generator of its own; the records
            by samples."""
            gen = torch.Generator(device=dev).manual_seed(seed + 23)
            p = seeded_params(ae_system, torch.Generator(device=dev).manual_seed(seed + 7))
            src = torch.randn(1, 3, *reversed(ae_cfg.img_wh), generator=gen, device=dev)
            with torch.no_grad():
                lat, _ = ae_system._encode(p, src, torch.tensor(0.7, device=dev))
            kw = art_level_modes["ae_quality"]
            recs = {}
            for n_c, n_f, per_ray in ((N_COARSE, N_FINE, False),
                                      (FIT_AE_COARSE, FIT_AE_FINE, True)):
                rd = torch.nn.functional.normalize(
                    torch.randn(TRAIN_RAYS, 3, generator=gen, device=dev), dim=-1)
                ro = -4.0 * rd + 0.3 * torch.randn(TRAIN_RAYS, 3, generator=gen, device=dev)
                target = torch.rand(TRAIN_RAYS, 3, generator=gen, device=dev)
                target = target * (torch.rand(TRAIN_RAYS, 1, generator=gen, device=dev) > 0.5)
                mask = (target.sum(-1) > 0).float()
                lw = (mask / (3.0 * mask.sum()).clamp_min(1.0)).contiguous()
                near, far = 2.0, 6.0
                if per_ray:  # the bench's AABB slabs: t_near 3.2..3.6, span 0.4..0.9
                    near = 3.2 + 0.4 * torch.rand(TRAIN_RAYS, generator=gen, device=dev)
                    far = near + 0.4 + 0.5 * torch.rand(TRAIN_RAYS, generator=gen, device=dev)
                t_lvl, _ = sample_along_rays(ro, rd, n_c, near, far, randomized=True,
                                             t_rand=torch.rand(TRAIN_RAYS, n_c + 1,
                                                               generator=gen, device=dev))
                path = "fit_ae" if per_ray else "training"
                for level in ("coarse_mlp", "fine_mlp"):
                    packed_l = fused_art.fold_latents(mlp_params(p, f"model.{level}"), lat)
                    n_samples = t_lvl.shape[1]
                    rows = TRAIN_RAYS * n_samples
                    fn_args = (packed_l, consts, t_lvl, ro, rd, rd, target, lw, mask)
                    recs[n_samples] = grad_record(
                        "fused_level_train_art_grads", fused_level_train_art_grads,
                        fused_level_train_art_grads_plain, fn_args, kw=kw,
                        forward=dict(t_vals=t_lvl, rays_d=rd, target=target, loss_w=lw),
                        shape=f"{TRAIN_RAYS}x{n_samples}", rows=rows,
                        flops=3 * 2.0 * art_macs * rows,
                        nbytes=4 * (2 * rows + (4 * 3 + 3) * TRAIN_RAYS + 2 * n_art_params + 1),
                        library=lambda fn_args=fn_args: library_art_level(
                            torch, *fn_args[:7], lw, encode_plain, mask=mask, **kw),
                        art=True, timed=timed, strict=strict, seed=seed,
                        arguments=dict(kw, mode="ae_quality"), path=path)
                    if level == "coarse_mlp":
                        wgt = fused_level_train_art_grads(*fn_args, **kw)[1]
                        bins = (0.5 * (t_lvl[:, 1:] + t_lvl[:, :-1])).contiguous()
                        u = sorted_uniform(torch.rand(TRAIN_RAYS, n_f + 1, generator=gen,
                                                      device=dev))
                        t_lvl = fused_resample(t_lvl, bins, wgt[:, 1:-1], u)
                    del packed_l, fn_args
            del p, lat
            torch.cuda.empty_cache()
            return recs

        ae_level_rows = ae_level_checks(args.seed)

        # ------------------------------------------------ bench shapes
        # rows 3, 2 and 9 as the bench's steps launch them: the first
        # microbatch of each bench batch, t stratified in its per-ray
        # intervals, then the union with the resample of the coarse level's
        # weights
        phase = "kernel:bench_shapes"

        def bench_shape_checks(seed, timed=True, strict=True, contracts=BENCH_CONTRACTS,
                               label="bench"):
            """Rows 3 and 9, and row 2 between their levels, on the first
            2,048 rays of each bench batch (vanilla 17 + 32 samples on
            occupancy intervals, white background; the auto-decoder 25 + 48 on
            AABB intervals), against their twins, on the weights and draws of
            ``seed``; the records by (kernel, samples).  ``contracts`` and
            ``label`` put other shapes through the same checks (the occ8
            config's)."""
            gen = torch.Generator(device=dev).manual_seed(seed + 14)
            recs = {}
            for system_name, n_rays, tight, batch_seed, (n_c, n_f) in contracts:
                hb = port_bench._synthetic_batch(n_rays, tight, seed=batch_seed)
                b = {k: torch.from_numpy(v[:TRAIN_RAYS]).to(dev) for k, v in hb.items()}
                ro, rd, vd, tg = b["rays_o"], b["rays_d"], b["viewdirs"], b["target"]
                contract = f"{system_name} {label}, {tight} intervals"
                t_lvl, _ = sample_along_rays(ro, rd, n_c, b["t_near"], b["t_far"],
                                             randomized=True, t_rand=torch.rand(
                                                 TRAIN_RAYS, n_c + 1, generator=gen, device=dev))
                vanilla = system_name == "vanilla"
                if vanilla:
                    p = seeded_params(system,
                                         torch.Generator(device=dev).manual_seed(seed + 1))
                else:
                    p = seeded_params(art_system,
                                         torch.Generator(device=dev).manual_seed(seed + 7))
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
                        forward = dict(t_vals=t_lvl, rays_d=rd, target=tg, white_bkgd=True)
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
                        forward = dict(t_vals=t_lvl, rays_d=rd, target=tg, loss_w=lw)
                        macs, n_p = art_macs, n_art_params
                        library = (lambda packed_l=packed_l, t=t_lvl: library_art_level(
                            torch, packed_l, consts, t, ro, rd, vd, tg, lw, encode_plain,
                            mask=ones, **art_level_modes["autodecoder"]))
                    recs[kname, n_samples] = grad_record(
                        kname, fn, fn_plain, fn_args, kw=kw, forward=forward,
                        shape=f"{TRAIN_RAYS}x{n_samples}",
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
                        u = sorted_uniform(torch.rand(TRAIN_RAYS, n_f + 1, generator=gen,
                                                      device=dev))
                        recs["resample_union", n_samples] = resample_record(
                            t_lvl, bins, wgt[:, 1:-1], u, timed=timed, seed=seed,
                            contract=contract)
                        t_lvl = fused_resample(t_lvl, bins, wgt[:, 1:-1], u)
                    del packed_l, fn_args
            torch.cuda.empty_cache()
            return recs

        bench_shape_rows = bench_shape_checks(args.seed)

        # ------------------------------------------------------ occ8 shapes
        # rows 3 and 2 between the occ8 config's levels (2,048 x 9, then 16
        # fine draws to x 25) through the bench shapes' checks, and row 1 at
        # the render chunk on occupancy intervals at 61,440 x 9 and x 25
        phase = "kernel:occ8"
        occ8_contract = config_contract(OCC8_CONFIG)
        require(occ8_contract == ("vanilla", TRAIN_RAYS, "occ", 0, (8, 16)),
                f"{OCC8_CONFIG} no longer has the occ8 shapes")
        occ8_rows = bench_shape_checks(args.seed, contracts=(occ8_contract,), label="occ8 config")
        occ8_batch = port_bench._synthetic_batch(CHUNK_RAYS, "occ", seed=0)
        near, far = (torch.from_numpy(occ8_batch[k]).to(dev) for k in ("t_near", "t_far"))
        n_c, n_f = occ8_contract[-1]
        occ8_mlp_rows = {}
        for n_samples in (n_c + 1, n_c + 1 + n_f):
            _, samples = sample_along_rays(origins, dirs, n_samples - 1, near, far)
            occ8_mlp_rows[n_samples] = mlp_eval_record(packed, samples.contiguous(), dirs)
            del samples
        del occ8_batch, near, far
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
                resample_union=ART_MICRO * ART_STEPS_V3, threefry_uniform=per_v3 * ART_STEPS_V3),
            "v2_launches": launches_are(
                art_v2["launches"], art_mlp_fwd=per_v3 * ART_STEPS_V2,
                art_mlp_bwd=per_v3 * ART_STEPS_V2, resample_union=ART_MICRO * ART_STEPS_V2,
                threefry_uniform=per_v3 * ART_STEPS_V2),
            "steps_counted": art_v3["final_step"] == ART_STEPS_V3,
            "many_launches": (
                launches_are(art_many["v3"]["launches"], fused_level_train_art_grads=levels,
                             resample_union=levels // 2, threefry_uniform=levels)
                and launches_are(art_many["v2"]["launches"], art_mlp_fwd=levels,
                                 art_mlp_bwd=levels, resample_union=levels // 2,
                                 threefry_uniform=levels)),
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
                restored = ckpt.restore(sy.init_state(prng.key(0)))
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

        # --------------------------------------------------------------- fit
        # The CLI's main path as users run it (aon_tpu_torch.run.main ->
        # Trainer.fit / validate / test) on the occupancy-interval quality
        # config over a 640x480 SAPIEN-layout fixture with depth: loaders cold
        # and from the interval cache, FIT_STEPS steps of 2,048 rays through
        # train_many in dispatches of 8, one 640x480 validation, a resume from
        # last.ckpt, --run_eval and an extraction with the dataset's bounds
        phase = "fit"
        # synthetic LPIPS weights (the port's script) under the build
        # directory: every --run_eval from here on reports LPIPS beside them
        lpips_npz = ROOT / "build" / "aon_tpu_torch" / "lpips_vgg.synthetic.npz"
        with contextlib.redirect_stdout(io.StringIO()):
            make_synthetic_lpips_weights.main(["--out", str(lpips_npz), "--seed", str(args.seed)])
        os.environ["AON_LPIPS_WEIGHTS"] = str(lpips_npz)
        fit_dir = Path(tempfile.mkdtemp(prefix="aon_fit_"))
        cwd = os.getcwd()
        try:
            os.chdir(fit_dir)
            with contextlib.redirect_stdout(io.StringIO()):
                make_fixture_dataset.main([str(fit_dir / "data"), "--n", str(FIT_VIEWS),
                                           "--wh", "640", "480", "--seed", str(args.seed)])
            cfg_json = json.loads((ROOT / FIT_CONFIG).read_text())
            cfg_json.update(root_dir=str(fit_dir / "data"), output_path=str(fit_dir / "results"),
                            run_max_steps=FIT_STEPS, num_epochs=1, limit_val_batches=1)
            fit_cfg_path = fit_dir / Path(FIT_CONFIG).name
            fit_cfg_path.write_text(json.dumps(cfg_json))
            fit_cfg = get_config(["--config", str(fit_cfg_path)])
            require((fit_cfg.N_samples, fit_cfg.N_importance) == (FIT_COARSE, FIT_FINE),
                    f"{FIT_CONFIG} no longer samples the kernel phase's fit shapes")
            ds_kw = dict(img_wh=tuple(fit_cfg.img_wh), use_aabb=fit_cfg.use_aabb,
                         aabb_pad=fit_cfg.aabb_pad, use_occgrid=fit_cfg.use_occgrid,
                         occgrid_res=fit_cfg.occgrid_res, occgrid_dilate=fit_cfg.occgrid_dilate)
            loader_s = {}
            for label in ("cold", "cached"):  # the second reads the interval cache
                t0 = time.perf_counter()
                train_ds = SapienDataset(fit_cfg.root_dir, "train", **ds_kw)
                loader_s[label] = time.perf_counter() - t0
            iv_cache = list((fit_dir / "data" / "train").glob(".occ_intervals_*.npz"))
            val_frame = SapienDataset(fit_cfg.root_dir, "val", **ds_kw).full_frame(0)
            val_chunks = math.ceil(int(val_frame["hit"].sum()) / fit_cfg.chunk)
            steps_per_epoch = train_ds.steps_per_epoch(fit_cfg.batch_size)
            require(steps_per_epoch >= FIT_STEPS, f"the fixture's epoch ({steps_per_epoch} steps) "
                    f"is shorter than the run ({FIT_STEPS})")

            def run_cli(cfg):
                for c in counters.values():
                    c.launches = 0
                printed = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    tr = port_run.main(cfg)
                torch.cuda.synchronize()
                return tr, time.perf_counter() - t0, {k: c.launches for k, c in counters.items()}, \
                    printed.getvalue()

            fit_trainer, fit_wall_s, fit_launches, _ = run_cli(fit_cfg)
            fit_params = {k: v.detach().clone() for k, v in fit_trainer.state.params.items()}
            run_dir = fit_dir / "results" / fit_cfg.exp_name
            recs = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
            losses = [(r["step"], r["train/loss"]) for r in recs if "train/loss" in r]
            rate = [r["train/rays_per_sec"] for r in recs if "train/rays_per_sec" in r]
            val_psnr = [r["val/psnr"] for r in recs if "val/psnr" in r]
            per_step = {k: fit_launches[k] / FIT_STEPS
                        for k in ("fused_level_train_grads", "resample_union")}

            # learning: the run's first batch and one fixed set of draws under
            # the run's initial weights (Trainer.__init__'s) and the fitted ones
            batch0 = next(fit_trainer.train_dataset.ray_batches(fit_cfg.batch_size,
                                                                seed=fit_cfg.seed))
            inject_ramps(fit_cfg, batch0, 0)
            batch0 = {k: v[0] for k, v in stack_step_batches(
                [batch0], microbatch=fit_cfg.microbatch_rays, device=dev).items()}
            # (the Trainer's init key: split(key(seed))[1], as the JAX trainer's)
            init_params = fit_trainer.system.init_state(
                prng.split(prng.key(fit_cfg.seed))[1]).params

            def fixed_loss(params):
                return accumulated_grads(fit_trainer.system.loss_fn, params, batch0,
                                         prng.key(args.seed + 11))[0].item()

            loss_fresh, loss_fitted = fixed_loss(init_params), fixed_loss(fit_params)
            val_psnr_fresh = eval_metrics.psnr(
                fit_trainer._render_full(init_params, val_frame)["comp_rgb"], val_frame["target"])
            del init_params

            # the device's idle share over dispatches of the same loop
            from torch.profiler import ProfilerActivity, profile

            it = fit_trainer._train_iterator()
            fit_trainer._dispatch(it, fit_cfg.steps_per_dispatch)  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(FIT_PROFILE_DISPATCHES):
                    fit_trainer.state, m = fit_trainer._dispatch(it, fit_cfg.steps_per_dispatch)
                torch.cuda.synchronize()
                window_ms = 1e3 * (time.perf_counter() - t0)
            busy_ms = sum(e.device_time_total for e in prof.key_averages()
                          if e.device_type.name == "CUDA") / 1e3
            require(busy_ms > 0, "torch.profiler recorded no device time in the fit loop")

            # resume: FIT_RESUME_STEPS more steps from last.ckpt
            res_cfg = get_config(["--config", str(fit_cfg_path)])
            res_cfg.run_max_steps = FIT_STEPS + FIT_RESUME_STEPS
            res_cfg.ckpt_path = "last.ckpt"
            # what the CLI's resume restores, taken as it returns from
            # CheckpointManager.restore
            restored, plain_restore = [], CheckpointManager.restore

            def restore_spy(manager, state, name=None):
                out = plain_restore(manager, state, name)
                restored.append((out.step, {k: v.detach().clone() for k, v in out.params.items()}))
                return out

            CheckpointManager.restore = restore_spy
            try:
                res_trainer, res_wall_s, res_launches, res_out = run_cli(res_cfg)
            finally:
                CheckpointManager.restore = plain_restore
            res_recs = [json.loads(ln) for ln in
                        (run_dir / "metrics.jsonl").read_text().splitlines()][len(recs):]
            res_val = [r["val/psnr"] for r in res_recs if "val/psnr" in r]
            res_trainer.global_step = 0
            first0 = next(res_trainer._train_iterator())
            res_trainer.global_step = FIT_STEPS
            first_resumed = next(res_trainer._train_iterator())
            res_trainer.global_step = FIT_STEPS + FIT_RESUME_STEPS

            # --run_eval --render_name smoke
            ev_cfg = get_config(["--config", str(fit_cfg_path), "--run_eval",
                                 "--render_name", "smoke"])
            _, ev_wall_s, ev_launches, _ = run_cli(ev_cfg)
            results = json.loads((fit_dir / "ckpts" / fit_cfg.exp_name / "results.json").read_text())
            jpgs = sorted((fit_dir / "ckpts" / fit_cfg.exp_name / "smoke").glob("*.jpg"))
            decoded = [read_jpeg(p) for p in jpgs]

            # geometry from the fitted checkpoint, bounds from the dataset
            for c in counters.values():
                c.launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                geo = extract_geometry.main(["--config", str(fit_cfg_path), "--out", "geometry_fit"])
            geo_launches_fit = {k: c.launches for k, c in counters.items()}
            gz = np.load(fit_dir / geo["out_dir"] / "density_grid.npz")
            want_bounds = scene_aabb([str(fit_dir / "data" / "train")], tuple(fit_cfg.img_wh),
                                     pad=fit_cfg.aabb_pad)
            pil = importlib.util.find_spec("PIL") is not None

            n_test = 2  # the fixture's test frames
            checks = {
                "interval_cache": len(iv_cache) == 1,
                "launches": launches_are(
                    fit_launches, fused_level_train_grads=2 * FIT_STEPS,
                    resample_union=FIT_STEPS + val_chunks,
                    fused_nerf_mlp_xyz_eval=2 * val_chunks, threefry_uniform=2 * FIT_STEPS),
                "loss_falls": loss_fitted < FIT_LOSS_FALL * loss_fresh,
                "val_psnr_finite": len(val_psnr) == 1 and math.isfinite(val_psnr[0]),
                "resume_continues": (f"resumed from step {FIT_STEPS}" in res_out
                                     and res_trainer.global_step == FIT_STEPS + FIT_RESUME_STEPS
                                     and all(r["step"] > FIT_STEPS for r in res_recs)
                                     and launches_are(
                                         res_launches,
                                         fused_level_train_grads=2 * FIT_RESUME_STEPS,
                                         resample_union=FIT_RESUME_STEPS + val_chunks,
                                         fused_nerf_mlp_xyz_eval=2 * val_chunks,
                                         threefry_uniform=2 * FIT_RESUME_STEPS)),
                "resume_restores_params": (
                    len(restored) == 1 and restored[0][0] == FIT_STEPS
                    and restored[0][1].keys() == fit_params.keys()
                    and all(torch.equal(restored[0][1][k], v) for k, v in fit_params.items())),
                "resumed_batch_differs": not np.array_equal(first0["rays_o"],
                                                            first_resumed["rays_o"]),
                "resume_val_psnr": (len(res_val) == 1
                                    and res_val[0] >= val_psnr[0] - TOL_RESUME_PSNR_DROP),
                "results_json": all(math.isfinite(results[k]["mean"]) for k in ("PSNR", "SSIM")),
                "eval_lpips": (results.get("lpips_weights") == "synthetic"
                               and math.isfinite(results["LPIPS"]["mean"])),
                "jpgs_decode": (len(jpgs) == 2 * n_test
                                and all(d.shape == (480, 640, 3) for d in decoded)),
                "eval_launches": ev_launches["fused_nerf_mlp_xyz_eval"] > 0
                                 and ev_launches["fused_level_train_grads"] == 0,
                "geometry_launches": launches_are(geo_launches_fit, fused_nerf_mlp_xyz=geo["queries"])
                                     and geo["queries"] == math.ceil(GEO_RES ** 3 / GEO_CHUNK),
                "geometry_dataset_bounds": np.allclose(gz["bounds"], want_bounds),
            }
            fit_rec = {
                "phase": "fit", "config": FIT_CONFIG, "fixture": {"wh": [640, 480],
                                                                   "train": FIT_VIEWS, "val": 2,
                                                                   "test": n_test},
                "train_rays": len(train_ds), "hit_fraction": train_ds.hit_fraction,
                "aabb_dropped_fg_frac": train_ds.aabb_dropped_fg_frac,
                "steps_per_epoch": steps_per_epoch, "steps": FIT_STEPS,
                "steps_per_dispatch": fit_cfg.steps_per_dispatch,
                "loader_s": loader_s, "wall_s": fit_wall_s,
                "rays_per_sec": rate, "ms_per_step": [1e3 * fit_cfg.batch_size / r for r in rate],
                "profile": {"dispatches": FIT_PROFILE_DISPATCHES, "window_ms": window_ms,
                            "device_busy_ms": busy_ms,
                            "device_idle_share": 1.0 - busy_ms / window_ms},
                "launches": {k: v for k, v in fit_launches.items() if v},
                "launches_per_step": per_step, "val_chunks": val_chunks,
                "loss": {"first": losses[0], "last": losses[-1]} if losses else None,
                "fixed_batch_loss": {"initial_weights": loss_fresh, "fitted": loss_fitted,
                                     "ratio": loss_fitted / loss_fresh, "fall": FIT_LOSS_FALL},
                "val_psnr": val_psnr, "val_psnr_initial_weights": val_psnr_fresh,
                "resume": {"wall_s": res_wall_s, "val_psnr": res_val,
                           "tol_psnr_drop": TOL_RESUME_PSNR_DROP,
                           "launches": {k: v for k, v in res_launches.items() if v}},
                "eval": {"wall_s": ev_wall_s, "PSNR": results["PSNR"]["mean"],
                         "SSIM": results["SSIM"]["mean"],
                         "LPIPS": results.get("LPIPS", {}).get("mean"),
                         "lpips_weights": results.get("lpips_weights"), "jpgs": len(jpgs),
                         "launches": {k: v for k, v in ev_launches.items() if v}},
                "geometry": {"queries": geo["queries"], "occupied": geo["occupied"],
                             "bounds": gz["bounds"].tolist(), "seconds": geo["seconds"],
                             "launches": {k: v for k, v in geo_launches_fit.items() if v}},
                "pil_importable": pil, "checks": checks, "card": card}
            emit(fit_rec)
            require(all(checks.values()), f"fit checks failed: {checks}")
            fit_path_launches = {k: fit_launches[k] + res_launches[k] + ev_launches[k]
                                 + geo_launches_fit[k] for k in counters}
        finally:
            os.chdir(cwd)
            shutil.rmtree(fit_dir, ignore_errors=True)
        torch.cuda.empty_cache()

        # ----------------------------------------------------------- fit_art
        # The CLI's main path for the auto-decoder on its quality config
        # (24 + 48 samples on AABB intervals, 4,096 rays a step as two
        # microbatches of 2,048) over a 320x240 --multi fixture with depth,
        # one instance with a test_spheric split: the loader cold and warm,
        # FIT_ART_STEPS steps in dispatches of 8 and one validation of five
        # frames, a resume, --run_eval (the 19-frame sweep), render_sweep,
        # eval_per_instance and an extraction with the dataset's bounds
        phase = "fit_art"
        fa_dir = Path(tempfile.mkdtemp(prefix="aon_fit_art_"))
        cwd = os.getcwd()
        try:
            os.chdir(fa_dir)
            data = fa_dir / "data"
            with contextlib.redirect_stdout(io.StringIO()):
                make_fixture_dataset.main([str(data), "--multi", "--n", str(FIT_ART_VIEWS),
                                           "--wh", "320", "240", "--seed", str(args.seed)])
            shutil.copytree(data / "obj_a" / "train" / "0_degree", data / "obj_a" / "test_spheric")

            def fit_config(config, out, steps, samples_per_epoch, **overrides):
                """``config`` on the fixture, run for ``steps`` steps into
                ``out``, written beside it: its path and the loaded config."""
                cfg_json = json.loads((ROOT / config).read_text())
                cfg_json.update(root_dir=str(data), output_path=str(fa_dir / out),
                                run_max_steps=steps, samples_per_epoch=samples_per_epoch,
                                num_epochs=1, **overrides)
                cfg_path = fa_dir / Path(config).name
                cfg_path.write_text(json.dumps(cfg_json))
                return cfg_path, get_config(["--config", str(cfg_path)])

            def chunks_of(frame, cfg):
                """A frame's render chunks: its box-hitting rays on AABB
                intervals, else every pixel."""
                rays = (int(np.asarray(frame["hit"]).sum()) if "hit" in frame
                        else np.asarray(frame["rays_o"]).reshape(-1, 3).shape[0])
                return math.ceil(rays / cfg.chunk)

            def fit_run(cfg, out, loss_seed):
                """The CLI's fit of ``cfg`` (one validation of five frames)
                and what a fit line checks: exact launches of rows 9, 2, 10
                and the draws, the run's first batch's loss under one set of
                draws falling from the initial weights' to under
                FIT_ART_LOSS_FALL of it, and the val PSNR above the initial
                weights'.  Returns the run's trainer, metrics and numbers."""
                val_ds = SapienDatasetMulti(
                    cfg.root_dir, "val", img_wh=tuple(cfg.img_wh), use_aabb=cfg.use_aabb,
                    aabb_pad=cfg.aabb_pad, ray_batch_size=cfg.ray_batch_size,
                    need_src_imgs=False)
                val_frames = [val_ds.val_frame(seed=cfg.seed + i)
                              for i in range(min(cfg.limit_val_batches, 5))]
                val_chunks = sum(chunks_of(f, cfg) for f in val_frames)
                trainer, wall_s, launches, _ = run_cli(cfg)
                params = {k: v.detach().clone() for k, v in trainer.state.params.items()}
                recs = [json.loads(ln) for ln in (fa_dir / out / cfg.exp_name
                                                  / "metrics.jsonl").read_text().splitlines()]
                # learning: the run's first batch with one fixed set of draws
                # under the run's initial weights and the fitted ones; the
                # val frames under the initial weights
                item0 = next(trainer.train_dataset.train_batches(seed=cfg.seed))
                batch0 = {k: v[0] for k, v in stack_step_batches(
                    [item0], microbatch=cfg.microbatch_rays, device=dev).items()}
                init = trainer.system.init_state(prng.split(prng.key(cfg.seed))[1]).params

                def fixed_loss(p):
                    return accumulated_grads(trainer.system.loss_fn, p, batch0,
                                             prng.key(loss_seed))[0].item()

                run = {"cfg": cfg, "trainer": trainer, "params": params, "recs": recs,
                       "wall_s": wall_s, "launches": launches, "val_chunks": val_chunks,
                       "item0": item0,
                       "rate": [r["train/rays_per_sec"] for r in recs
                                if "train/rays_per_sec" in r],
                       "val": [r["val/psnr"] for r in recs if "val/psnr" in r],
                       "loss_fresh": fixed_loss(init), "loss_fitted": fixed_loss(params),
                       "val_fresh": float(np.mean([eval_metrics.psnr(
                           trainer._render_full(init, f)["comp_rgb"], f["target"])
                           for f in val_frames]))}
                steps = cfg.run_max_steps
                run["checks"] = {
                    "launches": launches_are(
                        launches, fused_level_train_art_grads=art_steps * steps,
                        resample_union=ART_MICRO * steps + val_chunks,
                        art_mlp_fwd=2 * val_chunks, threefry_uniform=art_steps * steps),
                    "loss_falls": run["loss_fitted"] < FIT_ART_LOSS_FALL * run["loss_fresh"],
                    "val_psnr_rises": len(run["val"]) == 1 and run["val"][0] > run["val_fresh"],
                }
                run["line"] = {
                    "steps_per_dispatch": cfg.steps_per_dispatch,
                    "rays_per_step": cfg.ray_batch_size, "microbatch_rays": cfg.microbatch_rays,
                    "samples": [cfg.N_samples, cfg.N_importance], "wall_s": wall_s,
                    "rays_per_sec": run["rate"],
                    "ms_per_step": [1e3 * cfg.ray_batch_size / r for r in run["rate"]],
                    "launches": {k: v for k, v in launches.items() if v},
                    "val_chunks": val_chunks,
                    "fixed_batch_loss": {"initial_weights": run["loss_fresh"],
                                         "fitted": run["loss_fitted"],
                                         "ratio": run["loss_fitted"] / run["loss_fresh"],
                                         "fall": FIT_ART_LOSS_FALL},
                    "val_psnr": run["val"], "val_psnr_initial_weights": run["val_fresh"]}
                return run

            art_steps = 2 * ART_MICRO  # row 9 per step: two levels per microbatch
            # one epoch holds the run and its resume: one validation each
            fa_cfg_path, fa_cfg = fit_config(FIT_ART_CONFIG, "results", FIT_ART_STEPS,
                                             FIT_ART_STEPS + FIT_ART_RESUME_STEPS)
            _, bench_rays, _, _, bench_samples = BENCH_CONTRACTS[1]
            require((fa_cfg.N_samples, fa_cfg.N_importance, fa_cfg.ray_batch_size,
                     fa_cfg.microbatch_rays) == (FIT_ART_COARSE, FIT_ART_FINE, bench_rays,
                                                 bench_rays // ART_MICRO)
                    and bench_samples == (FIT_ART_COARSE, FIT_ART_FINE),
                    f"{FIT_ART_CONFIG} no longer has the bench's and the kernel phases' "
                    "auto-decoder shapes")
            ds_kw = dict(img_wh=tuple(fa_cfg.img_wh), use_aabb=fa_cfg.use_aabb,
                         aabb_pad=fa_cfg.aabb_pad, ray_batch_size=fa_cfg.ray_batch_size,
                         need_src_imgs=False)

            # the loader: the scene AABB from every degree directory's depth
            # maps (cold: computed; warm: its cache), then every train frame
            # decoded with its intervals (cold) and served from the frame
            # cache (warm), and a 4,096-ray item from cached frames
            fa_loader_s = {}
            for label in ("cold", "warm"):
                t0 = time.perf_counter()
                fa_train = SapienDatasetMulti(fa_cfg.root_dir, "train", **ds_kw)
                fa_loader_s[f"scene_aabb_{label}"] = time.perf_counter() - t0
            frames = [(inst, deg, k) for inst in fa_train.ids
                      for deg in fa_train._degree_dirs(inst) for k in range(FIT_ART_VIEWS)]
            for label in ("cold", "warm"):
                t0 = time.perf_counter()
                for inst, deg, k in frames:
                    fa_train._read_frame_cached(inst, deg, k)
                fa_loader_s[f"frame_ms_{label}"] = 1e3 * (time.perf_counter() - t0) / len(frames)
            items = fa_train.train_batches(seed=fa_cfg.seed)
            next(items)
            t0 = time.perf_counter()
            for _ in range(16):
                next(items)
            fa_loader_s["item_ms_warm"] = 1e3 * (time.perf_counter() - t0) / 16

            fa_test_ds = SapienDatasetMulti(fa_cfg.root_dir, "test_val", eval_inference="x",
                                            **ds_kw)
            n_test = len(fa_test_ds)
            test_chunks = sum(chunks_of(fa_test_ds.test_frame(i, seed=fa_cfg.seed), fa_cfg)
                              for i in range(n_test))
            per_inst_chunks = sum(chunks_of(fa_test_ds.test_frame(i, seed=fa_cfg.seed,
                                                                  instance=inst), fa_cfg)
                                  for inst in range(len(fa_test_ds.ids)) for i in range(n_test))
            sweep_ids = 2 * len(fa_test_ds._degree_dirs(fa_test_ds.ids[0])) - 1
            sweep_chunks = sweep_ids * chunks_of(
                dict(hit=fa_test_ds._read_frame(fa_test_ds.ids[0], "0_degree", 0)[5][0]), fa_cfg)

            fa = fit_run(fa_cfg, "results", args.seed + 11)
            fa_trainer, fa_params, fa_recs = fa["trainer"], fa["params"], fa["recs"]
            fa_launches, fa_val, fa_val_chunks = fa["launches"], fa["val"], fa["val_chunks"]
            fa_run_dir = fa_dir / "results" / fa_cfg.exp_name

            from torch.profiler import ProfilerActivity, profile

            it = fa_trainer._train_iterator()
            fa_trainer._dispatch(it, fa_cfg.steps_per_dispatch)  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(FIT_PROFILE_DISPATCHES):
                    fa_trainer.state, _ = fa_trainer._dispatch(it, fa_cfg.steps_per_dispatch)
                torch.cuda.synchronize()
                fa_window_ms = 1e3 * (time.perf_counter() - t0)
            fa_busy_ms = sum(e.device_time_total for e in prof.key_averages()
                             if e.device_type.name == "CUDA") / 1e3
            require(fa_busy_ms > 0, "torch.profiler recorded no device time in the fit_art loop")

            # resume: FIT_ART_RESUME_STEPS more steps from last.ckpt
            res_cfg = get_config(["--config", str(fa_cfg_path), "--ckpt_path", "last.ckpt"])
            res_cfg.run_max_steps = FIT_ART_STEPS + FIT_ART_RESUME_STEPS
            fa_restored, plain_restore = [], CheckpointManager.restore

            def fa_restore_spy(manager, state, name=None):
                out = plain_restore(manager, state, name)
                fa_restored.append((out.step, {k: v.detach().clone()
                                               for k, v in out.params.items()}))
                return out

            CheckpointManager.restore = fa_restore_spy
            try:
                fa_res_trainer, fa_res_wall_s, fa_res_launches, fa_res_out = run_cli(res_cfg)
            finally:
                CheckpointManager.restore = plain_restore
            fa_res_recs = [json.loads(ln) for ln in
                           (fa_run_dir / "metrics.jsonl").read_text().splitlines()][len(fa_recs):]
            fa_res_val = [r["val/psnr"] for r in fa_res_recs if "val/psnr" in r]

            # --run_eval: the 19-frame sweep
            ev_cfg = get_config(["--config", str(fa_cfg_path), "--run_eval",
                                 "--render_name", "smoke", "--ckpt_path", "last.ckpt"])
            _, fa_ev_wall_s, fa_ev_launches, _ = run_cli(ev_cfg)
            exp_dir = fa_dir / "ckpts" / fa_cfg.exp_name
            fa_results = json.loads((exp_dir / "results.json").read_text())
            images = sorted((exp_dir / "smoke").glob("image*.jpg"))
            video = sorted((exp_dir / "smoke" / "videos").iterdir())
            decoded = [read_jpeg(p) for p in images]

            def run_script(fn, argv):
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    out = fn(argv)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0, {k: c.launches for k, c in counters.items()}

            sweep, sweep_s, sweep_launches = run_script(render_sweep.main,
                                                        ["--config", str(fa_cfg_path)])
            sweep_files = sorted((exp_dir / "sweep").glob("sweep*.jpg"))
            per, per_s, per_launches = run_script(
                eval_per_instance.main, ["--config", str(fa_cfg_path), "--ckpt_path", "last.ckpt"])
            per_json = json.loads((exp_dir / "per_instance.json").read_text())
            fa_geo, fa_geo_s, fa_geo_launches = run_script(
                extract_geometry.main, ["--config", str(fa_cfg_path), "--out", "geometry_fit_art"])
            fa_gz = np.load(fa_dir / fa_geo["out_dir"] / "density_grid.npz")
            fa_bounds = scene_aabb(sorted(str(d) for d in data.glob("*/train/*_degree")),
                                   tuple(fa_cfg.img_wh), pad=fa_cfg.aabb_pad)

            fa_checks = {
                **fa["checks"],
                "resume_continues": (
                    f"resumed from step {FIT_ART_STEPS}" in fa_res_out
                    and fa_res_trainer.global_step == FIT_ART_STEPS + FIT_ART_RESUME_STEPS
                    and all(r["step"] > FIT_ART_STEPS for r in fa_res_recs)
                    and launches_are(
                        fa_res_launches,
                        fused_level_train_art_grads=art_steps * FIT_ART_RESUME_STEPS,
                        resample_union=ART_MICRO * FIT_ART_RESUME_STEPS + fa_val_chunks,
                        art_mlp_fwd=2 * fa_val_chunks,
                        threefry_uniform=art_steps * FIT_ART_RESUME_STEPS)),
                "resume_restores_params": (
                    len(fa_restored) == 1 and fa_restored[0][0] == FIT_ART_STEPS
                    and fa_restored[0][1].keys() == fa_params.keys()
                    and all(torch.equal(fa_restored[0][1][k], v) for k, v in fa_params.items())),
                "resume_val_psnr": (len(fa_res_val) == 1
                                    and fa_res_val[0] >= fa_val[0] - TOL_RESUME_PSNR_DROP),
                "test_launches": launches_are(fa_ev_launches, resample_union=test_chunks,
                                              art_mlp_fwd=2 * test_chunks),
                "results_json": all(math.isfinite(fa_results[k]["mean"])
                                    for k in ("PSNR", "SSIM", "PSNR_obj")),
                "test_files": (len(images) == n_test == 19
                               and all(d.shape == (240, 320, 3) for d in decoded)
                               and len(video) in (1, n_test)),
                "sweep": (len(sweep["frames"]) == len(sweep_files) == sweep_ids
                          and launches_are(sweep_launches, resample_union=sweep_chunks,
                                           art_mlp_fwd=2 * sweep_chunks)
                          and all(np.isfinite(f).all() for f in sweep["frames"])),
                "per_instance": (
                    per_json == json.loads(json.dumps(per))
                    and [r["instance"] for r in per_json["instances"]] == [0, 1]
                    and all(len(r["each"]) == n_test and math.isfinite(r["PSNR"])
                            for r in per_json["instances"])
                    and launches_are(per_launches, resample_union=per_inst_chunks,
                                     art_mlp_fwd=2 * per_inst_chunks)),
                "geometry_launches": launches_are(fa_geo_launches, art_mlp_fwd=fa_geo["queries"])
                                     and fa_geo["queries"] == math.ceil(GEO_RES ** 3 / GEO_CHUNK),
                "geometry_dataset_bounds": np.allclose(fa_gz["bounds"], fa_bounds),
            }
            fa_rec = {
                "phase": "fit_art", "config": FIT_ART_CONFIG,
                "fixture": {"wh": [320, 240], "instances": len(fa_train.ids), "degrees": 10,
                            "train_per_degree": FIT_ART_VIEWS, "test_spheric": "obj_a"},
                "steps": FIT_ART_STEPS, **fa["line"], "loader": fa_loader_s,
                "profile": {"dispatches": FIT_PROFILE_DISPATCHES, "window_ms": fa_window_ms,
                            "ms_per_step": fa_window_ms / (FIT_PROFILE_DISPATCHES
                                                           * fa_cfg.steps_per_dispatch),
                            "device_busy_ms": fa_busy_ms,
                            "device_idle_share": 1.0 - fa_busy_ms / fa_window_ms},
                "launches_per_step": {"fused_level_train_art_grads": art_steps,
                                      "resample_union": ART_MICRO},
                "test_chunks": test_chunks,
                "resume": {"wall_s": fa_res_wall_s, "val_psnr": fa_res_val,
                           "launches": {k: v for k, v in fa_res_launches.items() if v}},
                "eval": {"wall_s": fa_ev_wall_s,
                         **{k: fa_results[k]["mean"] for k in ("PSNR", "SSIM", "PSNR_obj")},
                         "jpgs": len(images), "video_files": len(video),
                         "launches": {k: v for k, v in fa_ev_launches.items() if v}},
                "sweep": {"seconds": sweep_s, "frames": len(sweep["frames"]),
                          "launches": {k: v for k, v in sweep_launches.items() if v}},
                "per_instance": {"seconds": per_s,
                                 "PSNR": [r["PSNR"] for r in per_json["instances"]],
                                 "launches": {k: v for k, v in per_launches.items() if v}},
                "geometry": {"seconds": fa_geo_s, "queries": fa_geo["queries"],
                             "occupied": fa_geo["occupied"], "bounds": fa_gz["bounds"].tolist(),
                             "launches": {k: v for k, v in fa_geo_launches.items() if v}},
                "checks": fa_checks, "card": card}
            emit(fa_rec)
            require(all(fa_checks.values()), f"fit_art checks failed: {fa_checks}")

            # the objover configuration on the same fixture: its own line
            phase = "fit_art_objover"
            _, ov_cfg = fit_config(FIT_OBJOVER_CONFIG, "results_objover", FIT_OBJOVER_STEPS,
                                   FIT_OBJOVER_STEPS, art_code_smoothness=FIT_OBJOVER_SMOOTHNESS)
            require((ov_cfg.N_samples, ov_cfg.N_importance, ov_cfg.use_aabb, ov_cfg.use_occgrid,
                     ov_cfg.obj_ray_oversample, ov_cfg.white_back, ov_cfg.ray_batch_size,
                     ov_cfg.microbatch_rays) == (64, 128, False, False, 0.5, False,
                                                 fa_cfg.ray_batch_size, fa_cfg.microbatch_rays),
                    f"{FIT_OBJOVER_CONFIG} no longer has the objover arguments")
            ov = fit_run(ov_cfg, "results_objover", args.seed + 12)
            ov_launches, ov_loss_w = ov["launches"], ov["item0"].get("loss_w")
            ov_reg = [r["train/loss/reg"] for r in ov["recs"] if "train/loss/reg" in r]
            ov_checks = {
                **ov["checks"],
                "items_carry_loss_w": (ov_loss_w is not None
                                       and ov_loss_w.shape == (ov_cfg.ray_batch_size,)
                                       and bool(np.isfinite(ov_loss_w).all())
                                       and float(ov_loss_w.min()) < 1.0 < float(ov_loss_w.max())),
                "smoothness_on": (ov["trainer"].cfg.art_code_smoothness == FIT_OBJOVER_SMOOTHNESS
                                  and len(ov_reg) > 0 and all(math.isfinite(r) for r in ov_reg)),
            }
            emit({
                "phase": "fit_art_objover", "config": FIT_OBJOVER_CONFIG,
                "overrides": {"art_code_smoothness": FIT_OBJOVER_SMOOTHNESS,
                              "run_max_steps": FIT_OBJOVER_STEPS},
                "fixture": "fit_art's", "steps": FIT_OBJOVER_STEPS, **ov["line"],
                "intervals": "raw", "obj_ray_oversample": ov_cfg.obj_ray_oversample,
                "loss_w": ({"min": float(ov_loss_w.min()), "max": float(ov_loss_w.max()),
                            "mean": float(ov_loss_w.mean())} if ov_loss_w is not None else None),
                "reg": ov_reg, "checks": ov_checks, "card": card})
            require(all(ov_checks.values()), f"fit_art_objover checks failed: {ov_checks}")
            del ov
            fit_art_path_launches = {
                k: fa_launches[k] + fa_res_launches[k] + fa_ev_launches[k] + sweep_launches[k]
                + per_launches[k] + fa_geo_launches[k] + ov_launches[k] for k in counters}
        finally:
            os.chdir(cwd)
            shutil.rmtree(fa_dir, ignore_errors=True)
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ fit_ae
        # The CLI's main path for the auto-encoder on its quality config
        # (ResNet-34 encoder on 320x240 source frames, 24 + 48 samples on
        # AABB intervals, 4,096 rays a step as two microbatches of 2,048,
        # softplus_bias sigma, opacity BCE 0.5) over the fit_art phase's
        # --multi fixture: FIT_AE_STEPS steps in dispatches of 8 and one
        # validation of five frames with the joint-state metrics, a resume,
        # --run_eval (the 19-frame sweep, each frame encoding its own image)
        # and an extraction with the dataset's bounds
        phase = "fit_ae"
        ae_dir = Path(tempfile.mkdtemp(prefix="aon_fit_ae_"))
        try:
            os.chdir(ae_dir)
            data = ae_dir / "data"
            with contextlib.redirect_stdout(io.StringIO()):
                make_fixture_dataset.main([str(data), "--multi", "--n", str(FIT_ART_VIEWS),
                                           "--wh", "320", "240", "--seed", str(args.seed)])
            shutil.copytree(data / "obj_a" / "train" / "0_degree", data / "obj_a" / "test_spheric")
            cfg_json = json.loads((ROOT / FIT_AE_CONFIG).read_text())
            # one epoch holds the run and its resume: one validation each
            cfg_json.update(root_dir=str(data), output_path=str(ae_dir / "results"),
                            run_max_steps=FIT_AE_STEPS,
                            samples_per_epoch=FIT_AE_STEPS + FIT_AE_RESUME_STEPS, num_epochs=1)
            ae_cfg_path = ae_dir / Path(FIT_AE_CONFIG).name
            ae_cfg_path.write_text(json.dumps(cfg_json))
            ae_run_cfg = get_config(["--config", str(ae_cfg_path)])
            require((ae_run_cfg.exp_type, ae_run_cfg.N_samples, ae_run_cfg.N_importance,
                     ae_run_cfg.ray_batch_size, ae_run_cfg.microbatch_rays,
                     ae_run_cfg.ae_sigma_activation, tuple(ae_run_cfg.img_wh))
                    == ("vanilla_ae_art", FIT_AE_COARSE, FIT_AE_FINE, ART_MICRO * TRAIN_RAYS,
                        TRAIN_RAYS, "softplus_bias", (320, 240)),
                    f"{FIT_AE_CONFIG} no longer has the kernel phase's auto-encoder shapes")
            ds_kw = dict(img_wh=tuple(ae_run_cfg.img_wh), use_aabb=ae_run_cfg.use_aabb,
                         aabb_pad=ae_run_cfg.aabb_pad, ray_batch_size=ae_run_cfg.ray_batch_size,
                         need_src_imgs=True)

            def chunks_of(frame):
                return math.ceil(int(np.asarray(frame["hit"]).sum()) / ae_run_cfg.chunk)

            ae_val_ds = SapienDatasetMulti(ae_run_cfg.root_dir, "val", **ds_kw)
            ae_val_frames = [ae_val_ds.val_frame(seed=ae_run_cfg.seed + i)
                             for i in range(min(ae_run_cfg.limit_val_batches, 5))]
            ae_val_chunks = sum(chunks_of(f) for f in ae_val_frames)
            ae_test_ds = SapienDatasetMulti(ae_run_cfg.root_dir, "test_val", eval_inference="x",
                                            **ds_kw)
            n_test = len(ae_test_ds)
            ae_test_chunks = sum(chunks_of(ae_test_ds.test_frame(i, seed=ae_run_cfg.seed))
                                 for i in range(n_test))

            ae_trainer, ae_wall_s, ae_launches, _ = run_cli(ae_run_cfg)
            ae_params = {k: v.detach().clone() for k, v in ae_trainer.state.params.items()}
            ae_run_dir = ae_dir / "results" / ae_run_cfg.exp_name
            ae_recs = [json.loads(ln) for ln in
                       (ae_run_dir / "metrics.jsonl").read_text().splitlines()]
            ae_rate = [r["train/rays_per_sec"] for r in ae_recs if "train/rays_per_sec" in r]
            ae_val = [r for r in ae_recs if "val/psnr" in r]
            ae_train_log = [{k: r[k] for k in ("step", "train/loss", "train/loss_state",
                                               "train/opacity_loss")}
                            for r in ae_recs if "train/loss" in r]

            # learning: the run's first dispatch of batches (8 steps' items,
            # 8 joint angles) with one fixed set of draws under the run's
            # initial weights and the fitted ones; the five val frames under
            # the initial weights
            def ae_fixed_batches(trainer, cfg):
                """The run's first dispatch of items, stacked as a step
                stacks them, each with its step's ramps."""
                it = trainer.train_dataset.train_batches(seed=cfg.seed)
                out = []
                for j in range(cfg.steps_per_dispatch):
                    b = next(it)
                    inject_ramps(cfg, b, j)
                    out.append({k: v[0] for k, v in stack_step_batches(
                        [b], microbatch=cfg.microbatch_rays, device=dev).items()})
                return out

            def ae_fixed_losses(trainer, batches, params):
                """The mean loss and joint-state loss over ``batches`` under
                one fixed set of draws."""
                out = []
                for b in batches:
                    loss, aux, _ = accumulated_grads(trainer.system.loss_fn, params, b,
                                                     prng.key(args.seed + 11))
                    out.append((loss.item(), aux["loss_state"].item()))
                return [float(np.mean([o[i] for o in out])) for i in (0, 1)]

            ae_batches = ae_fixed_batches(ae_trainer, ae_run_cfg)
            ae_init = ae_trainer.system.init_state(
                prng.split(prng.key(ae_run_cfg.seed))[1]).params
            (ae_loss_fresh, ae_state_fresh), (ae_loss_fitted, ae_state_fitted) = (
                ae_fixed_losses(ae_trainer, ae_batches, ae_init),
                ae_fixed_losses(ae_trainer, ae_batches, ae_params))
            ae_val_fresh = float(np.mean([eval_metrics.psnr(
                ae_trainer._render_full(ae_init, f)["comp_rgb"], f["target"])
                for f in ae_val_frames]))
            del ae_init

            # the encoder apart from the rest of the step: its forward (the
            # three heads, the joint state and the degree row) and its
            # backward from the latents' and the joint-state loss's cotangents,
            # per microbatch, on the fitted weights (cuDNN convolutions: no
            # kernel of the table)
            b0 = ae_batches[0]
            enc_params = {k: v.detach().requires_grad_(True) for k, v in ae_params.items()
                          if k.startswith(("encoder.", "joint_state.", "deg_embedding."))}
            src0 = b0["src_imgs"][None] if b0["src_imgs"].ndim == 3 else b0["src_imgs"]

            def enc_forward():
                with torch.enable_grad():
                    lat, pred = ae_trainer.system._encode(enc_params, src0, b0["deg"])
                    return lat, torch.mean((pred - b0["deg"]) ** 2)

            def enc_backward(lat, loss_state):
                torch.autograd.grad([lat[k] for k in lat] + [loss_state],
                                    list(enc_params.values()),
                                    grad_outputs=[torch.ones_like(lat[k]) for k in lat]
                                    + [torch.ones_like(loss_state)], allow_unused=True)

            enc_forward()  # warm
            fwd_ms, bwd_ms = [], []
            for _ in range(ENCODER_REPS):
                e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                e0.record()
                lat, ls = enc_forward()
                e1.record()
                enc_backward(lat, ls)
                e2.record()
                torch.cuda.synchronize()
                fwd_ms.append(e0.elapsed_time(e1))
                bwd_ms.append(e1.elapsed_time(e2))
            del enc_params, lat, ls

            from torch.profiler import ProfilerActivity, profile

            it = ae_trainer._train_iterator()
            ae_trainer._dispatch(it, ae_run_cfg.steps_per_dispatch)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()  # the same loop without the profiler
            for _ in range(FIT_PROFILE_DISPATCHES):
                ae_trainer.state, _ = ae_trainer._dispatch(it, ae_run_cfg.steps_per_dispatch)
            torch.cuda.synchronize()
            ae_loop_ms_per_step = 1e3 * (time.perf_counter() - t0) / (
                FIT_PROFILE_DISPATCHES * ae_run_cfg.steps_per_dispatch)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(FIT_PROFILE_DISPATCHES):
                    ae_trainer.state, _ = ae_trainer._dispatch(it, ae_run_cfg.steps_per_dispatch)
                torch.cuda.synchronize()
                ae_window_ms = 1e3 * (time.perf_counter() - t0)
            ae_by_kernel = sorted(((e.key, e.device_time_total / 1e3, e.count)
                                   for e in prof.key_averages()
                                   if e.device_time_total > 0 and e.device_type.name == "CUDA"),
                                  key=lambda r: -r[1])
            ae_busy_ms = sum(r[1] for r in ae_by_kernel)
            require(ae_busy_ms > 0, "torch.profiler recorded no device time in the fit_ae loop")
            ae_ms_per_step = ae_window_ms / (FIT_PROFILE_DISPATCHES
                                             * ae_run_cfg.steps_per_dispatch)

            # resume: FIT_AE_RESUME_STEPS more steps from last.ckpt
            res_cfg = get_config(["--config", str(ae_cfg_path), "--ckpt_path", "last.ckpt"])
            res_cfg.run_max_steps = FIT_AE_STEPS + FIT_AE_RESUME_STEPS
            ae_restored, plain_restore = [], CheckpointManager.restore

            def ae_restore_spy(manager, state, name=None):
                out = plain_restore(manager, state, name)
                ae_restored.append((out.step, {k: v.detach().clone()
                                               for k, v in out.params.items()}))
                return out

            CheckpointManager.restore = ae_restore_spy
            try:
                ae_res_trainer, ae_res_wall_s, ae_res_launches, ae_res_out = run_cli(res_cfg)
            finally:
                CheckpointManager.restore = plain_restore
            ae_res_recs = [json.loads(ln) for ln in
                           (ae_run_dir / "metrics.jsonl").read_text().splitlines()][len(ae_recs):]
            ae_res_val = [r["val/psnr"] for r in ae_res_recs if "val/psnr" in r]

            # --run_eval: the 19-frame sweep
            ev_cfg = get_config(["--config", str(ae_cfg_path), "--run_eval",
                                 "--render_name", "smoke", "--ckpt_path", "last.ckpt"])
            _, ae_ev_wall_s, ae_ev_launches, _ = run_cli(ev_cfg)
            exp_dir = ae_dir / "ckpts" / ae_run_cfg.exp_name
            ae_results = json.loads((exp_dir / "results.json").read_text())
            images = sorted((exp_dir / "smoke").glob("image*.jpg"))
            decoded = [read_jpeg(p) for p in images]

            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                ae_geo = extract_geometry.main(["--config", str(ae_cfg_path), "--out",
                                                "geometry_fit_ae", "--instance", "1",
                                                "--articulation", "4"])
            torch.cuda.synchronize()
            ae_geo_s = time.perf_counter() - t0
            ae_geo_launches = {k: c.launches for k, c in counters.items()}
            ae_gz = np.load(ae_dir / ae_geo["out_dir"] / "density_grid.npz")
            ae_bounds = scene_aabb(sorted(str(d) for d in data.glob("*/train/*_degree")),
                                   tuple(ae_run_cfg.img_wh), pad=ae_run_cfg.aabb_pad)

            art_steps = 2 * ART_MICRO  # row 9 per step: two levels per microbatch
            val_keys = ("val/psnr", "val/psnr_obj", "val/state_error_rad",
                        "val/abs_state_error_deg")
            ae_checks = {
                "launches": launches_are(
                    ae_launches, fused_level_train_art_grads=art_steps * FIT_AE_STEPS,
                    resample_union=ART_MICRO * FIT_AE_STEPS + ae_val_chunks,
                    art_mlp_fwd=2 * ae_val_chunks, threefry_uniform=art_steps * FIT_AE_STEPS),
                "loss_falls": ae_loss_fitted < FIT_AE_LOSS_FALL * ae_loss_fresh,
                "loss_state_falls": ae_state_fitted < ae_state_fresh,
                "val_psnr_rises": len(ae_val) == 1 and ae_val[0]["val/psnr"] > ae_val_fresh,
                "val_state_metrics": len(ae_val) == 1 and all(
                    math.isfinite(ae_val[0].get(k, math.nan)) for k in val_keys),
                "resume_continues": (
                    f"resumed from step {FIT_AE_STEPS}" in ae_res_out
                    and ae_res_trainer.global_step == FIT_AE_STEPS + FIT_AE_RESUME_STEPS
                    and all(r["step"] > FIT_AE_STEPS for r in ae_res_recs)
                    and launches_are(
                        ae_res_launches,
                        fused_level_train_art_grads=art_steps * FIT_AE_RESUME_STEPS,
                        resample_union=ART_MICRO * FIT_AE_RESUME_STEPS + ae_val_chunks,
                        art_mlp_fwd=2 * ae_val_chunks,
                        threefry_uniform=art_steps * FIT_AE_RESUME_STEPS)),
                "resume_restores_params": (
                    len(ae_restored) == 1 and ae_restored[0][0] == FIT_AE_STEPS
                    and ae_restored[0][1].keys() == ae_params.keys()
                    and any(k.startswith("encoder.") for k in ae_params)
                    and all(torch.equal(ae_restored[0][1][k], v) for k, v in ae_params.items())),
                "resume_val_psnr": (len(ae_res_val) == 1 and ae_res_val[0]
                                    >= ae_val[0]["val/psnr"] - TOL_RESUME_PSNR_DROP),
                "test_launches": launches_are(ae_ev_launches, resample_union=ae_test_chunks,
                                              art_mlp_fwd=2 * ae_test_chunks),
                "results_json": all(math.isfinite(ae_results[k]["mean"])
                                    for k in ("PSNR", "SSIM", "PSNR_obj")),
                "test_files": (len(images) == n_test == 19
                               and all(d.shape == (240, 320, 3) for d in decoded)),
                "geometry_launches": (
                    launches_are(ae_geo_launches, art_mlp_fwd=ae_geo["queries"])
                    and ae_geo["queries"] == math.ceil(GEO_RES ** 3 / GEO_CHUNK)
                    and geometry_files_ok(ae_dir / ae_geo["out_dir"], ae_geo)),
                "geometry_dataset_bounds": np.allclose(ae_gz["bounds"], ae_bounds),
            }
            enc_fwd, enc_bwd = statistics.median(fwd_ms), statistics.median(bwd_ms)
            ae_rec = {
                "phase": "fit_ae", "config": FIT_AE_CONFIG,
                "fixture": {"wh": [320, 240], "instances": 2, "degrees": 10,
                            "train_per_degree": FIT_ART_VIEWS, "test_spheric": "obj_a"},
                "steps": FIT_AE_STEPS, "steps_per_dispatch": ae_run_cfg.steps_per_dispatch,
                "rays_per_step": ae_run_cfg.ray_batch_size,
                "microbatch_rays": ae_run_cfg.microbatch_rays,
                "samples": [ae_run_cfg.N_samples, ae_run_cfg.N_importance],
                "sigma_activation": ae_run_cfg.ae_sigma_activation, "wall_s": ae_wall_s,
                "rays_per_sec": ae_rate,
                "ms_per_step": [1e3 * ae_run_cfg.ray_batch_size / r for r in ae_rate],
                "profile": {"dispatches": FIT_PROFILE_DISPATCHES, "window_ms": ae_window_ms,
                            "ms_per_step": ae_ms_per_step, "device_busy_ms": ae_busy_ms,
                            "device_idle_share": 1.0 - ae_busy_ms / ae_window_ms,
                            "ms_per_step_by_kernel": [
                                {"kernel": k[:80], "ms": ms / (FIT_PROFILE_DISPATCHES
                                                             * ae_run_cfg.steps_per_dispatch),
                                 "launches": n} for k, ms, n in ae_by_kernel[:15]]},
                "encoder": {"forward_ms": enc_fwd, "backward_ms": enc_bwd,
                            "per_microbatch_ms": enc_fwd + enc_bwd,
                            "loop_ms_per_step": ae_loop_ms_per_step,
                            "share_of_step": ART_MICRO * (enc_fwd + enc_bwd) / ae_loop_ms_per_step,
                            "reps": ENCODER_REPS,
                            "is": "cuDNN and PyTorch ops, median of CUDA-event pairs (the "
                                  "host's launches included: the device waits on them); "
                                  "loop_ms_per_step: the fit loop's dispatches without the "
                                  "profiler; no kernel of the table"},
                "launches": {k: v for k, v in ae_launches.items() if v},
                "launches_per_step": {"fused_level_train_art_grads": art_steps,
                                      "resample_union": ART_MICRO},
                "val_chunks": ae_val_chunks, "test_chunks": ae_test_chunks,
                "fixed_batches_loss": {"batches": len(ae_batches),
                                       "initial_weights": ae_loss_fresh,
                                       "fitted": ae_loss_fitted,
                                       "ratio": ae_loss_fitted / ae_loss_fresh,
                                       "fall": FIT_AE_LOSS_FALL,
                                       "loss_state_initial_weights": ae_state_fresh,
                                       "loss_state_fitted": ae_state_fitted},
                "train_log": ae_train_log,
                "val": [{k: r.get(k) for k in val_keys} for r in ae_val],
                "val_psnr_initial_weights": ae_val_fresh,
                "resume": {"wall_s": ae_res_wall_s, "val_psnr": ae_res_val,
                           "launches": {k: v for k, v in ae_res_launches.items() if v}},
                "eval": {"wall_s": ae_ev_wall_s,
                         **{k: ae_results[k]["mean"] for k in ("PSNR", "SSIM", "PSNR_obj")},
                         "jpgs": len(images),
                         "launches": {k: v for k, v in ae_ev_launches.items() if v}},
                "geometry": {"seconds": ae_geo_s, "queries": ae_geo["queries"],
                             "occupied": ae_geo["occupied"], "bounds": ae_gz["bounds"].tolist(),
                             "launches": {k: v for k, v in ae_geo_launches.items() if v}},
                "checks": ae_checks, "card": card}
            emit(ae_rec)
            require(all(ae_checks.values()), f"fit_ae checks failed: {ae_checks}")
            fit_ae_path_launches = {
                k: ae_launches[k] + ae_res_launches[k] + ae_ev_launches[k] + ae_geo_launches[k]
                for k in counters}
            del ae_trainer, ae_res_trainer, ae_params, ae_batches
            torch.cuda.empty_cache()

            # the auto-encoder's own config on the same fixture: 64 + 128
            # samples on raw intervals, relu sigma; a fit and its validation
            phase = "fit_ae_raw"
            raw_json = json.loads((ROOT / FIT_AE_RAW_CONFIG).read_text())
            raw_json.update(root_dir=str(data), output_path=str(ae_dir / "results_raw"),
                            run_max_steps=FIT_AE_RAW_STEPS, samples_per_epoch=FIT_AE_RAW_STEPS,
                            num_epochs=1)
            raw_cfg_path = ae_dir / Path(FIT_AE_RAW_CONFIG).name
            raw_cfg_path.write_text(json.dumps(raw_json))
            raw_cfg = get_config(["--config", str(raw_cfg_path)])
            require((raw_cfg.exp_type, raw_cfg.N_samples, raw_cfg.N_importance, raw_cfg.use_aabb,
                     raw_cfg.ae_sigma_activation, raw_cfg.ray_batch_size,
                     raw_cfg.microbatch_rays, tuple(raw_cfg.img_wh))
                    == ("vanilla_ae_art", N_COARSE, N_FINE, False, "relu",
                        ART_MICRO * TRAIN_RAYS, TRAIN_RAYS, (320, 240)),
                    f"{FIT_AE_RAW_CONFIG} no longer has the raw auto-encoder's arguments")
            # raw intervals: a val frame renders every pixel
            raw_val_chunks = min(raw_cfg.limit_val_batches, 5) * math.ceil(
                raw_cfg.img_wh[0] * raw_cfg.img_wh[1] / raw_cfg.chunk)
            raw_trainer, raw_wall_s, raw_launches, _ = run_cli(raw_cfg)
            raw_params = {k: v.detach().clone() for k, v in raw_trainer.state.params.items()}
            raw_recs = [json.loads(ln) for ln in (ae_dir / "results_raw" / raw_cfg.exp_name
                                                  / "metrics.jsonl").read_text().splitlines()]
            raw_rate = [r["train/rays_per_sec"] for r in raw_recs if "train/rays_per_sec" in r]
            raw_val = [r for r in raw_recs if "val/psnr" in r]
            raw_batches = ae_fixed_batches(raw_trainer, raw_cfg)
            raw_init = raw_trainer.system.init_state(
                prng.split(prng.key(raw_cfg.seed))[1]).params
            (raw_loss_fresh, raw_state_fresh), (raw_loss_fitted, raw_state_fitted) = (
                ae_fixed_losses(raw_trainer, raw_batches, raw_init),
                ae_fixed_losses(raw_trainer, raw_batches, raw_params))
            del raw_init
            raw_checks = {
                "launches": launches_are(
                    raw_launches, fused_level_train_art_grads=art_steps * FIT_AE_RAW_STEPS,
                    resample_union=ART_MICRO * FIT_AE_RAW_STEPS + raw_val_chunks,
                    art_mlp_fwd=2 * raw_val_chunks,
                    threefry_uniform=art_steps * FIT_AE_RAW_STEPS),
                "raw_intervals": "t_near" not in raw_batches[0],
                "loss_falls": raw_loss_fitted < FIT_AE_LOSS_FALL * raw_loss_fresh,
                "loss_state_falls": raw_state_fitted < raw_state_fresh,
                "val_finite": len(raw_val) == 1 and math.isfinite(raw_val[0]["val/psnr"]),
                "val_state_metrics": len(raw_val) == 1 and all(
                    math.isfinite(raw_val[0].get(k, math.nan)) for k in val_keys),
            }
            emit({
                "phase": "fit_ae_raw", "config": FIT_AE_RAW_CONFIG,
                "overrides": {"run_max_steps": FIT_AE_RAW_STEPS}, "fixture": "fit_ae's",
                "steps": FIT_AE_RAW_STEPS, "steps_per_dispatch": raw_cfg.steps_per_dispatch,
                "rays_per_step": raw_cfg.ray_batch_size,
                "microbatch_rays": raw_cfg.microbatch_rays,
                "samples": [raw_cfg.N_samples, raw_cfg.N_importance], "intervals": "raw",
                "sigma_activation": raw_cfg.ae_sigma_activation, "wall_s": raw_wall_s,
                "rays_per_sec": raw_rate,
                "ms_per_step": [1e3 * raw_cfg.ray_batch_size / r for r in raw_rate],
                "launches": {k: v for k, v in raw_launches.items() if v},
                "val_chunks": raw_val_chunks,
                "fixed_batches_loss": {"batches": len(raw_batches),
                                       "initial_weights": raw_loss_fresh,
                                       "fitted": raw_loss_fitted,
                                       "ratio": raw_loss_fitted / raw_loss_fresh,
                                       "fall": FIT_AE_LOSS_FALL,
                                       "loss_state_initial_weights": raw_state_fresh,
                                       "loss_state_fitted": raw_state_fitted},
                "val": [{k: r.get(k) for k in val_keys} for r in raw_val],
                "checks": raw_checks, "card": card})
            require(all(raw_checks.values()), f"fit_ae_raw checks failed: {raw_checks}")
            fit_ae_raw_launches = raw_launches
            del raw_trainer, raw_params, raw_batches
        finally:
            os.chdir(cwd)
            shutil.rmtree(ae_dir, ignore_errors=True)
        torch.cuda.empty_cache()

        # ------------------------------------------------------------- lpips
        # VGG16-LPIPS (aon_tpu_torch/eval/lpips.py: cuDNN convolutions in
        # float32, TF32 off) of two 640x480 frames on the card, on the
        # synthetic weights of the fit phase, against the same module on the
        # CPU; ms per frame pair, host copies included, as Trainer.test calls it
        phase = "lpips"
        from aon_tpu_torch.eval import lpips as port_lpips

        lp_rng = np.random.default_rng(args.seed + 1301)
        yy, xx = np.mgrid[0:LPIPS_WH[1], 0:LPIPS_WH[0]] / float(LPIPS_WH[1])
        lp_pred = np.stack([0.5 + 0.5 * np.sin(3 * xx + c) * np.cos(2 * yy - c)
                            for c in (0.0, 1.0, 2.0)], -1).astype(np.float32)
        lp_gt = np.clip(lp_pred + lp_rng.normal(0, 0.05, lp_pred.shape), 0, 1).astype(np.float32)
        lp_card, lp_cpu = port_lpips.lpips_fn(dev), port_lpips.lpips_fn("cpu")
        lp_got, lp_want = float(lp_card(lp_pred, lp_gt)), float(lp_cpu(lp_pred, lp_gt))
        lp_ms = time_ms(torch, lambda: lp_card(lp_pred, lp_gt), reps=LPIPS_REPS)
        lp_rel = abs(lp_got - lp_want) / abs(lp_want)
        emit({"phase": "lpips", "wh": list(LPIPS_WH), "weights": port_lpips.lpips_weights_kind(),
              "lpips": lp_got, "lpips_cpu": lp_want, "rel_err": lp_rel, "tol_rel": TOL_LPIPS_REL,
              "ms_per_frame": lp_ms, "card": card})
        require(port_lpips.lpips_weights_kind() == "synthetic" and math.isfinite(lp_got)
                and lp_rel <= TOL_LPIPS_REL, "LPIPS on the card disagrees with the CPU's")
        del lp_card, lp_cpu
        # configs/lpips_synth_demo.json through the CLI on its own fixture
        # (the port's make_fixture_dataset at its defaults): fit, then
        # --run_eval, whose results.json carries LPIPS beside its label
        demo_dir = Path(tempfile.mkdtemp(prefix="aon_lpips_demo_"))
        try:
            os.chdir(demo_dir)
            with contextlib.redirect_stdout(io.StringIO()):
                make_fixture_dataset.main([str(demo_dir / "data")])
                demo_json = json.loads((ROOT / LPIPS_DEMO_CONFIG).read_text())
                demo_json.update(root_dir=str(demo_dir / "data"))
                (demo_dir / "cfg.json").write_text(json.dumps(demo_json))
                port_run.main(get_config(["--config", str(demo_dir / "cfg.json")]), device=dev)
                port_run.main(get_config(["--config", str(demo_dir / "cfg.json"), "--run_eval",
                                          "--render_name", "demo"]), device=dev)
            demo_res = json.loads((demo_dir / "ckpts" / demo_json["exp_name"] /
                                   "results.json").read_text())
        finally:
            os.chdir(cwd)
            shutil.rmtree(demo_dir, ignore_errors=True)
        emit({"phase": "lpips", "config": LPIPS_DEMO_CONFIG,
              "results": {k: (v["mean"] if isinstance(v, dict) else v) for k, v in demo_res.items()},
              "card": card})
        require(demo_res.get("lpips_weights") == "synthetic"
                and math.isfinite(demo_res["LPIPS"]["mean"]),
                f"{LPIPS_DEMO_CONFIG} through the CLI reported no LPIPS")
        torch.cuda.empty_cache()

        # ------------------------------------------------------------- optim
        # The optimizer factories (aon_tpu_torch/train/optim.py): radam with a
        # cosine schedule and a warmup, OPTIM_STEPS updates of the vanilla
        # MLPs' tensors on the card against the same updates on the CPU; then
        # OPTIM_FIT_STEPS steps of the CLI with that optimizer on a 320x240
        # fixture, whose logged loss falls
        phase = "optim"
        from aon_tpu_torch.train import optim as port_optim

        og = torch.Generator().manual_seed(args.seed + 1302)
        o_cfg = get_config(["--config", str(ROOT / FIT_CONFIG)])
        o_params = seeded_params(VanillaSystem(o_cfg, 2.0, 6.0, True, device="cpu"), og)
        o_grads = [{k: 1e-3 * torch.randn(v.shape, generator=og) for k, v in o_params.items()}
                   for _ in range(OPTIM_STEPS)]
        o_sched = port_optim.get_scheduler(5e-4, "cosine", 8, 10, warmup_epochs=1,
                                           warmup_multiplier=2.0)
        o_tx = port_optim.get_optimizer("radam", schedule=o_sched)
        o_state = {}
        for where in ("cpu", dev):
            p = {k: v.to(where) for k, v in o_params.items()}
            mu, nu = o_tx.init(p)
            for step, gr in enumerate(o_grads):
                p, mu, nu = o_tx.update(p, {k: v.to(where) for k, v in gr.items()}, mu, nu, step)
            o_state[str(where)] = {k: v.cpu() for k, v in p.items()}
        o_diff = max((o_state[str(dev)][k] - v).abs().max().item()
                     for k, v in o_state["cpu"].items())
        o_ulp = torch.finfo(torch.float32).eps * max(v.abs().max().item()
                                                      for v in o_state["cpu"].values())
        o_moved = max((v - o_params[k]).abs().max().item() for k, v in o_state["cpu"].items())

        o_dir = Path(tempfile.mkdtemp(prefix="aon_optim_"))
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                make_fixture_dataset.main([str(o_dir / "data"), "--n", "3", "--wh", "320",
                                           "240", "--seed", str(args.seed + 1302)])
            cfg_json = json.loads((ROOT / FIT_CONFIG).read_text())
            cfg_json.update(root_dir=str(o_dir / "data"), output_path=str(o_dir / "results"),
                            img_wh=[320, 240], run_max_steps=OPTIM_FIT_STEPS, num_epochs=8,
                            limit_val_batches=1, log_every_n_steps=8, optimizer="radam",
                            lr_scheduler="cosine", warmup_epochs=1, warmup_multiplier=2.0)
            (o_dir / "cfg.json").write_text(json.dumps(cfg_json))
            o_run_cfg = get_config(["--config", str(o_dir / "cfg.json")])
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                o_trainer = port_run.main(o_run_cfg, device=dev)
            o_wall = time.perf_counter() - t0
            optim_launches = {k: c.launches for k, c in counters.items()}
            o_recs = [json.loads(ln) for ln in (o_dir / "results" / o_run_cfg.exp_name /
                                                "metrics.jsonl").read_text().splitlines()]
        finally:
            shutil.rmtree(o_dir, ignore_errors=True)
        o_losses = [r["train/loss"] for r in o_recs if "train/loss" in r]
        o_first, o_last = float(np.mean(o_losses[:5])), float(np.mean(o_losses[-5:]))
        o_checks = {
            "card_matches_cpu": o_diff <= OPTIM_STEPS * o_ulp and o_moved > 0,
            "fit_is_radam": type(o_trainer.system.tx) is port_optim.RAdam
                            and o_trainer.global_step == OPTIM_FIT_STEPS,
            "fit_loss_falls": len(o_losses) >= 10 and o_last < OPTIM_FIT_LOSS_FALL * o_first,
            "fit_launches": optim_launches["fused_level_train_grads"] == 2 * OPTIM_FIT_STEPS,
        }
        emit({"phase": "optim", "optimizer": "radam", "scheduler": "cosine", "warmup_epochs": 1,
              "updates": OPTIM_STEPS, "max_abs_diff": o_diff, "ulp": o_ulp, "moved": o_moved,
              "fit": {"config": FIT_CONFIG, "steps": OPTIM_FIT_STEPS, "wall_s": o_wall,
                      "loss_first5": o_first, "loss_last5": o_last,
                      "fall": OPTIM_FIT_LOSS_FALL, "lr_first": o_trainer.system.lr_schedule(0),
                      "launches": {k: v for k, v in optim_launches.items() if v}},
              "checks": o_checks, "card": card})
        require(all(o_checks.values()), f"optim checks failed: {o_checks}")
        del o_trainer
        torch.cuda.empty_cache()

        # ---------------------------------------------------------------- dp
        # Data parallelism (aon_tpu_torch/parallel/, make_train_many_sharded):
        # FIT_CONFIG's and FIT_AE_CONFIG's full step at their batch and samples
        # through multihost_train_demo, one step compared and DP_TIMED_STEPS
        # timed, on 1 rank over NCCL and on 2 ranks of this card over gloo,
        # against one process; then a 640x480 frame of FIT_CONFIG rendered by
        # each rank's block and gathered (multihost_eval_demo) against one
        # process's.  Each rank is a process of its own (a worker below),
        # with this process's float32 settings (no TF32: the encoder's
        # convolutions would otherwise round otherwise than the reference's).
        phase = "dp"
        dp_dir = Path(tempfile.mkdtemp(prefix="aon_dp_"))
        dp_worker = (
            "import sys, torch, torch.distributed as dist\n"
            "torch.backends.cuda.matmul.allow_tf32 = False  # as in this process\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from aon_tpu_torch.parallel.mesh import RENDEZVOUS_TIMEOUT\n"
            "from aon_tpu_torch.scripts import multihost_eval_demo, multihost_train_demo\n"
            "rank, world, backend, port, out = sys.argv[1:6]\n"
            "dist.init_process_group(backend, init_method=f'tcp://localhost:{port}',\n"
            "                        world_size=int(world), rank=int(rank),\n"
            "                        timeout=RENDEZVOUS_TIMEOUT)\n"
            "common = ['--num_processes', world, '--process_id', rank, '--backend', backend,\n"
            "          '--device', 'cuda:0']\n"
            "for system, cfg, timed in (\n"
            f"        ('vanilla', {str(ROOT / FIT_CONFIG)!r}, {DP_TIMED_STEPS['vanilla']}),\n"
            f"        ('ae', {str(ROOT / FIT_AE_CONFIG)!r}, {DP_TIMED_STEPS['ae']})):\n"
            "    multihost_train_demo.main(common + ['--system', system, '--config', cfg,\n"
            "        '--steps', '1', '--timed_steps', str(timed),\n"
            "        '--out', f'{out}/{system}_{backend}{world}_r{rank}.npz'])\n"
            f"multihost_eval_demo.main(common + ['--config', {str(ROOT / FIT_CONFIG)!r},\n"
            f"    '--wh', '{LPIPS_WH[0]}', '{LPIPS_WH[1]}', '--chunk', '{CHUNK_RAYS}',\n"
            "    '--out', f'{out}/frame_{backend}{world}_r{rank}.npz'])\n"
            "dist.destroy_process_group()\n")

        def dp_ranks(backend, world):
            """Run the worker as ``world`` ranks side by side; kill any left
            at the timeout."""
            import socket

            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            procs = [subprocess.Popen([sys.executable, "-c", dp_worker, str(r), str(world),
                                       backend, str(port), str(dp_dir)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                     for r in range(world)]
            errs = []
            try:
                for proc in procs:
                    errs.append(proc.communicate(timeout=DP_TIMEOUT)[1])
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.communicate()
            for proc, err in zip(procs, errs):
                require(proc.returncode == 0, f"a {backend} rank of {world} failed: {err[-3000:]}")

        try:
            t0 = time.perf_counter()
            dp_ranks("nccl", 1)
            dp_ranks("gloo", 2)
            dp_ranks_s = time.perf_counter() - t0
            # one process, here: the reference, and the dp path's launches
            for c in counters.values():
                c.launches = 0
            dp_ref = {}
            with contextlib.redirect_stdout(io.StringIO()):
                # dp_system, not system: the sweep's checks below still use the
                # vanilla system built at the start
                for dp_system, cfg_path in (("vanilla", FIT_CONFIG), ("ae", FIT_AE_CONFIG)):
                    multihost_train_demo.main([
                        "--system", dp_system, "--config", str(ROOT / cfg_path), "--steps", "1",
                        "--timed_steps", str(DP_TIMED_STEPS[dp_system]), "--device", "cuda:0",
                        "--out", str(dp_dir / f"{dp_system}_single.npz")])
                multihost_eval_demo.main([
                    "--config", str(ROOT / FIT_CONFIG), "--wh", str(LPIPS_WH[0]),
                    str(LPIPS_WH[1]), "--chunk", str(CHUNK_RAYS), "--device", "cuda:0",
                    "--out", str(dp_dir / "frame_single.npz")])
            dp_launches = {k: c.launches for k, c in counters.items()}
            dp_rec, dp_checks = {}, {}
            for dp_system, cfg_path in (("vanilla", FIT_CONFIG), ("ae", FIT_AE_CONFIG)):
                want = np.load(dp_dir / f"{dp_system}_single.npz")
                lr0 = port_optim.make_optimizer(get_config(["--config", str(ROOT / cfg_path)]))[1](0)
                runs = {"single": {"ms_per_step": 1e3 * float(np.median(want["timed_step_seconds"])),
                                   "device_idle_share": float(want["device_idle_share"]),
                                   "loss": float(want["loss"])}}
                # a flipped step lands 2 lr away, up to the rounding of each sum
                flip_ulps = 2.0 * np.finfo(np.float32).eps * np.abs(want["params"])
                for label, world in (("nccl1", 1), ("gloo2", 2)):
                    ranks = [np.load(dp_dir / f"{dp_system}_{label}_r{r}.npz") for r in range(world)]
                    diff = np.abs(ranks[0]["params"] - want["params"])
                    loss_rel = abs(float(ranks[0]["loss"]) - float(want["loss"])) / float(want["loss"])
                    runs[label] = {
                        "loss": float(ranks[0]["loss"]), "loss_rel_err": loss_rel,
                        "params_max_diff": float(diff.max()), "params_mean_diff": float(diff.mean()),
                        "ms_per_step": [1e3 * float(np.median(r["timed_step_seconds"]))
                                        for r in ranks],
                        "device_idle_share": [float(r["device_idle_share"]) for r in ranks]}
                    dp_checks[f"{dp_system}_{label}"] = bool(
                        all(int(r["processes"]) == world for r in ranks)
                        and all(np.array_equal(r["params"], ranks[0]["params"]) for r in ranks)
                        and loss_rel <= TOL_DP_LOSS and np.all(diff <= 2.0 * lr0 + flip_ulps)
                        and diff.mean() <= DP_PARAMS_MEAN_LR * lr0)
                dp_rec[dp_system] = {"config": cfg_path, "lr0": lr0, **runs}
            frame_want = np.load(dp_dir / "frame_single.npz")
            frame_err = {}
            for label, world in (("nccl1", 1), ("gloo2", 2)):
                for r in range(world):
                    got = np.load(dp_dir / f"frame_{label}_r{r}.npz")
                    frame_err[f"{label}_r{r}"] = max(float(np.abs(got[k] - frame_want[k]).max())
                                                     for k in frame_want.files)
            dp_checks["frame_gather"] = (frame_want["comp_rgb"].shape == (LPIPS_WH[1], LPIPS_WH[0], 3)
                                         and max(frame_err.values()) <= TOL_DP_FRAME)
        finally:
            shutil.rmtree(dp_dir, ignore_errors=True)
        emit({"phase": "dp", **dp_rec, "frame": {"wh": list(LPIPS_WH), "max_abs_err": frame_err,
                                                  "tol": TOL_DP_FRAME},
              "ranks_wall_s": dp_ranks_s, "tol_loss": TOL_DP_LOSS,
              "params_mean_lr": DP_PARAMS_MEAN_LR,
              "launches": {k: v for k, v in dp_launches.items() if v},
              "checks": dp_checks, "card": card})
        require(all(dp_checks.values()), f"dp checks failed: {dp_checks}")
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
            """Launches of the bench's dispatches: per step, two levels, a
            resample and two threefry draws per microbatch."""
            want = {}
            calls = port_bench.WARMUP_DISPATCHES + port_bench.TIMED_DISPATCHES
            for system, level in (("vanilla", "fused_level_train_grads"),
                                  ("autodecoder", "fused_level_train_art_grads"),
                                  ("ae", "fused_level_train_art_grads")):
                if system in res:
                    r = res[system]
                    micro = calls * r["steps_per_dispatch"] * r["rays_per_step"] // r["microbatch"]
                    want[level] = want.get(level, 0) + 2 * micro
                    want["resample_union"] = want.get("resample_union", 0) + micro
                    want["threefry_uniform"] = want.get("threefry_uniform", 0) + 2 * micro
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
                params0 = seeded_params(routes["v3"], g)
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
                    for ln in bench_runs["production"][1] + bench_runs["reference_contract"][1]),
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

        def sweep_line(seed, art, shapes, occ8, interval):
            """What one seed's checks read: per gradient check the two
            measures and the worst tensor, and the deformation's direction and
            size; the interval first step's errors and cosines."""
            grad_recs = {**{f"{k}/{m or 'cotangent'}/{n}": r for (k, m, n), r in art.items()
                            if k != "art_mlp_fwd"},
                         **{f"{k}/{label}/{n}": r
                            for label, recs in (("bench", shapes), ("occ8", occ8))
                            for (k, n), r in recs.items() if k != "resample_union"}}
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
                "resample_max_abs_err": max(r["max_abs_err"]
                                            for r in (*shapes.values(), *occ8.values())
                                            if r["name"] == "resample_union"),
                "interval": {
                    name: {r: {k: cmp[k] for k in ("loss_rel", "grad_max_rel", "grad_mean_rel",
                                                     "cos", "cos_by_code_table") if k in cmp}
                           for r, cmp in (("v3", rec), ("plain_bf16", rec["plain_bf16_vs_plain"]))}
                    for name, rec in interval.items()},
                "card": card}

        sweep, failed = [], []
        if args.seeds > 1:
            sweep.append(sweep_line(args.seed, art_train0, bench_shape_rows, occ8_rows,
                                    interval_first))
        for seed in range(args.seed + 1, args.seed + args.seeds):
            art, shapes, occ8 = (art_train_checks(seed, timed=False, strict=False),
                                 bench_shape_checks(seed, timed=False, strict=False),
                                 bench_shape_checks(seed, timed=False, strict=False,
                                                    contracts=(occ8_contract,),
                                                    label="occ8 config"))
            interval = interval_first_step(seed)
            sweep.append(sweep_line(seed, art, shapes, occ8, interval))
            emit(sweep[-1])
            failed += [f"seed {seed}: {r['name']} {r.get('arguments', {}).get('mode', '')} "
                       f"{r.get('contract', '')} {r['shape']}"
                       for r in (*art.values(), *shapes.values(), *occ8.values())
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
                        state, _ = sy.train_step(state, batch_fn(g, i),
                                                 prng.fold_in(prng.key(args.seed + 4), i))
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

        # ----------------------------------------------------------- scripts
        # The port's last scripts on the card, each through its main(): the
        # eval bench's reference contract at its four chunks and its
        # production mode on the fit config over a fixture like the fit
        # phase's; the articulated bench at v3 and v2; the auto-encoder's host
        # profile and device split on the fit_ae config over a fixture like
        # that phase's; the analytic sphere on the card against the CPU under
        # the same draws; the ground-truth ceiling of a lo/hi pair written
        # here; the camera plot of the fit fixture.  Inputs from a generator
        # of its own.  One line each, and the launches of rows 1, 2, 9, 10, 11
        phase = "scripts"
        from aon_tpu_torch.scripts import (
            analyze_gt_ceiling,
            bench_art,
            bench_eval,
            demo_sphere,
            profile_ae_host,
            roofline_ae,
            visualize_cameras,
        )
        from aon_tpu_torch.utils.imageio import read_png, write_png

        sc_gen = np.random.default_rng(args.seed + 14)
        scripts_launches = {k: 0 for k in counters}
        sc_dir = Path(tempfile.mkdtemp(prefix="aon_scripts_"))
        cwd = os.getcwd()

        def run_script(label, fn):
            """``fn()`` with its prints kept aside: (its result, its stdout lines,
            wall seconds, its launches by kernel), the launches also summed
            for the kernels line."""
            for c in counters.values():
                c.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = fn()
            wall = time.perf_counter() - t0
            launched = {k: c.launches for k, c in counters.items() if c.launches}
            for k, n in launched.items():
                scripts_launches[k] += n
            return out, buf.getvalue().splitlines(), wall, launched

        try:
            os.chdir(sc_dir)
            with contextlib.redirect_stdout(io.StringIO()):
                make_fixture_dataset.main([str(sc_dir / "fit_data"), "--n", str(FIT_VIEWS),
                                           "--wh", "640", "480", "--seed", str(args.seed)])
                make_fixture_dataset.main([str(sc_dir / "ae_data"), "--multi", "--n",
                                           str(FIT_ART_VIEWS), "--wh", "320", "240",
                                           "--seed", str(args.seed)])

            def with_root(cfg_path, root, **extra):
                cfg_json = json.loads((ROOT / cfg_path).read_text())
                cfg_json.update(root_dir=str(root), output_path=str(sc_dir / "results"), **extra)
                out = sc_dir / Path(cfg_path).name
                out.write_text(json.dumps(cfg_json))
                return str(out)

            # bench_eval: the reference contract, then production on the fit config
            recs, lines, wall, launched = run_script(
                "bench_eval", lambda: bench_eval.main([], device=dev))
            require(json.loads(lines[0]) == {"card": card} and len(recs) == 4
                    and all(math.isfinite(r["frame_ms"]) and r["frame_ms"] > 0 for r in recs),
                    f"bench_eval's reference contract printed {lines}")
            want_frames = 4 * sum(r["pieces"] for r in recs)  # a warm frame and three timed
            require(launched.get("fused_nerf_mlp_xyz_eval") == 2 * want_frames
                    and launched.get("resample_union") == want_frames,
                    f"bench_eval's reference contract launched {launched}")
            eval_rec = {"reference": [{k: r[k] for k in ("chunk", "frame_ms", "frames_per_sec",
                                                       "peak_device_bytes", "pieces")}
                                      for r in recs], "reference_launches": launched}
            prod, lines, wall, launched = run_script(
                "bench_eval", lambda: bench_eval.main(
                    ["--config", with_root(FIT_CONFIG, sc_dir / "fit_data")], device=dev))
            require(np.isfinite(prod["comp_rgb"]).all() and 0 < prod["hit_frac"] <= 1
                    and prod["n_rays"] == 640 * 480 and launched.get("resample_union", 0) > 0
                    and launched.get("fused_nerf_mlp_xyz_eval", 0) > 0,
                    f"bench_eval's production mode: {lines}, launched {launched}")
            eval_rec["production"] = {**{k: prod[k] for k in (
                "config", "img_wh", "samples", "use_aabb", "hit_frac", "chunk", "frame_ms",
                "frames_per_sec", "peak_device_bytes")}, "wall_s": wall, "launches": launched}
            emit({"phase": "scripts", "script": "bench_eval", **eval_rec, "card": card})

            # bench_art at v3 and v2, at its defaults
            art_rec = {}
            for fused, rows in (("v3", ("fused_level_train_art_grads", "resample_union")),
                                ("v2", ("art_mlp_fwd", "art_mlp_bwd", "resample_union"))):
                rec, lines, wall, launched = run_script(
                    "bench_art", lambda: bench_art.main(["--fused", fused], device=dev))
                require(json.loads(lines[-1])["metric"] == "art_train_rays_per_sec"
                        and all(math.isfinite(v) for v in rec["losses"])
                        and all(launched.get(k, 0) > 0 for k in rows),
                        f"bench_art --fused {fused}: {lines}, launched {launched}")
                art_rec[fused] = {"art_train_rays_per_sec": rec["value"], "seconds": rec["seconds"],
                                  "steps": rec["steps"], "losses": rec["losses"],
                                  "launches": launched}
            emit({"phase": "scripts", "script": "bench_art", **art_rec, "card": card})

            # profile_ae_host and roofline_ae on the fit_ae config's fixture
            shutil.copytree(sc_dir / "ae_data" / "obj_a" / "train" / "0_degree",
                            sc_dir / "ae_data" / "obj_a" / "test_spheric")
            ae_cfg = with_root(FIT_AE_CONFIG, sc_dir / "ae_data")
            prof_rep, lines, wall, launched = run_script("profile_ae_host", lambda: profile_ae_host.main(
                ["--config", ae_cfg, "--dispatches", str(SCRIPTS_AE_DISPATCHES)], device=dev))
            rates = [v for k, v in prof_rep.items() if k.endswith("_rays_per_sec")]
            require(len(rates) == 4 and all(v > 0 for v in rates)
                    and 0 <= prof_rep["dispatch_device_idle_share"] < 1
                    and launched.get("fused_level_train_art_grads", 0) > 0,
                    f"profile_ae_host: {prof_rep}, launched {launched}")
            # the timed loops' share of the wall: the rest is the Trainer's
            # setup, the warm dispatch and the profiled dispatches
            timed_s = SCRIPTS_AE_DISPATCHES * sum(prof_rep[f"{k}_ms_per_dispatch"]
                              for k in ("iterator", "stage", "dispatch", "end2end")) / 1e3
            emit({"phase": "scripts", "script": "profile_ae_host", "config": FIT_AE_CONFIG,
                  **{k: v for k, v in prof_rep.items() if k not in ("config", "card")},
                  "wall_s": wall, "timed_s": timed_s, "launches": launched, "card": card})
            roof, lines, wall, launched = run_script(
                "roofline_ae", lambda: roofline_ae.main(
                    ["--out", str(sc_dir / "torch_roofline_ae.json")], device=dev))
            require(all(roof[k] > 0 for k in ("ae_full_ms_per_dispatch", "enc_fwd_ms_per_dispatch",
                                              "enc_fwd_bwd_ms_per_dispatch",
                                              "autodec_body_ms_per_dispatch",
                                              "enc_fwd_flops_per_dispatch"))
                    and launched.get("fused_level_train_art_grads", 0) > 0,
                    f"roofline_ae: {roof}, launched {launched}")
            emit({"phase": "scripts", "script": "roofline_ae",
                  **{k: v for k, v in roof.items() if k not in ("_analysis", "card")},
                  "wall_s": wall, "launches": launched, "card": card})

            # demo_sphere at 120x160 on the card and on the CPU, the same draws
            n_px = 120 * 160
            sphere_draws = {"t_rand": torch.from_numpy(sc_gen.random((n_px, 65), np.float32)),
                            "u": torch.from_numpy(sc_gen.random((n_px, 128), np.float32))}
            on_card, lines, wall, launched = run_script(
                "demo_sphere", lambda: demo_sphere.main(
                    ["--out", str(sc_dir / "sphere.png")], device=dev, draws=sphere_draws))
            on_cpu, _, _, _ = run_script(
                "demo_sphere", lambda: demo_sphere.main(
                    ["--out", str(sc_dir / "sphere_cpu.png")], device="cpu", draws=sphere_draws))
            sphere_err = {k: float(np.abs(on_card[k] - on_cpu[k]).max())
                          for k in ("comp", "acc", "comp2", "acc2")}
            level_diff = np.abs(read_png(sc_dir / "sphere.png").astype(np.int16)
                                - read_png(sc_dir / "sphere_cpu.png").astype(np.int16)).max(-1)
            off_share = float(np.mean(level_diff > TOL_SPHERE_LEVELS))
            require(off_share <= TOL_SPHERE_OFF_SHARE and lines[-1].endswith("finite+sorted OK"),
                    f"demo_sphere: {off_share:.4f} of the card's pixels lie more than "
                    f"{TOL_SPHERE_LEVELS} level from the CPU's")
            emit({"phase": "scripts", "script": "demo_sphere", "hw": [120, 160],
                  "lines": lines[:2], "max_abs_err_vs_cpu": sphere_err,
                  "png_max_level_diff": int(level_diff.max()), "png_off_share": off_share,
                  "tol_levels": TOL_SPHERE_LEVELS, "tol_off_share": TOL_SPHERE_OFF_SHARE,
                  "wall_s": wall, "card": card})

            # analyze_gt_ceiling on a lo/hi pair: hi a smooth field, lo its 2x2
            # mean plus noise, a disk as the seg mask
            yy, xx = np.mgrid[0:480, 0:640] / 480.0
            for split in ("lo", "hi"):
                for sub in ("rgb", "seg"):
                    (sc_dir / "gt" / split / sub).mkdir(parents=True, exist_ok=True)
            for i in range(2):
                hi = np.stack([0.5 + 0.4 * np.sin(6 * xx + i), 0.5 + 0.4 * np.cos(5 * yy),
                               0.5 + 0.2 * np.sin(3 * (xx + yy))], -1)
                lo = hi.reshape(240, 2, 320, 2, 3).mean((1, 3)) + sc_gen.normal(0, 0.02, (240, 320, 3))
                seg = ((np.mgrid[0:240, 0:320][0] - 120) ** 2
                       + (np.mgrid[0:240, 0:320][1] - 160 - 20 * i) ** 2 < 60 ** 2)
                write_png(sc_dir / "gt" / "hi" / "rgb" / f"r_{i}.png",
                          np.rint(255 * np.clip(hi, 0, 1)).astype(np.uint8))
                write_png(sc_dir / "gt" / "lo" / "rgb" / f"r_{i}.png",
                          np.rint(255 * np.clip(lo, 0, 1)).astype(np.uint8))
                write_png(sc_dir / "gt" / "lo" / "seg" / f"r_{i}.png", (255 * seg).astype(np.uint8))
            gt, lines, wall, _ = run_script("analyze_gt_ceiling", lambda: analyze_gt_ceiling.main(
                ["--lo", str(sc_dir / "gt" / "lo"), "--hi", str(sc_dir / "gt" / "hi"),
                 "--out", str(sc_dir / "gt" / "analysis.json")], device=dev))
            require(len(gt["frames"]) == 2 and math.isfinite(gt["psnr_obj_ceiling_mean"])
                    and 0 < gt["edge_fraction_mean"] < 1
                    and json.loads((sc_dir / "gt" / "analysis.json").read_text()) == gt,
                    f"analyze_gt_ceiling: {lines}")
            emit({"phase": "scripts", "script": "analyze_gt_ceiling",
                  **{k: v for k, v in gt.items() if k != "frames"}, "frames": len(gt["frames"]),
                  "wall_s": wall, "card": card})

            # visualize_cameras on the fit fixture's train split
            img, lines, wall, _ = run_script("visualize_cameras", lambda: visualize_cameras.main(
                [str(sc_dir / "fit_data"), "--out", str(sc_dir / "cams.png")], device=dev))
            poses = visualize_cameras.load_poses(str(sc_dir / "fit_data"), "train")
            px = np.rint(visualize_cameras.project(
                poses[:, :3, 3], visualize_cameras.plot_limit(poses))).astype(int)
            require(lines[-1].endswith(f"({FIT_VIEWS} cameras)")
                    and np.array_equal(read_png(sc_dir / "cams.png"), img)
                    and (img[px[:, 1], px[:, 0]] == 0).all(),
                    f"visualize_cameras: {lines}")
            emit({"phase": "scripts", "script": "visualize_cameras", "cameras": len(poses),
                  "image": list(img.shape), "drawn_pixels": int((img != 255).any(-1).sum()),
                  "wall_s": wall, "card": card})
        finally:
            os.chdir(cwd)
            shutil.rmtree(sc_dir, ignore_errors=True)
        scripts_launches = {k: n for k, n in scripts_launches.items() if n}
        emit({"phase": "scripts", "launches": scripts_launches, "card": card})
        torch.cuda.empty_cache()

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
                       for n in (N_COARSE + 1, N_COARSE + 1 + N_FINE)],
             "fit": [{k: mlp_rows[n][k] for k in ("shape",) + keys}
                     for n in (FIT_COARSE + 1, FIT_COARSE + 1 + FIT_FINE)]},
            {"name": "resample_union", "route": "cuda",
             "source": "aon_tpu_torch/ops/csrc/resample.cu",
             "replaces": "aon_tpu/ops/resample_pallas.py:85",
             "launches": path_launches["resample_union"] + train_launches["resample_union"],
             "launches_by_path": {"render": path_launches["resample_union"],
                                  "train": train_launches["resample_union"]},
             "entry": "resample_union (under fused_resample: the main paths' entry, its CDF "
                      "built in the kernel)",
             "shape": resample_rec["shape"],
             **{k: resample_rec[k] for k in keys + device_keys + ("fused_resample",)},
             "train": {k: train_rows["resample_union", N_COARSE + 1][k]
                       for k in ("shape", "quantiles") + keys + device_keys
                       + ("fused_resample",)},
             **{path: {"shape": r["shape"], "quantiles": r["quantiles"],
                       "max_abs_err": r["max_abs_err"],
                       "fused_resample_max_abs_err": r["fused_resample"]["max_abs_err"]}
                for path, r in (("fit", resample_fit_rec), ("fit_art", resample_fit_art_rec))}},
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
                       for n in (N_COARSE + 1, N_COARSE + 1 + N_FINE)],
             "fit_art": [{k: art_rows["art_mlp_fwd", "fit_art", n][k] for k in ("shape",) + keys}
                         for n in (FIT_ART_COARSE + 1, FIT_ART_COARSE + 1 + FIT_ART_FINE)]},
            art_entry("art_mlp_bwd", "aon_tpu/ops/fused_art.py:220"),
            dict(art_entry("fused_level_train_art_grads",
                           "aon_tpu/ops/train_fused_level_art.py:60", "autodecoder"),
                 other_arguments=[
                     {k: rows_[k] for k in ("shape", "arguments", "max_abs_err", "mean_rel_err",
                                            "ms", "plain_ms", "bound_ms", "library_ms")}
                     for rows_ in (*(art_rows["fused_level_train_art_grads", mode,
                                              N_COARSE + 1 + N_FINE]
                                     for mode in ("autoencoder", "white_bkgd")),
                                   ae_level_rows[N_COARSE + 1 + N_FINE])],
                 # the auto-encoder quality config's arguments at every shape
                 ae_quality=[{k: r[k] for k in ("shape", "path", "max_abs_err", "mean_rel_err",
                                                "deform_min_cos", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
                             for r in ae_level_rows.values()]),
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
        # the fit phase's CLI runs (fit, resume, --run_eval) and its extraction
        for kname in ("fused_nerf_mlp_xyz_eval", "resample_union", "fused_level_train_grads",
                      "fused_nerf_mlp_xyz"):
            e = by_name[kname]
            e["launches"] += fit_path_launches[kname]
            e["launches_by_path"]["fit"] = fit_path_launches[kname]
        # the fit_art phase's CLI runs, scripts and extraction
        for kname in ("fused_level_train_art_grads", "resample_union", "art_mlp_fwd"):
            e = by_name[kname]
            e["launches"] += fit_art_path_launches[kname]
            e["launches_by_path"]["fit_art"] = fit_art_path_launches[kname]
        # the fit_ae phase's CLI runs and extraction, and the fit_ae_raw fit
        for kname in ("fused_level_train_art_grads", "resample_union", "art_mlp_fwd"):
            e = by_name[kname]
            for path, launched in (("fit_ae", fit_ae_path_launches),
                                   ("fit_ae_raw", fit_ae_raw_launches)):
                e["launches"] += launched[kname]
                e["launches_by_path"][path] = launched[kname]
        # the optim phase's CLI fit and the dp phase's one-process steps and frame
        for path, launched in (("optim", optim_launches), ("dp", dp_launches),
                               ("scripts", scripts_launches)):
            for kname, n in launched.items():
                if n and kname in by_name:
                    e = by_name[kname]
                    e.setdefault("launches_by_path", {"train": e["launches"]})
                    e["launches"] += n
                    e["launches_by_path"][path] = n
        # and their checks at the bench's shapes and at the occ8 config's
        for kname in ("resample_union", "fused_level_train_grads", "fused_level_train_art_grads"):
            for key, rows in (("bench_shapes", bench_shape_rows), ("occ8", occ8_rows)):
                recs = [{k: r[k] for k in ("contract", "shape") + keys
                         + (device_keys + ("fused_resample",) if kname == "resample_union" else ())}
                        for (n, _), r in rows.items() if n == kname]
                if recs:
                    by_name[kname][key] = recs
        by_name["fused_nerf_mlp_xyz_eval"]["occ8"] = [
            {k: r[k] for k in ("shape",) + keys} for r in occ8_mlp_rows.values()]

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
            **{k: timed14[k] for k in keys + device_keys if k != "max_abs_err"},
            "encoders": timed14["encoders"], "check_shape": row14["timed"][0]})
        # the threefry draws: every training path's, no TPU kernel's (XLA
        # generates jax.random's hash on the TPU)
        by_path = {"train": train_launches["threefry_uniform"],
                   "art_train": art_train_launches["threefry_uniform"],
                   "bench": sum(bench_launches[c]["threefry_uniform"] for c in bench_launches),
                   "fit": fit_path_launches["threefry_uniform"],
                   "fit_art": fit_art_path_launches["threefry_uniform"],
                   "fit_ae": fit_ae_path_launches["threefry_uniform"],
                   "fit_ae_raw": fit_ae_raw_launches["threefry_uniform"],
                   "optim": optim_launches["threefry_uniform"],
                   "scripts": scripts_launches.get("threefry_uniform", 0)}
        big = max(prng_rows, key=lambda r: r["shape"][0] * r["shape"][1])
        entries.append({
            "name": "threefry_uniform", "row": None, "route": "cuda",
            "source": "aon_tpu_torch/ops/csrc/prng.cu", "entry": "aon_threefry_uniform_launch",
            "replaces": "aon_tpu/core/sampling.py:42",
            "tpu_kernel": None, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape": big["shape"], **{k: big[k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in prng_rows),
            "device_ms": big["device_ms"],
            "shapes": [{k: r[k] for k in ("shape", "ms", "device_ms", "flat_ms", "flat_device_ms",
                                          "plain_ms", "bound_ms")} for r in prng_rows]})
        require(len(entries) == 19, "the kernels line lists kernel table rows 1-13 (rows 12 and "
                "13 by variant), row 14's check and the threefry draws")
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
