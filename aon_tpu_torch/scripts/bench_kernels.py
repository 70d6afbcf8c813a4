"""Kernel-variant microbenchmarks of the fused NeRF MLP on the card (port of
``scripts/bench_kernels.py``).

    python -m aon_tpu_torch.scripts.bench_kernels [variant ...]   (default: all)

Variants, by the JAX bench's names (``main()`` there), each run K times on
fixed random inputs after a warm-up launch:

  * ``fwdxyz512``, ``fwdxyz1024``: the forward from raw coordinates
    (``fused_nerf_mlp_xyz_eval``, kernel table row 1), 2^18 samples as 1,024
    rays x 256, K = 16;
  * ``bwd512f32``, ``bwd512bf16``, ``bwd640bf16``, ``bwd768bf16``: its weight
    backward (``fused_mlp_bwd_xyz``, row 4), K = 16;
  * ``step512f32``: both, K = 16;
  * ``body_base512``, ``body_2s512``, ``body_2s1024``, ``body_bf16acc512``: the
    forward on pre-encoded (2^18, 64) and (2^18, 32) inputs with one of the
    three bodies of ``_make_fwd`` (``ops.bench_variants.MLP_BODY``, row 12),
    K = 48;
  * ``train512``: forward and backward under autograd
    (``fused_mlp_train_xyz``, rows 1 and 4), 2^17 samples, K = 12;
  * ``xyzbody_base512``, ``xyzbody_mxu512``, ``xyzbody_doubling512``: the
    forward from per-sample raw xyz and viewdirs with one of the three
    encoders of ``bench_xyz_body`` (``ops.bench_variants.XYZ_BODY``, row 13),
    K = 48.  The JAX ``main()`` never calls ``bench_xyz_body``; these three
    names, new here, are the only way row 13 is launched.

The number in a name is the TPU kernel's tile of rows (``tpu_tile`` in the
line).  The port's kernels take their own ``tile`` whatever the name: 128
rows for the eval kernel (rows 1, 12 and 13: persistent blocks, one per SM,
``grid`` of them, clusters of ``cluster``), and 128-row tiles on the same
persistent grid for the training kernels' forward and backward; so variants that differ only in the TPU tile run the same
launch.  A line of the eval kernel alone also carries ``pct_bf16_peak`` and
``l2_weight_bytes``, the weights it streamed from L2 into shared memory per
call, with the rate ``l2_tb_s`` that implies at the measured time
(``eval_fields``).
``wdtype`` float32 means float32-packed weights, rounded to bf16 once when
the launch's weight blob is made (as ``fused_mlp_train_xyz`` does), outside
the timed launches, so those variants launch what their bf16 twins launch.

Timing: CUDA events around the K launches, after one warm-up launch whose
wall time (library load and first launch included) is ``compile_s``.  ``ms``
is the K launches together, as the JAX line's; ``ms_per_call`` beside it.
``tflops`` counts the MLP's true multiply-adds, 593,408 per sample
(``ops.fused_mlp.MLP_MACS_PER_SAMPLE``, the count chip_smoke's bounds use);
the backward counts three forwards, as the JAX bench does.
``tflops_jax_count`` is the same time at the JAX bench's own count, 725,632
per sample, which counts nine 256 x 256 products where the MLP has seven and
so reads 22% high.  The first line is the card's name and power limit.
``run_variant`` with ``device="cpu"`` runs a variant's plain twins at any
shape and gives no time.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from aon_tpu_torch.models.mlp import NeRFMLP, xavier_init_
from aon_tpu_torch.ops import bench_variants, train_sm90
from aon_tpu_torch.ops.fused_mlp import (
    EVAL_CLUSTER,
    EVAL_TILE_ROWS,
    MLP_MACS_PER_SAMPLE,
    eval_l2_weight_bytes,
    eval_launch_shape,
    launch_blobs,
    make_posenc_constants,
    pack_vanilla_mlp_params,
    pack_vanilla_mlp_params_f32,
    sm_count,
    train_blobs,
)
from aon_tpu_torch.ops.fused_mlp_train import (
    fused_mlp_bwd_xyz,
    fused_mlp_train_xyz,
    fused_nerf_mlp_xyz_eval,
)
from aon_tpu_torch.utils.device import DeviceLike, card_name, resolve_device

PORT_TILE = train_sm90.TILE_ROWS  # rows per tile of the training kernels (ops/csrc/train_sm90.cuh)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA's data sheet), at 700 W
# scripts/bench_kernels.py:41-45, for comparison with its lines only
JAX_BENCH_MACS_PER_SAMPLE = (
    64 * 256 + 6 * 256 * 256 + (256 + 64) * 256 + 2 * 256 * 256
    + 256 * 256 + 256 + (256 + 32) * 128 + 128 * 3
)
FLOPS_PER_SAMPLE = 2 * MLP_MACS_PER_SAMPLE

# name -> (kind, TPU tile, options), in the JAX bench's order, row 13 last
VARIANTS = {
    "fwdxyz512": ("parts", 512, dict(part="fwd", wdtype="bfloat16")),
    "fwdxyz1024": ("parts", 1024, dict(part="fwd", wdtype="bfloat16")),
    "bwd512f32": ("parts", 512, dict(part="bwd", wdtype="float32")),
    "bwd512bf16": ("parts", 512, dict(part="bwd", wdtype="bfloat16")),
    "bwd640bf16": ("parts", 640, dict(part="bwd", wdtype="bfloat16")),
    "bwd768bf16": ("parts", 768, dict(part="bwd", wdtype="bfloat16")),
    "step512f32": ("parts", 512, dict(part="fwd+bwd", wdtype="float32")),
    "body_base512": ("fwd", 512, dict(body="base")),
    "body_2s512": ("fwd", 512, dict(body="2s")),
    "body_2s1024": ("fwd", 1024, dict(body="2s")),
    "body_bf16acc512": ("fwd", 512, dict(body="bf16acc")),
    "train512": ("train", 512, {}),
    "xyzbody_base512": ("xyz", 512, dict(encoder="elementwise")),
    "xyzbody_mxu512": ("xyz", 512, dict(encoder="mxu")),
    "xyzbody_doubling512": ("xyz", 512, dict(encoder="doubling")),
}
# the JAX bench's rows and calls per kind
ROWS = {"parts": 1 << 18, "fwd": 1 << 18, "train": 1 << 17, "xyz": 1 << 18}
CALLS = {"parts": 16, "fwd": 48, "train": 12, "xyz": 48}
PART_MULT = {"fwd": 1, "bwd": 3, "fwd+bwd": 4}


def mlp_params(device: torch.device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A ``NeRFMLP`` state dict of xavier-uniform weights from ``seed``."""
    mlp = NeRFMLP().to(device)
    xavier_init_(mlp, torch.Generator(device=device).manual_seed(seed))
    return {k: v.detach() for k, v in mlp.state_dict().items()}


def card() -> Dict[str, str]:
    """The card's name and `nvidia-smi` name and power limit."""
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": card_name("cuda")}


def _timed(fn: Callable[[], object], calls: int):
    """(compile_s, seconds of ``calls`` runs) on the card: one warm-up run by
    the wall clock, then CUDA events around the runs."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return compile_s, start.elapsed_time(end) / 1e3


def _setup_parts(device, n, wdtype, part):
    params = mlp_params(device)
    consts = make_posenc_constants(device=device)
    g = np.random.default_rng(0)
    B, S = max(n // 256, 1), min(n, 256)
    samples = torch.from_numpy(g.normal(size=(B, S, 3)).astype(np.float32)).to(device)
    viewdirs = torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(device)
    gout = torch.ones(B, S, 4, device=device)
    packed32 = pack_vanilla_mlp_params_f32(params)
    packed = packed32 if wdtype == "float32" else pack_vanilla_mlp_params(params)
    # hoisted out of the timing: the eval kernel's blobs and the training kernels'
    cuda = device.type == "cuda"
    blobs = launch_blobs(packed) if cuda else None
    train_b = train_blobs(packed32) if cuda else None

    def run():
        if "fwd" in part:
            fused_nerf_mlp_xyz_eval(packed, consts, samples, viewdirs, blobs)
        if "bwd" in part:
            fused_mlp_bwd_xyz(packed32, consts, samples, viewdirs, gout, train_b)

    return run, B * S


def _setup_fwd(device, n, body):
    packed = pack_vanilla_mlp_params(mlp_params(device))
    g = np.random.default_rng(0)
    enc = torch.from_numpy(g.normal(size=(n, 64)).astype(np.float32)).to(device)
    venc = torch.from_numpy(g.normal(size=(n, 32)).astype(np.float32)).to(device)
    blobs = launch_blobs(packed) if device.type == "cuda" else None
    return (lambda: bench_variants.MLP_BODY[body](packed, enc, venc, blobs)), n


def _setup_xyz(device, n, encoder):
    packed = pack_vanilla_mlp_params(mlp_params(device))
    consts = make_posenc_constants(device=device)
    g = np.random.default_rng(0)
    xyz = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)).to(device)
    vdir = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)).to(device)
    blobs = launch_blobs(packed) if device.type == "cuda" else None
    return (lambda: bench_variants.XYZ_BODY[encoder](packed, consts, xyz, vdir, blobs)), n


def _setup_train(device, n):
    params = {k: v.clone().requires_grad_(True) for k, v in mlp_params(device).items()}
    consts = make_posenc_constants(device=device)
    g = np.random.default_rng(0)
    B, S = max(n // 256, 1), min(n, 256)
    samples = torch.from_numpy(g.normal(size=(B, S, 3)).astype(np.float32)).to(device)
    viewdirs = torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(device)

    def run():
        rgb, sigma = fused_mlp_train_xyz(params, consts, samples, viewdirs)
        torch.autograd.grad(rgb.sum() + sigma.sum(), list(params.values()))

    return run, B * S


def eval_fields(n_rows: int, ms_per_call: float, device: torch.device) -> dict:
    """What one call of the eval kernel on ``n_rows`` rows in ``ms_per_call``
    (measured on ``device``) did: TFLOP/s at the true count and their share
    of the bf16 peak, the launch's tile, grid and cluster, and the weights it
    streamed from L2 with the rate that implies."""
    sms = sm_count(device)
    tflops = n_rows * FLOPS_PER_SAMPLE / ms_per_call / 1e9
    l2_bytes = eval_l2_weight_bytes(n_rows, sms)
    return {"tflops": tflops, "pct_bf16_peak": 100 * tflops * 1e12 / PEAK_BF16_FLOPS,
            "tile_rows": EVAL_TILE_ROWS, "grid": eval_launch_shape(n_rows, sms)[1],
            "cluster": EVAL_CLUSTER, "l2_weight_bytes": l2_bytes,
            "l2_tb_s": l2_bytes / ms_per_call / 1e9}


def run_variant(name: str, device: torch.device, rows: Optional[int] = None,
                calls: Optional[int] = None) -> dict:
    """Time one variant; returns its line."""
    kind, tpu_tile, opts = VARIANTS[name]
    n, k = rows or ROWS[kind], calls or CALLS[kind]
    if kind == "parts":
        run, n = _setup_parts(device, n, opts["wdtype"], opts["part"])
    elif kind == "fwd":
        run, n = _setup_fwd(device, n, opts["body"])
    elif kind == "xyz":
        run, n = _setup_xyz(device, n, opts["encoder"])
    else:
        run, n = _setup_train(device, n)
    eval_only = kind in ("fwd", "xyz") or opts.get("part") == "fwd"
    line = {"variant": name, "tile": EVAL_TILE_ROWS if eval_only else PORT_TILE,
            "tpu_tile": tpu_tile, **opts, "calls": k, "rows": n, "device": device.type}
    if device.type != "cuda":  # the twins' control flow only: no time is a device's
        for _ in range(k + 1):
            run()
        return dict(line, ms="not measured (CPU)")
    compile_s, seconds = _timed(run, k)
    mult = PART_MULT[opts.get("part", "fwd+bwd" if kind == "train" else "fwd")]
    tflops = n * k * FLOPS_PER_SAMPLE * mult / seconds / 1e12
    line["tflops_4x" if kind == "train" else "tflops"] = tflops
    line.update(tflops_jax_count=tflops * JAX_BENCH_MACS_PER_SAMPLE / MLP_MACS_PER_SAMPLE,
                ms=1e3 * seconds, ms_per_call=1e3 * seconds / k, compile_s=compile_s)
    if eval_only:
        line.update(eval_fields(n, line["ms_per_call"], device))
    if opts.get("wdtype") == "float32":
        line["weights_at_launch"] = "bf16, rounded once from the float32 packing"
    return line


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda") -> List[dict]:
    """Run the named variants (all by default), printing the card's line and
    then one JSON line per variant; returns the variants' lines."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants: {unknown}; known: {list(VARIANTS)}")
    device = resolve_device(device)
    if device.type == "cuda":
        print(json.dumps(card()), flush=True)
    else:
        print(json.dumps({"name": "cpu", "nvidia_smi": None}), flush=True)
    lines = []
    for name in VARIANTS:
        if args.variants and name not in args.variants:
            continue
        line = run_variant(name, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
