"""Where one training level's time goes on the card, stage by stage.

    python -m aon_tpu_torch.scripts.level_split [--root DIR] [--art] [--samples 193 49]

Runs ``fused_level_train_grads`` (kernel table row 3), or with ``--art`` the
articulated ``fused_level_train_art_grads`` (row 9), on 2,048 rays at each
sample count, with seeded random weights and rays, under torch.profiler, and
prints one JSON line: the device milliseconds per level call of each of its
stages, by kernel name (forward, compositing, backward data path, weight
gradients, and the rest: the weight gathers and the zeroing of the gradient
blob), each beside its flop bound at the bf16 peak and the bytes of the
workspaces it writes and reads at the HBM rate, and the card's name and
power limit.  ``--root`` imports ``aon_tpu_torch`` from another checkout
(a parent tree, to compare in one call); the stages are found by name in
either design.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
RAYS = 2048
# multiply-adds per sample row of each stage at the MLP's own widths: the
# forward (ops/fused_mlp.py MLP_MACS_PER_SAMPLE), the backward's chain dv,
# dbott, D7..D0 (128 x 3 + 128 x 256 + 256 + 8 x 256 x 256), and the weight
# gradients of the 12 wide matrices (63 x 256 x 2 + 8 x 256 x 256 + 283 x 128)
STAGE_MACS = {"forward": 593408, "backward_data": 557696 + 256, "weight_grads": 592768}
# the articulated level's: the forward with the deformation (3 + 3 x 128 x
# 128 + 128 x 3) and the view branch (3 x 128 x 128) (ops/fused_art.py); the
# backward adds the view branch (3 x 128 x 128), d_enc (2 x 256 x 63), the
# encoding's VJP (63 x 3), the deformation head (128 x 3) and its layers (3 x
# 128 x 128); the weight gradients wd1..wd3 and wv1..wv3 (6 x 128 x 128)
ART_STAGE_MACS = {"forward": 692480,
                  "backward_data": 557952 + 49152 + 32256 + 189 + 384 + 49152,
                  "weight_grads": 592768 + 6 * 16384}
STAGES = ("forward", "composite", "backward_data", "weight_grads")


def stage_of(kernel: str) -> str:
    """The level stage a kernel of either design belongs to, by its name."""
    if "composite" in kernel:
        return "composite"
    if "wgrad" in kernel:
        return "weight_grads"
    if "bwd" in kernel:
        return "backward_data"
    if "fwd" in kernel:
        return "forward"
    return "other"


def workspace_bytes(n_pad: int, has_mask: bool) -> dict:
    """Bytes each stage writes or reads of the workspaces, once each: the
    activations (2,528 bf16 a row; 2,560 in 64-column chunks where the
    design keeps the mask bits) and gradients (2,432), and the relu-mask
    bits (256 bytes a row); without them the backward reads the masks from
    the activations (a0..a7, v)."""
    act, grad, mask = 2 * (2560 if has_mask else 2528), 2 * 2432, 256
    heads = 2 * (128 + 256)  # v and a7 for the heads' gradients
    if has_mask:
        fwd, bwd = act + mask, mask + heads + grad
    else:
        fwd, bwd = act, 2 * (8 * 256 + 128) + heads + grad
    per_row = {"forward": fwd, "composite": 0, "backward_data": bwd, "weight_grads": act + grad}
    return {k: n_pad * v for k, v in per_row.items()}


def art_workspace_bytes(n_pad: int, blocked: bool) -> dict:
    """``workspace_bytes`` of the articulated level: activations (3,424 bf16
    a row; 54 chunks of 64 in the blocked design, which also keeps the
    trunk's 256 bytes of mask bits) and gradients (3,328; 50 chunks), x' (16
    bytes) written by the forward and read by the backward.  The blocked
    backward reads the 128-wide layers' stored values for their masks (v0..v2,
    hd0..hd2) and D5 back; without the mask bits the backward reads every
    masked layer's activations (a0..a7, v0..v2, hd0..hd3)."""
    act, grad = 2 * (54 * 64 if blocked else 3424), 2 * (50 * 64 if blocked else 3328)
    mask, xp = 256, 16
    heads = 2 * (128 + 256 + 128)  # v3, a7 and hd3 for the heads' gradients
    if blocked:
        fwd, bwd = act + mask + xp, mask + 2 * 6 * 128 + heads + xp + 2 * 256 + grad
    else:
        fwd, bwd = act + xp, 2 * (8 * 256 + 7 * 128) + heads + xp + grad
    per_row = {"forward": fwd, "composite": 0, "backward_data": bwd, "weight_grads": act + grad}
    return {k: n_pad * v for k, v in per_row.items()}


def measure(samples, seed: int = 0, reps: int = 10, art: bool = False) -> dict:
    """The split of each sample count's level, on seeded weights and rays;
    ``art``: the articulated level (the auto-decoder's arguments)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aon_tpu_torch.ops.fused_mlp import make_posenc_constants, pack_vanilla_mlp_params_f32
    from aon_tpu_torch.ops.render_fused import mlp_params
    from aon_tpu_torch.ops.train_fused_level import fused_level_train_grads
    from aon_tpu_torch.train.systems import build_system
    from aon_tpu_torch.utils.config import Config
    try:
        from aon_tpu_torch.ops import train_sm90  # noqa: F401
        has_mask = True
    except ImportError:
        has_mask = False
    try:
        from aon_tpu_torch.ops import art_sm90  # noqa: F401
        art_blocked = True
    except ImportError:
        art_blocked = False

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    consts = make_posenc_constants(device=dev)
    d = torch.nn.functional.normalize(torch.randn(RAYS, 3, generator=gen, device=dev), dim=-1)
    o = -4.0 * d + 0.3 * torch.randn(RAYS, 3, generator=gen, device=dev)
    target = torch.rand(RAYS, 3, generator=gen, device=dev)
    if art:
        from aon_tpu_torch.ops.fused_art import fold_latents
        from aon_tpu_torch.ops.train_fused_level_art import fused_level_train_art_grads

        cfg = Config(exp_type="vanilla_autodecoder", N_max_objs=4, white_back=False)
        params = build_system(cfg, 2.0, 6.0, False, device=dev).init_params(gen)
        latents = {k: 0.1 * torch.randn(1, n, generator=gen, device=dev)
                   for k, n in (("density", 128), ("color", 128), ("articulation", 32))}
        packed = fold_latents(mlp_params(params, "model.fine_mlp"), latents)
        lw = torch.full((RAYS,), 1.0 / (3.0 * RAYS), device=dev)
        level = fused_level_train_art_grads
        stage_macs, has_mask = ART_STAGE_MACS, art_blocked
    else:
        params = build_system(Config(), 2.0, 6.0, True, device=dev).init_params(gen)
        packed = pack_vanilla_mlp_params_f32(mlp_params(params, "fine_mlp"))
        level, stage_macs = fused_level_train_grads, STAGE_MACS
    out = []
    for S in samples:
        t = torch.sort(torch.rand(RAYS, S, generator=gen, device=dev) * 4 + 2, dim=-1).values
        args = (packed, consts, t.contiguous(), o, d, d, target)
        args += (lw, torch.zeros_like(lw), False) if art else (True,)
        for _ in range(3):
            level(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                level(*args)
            torch.cuda.synchronize()
        ms = {k: 0.0 for k in STAGES + ("other",)}
        names = {k: [] for k in ms}
        for e in prof.key_averages():
            if e.device_type.name == "CUDA" and e.device_time_total > 0:
                stage = stage_of(e.key)
                ms[stage] += e.device_time_total / 1e3 / reps
                names[stage].append(e.key[:60])
        rows = RAYS * S
        n_pad = -(-rows // (128 if has_mask else 64)) * (128 if has_mask else 64)
        nbytes = art_workspace_bytes(n_pad, has_mask) if art else workspace_bytes(n_pad, has_mask)
        stages = {}
        for k in STAGES:
            flop = 2.0 * stage_macs.get(k, 0) * rows
            stages[k] = {"ms": ms[k], "flop_bound_ms": 1e3 * flop / PEAK_BF16_FLOPS,
                         "workspace_bytes": nbytes[k],
                         "workspace_ms_at_hbm": 1e3 * nbytes[k] / PEAK_BYTES,
                         "kernels": names[k]}
        stages["other"] = {"ms": ms["other"], "kernels": names["other"]}
        out.append({"shape": f"{RAYS}x{S}", "rows": rows, "level_ms": sum(ms.values()),
                    "stages": stages})
    return {"level": "articulated" if art else "vanilla", "mask_workspace": has_mask,
            "levels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="import aon_tpu_torch from this checkout")
    ap.add_argument("--samples", type=int, nargs="+", default=[193, 49])
    ap.add_argument("--art", action="store_true", help="the articulated level (row 9)")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "needs a CUDA device"}))
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rec = measure(args.samples, art=args.art)
    import aon_tpu_torch

    rec.update(root=str(aon_tpu_torch.__file__).rsplit("/aon_tpu_torch/", 1)[0], card=smi)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
