"""Multi-process eval-frame assembly, checked against one process (port of
``scripts/multihost_eval_demo.py``).

N ranks each render a contiguous block of one frame's rays with the same
seeded parameters and assemble the whole frame with
``parallel.multihost.alter_gather_cat`` (the reference's interface.py:31-51);
every rank writes the assembled frame, and one process writes the frame it
renders alone:

    # one process
    python -m aon_tpu_torch.scripts.multihost_eval_demo --device cpu --out /tmp/f_single.npz
    # 2 ranks (gloo on the CPU)
    python -m aon_tpu_torch.scripts.multihost_eval_demo --device cpu --num_processes 2 --process_id 0 --out /tmp/f_p0.npz &
    python -m aon_tpu_torch.scripts.multihost_eval_demo --device cpu --num_processes 2 --process_id 1 --out /tmp/f_p1.npz

Without ``--config`` the system is the JAX demo's (4 + 4 samples, float32,
the plain route); with it, the vanilla system of the config (its widths,
samples, dtype and route).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from aon_tpu_torch.core import prng
from aon_tpu_torch.core.rays import create_spheric_poses, get_ray_directions, get_rays
from aon_tpu_torch.parallel.mesh import pad_to_multiple
from aon_tpu_torch.parallel.multihost import alter_gather_cat, process_ray_slice
from aon_tpu_torch.scripts.multihost_train_demo import join_group
from aon_tpu_torch.train.systems import VanillaSystem
from aon_tpu_torch.utils.config import Config, get_config
from aon_tpu_torch.utils.device import resolve_device


def render(args, device: torch.device, group) -> dict:
    """This rank's block of the frame, rendered chunk by chunk and gathered."""
    w, h = args.wh
    if args.config:
        cfg = get_config(["--config", args.config])
        cfg.exp_type = "vanilla"
    else:
        cfg = Config(N_samples=4, N_importance=4, compute_dtype="float32", use_pallas=False,
                     img_wh=[w, h])
    system = VanillaSystem(cfg, near=2.0, far=6.0, white_bkgd=True, device=device)
    params = system.init_state(prng.key(0)).params

    directions = get_ray_directions(h, w, 0.7 * w)
    c2w = np.asarray(create_spheric_poses(radius=4.0)[0], dtype=np.float32)[:3, :4]
    rays_o, viewdirs, rays_d, _ = get_rays(directions, c2w, output_view_dirs=True,
                                           output_radii=True)
    n = rays_o.shape[0]
    world = 1 if group is None else dist.get_world_size(group)
    start, stop = process_ray_slice(n, group=group)
    per = stop - start
    rays = {k: pad_to_multiple(np.asarray(v, np.float32), world * args.chunk)
            for k, v in (("rays_o", rays_o), ("rays_d", rays_d), ("viewdirs", viewdirs))}
    per_pad = -(-per // args.chunk) * args.chunk
    chunks = []
    for i in range(start, start + per_pad, args.chunk):
        res = system.render_chunk(params, {k: torch.from_numpy(v[i:i + args.chunk]).to(device)
                                           for k, v in rays.items()})
        chunks.append({k: v.cpu().numpy() for k, v in res.items()})
    # this rank's padded tail off, so that the gathered blocks tile exactly
    local = {k: np.concatenate([c[k] for c in chunks], 0)[:per] for k in chunks[0]}
    return alter_gather_cat([local], (w, h), group=group, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--coordinator", default="localhost:19233", help="host:port of rank 0")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    ap.add_argument("--wh", type=int, nargs=2, default=[32, 24])
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--config", default=None, help="a vanilla config to render with")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.index is not None:
        torch.cuda.set_device(device)
    created = not dist.is_initialized()
    group = join_group(args, device)
    try:
        frame = render(args, device, group)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    np.savez(args.out, **frame)
    print(f"p{args.process_id}: wrote {args.out} (processes={args.num_processes})", flush=True)
    return frame


if __name__ == "__main__":
    main()
