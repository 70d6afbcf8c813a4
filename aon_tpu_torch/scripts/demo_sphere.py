"""Render an analytic solid sphere through the port's core pipeline (port of
``scripts/demo_sphere.py``).

End-to-end smoke and verify script for the library surface: ray generation ->
stratified coarse sampling (64) -> compositing -> inverse-CDF fine resampling
(128) -> compositing -> PNG.  No learned model is involved, so any regression
here is in the math, not the weights.  Prints the acc range, the coarse-vs-fine
PSNR and the zero-weight ``sample_pdf`` probe's result (finite and sorted).

    python -m aon_tpu_torch.scripts.demo_sphere [--out $TMPDIR/aon_sphere.png] [--hw 120 160]

The draws come from the JAX demo's key, ``PRNGKey(0)`` (the same uniforms),
or from ``draws``
(``t_rand`` (H*W, 65) and ``u`` (H*W, 128)) where a caller injects them.
Runs on ``cuda``; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Mapping, Optional

import numpy as np
import torch

from aon_tpu_torch.core import prng
from aon_tpu_torch.core.rays import create_spheric_poses, get_ray_directions, get_rays
from aon_tpu_torch.core.rendering import img2mse, mse2psnr, volumetric_rendering
from aon_tpu_torch.core.sampling import sample_along_rays, sample_pdf
from aon_tpu_torch.utils.device import DeviceLike, resolve_device
from aon_tpu_torch.utils.imageio import write_png

N_COARSE, N_FINE = 64, 128


def field(pts: torch.Tensor):
    """A red unit sphere of density 50 at the origin: (rgb, sigma)."""
    inside = (torch.linalg.norm(pts, dim=-1, keepdim=True) < 1.0).to(torch.float32)
    sigma = 50.0 * inside
    rgb = torch.cat([inside, 0.2 * inside, 0.2 * inside], -1)
    return rgb, sigma


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "aon_sphere.png"))
    ap.add_argument("--hw", nargs=2, type=int, default=[120, 160])
    return ap


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda",
         draws: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """Render, print and write the PNG; returns ``{comp, acc, comp2, acc2,
    img (H, W, 3) uint8, probe_t}`` on the host."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    H, W = args.hw
    draws = {k: torch.as_tensor(v, device=device) for k, v in (draws or {}).items()}
    key = None if draws else prng.key(0)  # the JAX demo's key, for both levels

    poses = create_spheric_poses(radius=4.0)
    dirs = get_ray_directions(H, W, focal=150.0 * W / 160)
    o, _, rd, _ = get_rays(dirs, poses[0][:3, :4], output_view_dirs=True, output_radii=True)
    o, rd = torch.from_numpy(o).to(device), torch.from_numpy(rd).to(device)

    t, pts = sample_along_rays(o, rd, N_COARSE, 2.0, 6.0, randomized=True, key=key,
                               t_rand=draws.get("t_rand"))
    rgb, sigma = field(pts)
    comp, acc, weights, _ = volumetric_rendering(rgb, sigma, t, rd, white_bkgd=True)

    t_mids = 0.5 * (t[..., 1:] + t[..., :-1])
    t2, pts2 = sample_pdf(t_mids, weights[..., 1:-1], o, rd, t, N_FINE, randomized=True,
                          key=key, u=draws.get("u"))
    rgb2, sigma2 = field(pts2)
    comp2, acc2, _, _ = volumetric_rendering(rgb2, sigma2, t2, rd, white_bkgd=True)

    img = np.clip(comp2.cpu().numpy().reshape(H, W, 3), 0, 1)
    accv = acc2.cpu().numpy().reshape(H, W)
    print("acc range", accv.min(), accv.max(), "mean", accv.mean())
    print("coarse-vs-fine psnr:", float(mse2psnr(img2mse(comp, comp2))))

    img8 = (img * 255).astype(np.uint8)
    write_png(args.out, img8)
    print("saved", args.out)

    tz, _ = sample_pdf(t_mids, torch.zeros_like(weights[..., 1:-1]), o, rd, t, N_FINE,
                       randomized=False)
    tz = tz.cpu().numpy()
    assert np.isfinite(tz).all() and (np.diff(tz, axis=-1) >= 0).all()
    print("probe zero-weight sample_pdf: finite+sorted OK")
    return {"comp": comp.cpu().numpy(), "acc": acc.cpu().numpy(), "comp2": comp2.cpu().numpy(),
            "acc2": acc2.cpu().numpy(), "img": img8, "probe_t": tz}


if __name__ == "__main__":
    main()
