"""Synthesize a miniature SAPIEN-layout dataset for tests and smoke training
(port of ``scripts/make_fixture_dataset.py``: the same files, with the port's
numpy ``core/rays.py`` and PNGs written by ``utils/imageio.py``).

Renders an analytic scene (axis-aligned colored sphere whose "lid" plane
rotates with articulation degree) on the CPU with numpy, and
writes the exact on-disk layout the reference datasets expect:

  single-scene (datasets/sapien.py):
    {root}/{train,val,test}/rgb/r_0.png ... + transforms.json
  articulated (datasets/sapien_multi.py):
    {root}/{instance}/train/{deg}_degree/{rgb,seg}/r_i.png + transforms.json

Usage:
  python -m aon_tpu_torch.scripts.make_fixture_dataset OUT_DIR [--multi] [--n 5] [--wh 64 48]
"""

import argparse
import json
from pathlib import Path

import numpy as np

from aon_tpu_torch.core.rays import get_ray_directions, get_rays
from aon_tpu_torch.utils.imageio import write_png

CAMERA_ANGLE_X = 0.6911112070083618  # matches SAPIEN's fovy-derived value scale


def render_analytic(c2w, w, h, deg=0.0):
    """CPU numpy renderer: unit sphere at origin, red top / blue bottom split
    by a plane rotated `deg` degrees about x — a crude articulated object."""
    # reference focal convention: computed at h, rescaled by w/320
    focal = 0.5 * h / np.tan(0.5 * CAMERA_ANGLE_X)
    focal *= w / 320.0
    dirs = get_ray_directions(h, w, focal)
    o, vd, rd, _ = get_rays(dirs, c2w[:3, :4], output_view_dirs=True, output_radii=True)
    # ray-sphere intersection, radius 1
    b = np.sum(o * rd, axis=-1)
    c = np.sum(o * o, axis=-1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    pts = o + t[:, None] * rd
    ang = np.deg2rad(deg)
    normal = np.array([0.0, np.cos(ang), np.sin(ang)])
    top = (pts @ normal) > 0
    rgb = np.zeros((h * w, 3), np.float32)
    rgb[hit & top] = [0.9, 0.2, 0.15]
    rgb[hit & ~top] = [0.15, 0.3, 0.9]
    alpha = hit.astype(np.float32)
    # camera-frame -z of the hit point (datagen depth convention,
    # data_utils.py:61-64): fwd = -c2w_z
    fwd = -c2w[:3, 2]
    z_depth = np.where(hit, (pts - c2w[:3, 3]) @ fwd, 0.0)
    return rgb.reshape(h, w, 3), alpha.reshape(h, w), z_depth.reshape(h, w)


def random_sphere_pose(g, radius=4.0):
    v = g.normal(size=3)
    v /= np.linalg.norm(v)
    eye = v * radius
    fwd = -eye / np.linalg.norm(eye)  # camera looks at origin, -z forward
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd  # z backwards (camera convention: -z forward)
    c2w[:3, 3] = eye
    return c2w


def write_split(split_dir: Path, n, w, h, g, deg=0.0, with_seg=False):
    (split_dir / "rgb").mkdir(parents=True, exist_ok=True)
    (split_dir / "depth").mkdir(parents=True, exist_ok=True)
    if with_seg:
        (split_dir / "seg").mkdir(parents=True, exist_ok=True)
    frames = {}
    for i in range(n):
        c2w = random_sphere_pose(g)
        rgb, alpha, z_depth = render_analytic(c2w, w, h, deg)
        rgba = np.concatenate(
            [(rgb * 255).astype(np.uint8), (alpha[..., None] * 255).astype(np.uint8)],
            axis=-1,
        )
        name = f"r_{i}"
        write_png(split_dir / "rgb" / f"{name}.png", rgba)
        # uint16 depth = -z_cam * 1000 (datagen/data_utils.py:61-64)
        write_png(split_dir / "depth" / f"{name}.png",
                  np.clip(z_depth * 1000.0, 0, 65535).astype(np.uint16))
        if with_seg:
            write_png(split_dir / "seg" / f"{name}.png", (alpha * 255).astype(np.uint8))
        frames[name] = c2w.tolist()
    with open(split_dir / "transforms.json", "w") as fh:
        json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, fh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--wh", nargs=2, type=int, default=[64, 48])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    w, h = args.wh
    g = np.random.default_rng(args.seed)
    out = Path(args.out)

    if args.multi:
        for inst in ["obj_a", "obj_b"]:
            for d in range(0, 100, 10):
                write_split(
                    out / inst / "train" / f"{d}_degree", args.n, w, h, g, deg=d, with_seg=True
                )
        print(f"wrote articulated fixture to {out}")
    else:
        for split, n in [("train", args.n), ("val", 2), ("test", 2)]:
            write_split(out / split, n, w, h, g)
        print(f"wrote single-scene fixture to {out}")


if __name__ == "__main__":
    main()
