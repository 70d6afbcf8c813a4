"""Camera-pose visualizer for SAPIEN-layout datasets (port of
``scripts/visualize_cameras.py``; host numpy only, no matplotlib).

Reads any ``transforms.json`` tree and draws, as the JAX script's matplotlib
figure does: the camera centres (black), each camera's x / y / z axes at
``axis_len`` in red / green / blue, its look direction ``-z * 2 * axis_len``
dashed in cyan, the object origin (an orange star) and the cube
``[-lim, lim]^3`` with ``lim = 1.2 * max |centre|`` (grey edges), seen from
matplotlib's default 3D view (azimuth -60 deg, elevation 30 deg, z up) in an
orthographic projection, into a 960x960 PNG (the JAX figure's 8 in at 120 dpi).

    python -m aon_tpu_torch.scripts.visualize_cameras DATA_ROOT [--split train] [--out cams.png]
    python -m aon_tpu_torch.scripts.visualize_cameras MULTI_ROOT --instance obj_a --degree 0 ...

The geometry (``camera_segments``, ``plot_limit``) is apart from the
rasterizer (``render``), so that it can be held to the lines the JAX script
hands matplotlib.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from aon_tpu_torch.utils.device import DeviceLike, resolve_device
from aon_tpu_torch.utils.imageio import write_png

AXIS_COLORS = ("r", "g", "b")  # x right, y up, z backward
LOOK_COLOR = "c"
RGB = {"r": (255, 0, 0), "g": (0, 128, 0), "b": (0, 0, 255), "c": (0, 191, 191),
       "k": (0, 0, 0), "orange": (255, 165, 0), "grey": (190, 190, 190)}
VIEW_AZIM_DEG, VIEW_ELEV_DEG = -60.0, 30.0
IMAGE_SIZE = 960
DASH_ON, DASH_OFF = 6, 4  # pixels


def load_poses(root: str, split: str, instance: Optional[str] = None,
               degree: Optional[int] = None) -> np.ndarray:
    if instance is not None:
        base = os.path.join(root, instance, "train", f"{degree}_degree")
    else:
        base = os.path.join(root, split)
    with open(os.path.join(base, "transforms.json")) as fh:
        meta = json.load(fh)
    return np.stack([np.array(m, np.float32) for m in meta["frames"].values()])


def camera_segments(poses: np.ndarray, axis_len: float = 0.5
                    ) -> Tuple[np.ndarray, np.ndarray, List[str], np.ndarray]:
    """The segments the figure draws, in its order: per camera its x, y, z
    axes, then its look direction.  Returns ``(starts (M, 3), ends (M, 3),
    colors (M,), dashed (M,))``."""
    starts, ends, colors, dashed = [], [], [], []
    for pose in poses:
        o = pose[:3, 3]
        for i, c in enumerate(AXIS_COLORS):
            starts.append(o)
            ends.append(o + pose[:3, i] * axis_len)
            colors.append(c)
            dashed.append(False)
        starts.append(o)
        ends.append(o + (-pose[:3, 2] * axis_len * 2))
        colors.append(LOOK_COLOR)
        dashed.append(True)
    return np.array(starts), np.array(ends), colors, np.array(dashed)


def plot_limit(poses: np.ndarray) -> float:
    """Half the side of the plotted cube: 1.2 x the largest centre coordinate."""
    return float(np.abs(poses[:, :3, 3]).max() * 1.2)


def project(points: np.ndarray, lim: float, size: int = IMAGE_SIZE) -> np.ndarray:
    """(N, 3) world points -> (N, 2) pixel (column, row) in the default view,
    the cube's corners inside the image with a margin."""
    az, el = math.radians(VIEW_AZIM_DEG), math.radians(VIEW_ELEV_DEG)
    right = np.array([-math.sin(az), math.cos(az), 0.0])
    up = np.array([-math.sin(el) * math.cos(az), -math.sin(el) * math.sin(az), math.cos(el)])
    p = np.asarray(points, np.float64) / lim
    scale = 0.45 * size / math.sqrt(3.0)  # the cube's half-diagonal fits
    return np.stack([size / 2 + scale * (p @ right), size / 2 - scale * (p @ up)], axis=-1)


def _stamp(img: np.ndarray, xy: np.ndarray, color, radius: int = 0) -> None:
    """Paint the pixels within ``radius`` of each (column, row) in ``xy``."""
    h, w = img.shape[:2]
    cols, rows = np.rint(xy[:, 0]).astype(int), np.rint(xy[:, 1]).astype(int)
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            if dr * dr + dc * dc > radius * radius:
                continue
            r, c = rows + dr, cols + dc
            ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            img[r[ok], c[ok]] = color


def _line(img: np.ndarray, a: np.ndarray, b: np.ndarray, color, dashed: bool = False) -> None:
    n = int(np.ceil(np.abs(b - a).max())) + 1
    s = np.arange(n + 1)
    pts = a + (b - a) * (s[:, None] / max(n, 1))
    if dashed:
        pts = pts[(s % (DASH_ON + DASH_OFF)) < DASH_ON]
    _stamp(img, pts, color)


def render(poses: np.ndarray, axis_len: float = 0.5, size: int = IMAGE_SIZE) -> np.ndarray:
    """The figure as a (size, size, 3) uint8 image."""
    lim = plot_limit(poses)
    img = np.full((size, size, 3), 255, np.uint8)
    corners = np.array([[x, y, z] for x in (-lim, lim) for y in (-lim, lim) for z in (-lim, lim)])
    cpx = project(corners, lim, size)
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(corners[i] != corners[j]) == 1:  # a cube edge
                _line(img, cpx[i], cpx[j], RGB["grey"])
    starts, ends, colors, dashed = camera_segments(poses, axis_len)
    spx, epx = project(starts, lim, size), project(ends, lim, size)
    for a, b, c, d in zip(spx, epx, colors, dashed):
        _line(img, a, b, RGB[c], bool(d))
    _stamp(img, project(poses[:, :3, 3], lim, size), RGB["k"], radius=2)
    origin = project(np.zeros((1, 3)), lim, size)[0]
    arms = np.array([[math.cos(t), math.sin(t)] for t in np.linspace(0, 2 * math.pi, 5,
                                                                        endpoint=False)])
    for arm in arms:  # a five-armed star
        _line(img, origin, origin + 8 * arm, RGB["orange"])
    _stamp(img, origin[None], RGB["orange"], radius=2)
    return img


def plot_cameras(poses: np.ndarray, out: str, axis_len: float = 0.5) -> np.ndarray:
    img = render(poses, axis_len)
    write_png(out, img)
    print(f"wrote {out} ({len(poses)} cameras)")
    return img


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda") -> np.ndarray:
    """Draw the figure; the work is host numpy, and the device is resolved only
    as every entry point of the port resolves it."""
    resolve_device(device)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--split", default="train")
    ap.add_argument("--instance", default=None)
    ap.add_argument("--degree", type=int, default=0)
    ap.add_argument("--out", default="cameras.png")
    args = ap.parse_args(argv)
    poses = load_poses(args.root, args.split, args.instance, args.degree)
    return plot_cameras(poses, args.out)


if __name__ == "__main__":
    main()
