"""Rays and targets worked out again from the dataset's raw files, for the
plain reference: the training batches a loader with the published sampling
draws from ``np.random.default_rng(seed)``, and a frame's rays.

* one scene (the reference's ``datasets/sapien.py``): the train images in
  file-name order, every pixel a ray, ``integers(0, n_rays, size=batch)``
  a step; RGBA blended to white; the focal from ``transforms.json``;
* articulated (``datasets/sapien_multi.py:188-241``): a step draws an
  instance, a degree directory and an image id in [0, 59) (wrapped by the
  file count), then ``integers(0, h * w, size=batch)`` pixels; RGB with the
  object's segmentation, the background black or white; the focal
  ``0.5 h / tan(camera_angle_x / 2) * w / 320``.

Directions are the pinhole's ``[(i - w/2) / f, -(j - h/2) / f, -1]`` (no
half-pixel centring) turned by the pose and normalised.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from pngio import read_png


def _by_index(files: List[str]) -> List[str]:
    return sorted(files, key=lambda f: int(f.split("_")[1].split(".")[0]))


def rays(pix: np.ndarray, w: int, h: int, focal: float, c2w: np.ndarray):
    """(rays_o, unit rays_d) float32 of pixel indices ``pix`` under ``c2w``."""
    i = (pix % w).astype(np.float32)
    j = (pix // w).astype(np.float32)
    d = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    c2w = np.asarray(c2w, np.float32)
    d = d.astype(np.float32) @ c2w[:3, :3].T
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(c2w[:3, 3], d.shape).astype(np.float32), d


class Scene:
    """The one-scene dataset's split directory."""

    def __init__(self, split_dir: str, img_wh, sort_numeric: bool):
        self.dir = split_dir
        self.w, self.h = img_wh
        with open(os.path.join(split_dir, "transforms.json")) as fh:
            self.meta = json.load(fh)
        cax = self.meta.get("camera_angle_x")
        self.focal = (0.5 * self.h / np.tan(0.5 * cax) * self.w / 320.0 if cax
                      else self.meta["focal"])
        files = os.listdir(os.path.join(split_dir, "rgb"))
        self.files = _by_index(files) if sort_numeric else sorted(files)

    def target(self, f: int, white: bool = True) -> np.ndarray:
        rgba = read_png(os.path.join(self.dir, "rgb", self.files[f])).astype(np.float32) / 255.0
        rgb, a = rgba[..., :3], rgba[..., 3:]
        return (rgb * a + (1.0 - a) if white else rgb * a).reshape(-1, 3)

    def pose(self, f: int) -> np.ndarray:
        return np.asarray(self.meta["frames"][self.files[f].split(".")[0]], np.float32)

    def frame_rays(self, f: int, pix: np.ndarray):
        return rays(pix, self.w, self.h, self.focal, self.pose(f))


def single_batches(root: str, img_wh, batch: int, seed: int, n_steps: int) -> List[Dict]:
    train = Scene(os.path.join(root, "train"), img_wh, sort_numeric=False)
    per = train.w * train.h
    g = np.random.default_rng(seed)
    idx = [g.integers(0, len(train.files) * per, size=batch) for _ in range(n_steps)]
    targets = {}
    out = []
    for ids in idx:
        o, d, tgt = np.empty((batch, 3), np.float32), np.empty((batch, 3), np.float32), \
            np.empty((batch, 3), np.float32)
        for f in np.unique(ids // per):
            sel = np.flatnonzero(ids // per == f)
            if f not in targets:
                targets[f] = train.target(int(f))
            pix = ids[sel] % per
            o[sel], d[sel] = train.frame_rays(int(f), pix)
            tgt[sel] = targets[f][pix]
        out.append({"rays_o": o, "rays_d": d, "target": tgt})
    return out


def multi_frame(root: str, img_wh, instance: str, degree_dir: str, image_id: int,
                white: bool):
    """(scene, frame index, target (h*w, 3)) of one articulated train image."""
    base = os.path.join(root, instance, "train", degree_dir)
    sc = Scene(base, img_wh, sort_numeric=True)
    f = image_id % len(sc.files)
    rgb = read_png(os.path.join(base, "rgb", sc.files[f]))[..., :3].astype(np.float32) / 255.0
    seg = read_png(os.path.join(base, "seg", sc.files[f])) > 0
    rgb = np.where(seg[..., None], rgb, 1.0 if white else 0.0).reshape(-1, 3)
    return sc, f, rgb


def degree_dirs(root: str, instance: str) -> List[str]:
    names = os.listdir(os.path.join(root, instance, "train"))
    return sorted(names, key=lambda n: int(n.split("_")[0]))


def multi_batches(root: str, img_wh, batch: int, seed: int, n_steps: int,
                  white: bool) -> List[Dict]:
    ids = sorted(e.name for e in os.scandir(root) if e.is_dir())
    w, h = img_wh
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        inst = int(g.integers(0, len(ids)))
        degs = degree_dirs(root, ids[inst])
        deg = int(g.integers(0, len(degs)))
        image_id = int(g.integers(0, 59))
        pix = g.integers(0, h * w, size=batch)
        sc, f, rgb = multi_frame(root, img_wh, ids[inst], degs[deg], image_id, white)
        o, d = sc.frame_rays(f, pix)
        out.append({"rays_o": o, "rays_d": d, "target": rgb[pix], "instance_id": inst,
                    "articulation_id": deg})
    return out
