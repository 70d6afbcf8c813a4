"""Scene AABB from training depth maps + per-ray interval tightening (port of
``aon_tpu/data/aabb.py``; depth PNGs through ``utils/imageio.py``, the cache
file ``.aabb_cache.json`` as the JAX package writes it, so a dataset directory
prepared by either package serves both).

Speed/quality lever with no reference counterpart: the reference
samples every ray uniformly over the global ``[near, far] = [2, 6]``
(reference ``datasets/sapien.py:72-73``, ``models/vanilla_nerf/model.py:130``)
even though the object occupies <20% of the rays and ~0.6 units of the
4-unit range (measured on the laptop scene).  Here we

  1. bound the scene once from the TRAIN split's depth maps (datagen writes
     ``depth/`` uint16 = camera -z * 1000 for every frame,
     ``datagen/data_utils.py:61-64``),
  2. tighten each ray to its AABB slab interval (``core/rays.py``'s
     vectorized slab test), so the same PSNR needs far fewer samples, and
  3. declare the model EMPTY outside the AABB: rays that miss the box render
     exactly the background and carry zero loss/gradient, so training skips
     them and eval composites them for free.

The box is computed in the TRAINING camera model (the dataset's own
focal/directions at img_wh, depth nearest-resized), so it bounds the scene
exactly as the training rays see it — immune to the reference's w/320 focal
quirk (``datasets/sapien.py:62-65``).

Everything here is host-side numpy executed once per run; results are
cached next to the depth data keyed by (img_wh, pad, file set).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
from aon_tpu_torch.utils.imageio import read_png, resize_nearest

from aon_tpu_torch.core.rays import get_ray_directions, ray_box_intersection

_CACHE_NAME = ".aabb_cache.json"
_MEM_CACHE: dict = {}


def _focal_for(meta: dict, img_wh: Tuple[int, int]) -> float:
    """The dataset loaders' focal rule (parity with data/sapien*.py)."""
    w, h = img_wh
    cam_x = meta.get("camera_angle_x")
    if cam_x:
        return 0.5 * h / float(np.tan(0.5 * cam_x)) * (w / 320.0)
    focal = meta.get("focal")
    if focal is None:
        raise ValueError("transforms.json has neither camera_angle_x nor focal")
    return float(focal)


def _frame_points(
    depth_path: str, c2w: np.ndarray, directions: np.ndarray, img_wh
) -> Optional[np.ndarray]:
    """World-space points of one frame's object pixels (depth > 0)."""
    w, h = img_wh
    depth = resize_nearest(read_png(depth_path), (w, h)).astype(np.float64) / 1000.0  # -z_cam
    mask = depth > 0
    if not mask.any():
        return None
    pts_cam = directions.reshape(h, w, 3) * depth[..., None]  # dirs have z=-1
    pts = pts_cam[mask] @ c2w[:3, :3].T + c2w[:3, 3]
    return np.stack([pts.min(axis=0), pts.max(axis=0)])


def _bounds_of_dir(scene_dir: str, img_wh) -> Optional[np.ndarray]:
    """(2, 3) min/max over one {rgb,depth,transforms.json} directory."""
    depth_dir = os.path.join(scene_dir, "depth")
    tf_path = os.path.join(scene_dir, "transforms.json")
    if not (os.path.isdir(depth_dir) and os.path.isfile(tf_path)):
        return None
    with open(tf_path) as fh:
        meta = json.load(fh)
    w, h = img_wh
    directions = np.asarray(get_ray_directions(h, w, _focal_for(meta, img_wh)))
    lo, hi = None, None
    for f in sorted(os.listdir(depth_dir)):
        name = f.split(".")[0]
        if name not in meta["frames"]:
            continue
        c2w = np.array(meta["frames"][name], dtype=np.float64)[:3, :4]
        mm = _frame_points(os.path.join(depth_dir, f), c2w, directions, img_wh)
        if mm is None:
            continue
        lo = mm[0] if lo is None else np.minimum(lo, mm[0])
        hi = mm[1] if hi is None else np.maximum(hi, mm[1])
    if lo is None:
        return None
    return np.stack([lo, hi])


def scene_aabb(
    scene_dirs: List[str], img_wh, pad: float = 0.05
) -> Optional[np.ndarray]:
    """Padded (2, 3) [min, max] union over scene directories, or None when
    no depth data exists (AABB tightening then silently disables)."""
    key = (tuple(sorted(scene_dirs)), tuple(img_wh), float(pad))
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]

    cache_path = os.path.join(scene_dirs[0], _CACHE_NAME)
    cache_key = {
        "dirs": sorted(os.path.abspath(d) for d in scene_dirs),
        "img_wh": list(img_wh),
        "pad": float(pad),
    }
    try:
        with open(cache_path) as fh:
            cached = json.load(fh)
        if cached.get("key") == cache_key:
            bounds = np.asarray(cached["bounds"], dtype=np.float64)
            _MEM_CACHE[key] = bounds
            return bounds
    except (OSError, ValueError, KeyError):
        pass

    lo, hi = None, None
    for d in scene_dirs:
        mm = _bounds_of_dir(d, img_wh)
        if mm is None:
            continue
        lo = mm[0] if lo is None else np.minimum(lo, mm[0])
        hi = mm[1] if hi is None else np.maximum(hi, mm[1])
    if lo is None:
        _MEM_CACHE[key] = None
        return None
    bounds = np.stack([lo - pad, hi + pad])
    _MEM_CACHE[key] = bounds
    try:
        with open(cache_path, "w") as fh:
            json.dump({"key": cache_key, "bounds": bounds.tolist()}, fh)
    except OSError:
        pass
    return bounds


def ray_intervals(
    bounds: np.ndarray, rays_o: np.ndarray, dirs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-ray (hit, t_near, t_far) against ``bounds`` along UNIT ``dirs``
    (the sampling t-axis is the dataset's normalized viewdirs)."""
    hit, tn, tf = ray_box_intersection(bounds, rays_o, dirs)
    return hit, tn.astype(np.float32), tf.astype(np.float32)


def ray_intervals_with_grid(
    bounds: np.ndarray,
    grid: Optional[np.ndarray],
    rays_o: np.ndarray,
    dirs: np.ndarray,
    dilate: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Slab intervals, optionally refined by an occupancy grid
    (``data/occgrid.py``).  ``grid=None`` degrades to the plain AABB path;
    ``dilate`` is the grid's dilation count (sets the safe probe step)."""
    hit, tn, tf = ray_intervals(bounds, rays_o, dirs)
    if grid is not None:
        from aon_tpu_torch.data.occgrid import refine_intervals

        hit, tn, tf = refine_intervals(
            bounds, grid, rays_o, dirs, hit, tn, tf, dilate=dilate
        )
    return hit, tn, tf
