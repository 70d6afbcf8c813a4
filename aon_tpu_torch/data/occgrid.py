"""Occupancy-grid ray-interval refinement on top of the scene AABB (port of
``aon_tpu/data/occgrid.py``; depth PNGs through ``utils/imageio.py``, the
cache file ``.occgrid_cache.npz`` as the JAX package writes it).

Second-stage speed/quality lever with no reference counterpart (the
reference samples the global ``[2, 6]`` interval uniformly — reference
``models/vanilla_nerf/model.py:130``, ``datasets/sapien.py:72-73``).  The
scene AABB (``data/aabb.py``) already tightens each ray to its box slab, but
the box bounds the WHOLE object: a ray can cross an empty box corner and
never come near the surface.  Here we

  1. splat the TRAIN split's depth points (the same source the AABB uses)
     into a ``res``³ boolean voxel grid over the padded bounds, dilated by
     ``dilate`` 6-connected iterations so thin surfaces can't be missed,
  2. march probe points along each ray's slab interval (step = one voxel
     edge when dilate >= 2 — the dilated blob is >= 2/sqrt(3) voxels thick
     along any line so it cannot fall between probes; half a voxel
     otherwise) and shrink the interval to [first, last] occupied probe
     ± one step,
  3. drop rays whose slab crosses only empty voxels (they render exactly
     the background, like AABB misses).

Everything is host-side numpy executed once per dataset load; the grid is
cached next to the depth data (``.occgrid_cache.npz``) keyed by its inputs.
The refined intervals flow through the existing ``t_near``/``t_far`` and
``hit`` plumbing — kernels and trainer are unchanged.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
from aon_tpu_torch.utils.imageio import read_png, resize_nearest

from aon_tpu_torch.core.rays import get_ray_directions
from aon_tpu_torch.data.aabb import _focal_for, scene_aabb

_CACHE_NAME = ".occgrid_cache.npz"
_MEM_CACHE: dict = {}


def _dilate6(grid: np.ndarray, iterations: int) -> np.ndarray:
    """6-connected binary dilation (no scipy dependency)."""
    g = grid
    for _ in range(iterations):
        p = np.pad(g, 1)
        g = (
            p[1:-1, 1:-1, 1:-1]
            | p[:-2, 1:-1, 1:-1] | p[2:, 1:-1, 1:-1]
            | p[1:-1, :-2, 1:-1] | p[1:-1, 2:, 1:-1]
            | p[1:-1, 1:-1, :-2] | p[1:-1, 1:-1, 2:]
        )
    return g


def _splat_dir(
    scene_dir: str, img_wh, bounds: np.ndarray, res: int, grid: np.ndarray
) -> None:
    """OR one {depth,transforms.json} directory's surface points into grid."""
    depth_dir = os.path.join(scene_dir, "depth")
    tf_path = os.path.join(scene_dir, "transforms.json")
    if not (os.path.isdir(depth_dir) and os.path.isfile(tf_path)):
        return
    with open(tf_path) as fh:
        meta = json.load(fh)
    w, h = img_wh
    directions = np.asarray(get_ray_directions(h, w, _focal_for(meta, img_wh)))
    lo = bounds[0]
    voxel = (bounds[1] - bounds[0]) / res
    for f in sorted(os.listdir(depth_dir)):
        name = f.split(".")[0]
        if name not in meta["frames"]:
            continue
        depth = resize_nearest(read_png(os.path.join(depth_dir, f)), (w, h))
        depth = depth.astype(np.float64) / 1000.0
        mask = depth > 0
        if not mask.any():
            continue
        c2w = np.array(meta["frames"][name], dtype=np.float64)[:3, :4]
        pts_cam = directions.reshape(h, w, 3) * depth[..., None]
        pts = pts_cam[mask] @ c2w[:3, :3].T + c2w[:3, 3]
        ijk = np.clip(((pts - lo) / voxel).astype(np.int64), 0, res - 1)
        grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True


def scene_occgrid(
    scene_dirs: List[str],
    img_wh,
    pad: float = 0.05,
    res: int = 128,
    dilate: int = 2,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(bounds (2,3), occupancy grid (res,res,res) bool) from train depth
    maps, or (None, None) when no depth data exists (feature disables)."""
    key = (tuple(sorted(scene_dirs)), tuple(img_wh), float(pad), res, dilate)
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]

    bounds = scene_aabb(scene_dirs, img_wh, pad=pad)
    if bounds is None:
        _MEM_CACHE[key] = (None, None)
        return None, None

    cache_path = os.path.join(scene_dirs[0], _CACHE_NAME)
    cache_key = {
        "dirs": sorted(os.path.abspath(d) for d in scene_dirs),
        "img_wh": list(img_wh), "pad": float(pad), "res": res,
        "dilate": dilate, "bounds": bounds.tolist(),
    }
    try:
        with np.load(cache_path, allow_pickle=False) as z:
            if json.loads(str(z["key"])) == cache_key:
                grid = np.unpackbits(z["grid"])[: res ** 3].reshape(
                    res, res, res
                ).astype(bool)
                _MEM_CACHE[key] = (bounds, grid)
                return bounds, grid
    except (OSError, ValueError, KeyError):
        pass

    grid = np.zeros((res, res, res), dtype=bool)
    for d in scene_dirs:
        _splat_dir(d, tuple(img_wh), bounds, res, grid)
    if not grid.any():
        _MEM_CACHE[key] = (None, None)
        return None, None
    grid = _dilate6(grid, dilate)

    try:
        np.savez_compressed(
            cache_path, key=json.dumps(cache_key), grid=np.packbits(grid)
        )
    except OSError:
        pass
    _MEM_CACHE[key] = (bounds, grid)
    return bounds, grid


def refine_intervals(
    bounds: np.ndarray,
    grid: np.ndarray,
    rays_o: np.ndarray,
    dirs: np.ndarray,
    hit: np.ndarray,
    t_near: np.ndarray,
    t_far: np.ndarray,
    chunk: int = 16384,
    dilate: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shrink each slab interval to [first, last] occupied probe ± one step.

    Args are the slab results from ``aabb.ray_intervals`` (UNIT ``dirs``).
    Returns refined (hit, t_near, t_far): rays whose slab crosses only empty
    voxels become misses; survivors get sub-slab intervals.
    """
    res = grid.shape[0]
    lo = bounds[0].astype(np.float32)
    voxel = ((bounds[1] - bounds[0]) / res).astype(np.float32)
    # probe step: after >=2 dilation iterations the thinnest occupied blob
    # cross-section is ~2/sqrt(3) = 1.15 voxel edges along any line, so a
    # 1-voxel-edge step cannot skip it; a bare splat needs half-voxel probes
    min_edge = float(voxel.min())
    step = np.float32(min_edge if dilate >= 2 else 0.5 * min_edge)

    out_hit = hit.copy()
    out_tn = t_near.astype(np.float32).copy()
    out_tf = t_far.astype(np.float32).copy()
    idx = np.flatnonzero(hit)
    if idx.size == 0:
        return out_hit, out_tn, out_tf

    flat = np.ascontiguousarray(grid.reshape(-1).view(np.uint8))
    s_yz = np.int32(res * res)
    s_z = np.int32(res)

    # sort by span so each chunk's probe count K fits ITS rays, not the
    # global worst case (most slab spans are far below the box diagonal)
    spans = (t_far[idx] - t_near[idx]).astype(np.float32)
    idx = idx[np.argsort(spans)]

    for s in range(0, idx.size, chunk):
        c = idx[s : s + chunk]
        o = rays_o[c].astype(np.float32)
        d = dirs[c].astype(np.float32)
        t0 = t_near[c].astype(np.float32)
        t1 = t_far[c].astype(np.float32)
        K = int(np.ceil(float((t1 - t0).max()) / step)) + 2
        ts = t0[:, None] + np.arange(K, dtype=np.float32)[None, :] * step
        pts = o[:, None, :] + ts[..., None] * d[:, None, :]
        ijk = ((pts - lo) / voxel).astype(np.int32)
        np.clip(ijk, 0, res - 1, out=ijk)
        lin = (ijk[..., 0] * s_yz + ijk[..., 1] * s_z + ijk[..., 2]).ravel()
        occ = flat[lin].reshape(ts.shape).astype(bool)
        occ &= ts <= t1[:, None] + step
        any_occ = occ.any(axis=1)
        first = occ.argmax(axis=1)
        last = K - 1 - occ[:, ::-1].argmax(axis=1)
        new_tn = np.maximum(t0, t0 + (first - 1) * step)
        new_tf = np.minimum(t1, t0 + (last + 1) * step)
        out_hit[c] = any_occ
        out_tn[c] = np.where(any_occ, new_tn, t0).astype(np.float32)
        out_tf[c] = np.where(any_occ, new_tf, t1).astype(np.float32)
    return out_hit, out_tn, out_tf
