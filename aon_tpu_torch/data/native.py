"""The numpy paths of ``aon_tpu/native/__init__.py``.

The JAX package binds an optional ctypes library for four host-side helpers
and falls back to numpy when it is missing; the port keeps only the numpy
paths, which give the same results as the JAX package's fallbacks bit for
bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from aon_tpu_torch.core.rays import ray_box_intersection


def ray_batch_gather(
    rays_o: np.ndarray, viewdirs: np.ndarray, rgbs: np.ndarray, idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """out[i] = buffers[idx[i]] for the three (n, 3) scene buffers."""
    return rays_o[idx], viewdirs[idx], rgbs[idx]


def aabb_intersect(
    bounds: np.ndarray, rays_o: np.ndarray, rays_d: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return ray_box_intersection(bounds, rays_o, rays_d)


def rgba_blend_white(rgba_u8: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBA -> (..., 3) float32 blended onto white."""
    f = np.ascontiguousarray(rgba_u8.reshape(-1, 4), np.uint8).astype(np.float32) / 255.0
    out = f[:, :3] * f[:, 3:] + (1.0 - f[:, 3:])
    return out.reshape(*rgba_u8.shape[:-1], 3)


def generate_rays(dirs: np.ndarray, c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 3) camera dirs + (3, 4) c2w -> (rays_o, unit viewdirs), both (n, 3)."""
    dirs = np.ascontiguousarray(dirs.reshape(-1, 3), np.float32)
    c2w = np.ascontiguousarray(c2w, np.float32)
    w = dirs @ c2w[:, :3].T
    v = w / np.linalg.norm(w, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:, 3], v.shape).copy()
    return o.astype(np.float32), v.astype(np.float32)
