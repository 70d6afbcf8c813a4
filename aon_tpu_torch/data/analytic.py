"""An analytic scene held in memory: a unit sphere at the origin, red above
and blue below a plane, seen from seeded poses on a sphere of radius 4.

A numpy copy of ``render_analytic`` and ``random_sphere_pose`` of the JAX
package's ``scripts/make_fixture_dataset.py``, which writes the same scene to
disk as a SAPIEN-layout fixture.  Here the views become whole-scene ray
buffers directly, with the targets composited on white, for smoke training
runs and tests that need no dataset on disk.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from aon_tpu_torch.core.rays import get_ray_directions, get_rays

CAMERA_ANGLE_X = 0.6911112070083618  # the fixture's, on SAPIEN's fovy-derived scale


def scene_rays(c2w: np.ndarray, w: int, h: int):
    """``(rays_o, viewdirs, rays_d)`` of one view, each (h*w, 3), rays_d unit-norm."""
    # reference focal convention: computed at h, rescaled by w/320
    focal = 0.5 * h / np.tan(0.5 * CAMERA_ANGLE_X) * (w / 320.0)
    return get_rays(get_ray_directions(h, w, focal), c2w[:3, :4], output_view_dirs=True)


def render_analytic(o: np.ndarray, rd: np.ndarray, deg: float = 0.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``(rgb (N, 3), alpha (N,))`` of the sphere along rays ``o + t * rd``; the
    colour split plane is rotated ``deg`` degrees about x."""
    b = np.sum(o * rd, axis=-1)  # ray-sphere intersection, radius 1
    disc = b * b - (np.sum(o * o, axis=-1) - 1.0)
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0)
    pts = o + t[:, None] * rd
    ang = np.deg2rad(deg)
    top = (pts @ np.array([0.0, np.cos(ang), np.sin(ang)])) > 0
    rgb = np.zeros((len(o), 3), np.float32)
    rgb[hit & top] = [0.9, 0.2, 0.15]
    rgb[hit & ~top] = [0.15, 0.3, 0.9]
    return rgb, hit.astype(np.float32)


def random_sphere_pose(g: np.random.Generator, radius: float = 4.0) -> np.ndarray:
    """A (4, 4) camera-to-world pose at ``radius`` looking at the origin."""
    v = g.normal(size=3)
    v /= np.linalg.norm(v)
    eye = v * radius
    fwd = -eye / np.linalg.norm(eye)  # -z forward
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
    return c2w


def analytic_scene(n_views: int = 8, w: int = 160, h: int = 120, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Whole-scene ray buffers ``{rays_o, rays_d, viewdirs, target}``, each
    (n_views * h * w, 3) float32; ``rays_d`` is unit-norm and the targets are
    composited on a white background."""
    g = np.random.default_rng(seed)
    parts = {"rays_o": [], "rays_d": [], "viewdirs": [], "target": []}
    for _ in range(n_views):
        o, vd, rd = scene_rays(random_sphere_pose(g), w, h)
        rgb, alpha = render_analytic(o, rd)
        parts["rays_o"].append(o)
        parts["rays_d"].append(rd)
        parts["viewdirs"].append(vd)
        parts["target"].append(rgb * alpha[:, None] + (1.0 - alpha[:, None]))
    return {k: np.concatenate(v).astype(np.float32) for k, v in parts.items()}
