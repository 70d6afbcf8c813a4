"""Analytic scenes held in memory: a unit sphere at the origin, red above and
blue below a plane, seen from seeded poses on a sphere of radius 4; and an
articulated family of two-sphere objects (``articulated_scene``) for the
auto-decoder.

A numpy copy of ``render_analytic`` and ``random_sphere_pose`` of the JAX
package's ``scripts/make_fixture_dataset.py``, which writes the same scene to
disk as a SAPIEN-layout fixture.  Here the views become whole-scene ray
buffers directly, with the targets composited on white, for smoke training
runs and tests that need no dataset on disk.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from aon_tpu_torch.core.rays import get_ray_directions, get_rays

CAMERA_ANGLE_X = 0.6911112070083618  # the fixture's, on SAPIEN's fovy-derived scale


def scene_rays(c2w: np.ndarray, w: int, h: int, focal: Optional[float] = None):
    """``(rays_o, viewdirs, rays_d)`` of one view, each (h*w, 3), rays_d unit-norm."""
    if focal is None:
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


# colours of the articulated scene's instances: (body, arm) per instance_id
_INSTANCE_COLOURS = (
    ((0.9, 0.2, 0.15), (0.95, 0.8, 0.2)),
    ((0.15, 0.3, 0.9), (0.2, 0.85, 0.4)),
    ((0.7, 0.2, 0.8), (0.2, 0.8, 0.85)),
    ((0.9, 0.55, 0.1), (0.85, 0.85, 0.85)),
)


def _sphere_hit(o: np.ndarray, rd: np.ndarray, centre: np.ndarray, radius: float) -> np.ndarray:
    """Distance along unit rays to a sphere, inf where a ray misses it."""
    oc = o - centre
    b = np.sum(oc * rd, axis=-1)
    disc = b * b - (np.sum(oc * oc, axis=-1) - radius * radius)
    t = -b - np.sqrt(np.maximum(disc, 0))
    return np.where((disc > 0) & (t > 0), t, np.inf)


def render_articulated(o: np.ndarray, rd: np.ndarray, instance_id: int, articulation_id: int,
                       n_articulations: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """``(rgb (N, 3), alpha (N,))`` of one articulated object along unit rays.

    A body sphere at the origin whose radius and colour follow
    ``instance_id``, and a smaller arm sphere on a circle around it in the xy
    plane whose angle follows ``articulation_id`` (0 to 90 degrees over
    ``n_articulations`` states); the nearer hit wins."""
    body_rgb, arm_rgb = _INSTANCE_COLOURS[instance_id % len(_INSTANCE_COLOURS)]
    r_body = 0.7 + 0.1 * (instance_id % 3)
    ang = 0.5 * np.pi * articulation_id / max(1, n_articulations - 1)
    arm_centre = (r_body + 0.3) * np.array([np.cos(ang), np.sin(ang), 0.0])
    t_body = _sphere_hit(o, rd, np.zeros(3), r_body)
    t_arm = _sphere_hit(o, rd, arm_centre, 0.35)
    rgb = np.zeros((len(o), 3), np.float32)
    rgb[t_body < t_arm] = body_rgb
    rgb[t_arm < t_body] = arm_rgb
    return rgb, np.isfinite(np.minimum(t_body, t_arm)).astype(np.float32)


def articulated_scene(n_instances: int = 2, n_articulations: int = 3, n_views: int = 4,
                      w: int = 160, h: int = 120, seed: int = 0) -> Dict[str, np.ndarray]:
    """Ray buffers of every ``(instance, articulation)`` pair of the family:
    ``{rays_o, rays_d, viewdirs, target}``, each (n_instances * n_articulations,
    n_views * h * w, 3) float32, pair ``p`` being instance ``p //
    n_articulations`` at articulation ``p % n_articulations``.  ``rays_d`` is
    unit-norm and the targets are composited on black (``white_back=false`` in
    the auto-decoder configurations); the horizontal field of view is
    ``CAMERA_ANGLE_X`` at every image size, so the object fills the frame.
    Smoke data for training runs and tests, not a dataset."""
    g = np.random.default_rng(seed)
    focal = 0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X)
    keys = ("rays_o", "rays_d", "viewdirs", "target")
    pairs = {k: [] for k in keys}
    for inst in range(n_instances):
        for art in range(n_articulations):
            parts = {k: [] for k in keys}
            for _ in range(n_views):
                o, vd, rd = scene_rays(random_sphere_pose(g), w, h, focal)
                rgb, alpha = render_articulated(o, rd, inst, art, n_articulations)
                for k, v in zip(keys, (o, rd, vd, rgb * alpha[:, None])):
                    parts[k].append(v)
            for k in keys:
                pairs[k].append(np.concatenate(parts[k]))
    return {k: np.stack(v).astype(np.float32) for k, v in pairs.items()}
