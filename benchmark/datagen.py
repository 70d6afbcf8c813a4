"""The configurations' datasets, rendered from their URDFs on the CPU.

A frozen copy of the repository's soft SAPIEN stand-in (``datagen/softsim.py``:
box visuals of a URDF, revolute joints, slab-test ray casting, Lambertian
shading under an ambient and a directional light, a checker texture) and of
its pose math (``datagen/data_utils.py``: random sphere poses of radius
4 +/- 0.5 looking at the origin, one seed a split), in numpy alone.  A
configuration's ``dataset`` entry lists its scenes as the datagen configs
give them (``configs/datagen/*.json``: URDF, resolution, splits, joint
degrees or the fixed lid angle, seed).

Only what the loaders read is written: ``rgb/r_i.png`` (RGBA, alpha zero
off the object) and, for articulated scenes, ``seg/r_i.png`` (0 / 255), with
``transforms.json``.  Depth maps feed only the scene-AABB and occupancy
intervals, which neither configuration uses.

``ensure_dataset`` renders a dataset once into a fixed directory and marks
it complete; later runs find the mark and render nothing.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from pngio import write_png

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
FOVY_DEG = 35.0
CAM_NEAR = 0.1
AMBIENT = np.array([0.5, 0.5, 0.5])
LIGHT_DIR = np.array([0.0, 1.0, -1.0]) / math.sqrt(2.0)
LIGHT_RGB = np.array([0.9, 0.9, 0.9])
DONE = ".complete"


# ------------------------------------------------------------------ poses


def sample_sphere_points(n: int, seed: int, radius: float = 4.0, jitter: float = 0.5):
    g = np.random.default_rng(seed)
    pts = g.normal(size=(n, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts[:, 2] = np.abs(pts[:, 2])
    r = radius + g.uniform(-jitter, jitter, size=(n, 1))
    return (pts * r).astype(np.float64)


def look_at_c2w(eye: np.ndarray) -> np.ndarray:
    up = np.array([0.0, 0.0, 1.0])
    fwd = -np.asarray(eye, np.float64)
    fwd /= np.linalg.norm(fwd)
    if abs(fwd @ up) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = np.cross(right, fwd)
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


# ------------------------------------------------------------------- URDF


def _rpy(rpy) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p), math.sin(p),
                              math.cos(y), math.sin(y))
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


def _axis_angle(axis, angle) -> np.ndarray:
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    return np.array([[x * x * C + c, x * y * C - z * s, x * z * C + y * s],
                     [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
                     [z * x * C - y * s, z * y * C + x * s, z * z * C + c]])


def _tf(rot, pos) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = rot
    t[:3, 3] = pos
    return t


def _origin(el) -> np.ndarray:
    if el is None:
        return np.eye(4)
    return _tf(_rpy([float(v) for v in el.get("rpy", "0 0 0").split()]),
               [float(v) for v in el.get("xyz", "0 0 0").split()])


class Articulation:
    """A URDF's box visuals on a chain of fixed and revolute joints."""

    def __init__(self, path: str):
        root = ET.parse(path).getroot()
        self.links: List[str] = []
        self.boxes: List[dict] = []
        for link in root.findall("link"):
            self.links.append(link.get("name"))
            for vis in link.findall("visual"):
                geom = vis.find("geometry/box")
                if geom is None:
                    continue
                cel = vis.find("material/color")
                color = [0.7, 0.7, 0.7] if cel is None else [
                    float(v) for v in cel.get("rgba", "0.7 0.7 0.7 1").split()][:3]
                self.boxes.append(dict(
                    link=link.get("name"), link_idx=len(self.links),
                    half=np.array([float(v) for v in geom.get("size").split()]) / 2.0,
                    local=_origin(vis.find("origin")), color=np.array(color)))
        self.joints = []
        for j in root.findall("joint"):
            ax = j.find("axis")
            self.joints.append(dict(
                type=j.get("type", "fixed"), origin=_origin(j.find("origin")),
                axis=np.array([1.0, 0, 0]) if ax is None else np.array(
                    [float(v) for v in ax.get("xyz").split()]),
                parent=j.find("parent").get("link"), child=j.find("child").get("link")))
        children = {j["child"] for j in self.joints}
        self.root = [n for n in self.links if n not in children][0]
        self.movable = [j for j in self.joints if j["type"] in ("revolute", "continuous")]
        self.set_qpos(np.zeros(len(self.movable)))

    def set_qpos(self, qpos) -> None:
        q = {id(j): float(v) for j, v in zip(self.movable, qpos)}
        poses: Dict[str, np.ndarray] = {self.root: np.eye(4)}
        remaining = list(self.joints)
        while remaining:
            for j in list(remaining):
                if j["parent"] in poses:
                    motion = (_tf(_axis_angle(j["axis"], q[id(j)]), [0, 0, 0])
                              if id(j) in q else np.eye(4))
                    poses[j["child"]] = poses[j["parent"]] @ j["origin"] @ motion
                    remaining.remove(j)
        for b in self.boxes:
            b["world"] = poses[b["link"]] @ b["local"]


def _checker(u, v, period: float = 0.08):
    return 0.55 + 0.45 * ((np.floor(u / period) + np.floor(v / period)) % 2.0)


def render(art: Articulation, c2w: np.ndarray, w: int, h: int):
    """(rgba (h, w, 4) uint8 with alpha zero off the object, seg (h, w) bool)."""
    f = 0.5 * h / math.tan(0.5 * math.radians(FOVY_DEG))
    i, j = np.meshgrid(np.arange(w), np.arange(h))
    dirs = np.stack([(i - w / 2.0) / f, -(j - h / 2.0) / f, -np.ones_like(i, np.float64)],
                    -1).reshape(-1, 3)
    rd = dirs @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(c2w[:3, 3], rd.shape)
    n = rd.shape[0]
    best_t, best_link, best_rgb = np.full(n, np.inf), np.zeros(n, np.int64), np.zeros((n, 3))
    for box in art.boxes:
        w2b = np.linalg.inv(box["world"])
        o = ro @ w2b[:3, :3].T + w2b[:3, 3]
        d = rd @ w2b[:3, :3].T
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t0 = (-box["half"] - o) * inv
            t1 = (box["half"] - o) * inv
        tn = np.nanmax(np.minimum(t0, t1), axis=-1)
        tf = np.nanmin(np.maximum(t0, t1), axis=-1)
        hit = (tf >= np.maximum(tn, CAM_NEAR)) & (tn < best_t) & (tn > CAM_NEAR)
        if not hit.any():
            continue
        t_hit = tn[hit]
        p = o[hit] + t_hit[:, None] * d[hit]
        face = np.argmin(np.abs(np.abs(p) - box["half"]), axis=-1)
        rows = np.arange(p.shape[0])
        normal = np.zeros_like(p)
        normal[rows, face] = np.sign(p[rows, face])
        normal_w = normal @ box["world"][:3, :3].T
        uvw = p + box["half"]
        tex = _checker(uvw[rows, (face + 1) % 3], uvw[rows, (face + 2) % 3])[:, None]
        shade = AMBIENT + np.maximum(0.0, -(normal_w @ LIGHT_DIR))[:, None] * LIGHT_RGB
        best_t[hit] = t_hit
        best_link[hit] = box["link_idx"]
        best_rgb[hit] = np.clip(box["color"] * tex * shade, 0.0, 1.0)
    color = np.zeros((n, 4), np.float32)
    color[:, 3] = 1.0
    hit_any = np.isfinite(best_t)
    color[hit_any, :3] = best_rgb[hit_any].astype(np.float32)
    rgba = (color.reshape(h, w, 4) * 255).astype(np.uint8)
    seg = (best_link > 0).reshape(h, w)
    rgba[..., 3] = np.where(seg, rgba[..., 3], 0)
    return rgba, seg


# ---------------------------------------------------------------- writing


def _cax_for_loader(w: int) -> float:
    """camera_angle_x whose trip through the multi-instance loader's focal,
    0.5 h / tan(cax / 2) * (w / 320), gives the render's focal."""
    return 2.0 * math.atan(math.tan(0.5 * math.radians(FOVY_DEG)) * w / 320.0)


def _write_split(base: str, art: Articulation, poses, w: int, h: int, seg: bool,
                 meta: dict) -> None:
    os.makedirs(os.path.join(base, "rgb"), exist_ok=True)
    if seg:
        os.makedirs(os.path.join(base, "seg"), exist_ok=True)
    frames = {}
    for i, c2w in enumerate(poses):
        rgba, mask = render(art, c2w, w, h)
        write_png(os.path.join(base, "rgb", f"r_{i}.png"), rgba)
        if seg:
            write_png(os.path.join(base, "seg", f"r_{i}.png"), mask.astype(np.uint8) * 255)
        frames[f"r_{i}"] = np.asarray(c2w).tolist()
    with open(os.path.join(base, "transforms.json"), "w") as fh:
        json.dump(dict(meta, frames=frames), fh)


def write_scene(scene: dict, out_dir: str) -> None:
    """One datagen config's files under ``out_dir``."""
    w, h = scene["resolution"]
    art = Articulation(os.path.join(ASSETS, scene["urdf"]))
    poses, seed = {}, scene["seed"]
    for split, n in scene["splits"].items():
        poses[split] = [look_at_c2w(p) for p in sample_sphere_points(n, seed)]
        seed += 1
    degrees = scene.get("joint_degrees")
    if degrees is None:  # one scene: the lid fixed, the literal focal
        art.set_qpos([math.radians(scene["qpos_deg"])])
        focal = 0.5 * h / math.tan(0.5 * math.radians(FOVY_DEG))
        for split, ps in poses.items():
            _write_split(os.path.join(out_dir, split), art, ps, w, h, False, {"focal": focal})
        return
    for deg in degrees:
        art.set_qpos([math.radians(deg)])
        for split, ps in poses.items():
            _write_split(os.path.join(out_dir, split, f"{deg}_degree"), art, ps, w, h, True,
                         {"camera_angle_x": _cax_for_loader(w)})


def ensure_dataset(dataset: dict, root: str) -> str:
    """The dataset's directory under ``root``, rendered if it is not complete."""
    out = os.path.join(root, dataset["name"])
    if os.path.exists(os.path.join(out, DONE)):
        return out
    shutil.rmtree(out, ignore_errors=True)
    for scene in dataset["scenes"]:
        write_scene(scene, os.path.join(out, scene.get("dir", ".")))
    with open(os.path.join(out, DONE), "w") as fh:
        fh.write("ok\n")
    return out
