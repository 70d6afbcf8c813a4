"""Single-scene SAPIEN dataset (port of ``aon_tpu/data/sapien.py``: host-side
numpy, fixed-shape batches).

Disk layout and semantics from reference ``datasets/sapien.py``:

* ``{root}/{split}/rgb/*.png`` + ``{root}/{split}/transforms.json``;
* focal from ``camera_angle_x`` (``0.5*h/tan(0.5*angle)``) rescaled by
  ``w/320`` (sapien.py:62-65), or a literal ``focal`` key;
* near/far fixed at 2.0/6.0 (sapien.py:72-73);
* images LANCZOS-resized to ``img_wh`` (Pillow's resize, through
  ``utils/imageio.py``), RGBA alpha-blended to WHITE (sapien.py:96-99)
  regardless of white_back (parity quirk kept);
* train: every ray of every image goes into flat buffers; with the scene
  AABB (``use_aabb``) or the occupancy grid (``use_occgrid``) only the rays
  that hit it, with their per-ray ``t_near`` / ``t_far``; batches are
  uniform random rays from ``np.random.default_rng(seed)``, so they are the
  JAX package's bit for bit;
* val/test: one full image of rays per item, with ``instance_mask`` from
  alpha > 0; val/test file lists sorted by the integer in ``name_123.png``.

The occupancy-refined intervals of the train split are cached in the split's
directory as ``.occ_intervals_{w}x{h}_n{N}.npz``, the JAX package's file.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Iterator, List, Optional

import numpy as np

from aon_tpu_torch.core.rays import get_ray_directions, get_rays
from aon_tpu_torch.data import native
from aon_tpu_torch.data.aabb import ray_intervals_with_grid, scene_aabb
from aon_tpu_torch.data.occgrid import scene_occgrid
from aon_tpu_torch.utils.imageio import read_png, resize_lanczos

NEAR, FAR = 2.0, 6.0


def _sorted_by_index(files: List[str]) -> List[str]:
    return [files[i] for i in np.argsort([int(f.split("_")[1].split(".")[0]) for f in files])]


def _load_rgba(path: str, img_wh) -> np.ndarray:
    arr = resize_lanczos(read_png(path), img_wh).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.ones_like(arr)], axis=-1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
    return arr  # (h, w, 4)


class SapienDataset:
    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh=(320, 240),
        model_type: Optional[str] = None,
        white_back: Optional[bool] = None,
        eval_inference: Optional[str] = None,
        use_aabb: bool = False,
        aabb_pad: float = 0.05,
        use_occgrid: bool = False,
        occgrid_res: int = 128,
        occgrid_dilate: int = 2,
    ):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.white_back = white_back
        self.near, self.far = NEAR, FAR

        # bounds always come from the TRAIN split's depth maps so train/val/
        # test agree on where the model is defined; None when depth data is
        # absent (feature off)
        self.scene_bounds = None
        self.occ_grid = None
        self._occ_dilate = occgrid_dilate
        train_dir = [os.path.join(root_dir, "train")]
        if use_occgrid:
            self.scene_bounds, self.occ_grid = scene_occgrid(
                train_dir, tuple(img_wh), pad=aabb_pad, res=occgrid_res, dilate=occgrid_dilate,
            )
        elif use_aabb:
            self.scene_bounds = scene_aabb(train_dir, tuple(img_wh), pad=aabb_pad)

        w, h = self.img_wh
        split_dir = {"train": "train", "val": "val"}.get(split, "test")
        base_dir = os.path.join(root_dir, split_dir)
        self.base_dir = base_dir

        with open(os.path.join(base_dir, "transforms.json")) as fh:
            self.meta = json.load(fh)

        cam_x = self.meta.get("camera_angle_x")
        if cam_x:
            self.focal = 0.5 * h / np.tan(0.5 * cam_x)
            self.focal *= w / 320.0
        else:
            self.focal = self.meta.get("focal")
            if self.focal is None:
                raise ValueError("focal length not found in transforms.json")

        self.directions = get_ray_directions(h, w, self.focal)

        files = sorted(os.listdir(os.path.join(base_dir, "rgb")))
        if split != "train":
            files = _sorted_by_index(files)
        self.img_files = files

        num = len(files) if eval_inference is not None else 1
        self.image_sizes = np.array([[h, w] for _ in range(num)])

        if split == "train":
            self._build_train_buffers()

    def _frame_rays(self, img_file: str):
        """(rgba (h, w, 4), rays_o, viewdirs) of one image of the split."""
        pose = np.array(self.meta["frames"][img_file.split(".")[0]], dtype=np.float32)
        rgba = _load_rgba(os.path.join(self.base_dir, "rgb", img_file), self.img_wh)
        rays_o, viewdirs, _, _ = get_rays(
            self.directions, pose[:3, :4], output_view_dirs=True, output_radii=True
        )
        return pose, rgba, rays_o, viewdirs

    def _build_train_buffers(self) -> None:
        all_rays_o, all_viewdirs, all_rgbs, all_alpha = [], [], [], []
        self.poses = []
        for img_file in self.img_files:
            pose, rgba, rays_o, viewdirs = self._frame_rays(img_file)
            self.poses.append(pose)
            rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])  # blend to white
            all_rays_o.append(rays_o)
            all_viewdirs.append(viewdirs)
            all_rgbs.append(rgb.reshape(-1, 3).astype(np.float32))
            if self.scene_bounds is not None:
                all_alpha.append(rgba[..., 3].reshape(-1))
        self.all_rays_o = np.concatenate(all_rays_o, 0)
        self.all_viewdirs = np.concatenate(all_viewdirs, 0)
        self.all_rgbs = np.concatenate(all_rgbs, 0)

        if self.scene_bounds is None:
            return
        # keep only rays whose interval hits the scene: the model is empty
        # outside, so missed rays render exactly the background with zero
        # loss and gradient
        hit, tn, tf = self._train_intervals()
        alpha = np.concatenate(all_alpha, 0)
        dropped_fg = float(((alpha > 0) & ~hit).sum()) / max(1, int((alpha > 0).sum()))
        self.aabb_dropped_fg_frac = dropped_fg
        if dropped_fg > 1e-3:
            warnings.warn(
                f"scene AABB drops {dropped_fg:.2%} of foreground rays — increase aabb_pad"
            )
        self.all_rays_o = self.all_rays_o[hit]
        self.all_viewdirs = self.all_viewdirs[hit]
        self.all_rgbs = self.all_rgbs[hit]
        self.all_tnear = tn[hit]
        self.all_tfar = tf[hit]
        self.hit_fraction = float(hit.mean())

    def _train_intervals(self):
        """(hit, t_near, t_far) of every train ray; the occupancy-refined ones
        come from the split's interval cache when it matches."""
        iv_cache = None
        if self.occ_grid is not None:
            w, h = self.img_wh
            iv_cache = os.path.join(
                self.base_dir, f".occ_intervals_{w}x{h}_n{len(self.img_files)}.npz"
            )
            try:
                with np.load(iv_cache, allow_pickle=False) as z:
                    if (
                        z["bounds"].shape == self.scene_bounds.shape
                        and np.allclose(z["bounds"], self.scene_bounds)
                        and z["grid_sum"] == int(self.occ_grid.sum())
                        and z["hit"].shape[0] == self.all_rays_o.shape[0]
                    ):
                        return z["hit"], z["tn"], z["tf"]
            except (OSError, ValueError, KeyError):
                pass
        ivs = ray_intervals_with_grid(
            self.scene_bounds, self.occ_grid, self.all_rays_o, self.all_viewdirs,
            dilate=self._occ_dilate,
        )
        if iv_cache is not None:
            try:
                np.savez(iv_cache, bounds=self.scene_bounds, grid_sum=int(self.occ_grid.sum()),
                         hit=ivs[0], tn=ivs[1], tf=ivs[2])
            except OSError:
                pass
        return ivs

    def __len__(self) -> int:
        if self.split == "train":
            return len(self.all_rays_o)
        if self.split == "val":
            return 1
        return len(self.img_files)

    # ----- training batches -----

    def ray_batches(self, batch_size: int, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of uniform-random fixed-shape ray batches."""
        g = np.random.default_rng(seed)
        n = len(self.all_rays_o)
        tight = self.scene_bounds is not None
        while True:
            idx = g.integers(0, n, size=batch_size)
            rays_o, viewdirs, rgbs = native.ray_batch_gather(
                self.all_rays_o, self.all_viewdirs, self.all_rgbs, idx
            )
            batch = {
                "rays_o": rays_o,
                "rays_d": viewdirs,  # normalized (parity contract)
                "viewdirs": viewdirs,
                "target": rgbs,
            }
            if tight:
                batch["t_near"] = self.all_tnear[idx]
                batch["t_far"] = self.all_tfar[idx]
            yield batch

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self.all_rays_o) // batch_size)

    # ----- full-frame items (val/test) -----

    def full_frame(self, idx: int) -> Dict[str, np.ndarray]:
        w, h = self.img_wh
        _, rgba, rays_o, viewdirs = self._frame_rays(self.img_files[idx])
        valid_mask = (rgba[..., 3] > 0).reshape(-1)
        rgb = (rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])).reshape(-1, 3)
        frame = {
            "rays_o": rays_o,
            "rays_d": viewdirs,
            "viewdirs": viewdirs,
            "instance_mask": valid_mask,
            "target": rgb.astype(np.float32),
            "img_wh": np.array([w, h]),
        }
        if self.scene_bounds is not None:
            hit, tn, tf = ray_intervals_with_grid(
                self.scene_bounds, self.occ_grid, rays_o, viewdirs, dilate=self._occ_dilate,
            )
            frame.update(hit=hit, t_near=tn, t_far=tf)
        return frame
