"""Multi-instance articulated SAPIEN dataset (port of
``aon_tpu/data/sapien_multi.py``: host-side numpy, fixed-shape batches).

Disk layout and semantics from reference ``datasets/sapien_multi.py``:

* ``{root}/{instance}/train/{deg}_degree/{rgb,seg,transforms.json}``;
* train degrees 0..90 step 10 indexed 0..9 (sapien_multi.py:11-14);
* virtual epoch of ``samples_per_epoch=4000`` items (sapien_multi.py:138);
* a train item picks random (instance, degree, image<=58), masks the RGB
  image outside seg>0 with white/black background (sapien_multi.py:188-199),
  and draws ``ray_batch_size=4096`` uniform random pixels (with
  replacement, torch.randint semantics — sapien_multi.py:234-241);
* an item carries the seg-masked full image normalized to [-1,1]
  (``src_imgs``) when ``need_src_imgs`` is set (the auto-encoder's case), the
  articulation angle in radians (``deg``), ``instance_id`` and
  ``articulation_id``;
* val: one random full frame from the TRAIN directories
  (sapien_multi.py:259-268);
* test: 19 frames over the 0_degree instance with spheric render poses
  (radius 4) and ``articulation_id = idx`` indexing the interpolated latent
  table (sapien_multi.py:308-348, 438-479), or the ``test_spheric`` split
  where datagen wrote one;
* focal from camera_angle_x, rescaled by w/320; near/far 2/6.

Images decode through ``utils/imageio.py``.  The RGB image is read as PIL's
``convert("RGB")`` reads it: an RGBA file's alpha is DROPPED, not blended
(the single-scene loader blends to white), and the 3-channel image is
LANCZOS-resized before the seg mask is applied.  Every item is the JAX
loader's at atol 0: the same ``np.random.default_rng`` draws in the same
order and shapes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional

import numpy as np

from aon_tpu_torch.core.rays import create_spheric_poses, get_ray_directions, get_rays
from aon_tpu_torch.data.aabb import ray_intervals_with_grid, scene_aabb
from aon_tpu_torch.data.occgrid import scene_occgrid
from aon_tpu_torch.utils.imageio import read_png, resize_lanczos

IDX_TO_DEG = {
    "train": {i: 10 * i for i in range(10)},
    "val": {i: 5 + 10 * i for i in range(9)},
}
NEAR, FAR = 2.0, 6.0
N_TEST_FRAMES = 19


def _read_rgb(path: str) -> np.ndarray:
    """(h, w, 3) uint8 as PIL's ``Image.open(path).convert("RGB")``: gray is
    replicated, alpha dropped."""
    px = read_png(path)
    if px.ndim == 2:
        return np.repeat(px[..., None], 3, axis=-1)
    if px.shape[-1] == 2:  # gray + alpha
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


class SapienDatasetMulti:
    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh=(320, 240),
        model_type: Optional[str] = None,
        white_back: Optional[bool] = None,
        eval_inference: Optional[str] = None,
        samples_per_epoch: int = 4000,
        ray_batch_size: int = 4096,
        use_aabb: bool = False,
        aabb_pad: float = 0.05,
        use_occgrid: bool = False,
        occgrid_res: int = 128,
        occgrid_dilate: int = 2,
        obj_ray_oversample: float = 0.0,
        need_src_imgs: bool = True,
    ):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.white_back = white_back
        self.near, self.far = NEAR, FAR
        self.samples_per_epoch = samples_per_epoch
        self.ray_batch_size = ray_batch_size
        self.obj_ray_oversample = float(obj_ray_oversample)
        # only the auto-encoder consumes src_imgs (reference model_ae_art.py:361)
        self.need_src_imgs = bool(need_src_imgs)

        self.ids = np.sort([f.name for f in os.scandir(root_dir) if f.is_dir()])

        # one box (and grid) bounding ALL instances at ALL train articulations
        self.scene_bounds = None
        self.occ_grid = None
        self._occ_dilate = occgrid_dilate
        if use_aabb or use_occgrid:
            deg_dirs = []
            for inst in self.ids:
                base = os.path.join(root_dir, inst, "train")
                deg_dirs += [f.path for f in os.scandir(base) if f.is_dir()]
            if use_occgrid:
                self.scene_bounds, self.occ_grid = scene_occgrid(
                    sorted(deg_dirs), tuple(img_wh), pad=aabb_pad,
                    res=occgrid_res, dilate=occgrid_dilate,
                )
            else:
                self.scene_bounds = scene_aabb(sorted(deg_dirs), tuple(img_wh), pad=aabb_pad)
        # decoded frames and the per-frame arrays a train batch gathers from,
        # keyed on the wrapped image index (see _read_frame_cached)
        self._frame_cache = {}
        self._frame_cache_cap = int(os.environ.get("AON_FRAME_CACHE", "512"))
        self._frame_counts: Dict[tuple, int] = {}
        self._derived_cache: Dict[tuple, dict] = {}
        self._degree_dirs_cache: Dict[str, list] = {}
        w, h = self.img_wh
        if eval_inference is not None:
            self.image_sizes = np.array([[h, w] for _ in range(N_TEST_FRAMES)])
            self.poses_test = create_spheric_poses(radius=4.0)
        else:
            self.image_sizes = np.array([[h, w]])

    # ----- helpers -----

    def _degree_dirs(self, instance_dir: str):
        hit = self._degree_dirs_cache.get(instance_dir)
        if hit is not None:
            return hit
        base = os.path.join(self.root_dir, instance_dir, "train")
        names = [f.name for f in os.scandir(base)]
        order = np.argsort([int(n.split("_")[0]) for n in names])
        out = [names[i] for i in order]
        self._degree_dirs_cache[instance_dir] = out
        return out

    def _load_image_and_seg(self, img_path: str, seg_path: str):
        img = resize_lanczos(_read_rgb(img_path), self.img_wh)
        seg_mask = resize_lanczos(read_png(seg_path), self.img_wh) > 0
        if seg_mask.ndim == 3:
            seg_mask = seg_mask.any(axis=-1)
        return img, seg_mask

    def _mask_image(self, img: np.ndarray, seg: np.ndarray) -> np.ndarray:
        bg = 255 if self.white_back else 0
        out = np.full_like(img, bg)
        out[seg] = img[seg]
        return out

    def _read_frame_cached(self, instance_id: str, degree_dir: str, image_id: int):
        # Cache on the WRAPPED file index: the reference draws image_id in
        # [0, 59) whatever the file count, and _read_frame wraps with
        # ``image_id % len(files)``, so raw ids would alias several cache keys
        # to one frame and overflow the cap (every overflow draw then re-runs
        # the interval march).
        ckey = (instance_id, degree_dir)
        n = self._frame_counts.get(ckey)
        if n is None:
            n = len(os.listdir(
                os.path.join(self.root_dir, instance_id, "train", degree_dir, "rgb")))
            self._frame_counts[ckey] = n
        key = (instance_id, degree_dir, image_id % n)
        hit = self._frame_cache.get(key)
        if hit is not None:
            return key, hit
        frame = self._read_frame(instance_id, degree_dir, image_id)
        if len(self._frame_cache) < self._frame_cache_cap:
            self._frame_cache[key] = frame
        return key, frame

    def _train_derived(self, key, img, seg, aabb):
        """Per-frame arrays the train batch gathers from, computed once per
        cached frame (the same casts in the same order as ``_to_sample``)."""
        der = self._derived_cache.get(key)
        if der is not None:
            return der
        seg_flat = seg.reshape(-1)
        der = {
            "rgbs": np.asarray(img, dtype=np.float32).reshape(-1, 3) / 255.0,
            "mask": seg.reshape(-1, 1).astype(np.float32),
            "seg_flat": seg_flat,
            "obj_idx": np.flatnonzero(seg_flat),
            "hit_idx": np.flatnonzero(aabb[0]) if aabb is not None else None,
            "src": (
                np.transpose((np.asarray(img, dtype=np.float32) / 255.0 - 0.5) / 0.5, (2, 0, 1))
                if self.need_src_imgs else None
            ),
        }
        if len(self._derived_cache) < self._frame_cache_cap:
            self._derived_cache[key] = der
        return der

    def _read_frame(
        self, instance_id: str, degree_dir: Optional[str], image_id: int,
        c2w_override=None, split_dir: str = "train",
    ):
        if degree_dir is None:
            base = os.path.join(self.root_dir, instance_id, split_dir)
        else:
            base = os.path.join(self.root_dir, instance_id, split_dir, degree_dir)
        files = os.listdir(os.path.join(base, "rgb"))
        order = np.argsort([int(f.split("_")[1].split(".")[0]) for f in files])
        files = [files[i] for i in order]
        with open(os.path.join(base, "transforms.json")) as fh:
            poses = json.load(fh)
        w, h = self.img_wh
        # the reference's focal quirk (sapien_multi.py:115-116); datagen
        # writes camera_angle_x for it (datagen/data_gen.py::_cax_for_loader)
        focal = 0.5 * h / np.tan(0.5 * poses["camera_angle_x"])
        focal *= w / 320.0
        directions = get_ray_directions(h, w, focal)

        img_file = files[image_id % len(files)]  # drawn in [0, 59); small fixtures wrap
        if c2w_override is not None:
            c2w = np.asarray(c2w_override, dtype=np.float32)[:3, :4]
        else:
            c2w = np.array(poses["frames"][img_file.split(".")[0]], dtype=np.float32)[:3, :4]

        img, seg = self._load_image_and_seg(
            os.path.join(base, "rgb", img_file), os.path.join(base, "seg", img_file)
        )
        img = self._mask_image(img, seg)
        rays_o, viewdirs, rays_d, _ = get_rays(
            directions, c2w, output_view_dirs=True, output_radii=True
        )
        aabb = None
        if self.scene_bounds is not None:
            aabb = ray_intervals_with_grid(self.scene_bounds, self.occ_grid, rays_o, viewdirs,
                                           dilate=self._occ_dilate)
        return rays_o, viewdirs, rays_d, img, seg, aabb

    def _to_sample(self, rays_o, viewdirs, rays_d, img, seg, pix_inds=None, aabb=None):
        rgbs = np.asarray(img, dtype=np.float32).reshape(-1, 3) / 255.0
        mask = seg.reshape(-1, 1).astype(np.float32)
        src_img = None
        if self.need_src_imgs:
            src_img = (np.asarray(img, dtype=np.float32) / 255.0 - 0.5) / 0.5  # [-1, 1]
            src_img = np.transpose(src_img, (2, 0, 1))  # (3, h, w) like the reference
        if pix_inds is not None:
            rays_o = rays_o[pix_inds]
            rays_d = rays_d[pix_inds]
            viewdirs = viewdirs[pix_inds]
            rgbs = rgbs[pix_inds]
            mask = mask[pix_inds]
        sample = {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "viewdirs": viewdirs,
            "target": rgbs,
            "instance_mask": mask,
        }
        if src_img is not None:
            sample["src_imgs"] = src_img
        if aabb is not None:
            hit, tn, tf = aabb
            if pix_inds is not None:
                sample["t_near"] = tn[pix_inds]
                sample["t_far"] = tf[pix_inds]
            else:
                sample.update(hit=hit, t_near=tn, t_far=tf)
        return sample

    def _draw_pixels(self, g, cand_idx, seg, n_pixels, seg_flat=None, obj_idx=None):
        """(pix_inds, loss_w|None) for one train item.

        Uniform with replacement over the candidate set (reference
        sapien_multi.py:234-241; the AABB path restricts candidates to
        box-hitting rays).  With ``obj_ray_oversample`` = f > 0, a fraction f
        of the batch is drawn uniformly from OBJECT (seg>0) pixels instead;
        each ray then carries the importance weight

            loss_w_i = (1/N) / p_i,   p_i = (1-f)/N + f*[i in obj]/N_obj

        so (1/B) sum loss_w_i err_i^2 stays an unbiased estimator of the
        uniform-pixel mean.
        """
        B = self.ray_batch_size
        f = self.obj_ray_oversample
        if cand_idx is None:
            n_cand = n_pixels

            def draw_uniform(n):
                return g.integers(0, n_pixels, size=n)

        else:
            n_cand = len(cand_idx)

            def draw_uniform(n):
                return cand_idx[g.integers(0, n_cand, size=n)]

        if f <= 0.0:
            return draw_uniform(B), None

        if seg_flat is None:
            seg_flat = seg.reshape(-1)
        if cand_idx is None:
            if obj_idx is None:
                obj_idx = np.flatnonzero(seg_flat)
        else:
            obj_idx = cand_idx[seg_flat[cand_idx]]
        if len(obj_idx) == 0:  # no object pixels: degrade to uniform
            return draw_uniform(B), None
        n_obj_draw = int(round(f * B))
        pix_inds = np.concatenate([
            draw_uniform(B - n_obj_draw),
            obj_idx[g.integers(0, len(obj_idx), size=n_obj_draw)],
        ])
        p = np.full(len(pix_inds), (1.0 - f) / n_cand, dtype=np.float64)
        p[seg_flat[pix_inds]] += f / len(obj_idx)
        loss_w = (1.0 / n_cand) / p
        return pix_inds, loss_w.astype(np.float32)

    # ----- item generators -----

    def __len__(self) -> int:
        if self.split == "train":
            return self.samples_per_epoch
        if self.split == "val":
            return 1
        return N_TEST_FRAMES

    def train_batches(self, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of fixed-shape ``ray_batch_size``-ray articulated
        batches, one (instance, articulation) pair each."""
        g = np.random.default_rng(seed)
        w, h = self.img_wh
        while True:
            train_idx = int(g.integers(0, len(self.ids)))
            instance_dir = self.ids[train_idx]
            deg_paths = self._degree_dirs(instance_dir)
            deg_idx = int(g.integers(0, len(deg_paths)))
            image_id = int(g.integers(0, 59))
            key, (rays_o, viewdirs, rays_d, img, seg, aabb) = self._read_frame_cached(
                instance_dir, deg_paths[deg_idx], image_id
            )
            der = self._train_derived(key, img, seg, aabb)
            # AABB path: rays missing the box are exactly background with
            # zero loss/grad — draw (with replacement) from hit rays only
            pix_inds, loss_w = self._draw_pixels(
                g, der["hit_idx"], seg, h * w, seg_flat=der["seg_flat"], obj_idx=der["obj_idx"],
            )
            sample = {
                "rays_o": rays_o[pix_inds],
                "rays_d": rays_d[pix_inds],
                "viewdirs": viewdirs[pix_inds],
                "target": der["rgbs"][pix_inds],
                "instance_mask": der["mask"][pix_inds],
            }
            if self.need_src_imgs:
                sample["src_imgs"] = der["src"]
            if aabb is not None:
                sample["t_near"] = aabb[1][pix_inds]
                sample["t_far"] = aabb[2][pix_inds]
            if loss_w is not None:
                sample["loss_w"] = loss_w
            sample["deg"] = np.float32(np.deg2rad(IDX_TO_DEG["train"][deg_idx]))
            sample["instance_id"] = np.int32(train_idx)
            sample["articulation_id"] = np.int32(deg_idx)
            yield sample

    def val_frame(self, seed: int = 0) -> Dict[str, np.ndarray]:
        g = np.random.default_rng(seed)
        val_idx = int(g.integers(0, len(self.ids)))
        instance_dir = self.ids[val_idx]
        deg_paths = self._degree_dirs(instance_dir)
        deg_idx = int(g.integers(0, len(deg_paths)))
        image_id = int(g.integers(0, 59))
        rays_o, viewdirs, rays_d, img, seg, aabb = self._read_frame(
            instance_dir, deg_paths[deg_idx], image_id
        )
        sample = self._to_sample(rays_o, viewdirs, rays_d, img, seg, aabb=aabb)
        sample["deg"] = np.float32(np.deg2rad(IDX_TO_DEG["train"][deg_idx]))
        sample["instance_id"] = np.int32(val_idx)
        sample["articulation_id"] = np.int32(deg_idx)
        sample["img_wh"] = np.array(self.img_wh)
        return sample

    def test_frame(
        self, idx: int, seed: int = 0, instance: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        """Spheric-pose frame; ``articulation_id = idx`` indexes the
        interpolated latent table (reference :438-479).

        ``instance`` overrides the seeded instance choice (the per-instance
        sweep of ``scripts/eval_per_instance.py``).

        Ground truth: the ``test_spheric`` split where datagen wrote one
        (frame i rendered AT poses_test[i] with the joint at 5*i degrees);
        otherwise the reference's quirk, the train 0_degree images at
        UNRELATED poses (the true-pose line is commented out upstream,
        sapien_multi.py:333), pose-mismatched by construction."""
        g = np.random.default_rng(seed)
        val_idx = int(g.integers(0, len(self.ids)))
        if instance is not None:
            val_idx = int(instance)
        instance_dir = self.ids[val_idx]
        ts_dir = os.path.join(self.root_dir, instance_dir, "test_spheric")
        if os.path.isdir(ts_dir):
            rays_o, viewdirs, rays_d, img, seg, aabb = self._read_frame(
                instance_dir, None, idx, split_dir="test_spheric"
            )
        else:
            rays_o, viewdirs, rays_d, img, seg, aabb = self._read_frame(
                instance_dir, "0_degree", idx, c2w_override=self.poses_test[idx]
            )
        sample = self._to_sample(rays_o, viewdirs, rays_d, img, seg, aabb=aabb)
        sample["instance_id"] = np.int32(val_idx)
        sample["articulation_id"] = np.int32(idx)
        # the angle swept 0..90 deg over the 19 frames (5 deg a frame), as the
        # interpolated latent table the auto-decoder indexes with
        # articulation_id; the auto-encoder's deg input at test time
        sample["deg"] = np.float32(np.deg2rad(5.0 * idx))
        sample["img_wh"] = np.array(self.img_wh)
        return sample
