"""Eval artifact writers: image sequences, depth maps, video, results.json
(port of ``aon_tpu/eval/artifacts.py``; images written by ``utils/imageio.py``,
the depth colormap from its JET table).

Contracts from reference ``models/utils.py``:
  * ``store_image`` (utils.py:21-27): jpg sequence ``{name}{i:03d}.jpg``;
  * ``store_depth_img`` (utils.py:29-43): jointly-normalized JET colormap;
  * ``store_video`` (utils.py:55-59): mp4 at fps=20 under ``videos/``;
  * ``write_stats`` (utils.py:62-73): results.json of stat dicts.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional

import numpy as np

from aon_tpu_torch.utils.imageio import JET_RGB, write_jpeg


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def store_image(dirpath: str, rgbs: Iterable[np.ndarray], name: str = "image") -> List[str]:
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for i, rgb in enumerate(rgbs):
        path = os.path.join(dirpath, f"{name}{str(i).zfill(3)}.jpg")
        write_jpeg(path, to8b(np.asarray(rgb)))
        paths.append(path)
    return paths


def store_depth_img(dirpath: str, depths: Iterable[np.ndarray], name: str = "depth") -> List[str]:
    os.makedirs(dirpath, exist_ok=True)
    depth_maps = [np.asarray(d) for d in depths]
    mn = min(d.min() for d in depth_maps)
    mx = max(d.max() for d in depth_maps)
    rng = max(mx - mn, 1e-8)
    paths = []
    for i, d in enumerate(depth_maps):
        path = os.path.join(dirpath, f"{name}{str(i).zfill(3)}.jpg")
        write_jpeg(path, JET_RGB[to8b((d - mn) / rng)])
        paths.append(path)
    return paths


def store_depth_raw(dirpath: str, depths: Iterable[np.ndarray], name: str = "depth") -> None:
    os.makedirs(dirpath, exist_ok=True)
    for i, d in enumerate(depths):
        np.savez_compressed(os.path.join(dirpath, f"{name}{str(i).zfill(3)}"), np.asarray(d))


def store_video(dirpath: str, rgbs: Iterable[np.ndarray], fps: int = 20) -> Optional[str]:
    """mp4 through ``imageio`` where it imports and can encode; otherwise the
    frames as ``videos/frame{i:03d}.jpg``."""
    video_dir = os.path.join(dirpath, "videos")
    os.makedirs(video_dir, exist_ok=True)
    frames = [to8b(np.asarray(r)) for r in rgbs]
    path = os.path.join(video_dir, "images.mp4")
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps, quality=8)
        return path
    except Exception as e:  # no encoder available: fall back to frame dump
        print(f"[artifacts] mp4 write failed ({e}); storing frames instead")
        store_image(video_dir, [f / 255.0 for f in frames], "frame")
        return None


def write_stats(fpath: str, *stats: dict, extra: dict | None = None) -> None:
    d = dict(extra or {})
    for stat in stats:
        if stat is None:
            continue
        d[stat["name"]] = {
            k: (w if isinstance(w, list) or w is None else float(w))
            for (k, w) in stat.items()
            if k not in ("name", "scene_wise")
        }
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    with open(fpath, "w") as fp:
        json.dump(d, fp, indent=4, sort_keys=True)
