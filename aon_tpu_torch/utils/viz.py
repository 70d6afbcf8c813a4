"""Validation visualization: [GT | pred | depth | opacity] grid (port of
``aon_tpu/utils/viz.py``; the depth colormap from ``utils/imageio.JET_RGB``,
cv2's ``COLORMAP_JET``).

Mirrors reference ``utils/train_helper.py:138-159`` (vanilla/autodecoder)
and ``:311-332`` (ae_art, no depth): one horizontal strip per val frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from aon_tpu_torch.utils.imageio import JET_RGB


def _to_img(x: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.clip(np.asarray(x, np.float32).reshape(h, w, -1), 0, 1)


def _colormap_depth(depth: np.ndarray) -> np.ndarray:
    d = np.asarray(depth, np.float32)
    d = (d - d.min()) / max(d.max() - d.min(), 1e-8)
    return JET_RGB[(d * 255).astype(np.uint8)].astype(np.float32) / 255.0


def val_grid(
    img_wh,
    target: np.ndarray,
    comp_rgb: np.ndarray,
    depth: Optional[np.ndarray] = None,
    acc: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Returns a (H, W*k, 3) float image, k in 2..4."""
    w, h = int(img_wh[0]), int(img_wh[1])
    panels = [_to_img(target, h, w), _to_img(comp_rgb, h, w)]
    if depth is not None:
        panels.append(_colormap_depth(np.asarray(depth).reshape(h, w)))
    if acc is not None:
        a = _to_img(acc, h, w)
        panels.append(np.repeat(a, 3, axis=-1) if a.shape[-1] == 1 else a)
    return np.concatenate(panels, axis=1)
