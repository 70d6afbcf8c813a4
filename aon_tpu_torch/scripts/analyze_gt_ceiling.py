"""Thin-geometry ground-truth resolution ceiling (port of
``scripts/analyze_gt_ceiling.py``; host numpy only).

Is an auto-decoder's low object PSNR on thin geometry (scissors) limited by
the model or by the 320x240 ground truth itself?  The same ``test_spheric``
frames re-rendered at 640x480 with the same datagen config and seed are
area-downsampled 2x2 to 320x240 -- the antialiased "ideal" image that a
continuous radiance field could at best reproduce -- and scored against the
committed point-sampled 320x240 ground truth on object pixels.
Rasterization aliasing is pose-dependent high-frequency noise that a smooth
3D field cannot reproduce, so

    PSNR_obj(antialiased ideal, point-sampled GT)

is an effective ceiling for any NeRF's object PSNR on that ground truth.  It
also reports the object's edge-pixel fraction (pixels whose 3x3
neighbourhood leaves the seg mask): thin blades are nearly all edge.

    python -m aon_tpu_torch.scripts.analyze_gt_ceiling \\
        --lo data/scissors_multi/scissors_0/test_spheric \\
        --hi <640x480 re-render>/scissors_0/test_spheric \\
        --out results/scissors_gt_ceiling/analysis.json

Images are read with ``utils/imageio.py`` as PIL's ``convert("RGB")`` reads
them (alpha dropped, grey replicated) and the seg mask from its channel 0.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
from scipy import ndimage

from aon_tpu_torch.utils.device import DeviceLike, resolve_device
from aon_tpu_torch.utils.imageio import read_png


def load_rgb(path) -> np.ndarray:
    a = read_png(path)
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] in (1, 2):  # grey (+ alpha): PIL's convert("RGB") replicates grey
        a = np.repeat(a[..., :1], 3, axis=-1)
    return a[..., :3].astype(np.float64) / 255.0


def load_seg(path) -> np.ndarray:
    a = read_png(path)
    if a.ndim == 3:
        a = a[..., 0]
    return a > 0


def downsample2(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    return img.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3))


def psnr(a: np.ndarray, b: np.ndarray, m: np.ndarray) -> float:
    mse = float(np.mean(((a - b) ** 2)[m]))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def edge_fraction(seg: np.ndarray) -> float:
    er = ndimage.binary_erosion(seg, np.ones((3, 3)))
    n = seg.sum()
    return float((seg & ~er).sum() / max(n, 1))


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda") -> dict:
    """Score every frame and write the report; the work is host numpy, and the
    device is resolved only as every entry point of the port resolves it."""
    resolve_device(device)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lo", required=True, help="320x240 test_spheric dir")
    p.add_argument("--hi", required=True, help="640x480 test_spheric dir")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    frames = sorted(os.listdir(os.path.join(args.lo, "rgb")))
    rows = []
    for f in frames:
        lo = load_rgb(os.path.join(args.lo, "rgb", f))
        seg = load_seg(os.path.join(args.lo, "seg", f))
        hi = load_rgb(os.path.join(args.hi, "rgb", f))
        ideal = downsample2(hi)
        m3 = np.repeat(seg[..., None], 3, axis=-1)
        rows.append({
            "frame": f,
            "psnr_obj_ceiling": psnr(ideal, lo, m3),
            "psnr_full": psnr(ideal, lo, np.ones_like(m3, bool)),
            "obj_pixels": int(seg.sum()),
            "edge_fraction": edge_fraction(seg),
        })
        print(rows[-1], flush=True)

    out = {
        "method": "area-downsampled 640x480 re-render (antialiased ideal) vs "
        "point-sampled 320x240 GT, object pixels only",
        "frames": rows,
        "psnr_obj_ceiling_mean": float(np.mean([r["psnr_obj_ceiling"] for r in rows])),
        "psnr_full_mean": float(np.mean([r["psnr_full"] for r in rows])),
        "obj_pixels_mean": float(np.mean([r["obj_pixels"] for r in rows])),
        "edge_fraction_mean": float(np.mean([r["edge_fraction"] for r in rows])),
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(
        f"\nobject-PSNR ceiling {out['psnr_obj_ceiling_mean']:.2f} dB, "
        f"edge fraction {out['edge_fraction_mean']:.2f}, "
        f"mean object pixels {out['obj_pixels_mean']:.0f} -> {args.out}"
    )
    return out


if __name__ == "__main__":
    main()
