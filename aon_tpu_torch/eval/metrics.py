"""Image quality metrics (port of ``aon_tpu/eval/metrics.py``): PSNR,
object-PSNR, SSIM, LPIPS and the results.json stat dict.

* ``psnr``: clip to [0,1] then -10 log10(mse) (reference interface.py:54-62).
* ``ssim``: Gaussian-window SSIM (window 11, sigma 1.5, k1=0.01, k2=0.03 on
  dynamic range 1), the algorithm piqa's SSIM implements.  It runs in
  float32 on the CPU, so no cuDNN TF32 convolution touches it.
* ``psnr_masked``: seg-mask-selected pixels only (models/utils.py:102-109).
* ``lpips``: LPIPS(VGG16) (``eval/lpips.py``), None without weights.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aon_tpu_torch.eval.lpips import lpips_fn
from aon_tpu_torch.utils.device import DeviceLike


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = np.clip(np.asarray(pred, np.float32), 0, 1)
    gt = np.clip(np.asarray(gt, np.float32), 0, 1)
    mse = np.mean((pred - gt) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def psnr_masked(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    """Object-PSNR over seg-selected pixels (models/utils.py:102-109)."""
    mask = np.asarray(mask, bool).reshape(-1)
    p = np.asarray(pred, np.float32).reshape(-1, 3)[mask]
    g = np.asarray(gt, np.float32).reshape(-1, 3)[mask]
    if p.size == 0:
        return float("nan")
    mse = np.mean((np.clip(p, 0, 1) - np.clip(g, 0, 1)) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / torch.sum(g)


def _filter2d(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter; img: (H, W, C)."""
    x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x[:, 0].permute(1, 2, 0)  # (H', W', C)


def ssim(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = torch.from_numpy(np.clip(np.asarray(pred, np.float32), 0, 1))
    gt = torch.from_numpy(np.clip(np.asarray(gt, np.float32), 0, 1))
    k = _gaussian_kernel()
    c1, c2 = 0.01**2, 0.03**2
    mu_p = _filter2d(pred, k)
    mu_g = _filter2d(gt, k)
    mu_pp = _filter2d(pred * pred, k)
    mu_gg = _filter2d(gt * gt, k)
    mu_pg = _filter2d(pred * gt, k)
    var_p = mu_pp - mu_p**2
    var_g = mu_gg - mu_g**2
    cov = mu_pg - mu_p * mu_g
    ssim_map = ((2 * mu_p * mu_g + c1) * (2 * cov + c2)) / (
        (mu_p**2 + mu_g**2 + c1) * (var_p + var_g + c2)
    )
    return float(torch.mean(ssim_map))


def lpips(pred: np.ndarray, gt: np.ndarray, device: DeviceLike = "cuda") -> Optional[float]:
    """LPIPS(VGG16) of two (H, W, 3) images on ``device``, or None (with a
    warning, once) where there are no weights (``eval/lpips.py``)."""
    fn = lpips_fn(device)
    if fn is None:
        warnings.warn(
            "LPIPS reported as null: VGG weights not found (weights/lpips_vgg.npz or "
            "$AON_LPIPS_WEIGHTS missing; see weights/README.md for the recipe)",
            stacklevel=2)
        return None
    return float(fn(pred, gt))


def summarize(name: str, values: List[float]) -> dict:
    """Reference results.json stat dict (interface.py:125-171) plus the
    per-frame ``each`` list."""
    vals = [v for v in values if v is not None and np.isfinite(v)]
    mean = float(np.mean(vals)) if vals else float("nan")
    each = [None if v is None or not np.isfinite(v) else float(v) for v in values]
    return {"name": name, "mean": mean, "test": mean, "each": each}
