"""LPIPS (VGG16) perceptual metric (port of ``aon_tpu/eval/lpips.py``).

Replaces the reference's ``piqa.lpips.LPIPS(network="vgg")``
(``models/interface.py:113-123``).  VGG16 features tapped after
relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, unit-normalised along the
channels, the squared difference weighted by a 1x1 linear head per tap,
averaged over space and summed over the taps: the standard LPIPS.

The weights are read from ``AON_LPIPS_WEIGHTS`` or, where that is unset,
``weights/lpips_vgg.npz`` of the repository: the JAX package's file, which
``scripts/convert_lpips_weights.py`` converts from torchvision's VGG16 and
the LPIPS heads (``weights/README.md``).  Its layout is kept, so either
package reads the other's file: ``conv{i}_w`` in HWIO, ``conv{i}_b`` (C,),
``lin{i}_w`` (1, 1, C, 1); the module turns the kernels to OIHW.  Without a
file ``lpips_fn`` returns None and the evaluation reports LPIPS as null.
``aon_tpu_torch/scripts/make_synthetic_lpips_weights.py`` writes random
weights with a ``__synthetic__`` marker, for plumbing only.

The convolutions are PyTorch's (cuDNN on the card), as the JAX package
leaves them to XLA: flax's "SAME" 3x3 is padding 1, its "VALID" 2x2 max
pool is ``max_pool2d(2, 2)``, which floors odd sizes the same way.
"""

from __future__ import annotations

import functools
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aon_tpu_torch.utils.device import DeviceLike, resolve_device

# VGG16 conv plan: output channels, "M" a 2x2 max pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_TAPS = {1, 3, 6, 9, 12}  # conv indices (0-based among convs) whose relu output is tapped
# LPIPS input normalisation constants (standard)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

SYNTHETIC_MARKER = "__synthetic__"


DEFAULT_WEIGHTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                               "weights", "lpips_vgg.npz"))


def _weights_path() -> Optional[str]:
    cand = os.environ.get("AON_LPIPS_WEIGHTS")
    if cand and os.path.exists(cand):
        return cand
    return DEFAULT_WEIGHTS if os.path.exists(DEFAULT_WEIGHTS) else None


def lpips_weights_kind() -> Optional[str]:
    """None (no weights), "pretrained", or "synthetic" (the random-weight npz
    of ``make_synthetic_lpips_weights``: plumbing only, its values mean
    nothing as a perceptual metric).  Recorded beside every non-null LPIPS in
    an evaluation's results.json."""
    path = _weights_path()
    if path is None:
        return None
    with np.load(path) as data:
        return "synthetic" if SYNTHETIC_MARKER in data.files else "pretrained"


class LPIPS(nn.Module):
    """The LPIPS distance of two (H, W, 3) images in [0, 1] (clipped), from
    the npz's arrays ``weights``, on ``device``; float32 throughout."""

    def __init__(self, weights: Mapping[str, np.ndarray], device: DeviceLike = "cuda"):
        super().__init__()
        device = resolve_device(device)

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        n_convs = sum(1 for item in _VGG_CFG if item != "M")
        for i in range(n_convs):
            self.register_buffer(f"conv{i}_w", tensor(np.transpose(weights[f"conv{i}_w"],
                                                                   (3, 2, 0, 1))))
            self.register_buffer(f"conv{i}_b", tensor(np.reshape(weights[f"conv{i}_b"], -1)))
        for i in range(len(_TAPS)):
            # (1, 1, C, 1) HWIO -> (C,): a 1x1 convolution to one channel
            self.register_buffer(f"lin{i}_w", tensor(np.reshape(weights[f"lin{i}_w"], -1)))
        self.register_buffer("shift", tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", tensor(_SCALE).reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list:
        """The tapped relu maps of an (N, 3, H, W) LPIPS-normalised batch."""
        feats, conv_idx = [], 0
        for item in _VGG_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(F.conv2d(x, getattr(self, f"conv{conv_idx}_w"),
                                getattr(self, f"conv{conv_idx}_b"), padding=1))
            if conv_idx in _TAPS:
                feats.append(x)
            conv_idx += 1
        return feats

    @torch.no_grad()
    def forward(self, pred, gt) -> torch.Tensor:
        device = self.shift.device

        def prep(img):
            img = torch.as_tensor(np.asarray(img, np.float32), device=device).clamp(0, 1)
            img = img.permute(2, 0, 1)[None] * 2.0 - 1.0  # [0,1] -> [-1,1], NCHW
            return (img - self.shift) / self.scale

        cudnn = torch.backends.cudnn
        # float32 convolutions on the card too: no TF32 rounding in a metric
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            both = self.features(torch.cat([prep(pred), prep(gt)]))
        total = torch.zeros((), device=device)
        for i, f in enumerate(both):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            diff = (f[0] - f[1]) ** 2  # (C, h, w)
            d = torch.einsum("chw,c->hw", diff, getattr(self, f"lin{i}_w"))
            total = total + d.mean()
        return total


@functools.lru_cache(maxsize=2)
def _load(path: str, device: str) -> LPIPS:
    with np.load(path) as data:
        weights = {k: data[k] for k in data.files if k != SYNTHETIC_MARKER}
    return LPIPS(weights, device=device)


def lpips_fn(device: DeviceLike = "cuda") -> Optional[LPIPS]:
    """The LPIPS module on ``device`` from the weights file (loaded once per
    file and device), or None where there is none.  Call it as
    ``float(fn(pred, gt))``."""
    path = _weights_path()
    if path is None:
        return None
    return _load(path, str(resolve_device(device)))
