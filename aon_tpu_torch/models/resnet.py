"""ResNet-34 multi-head image encoder of the auto-encoder variant (port of
``aon_tpu/models/resnet.py``), in NCHW.

Contract from reference ``models/resnet_encoder.py:292-512``
(``ImgEncoder_MultiHead_Art`` defaults): a resnet34 backbone with every
BatchNorm2d swapped for an affine-free InstanceNorm2d; a shared trunk
conv1..layer3; three heads, each its OWN copy of layer4 + global average pool
+ linear: color -> 128, density -> 128, articulation -> 32.

Module names follow the flax module (``conv1``, ``layer{1,2,3}.block{i}``,
``{head}_layer4``, ``{head}_fc``) so ``models/convert.py`` maps flax params
one to one (a conv ``kernel`` (kh, kw, in, out) is a ``weight`` (out, in, kh,
kw)).  The convolutions and the norm run in ``dtype`` (the config's compute
dtype), the norm's statistics in float32 as ``jnp.mean`` / ``jnp.var`` take
them; the heads' ``fc`` layers run in float32.  Weights are flax's default
``lecun_normal`` (a truncated normal of variance 1/fan_in), biases zero,
drawn from a threefry key as flax draws them (``models/init.py``).

Pretrained ImageNet weights are optional: ``params_from_npz`` overlays the
conv kernels that ``scripts/convert_resnet_weights.py`` writes; without them
the encoder trains from its random init, as the JAX package's runs did.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aon_tpu_torch.models.init import flax_init_

# ResNet-34 stage plan: (num_blocks, channels)
RESNET34_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
HEADS = (("color", 128), ("density", 128), ("articulation", 32))


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW: biased variance over H, W, the
    statistics taken in float32 and applied in ``x``'s dtype."""
    var, mean = torch.var_mean(x.float(), dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False, device="meta")


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(cin, channels, 3, stride, 1)
        self.conv2 = _conv(channels, channels, 3, 1, 1)
        self.downsample = (_conv(cin, channels, 1, stride) if stride != 1 or cin != channels
                           else None)

    def _conv_of(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, conv.weight.to(self.dtype), None, conv.stride, conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(instance_norm(self._conv_of(self.conv1, x)))
        y = instance_norm(self._conv_of(self.conv2, y))
        if self.downsample is not None:
            x = instance_norm(self._conv_of(self.downsample, x))
        return torch.relu(y + x)


class ResNetStage(nn.Module):
    def __init__(self, cin: int, num_blocks: int, channels: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"block{i}", BasicBlock(cin if i == 0 else channels, channels,
                                                    stride if i == 0 else 1, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class ImgEncoderMultiHeadArt(nn.Module):
    """ResNet-34 trunk (conv1..layer3 shared) + per-head layer4 / avgpool / linear."""

    def __init__(self, shared_layers: int = 3, dtype: torch.dtype = torch.float32, device=None,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3)
        strides = (1, 2, 2, 2)
        cin = 64
        for i in range(shared_layers):
            n_blocks, ch = RESNET34_STAGES[i]
            self.add_module(f"layer{i + 1}", ResNetStage(cin, n_blocks, ch, strides[i], dtype))
            cin = ch
        self.shared_layers = shared_layers
        n_blocks4, ch4 = RESNET34_STAGES[3]
        for head, size in HEADS:
            self.add_module(f"{head}_layer4", ResNetStage(cin, n_blocks4, ch4, strides[3], dtype))
            self.add_module(f"{head}_fc", nn.Linear(ch4, size, device="meta"))
        # built on the meta device so no default init draws from the global RNG
        self.to_empty(device=torch.device("cpu") if device is None else device)
        self.reset_parameters(key)

    def reset_parameters(self, key: Optional[torch.Tensor]) -> None:
        """flax's default init, drawn as its ``init(key)`` draws it:
        ``lecun_normal`` kernels, zero biases."""
        flax_init_(self, key, "lecun_normal")

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, 3, H, W), the dataset's ``src_imgs`` layout, or (B, H, W, 3).
        Returns ``{color (B, 128), density (B, 128), articulation (B, 32)}``
        in float32."""
        if not (x.shape[1] == 3 and x.shape[-1] != 3):
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, where the JAX module keeps NHWC
        x = x.to(self.dtype)
        x = F.conv2d(x, self.conv1.weight.to(self.dtype), None, 2, 3)
        x = torch.relu(instance_norm(x))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, as flax's max_pool
        for i in range(self.shared_layers):
            x = getattr(self, f"layer{i + 1}")(x)
        out = {}
        for head, _ in HEADS:
            h = getattr(self, f"{head}_layer4")(x).mean(dim=(2, 3))  # global avgpool
            fc = getattr(self, f"{head}_fc")
            out[head] = F.linear(h.float(), fc.weight, fc.bias)
        return out

    @staticmethod
    def aggregate_views(outs: Sequence[Mapping[str, torch.Tensor]], how: str = "mean"):
        """Multi-view latent aggregation (resnet_encoder.py:428-447)."""
        keys = outs[0].keys()
        if how == "mean":
            return {k: torch.stack([o[k] for o in outs]).mean(dim=0) for k in keys}
        if how == "max":
            return {k: torch.stack([o[k] for o in outs]).amax(dim=0) for k in keys}
        raise NotImplementedError(f"aggregation {how!r} not supported")

    @staticmethod
    def params_from_npz(params: Mapping[str, torch.Tensor], npz_path: str
                        ) -> Dict[str, torch.Tensor]:
        """Overlay converted ResNet-34 backbone weights onto the encoder's
        state dict.

        ``npz_path`` is the output of ``scripts/convert_resnet_weights.py``:
        conv kernels (kh, kw, in, out) keyed by flax path (``conv1/kernel``,
        ``layer1/block0/conv1/kernel``, ..., ``layer4/...``).  The shared trunk
        takes conv1..layer3; each head's private layer4 copy takes the SAME
        layer4 (the reference deep-copies layer4 per head,
        resnet_encoder.py:365-391).  The heads' fc layers keep their values.
        Raises KeyError on a path with no parameter and ValueError on a shape
        mismatch."""
        out = dict(params)
        with np.load(npz_path) as data:
            for key in data.files:
                val = data[key]
                targets = ([f"{head}_layer4/{key[len('layer4/'):]}" for head, _ in HEADS]
                           if key.startswith("layer4/") else [key])
                for t in targets:
                    *path, leaf = t.split("/")
                    if leaf != "kernel":
                        raise KeyError(f"converted weight {key!r} is not a conv kernel")
                    name = ".".join(path) + ".weight"
                    if name not in out:
                        raise KeyError(f"converted weight {key!r} has no param at {t!r}")
                    w = np.transpose(val, (3, 2, 0, 1)) if val.ndim == 4 else val
                    if tuple(out[name].shape) != tuple(w.shape):
                        raise ValueError(
                            f"shape mismatch at {t!r}: param {tuple(out[name].shape)} "
                            f"vs converted {tuple(w.shape)}")
                    out[name] = torch.from_numpy(np.ascontiguousarray(w)).to(out[name])
        return out
