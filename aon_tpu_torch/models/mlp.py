"""Vanilla NeRF MLP as a ``torch.nn.Module`` (port of ``aon_tpu/models/mlp.py``).

Architecture contract of reference ``models/vanilla_nerf/model.py:39-120``:
``netdepth`` x ``netwidth`` dense+ReLU trunk with the encoded input
re-concatenated after every layer ``idx`` with ``idx % skip_layer == 0 and
idx > 0`` (after ``pts_4`` at the defaults); a 1-channel density head and a
linear bottleneck off the trunk; a view branch of ``netdepth_condition`` x
``netwidth_condition`` on ``[bottleneck, viewdir_enc]`` feeding the rgb head.

Layer names follow the flax module (``pts_0..7``, ``density``,
``bottleneck``, ``views_0``, ``rgb``) so ``models/convert.py`` maps flax
params one to one.  Weights are xavier-uniform, biases zero, drawn as flax
draws them (``models/init.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aon_tpu_torch.models.init import flax_init_


class NeRFMLP(nn.Module):
    def __init__(
        self,
        in_features: int = 63,
        view_features: int = 27,
        netdepth: int = 8,
        netwidth: int = 256,
        netdepth_condition: int = 1,
        netwidth_condition: int = 128,
        skip_layer: int = 4,
        num_rgb_channels: int = 3,
        num_density_channels: int = 1,
        dtype: torch.dtype = torch.float32,
        device=None,
        key: Optional[torch.Tensor] = None,
    ):
        """``dtype`` is the compute dtype of the trunk, bottleneck and view
        branch (flax ``dtype``); the density and rgb heads compute in float32.
        Parameters are float32 on ``device``, drawn as flax's ``init(key)`` of
        the JAX module draws them (zero without a key, ``models/init.py``)."""
        super().__init__()
        self.netdepth = netdepth
        self.netdepth_condition = netdepth_condition
        self.skip_layer = skip_layer
        self.dtype = dtype
        meta = dict(device="meta")
        width_in = in_features
        for idx in range(netdepth):
            self.add_module(f"pts_{idx}", nn.Linear(width_in, netwidth, **meta))
            width_in = netwidth
            if idx % skip_layer == 0 and idx > 0:
                width_in += in_features
        self.density = nn.Linear(width_in, num_density_channels, **meta)
        self.bottleneck = nn.Linear(width_in, netwidth, **meta)
        width_in = netwidth + view_features
        for idx in range(netdepth_condition):
            self.add_module(f"views_{idx}", nn.Linear(width_in, netwidth_condition, **meta))
            width_in = netwidth_condition
        self.rgb = nn.Linear(width_in, num_rgb_channels, **meta)
        # built on the meta device so no default init draws from the global RNG
        self.to_empty(device=torch.device("cpu") if device is None else device)
        flax_init_(self, key)

    def _dense(self, name: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        layer = getattr(self, name)
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))

    def forward(
        self, samples_enc: torch.Tensor, viewdirs_enc: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """samples_enc: (B, S, Cpos); viewdirs_enc: (B, Cview).

        Returns (raw_rgb (B, S, 3), raw_density (B, S, 1)) in float32.
        """
        B, S, feat = samples_enc.shape
        x = samples_enc.reshape(B * S, feat).to(self.dtype)
        inputs = x
        for idx in range(self.netdepth):
            x = torch.relu(self._dense(f"pts_{idx}", x, self.dtype))
            if idx % self.skip_layer == 0 and idx > 0:
                x = torch.cat([x, inputs], dim=-1)

        raw_density = self._dense("density", x, torch.float32).reshape(B, S, -1)
        bottleneck = self._dense("bottleneck", x, self.dtype)
        cond = viewdirs_enc[:, None, :].to(self.dtype).expand(B, S, viewdirs_enc.shape[-1])
        x = torch.cat([bottleneck, cond.reshape(B * S, -1)], dim=-1)
        for idx in range(self.netdepth_condition):
            x = torch.relu(self._dense(f"views_{idx}", x, self.dtype))
        raw_rgb = self._dense("rgb", x, torch.float32).reshape(B, S, -1)
        return raw_rgb, raw_density
