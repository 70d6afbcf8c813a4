"""Joint-state regressor: articulation latent (32) -> scalar joint angle (port
of ``aon_tpu/models/joint_state.py``).

Contract from reference ``models/vanilla_nerf/model_autodecoder.py:42-57``:
32 -> 64 -> 32 -> 1 with ReLU between layers, linear output.  Layer names
follow the flax module (``fc1``, ``fc2``, ``fc_joint_state``) so
``models/convert.py`` maps flax params one to one; weights are flax's default
``lecun_normal``, biases zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aon_tpu_torch.models.init import flax_init_


class JointStateDecoder(nn.Module):
    def __init__(self, in_features: int = 32, device=None,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        meta = dict(device="meta")
        self.fc1 = nn.Linear(in_features, 64, **meta)
        self.fc2 = nn.Linear(64, 32, **meta)
        self.fc_joint_state = nn.Linear(32, 1, **meta)
        # built on the meta device so no default init draws from the global RNG
        self.to_empty(device=torch.device("cpu") if device is None else device)
        self.reset_parameters(key)

    def reset_parameters(self, key: Optional[torch.Tensor]) -> None:
        """flax's ``lecun_normal`` kernels and zero biases, drawn as its
        ``init(key)`` draws them."""
        flax_init_(self, key, "lecun_normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc_joint_state(x)
