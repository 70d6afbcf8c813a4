"""Latent code library of the auto-decoder articulated NeRF (port of
``aon_tpu/models/code_library.py``).

Contract from reference ``models/code_library.py:12-71``: per-instance shape
and appearance embeddings (``n_max_objs`` x ``n_obj_code_length``) and a
10 x 32 articulation table, xavier-uniform initialised (as flax's ``init``
draws them, ``models/init.py``).  Test-time
articulation interpolation produces ``2*10 - 1 = 19`` codes by inserting
midpoint averages between consecutive learned codes.

The tables are ordinary parameters, so the one Adam update over the whole
state dict also trains the codes.  A row that a step did not index has a
zero gradient, but Adam still moves it through its moments from earlier
steps, as optax's dense Adam moves it in the JAX package; only a row that no
step has indexed yet stays where it was.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from aon_tpu_torch.models.init import flax_init_

N_MAX_ARTICULATIONS = 10
N_ART_CODE_LENGTH = 32


def interpolate_articulations(table: torch.Tensor) -> torch.Tensor:
    """(N, C) learned codes -> (2N - 1, C): even rows are the learned codes,
    odd rows are midpoints of their neighbours."""
    n = table.shape[0]
    out = table.new_zeros((2 * n - 1, table.shape[1]))
    out[0::2] = table
    out[1::2] = 0.5 * (table[:-1] + table[1:])
    return out


class CodeLibraryArticulated(nn.Module):
    def __init__(
        self,
        n_max_objs: int = 151,
        n_obj_code_length: int = 128,
        n_max_articulations: int = N_MAX_ARTICULATIONS,
        n_art_code_length: int = N_ART_CODE_LENGTH,
        device=None,
        key: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        meta = dict(device="meta")
        self.embedding_instance_shape = nn.Embedding(n_max_objs, n_obj_code_length, **meta)
        self.embedding_instance_appearance = nn.Embedding(n_max_objs, n_obj_code_length, **meta)
        self.embedding_instance_articulation = nn.Embedding(
            n_max_articulations, n_art_code_length, **meta)
        # built on the meta device so no default init draws from the global RNG
        self.to_empty(device=torch.device("cpu") if device is None else device)
        self.reset_parameters(key)

    def reset_parameters(self, key: Optional[torch.Tensor]) -> None:
        """Xavier-uniform tables drawn as flax's ``init(key)`` of the JAX
        module draws them."""
        flax_init_(self, key)

    def forward(self, instance_id, articulation_id, is_test: bool = False
                ) -> Dict[str, torch.Tensor]:
        """instance_id / articulation_id: int scalars or (B,) integer tensors.

        Returns {density, color, articulation} embedding rows, each (B, C) with
        B = 1 for scalars.  When ``is_test`` is True, articulation_id indexes
        the 2N-1 interpolated table instead of the learned one.
        """
        device = self.embedding_instance_shape.weight.device
        instance_id = torch.atleast_1d(torch.as_tensor(instance_id, device=device)).long()
        articulation_id = torch.atleast_1d(torch.as_tensor(articulation_id, device=device)).long()
        table = self.embedding_instance_articulation.weight
        if is_test:
            table = interpolate_articulations(table)
        return {
            "density": self.embedding_instance_shape(instance_id),
            "color": self.embedding_instance_appearance(instance_id),
            "articulation": table[articulation_id],
        }
