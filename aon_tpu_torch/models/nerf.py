"""Two-level hierarchical vanilla NeRF (port of ``aon_tpu/models/nerf.py``).

Contract of reference ``models/vanilla_nerf/model.py:123-199``: a coarse
level on ``num_coarse_samples + 1`` t-values, an inverse-CDF fine level over
the interior coarse weights, sigmoid rgb, ReLU sigma and alpha compositing.
This is the plain, unfused path (``use_pallas=False``); only the
deterministic forward is ported so far.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from aon_tpu_torch.core import sampling
from aon_tpu_torch.core.rendering import volumetric_rendering
from aon_tpu_torch.models.mlp import NeRFMLP


class VanillaNeRF(nn.Module):
    def __init__(
        self,
        num_levels: int = 2,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
        num_coarse_samples: int = 64,
        num_fine_samples: int = 128,
        noise_std: float = 0.0,
        lindisp: bool = False,
        netdepth: int = 8,
        netwidth: int = 256,
        netdepth_condition: int = 1,
        netwidth_condition: int = 128,
        skip_layer: int = 4,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_levels = num_levels
        self.min_deg_point, self.max_deg_point = min_deg_point, max_deg_point
        self.deg_view = deg_view
        self.num_coarse_samples, self.num_fine_samples = num_coarse_samples, num_fine_samples
        self.noise_std, self.lindisp = noise_std, lindisp
        mlp_kw = dict(
            in_features=(2 * (max_deg_point - min_deg_point) + 1) * 3,
            view_features=(2 * deg_view + 1) * 3,
            netdepth=netdepth,
            netwidth=netwidth,
            netdepth_condition=netdepth_condition,
            netwidth_condition=netwidth_condition,
            skip_layer=skip_layer,
            dtype=dtype,
            device=device,
            generator=generator,
        )
        self.coarse_mlp = NeRFMLP(**mlp_kw)
        self.fine_mlp = NeRFMLP(**mlp_kw)

    def forward(
        self,
        rays: Dict[str, torch.Tensor],
        white_bkgd: bool,
        near: Union[float, torch.Tensor],
        far: Union[float, torch.Tensor],
        randomized: bool = False,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """rays: {rays_o, rays_d, viewdirs} each (B, 3).

        Returns ``[(comp_rgb, acc, depth)]`` per level (reference model.py:147-199).
        When ``randomized``, the uniforms come from ``generator`` or from
        ``draws``: ``t_rand`` (B, num_coarse + 1), ``u`` (B, num_fine) and,
        with ``noise_std > 0``, ``noise0`` / ``noise1`` shaped like raw sigma.
        """
        draws = draws or {}
        ret = []
        t_vals = weights = None
        for i_level in range(self.num_levels):
            if i_level == 0:
                t_vals, samples = sampling.sample_along_rays(
                    rays["rays_o"], rays["rays_d"], self.num_coarse_samples, near, far,
                    randomized=randomized, lindisp=self.lindisp, generator=generator,
                    t_rand=draws.get("t_rand"),
                )
                mlp = self.coarse_mlp
            else:
                t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                t_vals, samples = sampling.sample_pdf(
                    t_mids, weights[..., 1:-1], rays["rays_o"], rays["rays_d"], t_vals,
                    self.num_fine_samples, randomized=randomized, generator=generator,
                    u=draws.get("u"),
                )
                mlp = self.fine_mlp

            samples_enc = sampling.pos_enc(samples, self.min_deg_point, self.max_deg_point)
            viewdirs_enc = sampling.pos_enc(rays["viewdirs"], 0, self.deg_view)
            raw_rgb, raw_sigma = mlp(samples_enc, viewdirs_enc)
            if self.noise_std > 0 and randomized:
                noise = draws.get(f"noise{i_level}")
                if noise is None:
                    noise = sampling.draw_uniform(tuple(raw_sigma.shape), generator,
                                                  raw_sigma.device, raw_sigma.dtype)
                raw_sigma = raw_sigma + noise * self.noise_std
            comp_rgb, acc, weights, depth = volumetric_rendering(
                torch.sigmoid(raw_rgb), torch.relu(raw_sigma), t_vals, rays["rays_d"],
                white_bkgd=white_bkgd,
            )
            ret.append((comp_rgb, acc, depth))
        return ret
