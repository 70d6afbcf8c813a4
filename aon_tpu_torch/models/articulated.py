"""Articulated NeRF: latent-conditioned MLP with a deformation field (port of
``aon_tpu/models/articulated.py``).

Architecture contract from reference
``models/vanilla_nerf/model_autodecoder.py:60-337``:

* deformation MLP: ``netdepth_deformation`` x ``netwidth_deformation`` on
  ``[xyz, shape_latent, articulation_latent]`` producing a 3-vector offset
  added to xyz (``enc_after=True``: the positional encoding is applied AFTER
  the deformation);
* trunk input ``[pos_enc(xyz + dxyz), shape_latent]``, re-concatenated at the
  skip;
* view branch input ``[bottleneck, viewdir_enc, appearance_latent]``,
  ``netdepth_condition=4`` x 128;
* auto-decoder head activations: ``sigma = softplus(raw + density_bias)``
  (bias -1.0) and ``rgb = sigmoid(raw) * (1 + 2*rgb_padding) - rgb_padding``
  (padding 1e-3); the auto-encoder variant uses plain ReLU sigma and un-padded
  sigmoid rgb, selected by ``sigma_activation`` / ``rgb_padding``.

Layer names follow the flax module (``deform_0..3``, ``deform_out``,
``pts_0..7``, ``density``, ``bottleneck``, ``views_0..3``, ``rgb``) so
``models/convert.py`` maps flax params one to one.  This is the plain, unfused
path (``use_pallas=False`` or a CPU device); the kernels' packing of the same
parameters is ``ops/fused_art.py``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from aon_tpu_torch.core import prng, sampling
from aon_tpu_torch.core.rendering import volumetric_rendering
from aon_tpu_torch.models.init import flax_init_


def head_activations(raw_rgb: torch.Tensor, raw_sigma: torch.Tensor, sigma_activation: str,
                     rgb_padding: float, density_bias: float):
    """``(rgb, sigma)`` from the raw heads (``_activations`` of the JAX
    package's ``ops/train_art_pallas.py``)."""
    rgb = torch.sigmoid(raw_rgb)
    if rgb_padding > 0:
        rgb = rgb * (1 + 2 * rgb_padding) - rgb_padding
    if sigma_activation == "softplus_bias":
        sigma = F.softplus(raw_sigma + density_bias)
    elif sigma_activation == "relu":
        sigma = torch.relu(raw_sigma)
    else:
        raise ValueError(f"unknown sigma_activation: {sigma_activation}")
    return rgb, sigma


class ArticulatedNeRFMLP(nn.Module):
    def __init__(
        self,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        view_features: int = 27,
        shape_dim: int = 128,
        articulation_dim: int = 32,
        appearance_dim: int = 128,
        netdepth: int = 8,
        netwidth: int = 256,
        netdepth_deformation: int = 4,
        netwidth_deformation: int = 128,
        netdepth_condition: int = 4,
        netwidth_condition: int = 128,
        skip_layer: int = 4,
        num_rgb_channels: int = 3,
        num_density_channels: int = 1,
        use_deg_embedding: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
        key: Optional[torch.Tensor] = None,
    ):
        """The ``enc_after=True`` deformation variant, the only one the JAX
        package's systems build.  ``dtype`` is the compute dtype of all layers
        but the float32 density and rgb heads; parameters are float32 on
        ``device``, drawn as flax's ``init(key)`` draws them (zero without a
        key, ``models/init.py``).  With ``use_deg_embedding``
        the articulation code is read from ``latents["articulation_deg"]``
        (``articulation_dim`` is then that embedding's width)."""
        super().__init__()
        self.min_deg_point, self.max_deg_point = min_deg_point, max_deg_point
        self.netdepth, self.skip_layer = netdepth, skip_layer
        self.netdepth_deformation = netdepth_deformation
        self.netdepth_condition = netdepth_condition
        self.use_deg_embedding = use_deg_embedding
        self.dtype = dtype
        meta = dict(device="meta")
        width_in = 3 + shape_dim + articulation_dim
        for idx in range(netdepth_deformation):
            self.add_module(f"deform_{idx}", nn.Linear(width_in, netwidth_deformation, **meta))
            width_in = netwidth_deformation
        self.deform_out = nn.Linear(width_in, 3, **meta)
        in_features = (2 * (max_deg_point - min_deg_point) + 1) * 3 + shape_dim
        width_in = in_features
        for idx in range(netdepth):
            self.add_module(f"pts_{idx}", nn.Linear(width_in, netwidth, **meta))
            width_in = netwidth
            if idx % skip_layer == 0 and idx > 0:
                width_in += in_features
        self.density = nn.Linear(width_in, num_density_channels, **meta)
        self.bottleneck = nn.Linear(width_in, netwidth, **meta)
        width_in = netwidth + view_features + appearance_dim
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

    def forward(self, pos: torch.Tensor, condition: torch.Tensor,
                latents: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """pos: (B, S, 3) raw sample coords; condition: (B, Cview) encoded
        viewdirs; latents: ``density`` (shape code), ``color`` (appearance
        code), ``articulation`` (or ``articulation_deg``), each (1, C) or (C,),
        broadcast to all samples (one instance and articulation per step).

        Returns (raw_rgb (B, S, 3), raw_density (B, S, 1)) in float32.
        """
        B, S, feat = pos.shape
        BN = B * S
        x_pos = pos.reshape(BN, feat).to(self.dtype)

        def bcast(code: torch.Tensor) -> torch.Tensor:
            return code.reshape(1, -1).to(self.dtype).expand(BN, -1)

        shape_code = bcast(latents["density"])
        appearance_code = bcast(latents["color"])
        art_key = "articulation_deg" if self.use_deg_embedding else "articulation"
        x = torch.cat([x_pos, shape_code, bcast(latents[art_key])], dim=-1)

        for idx in range(self.netdepth_deformation):
            x = torch.relu(self._dense(f"deform_{idx}", x, self.dtype))
        x = self._dense("deform_out", x, self.dtype) + x_pos
        x = sampling.pos_enc(x, self.min_deg_point, self.max_deg_point)
        x = torch.cat([x, shape_code], dim=-1)

        inputs = x
        for idx in range(self.netdepth):
            x = torch.relu(self._dense(f"pts_{idx}", x, self.dtype))
            if idx % self.skip_layer == 0 and idx > 0:
                x = torch.cat([x, inputs], dim=-1)

        raw_density = self._dense("density", x, torch.float32).reshape(B, S, -1)
        bottleneck = self._dense("bottleneck", x, self.dtype)
        cond = condition[:, None, :].to(self.dtype).expand(B, S, condition.shape[-1])
        x = torch.cat([bottleneck, cond.reshape(BN, -1), appearance_code], dim=-1)
        for idx in range(self.netdepth_condition):
            x = torch.relu(self._dense(f"views_{idx}", x, self.dtype))
        raw_rgb = self._dense("rgb", x, torch.float32).reshape(B, S, -1)
        return raw_rgb, raw_density


class ArticulatedNeRF(nn.Module):
    """Two-level hierarchical articulated NeRF (reference NeRF_AE_Art).

    ``sigma_activation``: "softplus_bias" (auto-decoder contract,
    softplus(raw + density_bias)) or "relu" (auto-encoder contract).
    ``rgb_padding``: 0 disables the sigmoid padding.
    """

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
        rgb_padding: float = 0.001,
        density_bias: float = -1.0,
        sigma_activation: str = "softplus_bias",
        use_deg_embedding: bool = False,
        articulation_deg: int = 32,
        shape_dim: int = 128,
        dtype: torch.dtype = torch.float32,
        device=None,
        key: Optional[torch.Tensor] = None,
    ):
        """``articulation_deg`` is the width of the articulation code the MLPs
        take (the library's 32, or the auto-encoder's degree embedding).
        Parameters are drawn as flax's ``init(key)`` of the JAX
        ``ArticulatedNeRF`` draws them (zero without a key)."""
        super().__init__()
        if sigma_activation not in ("softplus_bias", "relu"):
            raise ValueError(f"unknown sigma_activation: {sigma_activation}")
        self.num_levels = num_levels
        self.min_deg_point, self.max_deg_point, self.deg_view = min_deg_point, max_deg_point, deg_view
        self.num_coarse_samples, self.num_fine_samples = num_coarse_samples, num_fine_samples
        self.noise_std, self.lindisp = noise_std, lindisp
        self.rgb_padding, self.density_bias = rgb_padding, density_bias
        self.sigma_activation = sigma_activation
        mlp_kw = dict(
            min_deg_point=min_deg_point, max_deg_point=max_deg_point,
            view_features=(2 * deg_view + 1) * 3, shape_dim=shape_dim, appearance_dim=shape_dim,
            articulation_dim=articulation_deg, use_deg_embedding=use_deg_embedding,
            dtype=dtype, device=device,
        )
        self.coarse_mlp = ArticulatedNeRFMLP(**mlp_kw)
        self.fine_mlp = ArticulatedNeRFMLP(**mlp_kw)
        flax_init_(self, key)

    def forward(
        self,
        rays: Dict[str, torch.Tensor],
        latents: Mapping[str, torch.Tensor],
        white_bkgd: bool,
        near: Union[float, torch.Tensor],
        far: Union[float, torch.Tensor],
        randomized: bool = False,
        key: Optional[torch.Tensor] = None,
        draws: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """rays: {rays_o, rays_d, viewdirs} each (B, 3), and optionally
        ``draw_row0``, the first row of this block in the draw of the whole
        batch (a rank's block).

        Returns ``[(comp_rgb, acc, depth)]`` per level.  When ``randomized``,
        the uniforms come from ``split(key, 2 * num_levels)`` as in the JAX
        module (``aon_tpu/models/articulated.py:176``; the keys of
        ``VanillaNeRF.forward``), or from ``draws``: ``t_rand`` (B,
        num_coarse + 1), ``u`` (B, num_fine) and, with ``noise_std > 0``,
        ``noise0`` / ``noise1`` shaped like raw sigma.
        """
        draws = draws or {}
        keys = prng.maybe_split(key if randomized else None, 2 * self.num_levels)
        row0 = int(rays.get("draw_row0", 0))
        ret = []
        t_vals = weights = None
        for i_level in range(self.num_levels):
            if i_level == 0:
                t_vals, samples = sampling.sample_along_rays(
                    rays["rays_o"], rays["rays_d"], self.num_coarse_samples, near, far,
                    randomized=randomized, lindisp=self.lindisp, key=keys[0],
                    t_rand=draws.get("t_rand"), row0=row0,
                )
                mlp = self.coarse_mlp
            else:
                t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                t_vals, samples = sampling.sample_pdf(
                    t_mids, weights[..., 1:-1], rays["rays_o"], rays["rays_d"], t_vals,
                    self.num_fine_samples, randomized=randomized, key=keys[2 * i_level],
                    u=draws.get("u"), row0=row0,
                )
                mlp = self.fine_mlp

            viewdirs_enc = sampling.pos_enc(rays["viewdirs"], 0, self.deg_view)
            raw_rgb, raw_sigma = mlp(samples, viewdirs_enc, latents)
            if self.noise_std > 0 and randomized:
                noise = draws.get(f"noise{i_level}")
                if noise is None:
                    noise = sampling.draw_uniform(tuple(raw_sigma.shape), keys[2 * i_level + 1],
                                                  raw_sigma.device, raw_sigma.dtype, row0=row0)
                raw_sigma = raw_sigma + noise * self.noise_std
            rgb, sigma = head_activations(raw_rgb, raw_sigma, self.sigma_activation,
                                          self.rgb_padding, self.density_bias)
            comp_rgb, acc, weights, depth = volumetric_rendering(
                rgb, sigma, t_vals, rays["rays_d"], white_bkgd=white_bkgd)
            ret.append((comp_rgb, acc, depth))
        return ret
