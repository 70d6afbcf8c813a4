"""Fused two-level NeRF rendering (port of ``aon_tpu/ops/render_pallas.py``).

The renderer runs on one rank's rays: the JAX renderer's multi-device
``shard_map`` branch is one level up here, in ``eval/render.py::render_frame``,
which gives each rank its block of a frame's rays and gathers the blocks
(``parallel/multihost.py``).

Coarse level -> ``sample_pdf_fused`` -> fine level.  The two MLP passes go
through ``fused_nerf_mlp_xyz_eval`` and the resample through the merge
kernel; sampling, sigmoid/relu and compositing stay plain PyTorch.  On CPU
tensors every kernel wrapper runs its plain twin.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from aon_tpu_torch.core import sampling
from aon_tpu_torch.core.rendering import volumetric_rendering
from aon_tpu_torch.ops.fused_mlp import make_posenc_constants, pack_vanilla_mlp_params
from aon_tpu_torch.ops.fused_mlp_train import fused_nerf_mlp_xyz_eval
from aon_tpu_torch.ops.resample import sample_pdf_fused


def mlp_params(params: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The ``NeRFMLP`` state dict under ``prefix`` (``coarse_mlp``/``fine_mlp``)."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in params.items() if k.startswith(head)}


def _level(packed, enc_consts, rays, t_vals, samples, white_bkgd):
    raw_rgb, raw_sigma = fused_nerf_mlp_xyz_eval(packed, enc_consts, samples, rays["viewdirs"])
    return volumetric_rendering(
        torch.sigmoid(raw_rgb), torch.relu(raw_sigma), t_vals, rays["rays_d"], white_bkgd=white_bkgd
    )


def make_fused_render_fn(
    near: float,
    far: float,
    white_bkgd: bool,
    num_coarse: int = 64,
    num_fine: int = 128,
    max_deg: int = 10,
    deg_view: int = 4,
    lindisp: bool = False,
) -> Callable[[Mapping[str, torch.Tensor], Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns ``fn(params, rays) -> {comp_rgb, acc, depth}`` with ``params``
    the ``VanillaNeRF`` state dict and ``rays`` (B, 3) tensors on one device.
    Deterministic; the weights are packed to bf16 as the JAX path packs them."""

    @torch.no_grad()
    def render(params: Mapping[str, torch.Tensor], rays: Dict[str, torch.Tensor]):
        device = rays["rays_o"].device
        enc_consts = make_posenc_constants(max_deg, deg_view, device=device)
        packed_c = pack_vanilla_mlp_params(mlp_params(params, "coarse_mlp"))
        packed_f = pack_vanilla_mlp_params(mlp_params(params, "fine_mlp"))

        t_vals, samples = sampling.sample_along_rays(
            rays["rays_o"], rays["rays_d"], num_coarse,
            rays.get("t_near", near), rays.get("t_far", far), lindisp=lindisp,
        )
        _, _, weights, _ = _level(packed_c, enc_consts, rays, t_vals, samples, white_bkgd)

        t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_vals, samples = sample_pdf_fused(
            t_mids, weights[..., 1:-1], rays["rays_o"], rays["rays_d"], t_vals, num_fine
        )
        comp_rgb, acc, _, depth = _level(packed_f, enc_consts, rays, t_vals, samples, white_bkgd)
        return {"comp_rgb": comp_rgb, "acc": acc, "depth": depth}

    return render
