"""Fused training loss and renderer of the ARTICULATED NeRF, two-kernel route
(port of ``aon_tpu/ops/train_art_pallas.py``; the module keeps the JAX
package's name so the counterpart is easy to find, the kernels are CUDA).

Mirrors ``ops/train_pallas.py`` for the latent-conditioned model: sampling and
compositing in plain PyTorch under autograd, both MLP passes through
``fused_art_mlp_train`` (forward kernel + backward kernel, ``ops/fused_art.py``)
with gradients flowing to the model weights AND the latent tables.  Head
activations follow the auto-decoder contract: ``softplus(raw + density_bias)``,
padded sigmoid rgb.  The multi-device ``shard_map`` branch of the JAX renderer
has no counterpart yet.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from aon_tpu_torch.core import sampling
from aon_tpu_torch.core.rays import effective_intervals
from aon_tpu_torch.core.rendering import img2mse, volumetric_rendering
from aon_tpu_torch.models.articulated import head_activations
from aon_tpu_torch.ops.fused_art import fused_art_mlp_eval, fused_art_mlp_train
from aon_tpu_torch.ops.fused_mlp import EncConstsCache
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.resample import sample_pdf_fused
from aon_tpu_torch.ops.train_fused_level_art import latent_reg


def fused_two_level_train(
    model_params: Mapping[str, torch.Tensor],
    latents: Mapping[str, torch.Tensor],
    batch: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    near: float,
    far: float,
    white_bkgd: bool,
    num_coarse: int,
    num_fine: int,
    sigma_activation: str,
    rgb_padding: float,
    density_bias: float,
    lindisp: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
):
    """Shared randomized two-level fused render of articulated training.

    ``model_params`` holds ``coarse_mlp.*`` and ``fine_mlp.*``.  Returns
    ``((comp0, acc0), (comp1, acc1))``: what the auto-decoder and the
    auto-encoder losses share (they differ in where the latents come from and
    in which losses they compute)."""
    rays_o, rays_d, viewdirs = batch["rays_o"], batch["rays_d"], batch["viewdirs"]
    ray_ids = batch.get("ray_ids")
    draws = draws or {}

    def level(prefix, t_vals, samples):
        raw_rgb, raw_sigma = fused_art_mlp_train(
            mlp_params(model_params, prefix), latents, samples, viewdirs, enc_consts)
        rgb, sigma = head_activations(raw_rgb, raw_sigma, sigma_activation, rgb_padding,
                                      density_bias)
        return volumetric_rendering(rgb, sigma, t_vals, rays_d, white_bkgd=white_bkgd)

    t_vals, samples = sampling.sample_along_rays(
        rays_o, rays_d, num_coarse, *effective_intervals(batch, near, far), randomized=True,
        lindisp=lindisp, generator=generator, ray_ids=ray_ids, t_rand=draws.get("t_rand"),
    )
    comp0, acc0, weights, _ = level("coarse_mlp", t_vals, samples)

    t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
    t_vals, samples = sample_pdf_fused(
        t_mids, weights[..., 1:-1], rays_o, rays_d, t_vals, num_fine, randomized=True,
        generator=generator, ray_ids=ray_ids, u=draws.get("u"),
    )
    comp1, acc1, _, _ = level("fine_mlp", t_vals, samples)
    return (comp0, acc0), (comp1, acc1)


def weighted_mse(comp: torch.Tensor, target: torch.Tensor,
                 loss_w: Optional[torch.Tensor]) -> torch.Tensor:
    """``img2mse``, or with mean-1 per-ray importance weights
    ``mean(w * (comp - target)^2)``."""
    if loss_w is None:
        return img2mse(comp, target)
    return torch.mean(loss_w.reshape(-1, 1) * (comp - target) ** 2)


def make_fused_autodecoder_loss_fn(
    code_library: torch.nn.Module,
    near: float,
    far: float,
    white_bkgd: bool,
    num_coarse: int = 64,
    num_fine: int = 128,
    sigma_activation: str = "softplus_bias",
    rgb_padding: float = 0.001,
    density_bias: float = -1.0,
    lindisp: bool = False,
    max_deg: int = 10,
    deg_view: int = 4,
) -> Callable:
    """``loss_fn(params, batch, generator=None, draws=None) -> (loss, aux)`` of
    the ``AutoDecoderSystem`` contract; ``params`` is the flat state dict
    ``{"model.*", "code_library.*"}``, differentiated by autograd."""
    consts = EncConstsCache(max_deg, deg_view)

    def loss_fn(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, draws=None):
        latents = torch.func.functional_call(
            code_library, mlp_params(params, "code_library"),
            (batch["instance_id"], batch["articulation_id"]))
        (comp0, _), (comp1, _) = fused_two_level_train(
            mlp_params(params, "model"), latents, batch, consts.on(batch["rays_o"].device),
            near, far, white_bkgd, num_coarse, num_fine, sigma_activation, rgb_padding,
            density_bias, lindisp=lindisp, generator=generator, draws=draws)
        loss0 = weighted_mse(comp0, batch["target"], batch.get("loss_w"))
        loss1 = weighted_mse(comp1, batch["target"], batch.get("loss_w"))
        reg = latent_reg(latents)
        return loss0 + loss1 + reg, {"loss0": loss0, "loss1": loss1, "reg": reg}

    return loss_fn


def make_fused_art_render_fn(
    code_library: torch.nn.Module,
    near: float,
    far: float,
    white_bkgd: bool,
    num_coarse: int = 64,
    num_fine: int = 128,
    sigma_activation: str = "softplus_bias",
    rgb_padding: float = 0.001,
    density_bias: float = -1.0,
    lindisp: bool = False,
    max_deg: int = 10,
    deg_view: int = 4,
) -> Callable:
    """Deterministic fused two-level renderer of the auto-decoder:
    ``fn(params, rays, instance_id, articulation_id, is_test=False) ->
    {comp_rgb, acc, depth}`` with ``rays`` (B, 3) tensors on one device."""
    consts = EncConstsCache(max_deg, deg_view)

    @torch.no_grad()
    def render_fn(params, rays, instance_id, articulation_id, is_test: bool = False):
        latents = torch.func.functional_call(
            code_library, mlp_params(params, "code_library"), (instance_id, articulation_id),
            dict(is_test=is_test))
        enc_consts = consts.on(rays["rays_o"].device)

        def level(prefix, t_vals, samples):
            raw_rgb, raw_sigma = fused_art_mlp_eval(mlp_params(params, prefix), latents, samples,
                                                    rays["viewdirs"], enc_consts)
            rgb, sigma = head_activations(raw_rgb, raw_sigma, sigma_activation, rgb_padding,
                                          density_bias)
            return volumetric_rendering(rgb, sigma, t_vals, rays["rays_d"], white_bkgd=white_bkgd)

        t_vals, samples = sampling.sample_along_rays(
            rays["rays_o"], rays["rays_d"], num_coarse, rays.get("t_near", near),
            rays.get("t_far", far), lindisp=lindisp,
        )
        _, _, weights, _ = level("model.coarse_mlp", t_vals, samples)
        t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_vals, samples = sample_pdf_fused(
            t_mids, weights[..., 1:-1], rays["rays_o"], rays["rays_d"], t_vals, num_fine)
        comp_rgb, acc, _, depth = level("model.fine_mlp", t_vals, samples)
        return {"comp_rgb": comp_rgb, "acc": acc, "depth": depth}

    return render_fn
