"""Fused training loss of the vanilla NeRF, two-kernel route (port of
``aon_tpu/ops/train_pallas.py``; the module keeps the JAX package's name so
the counterpart is easy to find, the kernels are CUDA).

Both MLP passes go through ``fused_mlp_train_xyz`` (forward kernel + backward
kernel, ``ops/fused_mlp_train.py``); sampling, compositing and ``img2mse``
stay plain PyTorch under autograd, and the gradients land on the ordinary
``VanillaNeRF`` state dict.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from aon_tpu_torch.core import prng, sampling
from aon_tpu_torch.core.rays import effective_intervals
from aon_tpu_torch.core.rendering import img2mse, volumetric_rendering
from aon_tpu_torch.ops.fused_mlp import EncConstsCache
from aon_tpu_torch.ops.fused_mlp_train import fused_mlp_train_xyz
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.resample import sample_pdf_fused


def _level_train(mlp, enc_consts, rays, t_vals, samples, noise, white_bkgd, noise_std):
    raw_rgb, raw_sigma = fused_mlp_train_xyz(mlp, enc_consts, samples.contiguous(),
                                             rays["viewdirs"])
    if noise is not None:
        raw_sigma = raw_sigma + noise * noise_std
    return volumetric_rendering(torch.sigmoid(raw_rgb), torch.relu(raw_sigma), t_vals,
                                rays["rays_d"], white_bkgd=white_bkgd)


def make_fused_loss_fn(
    near: float,
    far: float,
    white_bkgd: bool,
    num_coarse: int = 64,
    num_fine: int = 128,
    max_deg: int = 10,
    deg_view: int = 4,
    noise_std: float = 0.0,
    lindisp: bool = False,
    randomized: bool = True,
) -> Callable:
    """Returns ``loss_fn(params, batch, key=None, draws=None) -> (loss,
    aux)`` of the ``VanillaSystem`` contract; ``params`` is the ``VanillaNeRF``
    state dict, differentiated by autograd.

    ``randomized=False`` freezes both sampling levels to their deterministic
    quantiles, for tests that compare with the plain path sample for sample
    (the randomized fine quantiles are sorted order statistics, not the plain
    path's iid draws).  ``draws``: ``t_rand`` (B, num_coarse + 1), ``u``
    (B, num_fine) with ascending rows, ``noise0`` / ``noise1`` (B, S, 1).
    Otherwise they come from ``split(key, 4)`` as in the JAX loss
    (``aon_tpu/ops/train_pallas.py:69``): the coarse samples, the coarse
    sigma noise, the fine samples, the fine sigma noise.
    """
    enc_consts = EncConstsCache(max_deg, deg_view)

    def loss_fn(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
                key: Optional[torch.Tensor] = None, draws=None):
        rays = {k: batch[k] for k in ("rays_o", "rays_d", "viewdirs")}
        ray_ids = batch.get("ray_ids")
        draws = draws or {}
        keys = prng.maybe_split(key, 4)
        device = rays["rays_o"].device
        consts = enc_consts.on(device)

        def noise(level, shape):
            if not (noise_std > 0 and randomized):
                return None
            if f"noise{level}" in draws:
                return draws[f"noise{level}"]
            return sampling.draw_uniform(shape, keys[2 * level + 1], device)

        t_vals, samples = sampling.sample_along_rays(
            rays["rays_o"], rays["rays_d"], num_coarse,
            *effective_intervals(batch, near, far),
            randomized=randomized, lindisp=lindisp, key=keys[0], ray_ids=ray_ids,
            t_rand=draws.get("t_rand"),
        )
        comp0, _, weights, _ = _level_train(
            mlp_params(params, "coarse_mlp"), consts, rays, t_vals, samples,
            noise(0, (*t_vals.shape, 1)), white_bkgd, noise_std)

        t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_vals, samples = sample_pdf_fused(
            t_mids, weights[..., 1:-1], rays["rays_o"], rays["rays_d"], t_vals, num_fine,
            randomized=randomized, key=keys[2], ray_ids=ray_ids, u=draws.get("u"),
        )
        comp1, _, _, _ = _level_train(
            mlp_params(params, "fine_mlp"), consts, rays, t_vals, samples,
            noise(1, (*t_vals.shape, 1)), white_bkgd, noise_std)

        loss0 = img2mse(comp0, batch["target"])
        loss1 = img2mse(comp1, batch["target"])
        return loss0 + loss1, {"loss0": loss0, "loss1": loss1}

    return loss_fn
