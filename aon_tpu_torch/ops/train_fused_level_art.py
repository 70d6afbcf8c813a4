"""One kernel launch per level of ARTICULATED NeRF training (port of
``aon_tpu/ops/train_fused_level_art.py``, the v3 train path).

The articulated analogue of ``ops/train_fused_level.py``: each training level
is one launch that runs the deformation prefix + trunk + view-branch forward
(latents pre-folded into effective biases, ``ops/fused_art.py``), the head
activations (padded sigmoid rgb; ``softplus(raw + density_bias)`` or relu
sigma), the volume compositing and loss, the compositing VJP and the full MLP
backward from the stored activations.

The in-kernel loss covers both articulated systems:

* a per-ray loss weight ``loss_w``: the photometric term is
  ``sum_r loss_w_r * |comp_r - target_r|^2``.  The auto-decoder's plain MSE is
  ``loss_w = 1/(B*3)``; the auto-encoder's instance-masked MSE is
  ``loss_w = mask_r / denom``;
* optional opacity BCE-with-logits on acc against ``mask`` (the
  auto-encoder's ``0.5 * BCE(acc, mask)`` per level): ``d_acc = bce_weight *
  (sigmoid(acc) - m) / B`` feeds the compositing backward in the kernel; the
  BCE *value* is computed outside from the per-ray acc output.

``fused_level_train_art_grads`` launches ``ops/csrc/art.cu`` (four kernels on
``ops/csrc/art_sm90.cuh``; blobs, workspaces and work list: ``ops/art_sm90.py``) on CUDA tensors
and runs its plain twin, ``fused_level_train_art_grads_plain``, on CPU
tensors.  Latent gradients fall out of the effective-bias gradients exactly
as on the two-kernel route (``fused_art.unfold_grads``).  The TPU tile logic
of the JAX module (ray padding with ``loss_w = 0``, ``_choose_tile``) has no
counterpart: the CUDA kernel takes the real B and S.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from aon_tpu_torch.core import sampling
from aon_tpu_torch.core.rays import effective_intervals
from aon_tpu_torch.ops import _build, art_sm90
from aon_tpu_torch.ops.fused_art import (
    N_KERNEL_BIASES,
    N_KERNEL_WEIGHTS,
    _require_float32_reference,
    art_blobs,
    art_bwd_from_acts,
    art_forward,
    fold_latents,
    grads_from_blob,
    train_workspaces,
    unfold_grads,
)
from aon_tpu_torch.ops.fused_mlp import ENC_ORDER, EncConstsCache
from aon_tpu_torch.ops.fused_mlp_train import _check_enc_consts, check_float32
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.resample import sample_pdf_fused

MAX_SAMPLES = 256  # the compositing kernel holds a ray in one warp, 8 samples a lane
SIGMA_ACTS = ("softplus_bias", "relu")


def fused_level_train_art_grads_plain(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    target: torch.Tensor,
    loss_w: torch.Tensor,
    mask: torch.Tensor,
    white_bkgd: bool,
    rgb_padding: float = 0.001,
    density_bias: float = -1.0,
    bce_weight: float = 0.0,
    sigma_act: str = "softplus_bias",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch twin of ``fused_level_train_art_grads``, on any device:
    the compositing backward and the MLP backward written out by hand with the
    kernel's roundings, not autograd."""
    _require_float32_reference(t_vals)
    if sigma_act not in SIGMA_ACTS:
        raise ValueError(f"unknown sigma_act: {sigma_act}")
    B, S = t_vals.shape
    coords = (rays_o[:, None, :] + t_vals[..., None] * rays_d[:, None, :]).reshape(B * S, 3)
    acts = art_forward(coords, torch.repeat_interleave(viewdirs, S, dim=0), packed, enc_consts)
    raw_rgb = acts["rgb"].reshape(B, S, 3)
    raw_sigma = acts["sigma"].reshape(B, S)

    # head activations
    sig = torch.sigmoid(raw_rgb)
    rgb = sig * (1.0 + 2.0 * rgb_padding) - rgb_padding
    if sigma_act == "softplus_bias":
        sp_in = raw_sigma + density_bias
        sigma = F.softplus(sp_in)
    else:
        sigma = torch.clamp_min(raw_sigma, 0.0)

    # compositing forward (unit-norm dirs)
    dist = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-sigma * dist)
    # max(1 - alpha, 0) + eps in this order: u stays >= 1e-10 at opaque
    # samples, which the divisions below need
    u = torch.clamp_min(1.0 - alpha, 0.0) + 1e-10
    T = torch.cat([torch.ones_like(u[:, :1]), torch.cumprod(u[:, :-1], dim=-1)], dim=-1)
    wgt = alpha * T
    comp = (wgt[..., None] * rgb).sum(dim=1)
    acc = wgt.sum(dim=1)
    if white_bkgd:
        comp = comp + (1.0 - acc[:, None])

    # photometric: L = sum_r lw_r |err_r|^2  ->  dL/dcomp = 2 lw err
    lw = loss_w.reshape(B, 1)
    err = comp - target
    dcomp = (2.0 * lw * err)[:, None, :]
    d_rgb = wgt[..., None] * dcomp
    # G = dL/dw_s = <dcomp, rgb_s> - white * <dcomp, 1> through the suffix sum
    G = (dcomp * rgb).sum(dim=-1)
    if white_bkgd:
        G = G - dcomp.sum(dim=-1)
    wG = wgt * G
    P = torch.cat([torch.flip(torch.cumsum(torch.flip(wG[:, 1:], [-1]), -1), [-1]),
                   torch.zeros_like(wG[:, :1])], dim=-1)  # sum_{j > s} w_j G_j
    d_alpha = T * G - P / u
    if bce_weight != 0.0:
        # opacity BCE-with-logits(acc, mask), mean over rays: a per-ray
        # constant dL/dw, through the telescoped closed form d_acc * T_total / u
        # (the suffix-sum form cancels two O(1) terms where acc saturates)
        d_acc = (torch.sigmoid(acc) - mask.reshape(B)) * (bce_weight / B)
        T_total = T[:, -1] * u[:, -1]
        d_alpha = d_alpha + (d_acc * T_total)[:, None] / u
    d_sigma = d_alpha * dist * (1.0 - alpha)

    # head VJPs
    g_rgb = d_rgb * (1.0 + 2.0 * rgb_padding) * sig * (1.0 - sig)
    if sigma_act == "softplus_bias":
        g_sigma = d_sigma * torch.sigmoid(sp_in)
    else:
        g_sigma = torch.where(raw_sigma > 0, d_sigma, torch.zeros_like(d_sigma))

    grads = art_bwd_from_acts(coords, g_rgb.reshape(B * S, 3), g_sigma.reshape(B * S, 1), acts,
                              packed, enc_consts)
    photo_loss = ((err * err).sum(dim=-1) * loss_w.reshape(B)).sum()
    return photo_loss, wgt, acc, grads


def fused_level_train_art_grads(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    target: torch.Tensor,
    loss_w: torch.Tensor,
    mask: torch.Tensor,
    white_bkgd: bool,
    rgb_padding: float = 0.001,
    density_bias: float = -1.0,
    bce_weight: float = 0.0,
    sigma_act: str = "softplus_bias",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One articulated training level, fully fused.

    ``t_vals`` (B, S) sorted sample positions; ``rays_o``, unit-norm
    ``rays_d``, ``viewdirs``, ``target`` (B, 3); ``loss_w`` (B,) per-ray
    photometric loss weight; ``mask`` (B,) opacity-BCE target (ignored if
    ``bce_weight == 0``); ``packed`` float32 effective weights
    (``fused_art.fold_latents``).  Returns ``(photo_loss, weights (B, S), acc
    (B,), effective grads)`` where ``photo_loss = sum_r loss_w_r * |comp_r -
    target_r|^2`` and the grads are d(photo_loss [+ bce_weight * mean
    BCE(acc, mask)])/d(packed): unfold with ``fused_art.unfold_grads``.  CUDA
    tensors launch the kernel; CPU tensors run the plain twin.
    """
    args = (packed, enc_consts, t_vals, rays_o, rays_d, viewdirs, target, loss_w, mask,
            white_bkgd, rgb_padding, density_bias, bce_weight, sigma_act)
    if t_vals.device.type == "cpu":
        return fused_level_train_art_grads_plain(*args)
    if t_vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {t_vals.device}")
    if sigma_act not in SIGMA_ACTS:
        raise ValueError(f"unknown sigma_act: {sigma_act}")
    device = t_vals.device
    B, S = t_vals.shape
    if S > MAX_SAMPLES:
        raise ValueError(f"{S} samples per ray exceed the kernel's {MAX_SAMPLES}")
    check_float32(device, t_vals=(t_vals, (B, S)), rays_o=(rays_o, (B, 3)), rays_d=(rays_d, (B, 3)),
                  viewdirs=(viewdirs, (B, 3)), target=(target, (B, 3)), loss_w=(loss_w, (B,)),
                  mask=(mask, (B,)))
    _check_enc_consts(enc_consts, device)
    tblob, bblob, items, n_items, grid = art_sm90.train_inputs(art_blobs(packed), B * S, device)
    act, grad, relu_mask, xp, raw_rgb, raw_sigma = train_workspaces(B * S, device)
    g = torch.empty(B * S, 4, dtype=torch.float32, device=device)
    weights = torch.empty(B, S, dtype=torch.float32, device=device)
    acc = torch.empty(B, dtype=torch.float32, device=device)
    # zeroed on the launch's stream: the kernels add into both
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES + 1, dtype=torch.float32, device=device)
    photo_loss = gw[-1:]
    err = _build.library("art").aon_art_level_launch(
        t_vals.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(), viewdirs.data_ptr(),
        target.data_ptr(), loss_w.data_ptr(), mask.data_ptr(),
        *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        tblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        g.data_ptr(), act.data_ptr(), xp.data_ptr(), grad.data_ptr(), relu_mask.data_ptr(),
        weights.data_ptr(), acc.data_ptr(), photo_loss.data_ptr(), gw.data_ptr(),
        items.data_ptr(), n_items, B, S, int(bool(white_bkgd)), float(rgb_padding),
        float(density_bias), float(bce_weight), int(sigma_act == "softplus_bias"), grid,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "fused_level_train_art_grads")
    fused_level_train_art_grads.launches += 1
    return photo_loss[0], weights, acc, grads_from_blob(gw)


fused_level_train_art_grads.launches = 0


def latent_reg(latents: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Latent-norm regularisation (reference model_autodecoder.py:456-466):
    ``norm(code, dim=0)`` over a (1, C) code is the per-channel ``|x|``."""
    return 1e-4 * sum(torch.linalg.norm(latents[k], dim=0).mean()
                      for k in ("density", "color", "articulation"))


def make_fused_autodecoder_step_fn(
    code_library: torch.nn.Module,
    near: float,
    far: float,
    white_bkgd: bool,
    num_coarse: int = 64,
    num_fine: int = 128,
    rgb_padding: float = 0.001,
    density_bias: float = -1.0,
    lindisp: bool = False,
    max_deg: int = 10,
    deg_view: int = 4,
) -> Callable:
    """v3 auto-decoder step: ``fn(params, batch, generator=None, draws=None)
    -> (loss, aux, grads)`` with the gradients already computed
    (``fn.returns_grads`` is True).

    ``params`` is the flat state dict ``{"model.coarse_mlp.*", "model.fine_mlp.*",
    "code_library.*"}`` and the gradients come back under the same names.  The
    MLP gradients come from the level kernels; the code tables' from autograd
    through ``code_library`` (an embedding lookup and the regulariser), fed
    the latent cotangents the kernels' effective-bias gradients unfold to.
    ``draws`` injects the uniforms: ``t_rand`` (B, num_coarse + 1) and ``u``
    (B, num_fine), each row of ``u`` ascending.
    """
    enc_consts = EncConstsCache(max_deg, deg_view)

    @torch.no_grad()
    def step_fn(params, batch, generator: Optional[torch.Generator] = None, draws=None):
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        viewdirs, target = batch["viewdirs"], batch["target"]
        ray_ids = batch.get("ray_ids")
        draws = draws or {}
        B = rays_o.shape[0]
        device = rays_o.device
        consts = enc_consts.on(device)

        tables = {k: v.detach().requires_grad_(True)
                  for k, v in mlp_params(params, "code_library").items()}
        with torch.enable_grad():
            lat = torch.func.functional_call(
                code_library, tables, (batch["instance_id"], batch["articulation_id"]))
            reg = latent_reg(lat)
        latents = {k: v.detach() for k, v in lat.items()}

        # optional per-ray importance weights (object-pixel oversampling),
        # mean 1 by construction: the uniform case is lw = 1/(B*3) exactly
        w = batch.get("loss_w")
        lw = (torch.full((B,), 1.0 / (B * 3.0), device=device) if w is None
              else (w.reshape(-1) / (B * 3.0)).float().contiguous())
        m = torch.zeros(B, device=device)

        def level(prefix, t_vals):
            mlp = mlp_params(params, prefix)
            packed = fold_latents(mlp, latents)
            photo, wgt, _, g_eff = fused_level_train_art_grads(
                packed, consts, t_vals, rays_o, rays_d, viewdirs, target, lw, m, white_bkgd,
                rgb_padding=rgb_padding, density_bias=density_bias, bce_weight=0.0)
            dp, d_lat = unfold_grads(g_eff, mlp, latents)
            return photo, wgt, {f"{prefix}.{k}": v for k, v in dp.items()}, d_lat

        t_near, t_far = effective_intervals(batch, near, far)
        t_vals, _ = sampling.sample_along_rays(
            rays_o, rays_d, num_coarse, t_near, t_far, randomized=True, lindisp=lindisp,
            generator=generator, ray_ids=ray_ids, t_rand=draws.get("t_rand"),
        )
        loss0, wgt, grads, d_lat_c = level("model.coarse_mlp", t_vals)

        t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_union, _ = sample_pdf_fused(
            t_mids, wgt[..., 1:-1], rays_o, rays_d, t_vals, num_fine, randomized=True,
            generator=generator, ray_ids=ray_ids, u=draws.get("u"),
        )
        loss1, _, grads_f, d_lat_f = level("model.fine_mlp", t_union)
        grads.update(grads_f)

        names = list(tables)
        d_tables = torch.autograd.grad(
            [lat[k] for k in latents] + [reg], [tables[n] for n in names],
            grad_outputs=[d_lat_c[k] + d_lat_f[k] for k in latents] + [torch.ones_like(reg)],
        )
        grads.update({f"code_library.{n}": g for n, g in zip(names, d_tables)})
        reg = reg.detach()
        return loss0 + loss1 + reg, {"loss0": loss0, "loss1": loss1, "reg": reg}, grads

    step_fn.returns_grads = True
    return step_fn
