"""One kernel launch per level of NeRF training: forward MLP, volume
compositing, MSE loss and the full backward (port of
``aon_tpu/ops/train_fused_level.py``, the v3 train path).

``fused_level_train_grads`` launches ``ops/csrc/level_train.cu`` (its four
kernels on ``ops/csrc/train_sm90.cuh``: the persistent wgmma forward and
backward, the compositing, the weight gradients) on CUDA tensors and runs
its plain twin, ``fused_level_train_grads_plain``, on CPU tensors.  The twin
writes the compositing backward and the MLP backward out
by hand, with the kernel's roundings, instead of calling autograd.

Contracts (the loss-relevant parts of reference helper.py:157-195 and the MSE
of model.py:271-282): last-interval dist 1e10, alpha = 1 - exp(-relu(sigma) *
dist), T the exclusive cumprod of ``max(1 - alpha, 0) + 1e-10``, white
background, level loss = mean((comp - target)^2).  ``noise_std`` must be 0 and
``rays_d`` unit-norm: dists are not rescaled by ``|rays_d|``.

The TPU tile logic of the JAX module (``_choose_tile``, ``_vmem_params``,
``_device_vmem_bytes``) has no counterpart here: the CUDA kernel takes the
real B and S and masks its own ragged last tile.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from aon_tpu_torch.core import sampling
from aon_tpu_torch.core.rays import effective_intervals
from aon_tpu_torch.ops import _build, train_sm90
from aon_tpu_torch.ops.fused_mlp import (
    ENC_ORDER,
    N_KERNEL_BIASES,
    N_KERNEL_WEIGHTS,
    EncConstsCache,
    grads_from_blob,
    pack_vanilla_mlp_params_f32,
    train_blobs,
    unpack_vanilla_mlp_grads,
)
from aon_tpu_torch.ops.fused_mlp_train import (
    _check_enc_consts,
    bwd_from_acts,
    check_float32,
    encode_rows,
    fwd_activations,
    train_workspaces,
)
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.resample import sample_pdf_fused

MAX_SAMPLES = 256  # the compositing kernel holds a ray in one warp, 8 samples a lane


def fused_level_train_grads_plain(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    target: torch.Tensor,
    white_bkgd: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch twin of ``fused_level_train_grads``, on any device."""
    if t_vals.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain level is a float32 reference: set allow_tf32 = False")
    B, S = t_vals.shape
    coords = rays_o[:, None, :] + t_vals[..., None] * rays_d[:, None, :]
    enc, venc = encode_rows(enc_consts, coords.reshape(B * S, 3), viewdirs, S)
    acts = fwd_activations(enc, venc, packed)
    raw_rgb = acts["rgb"].reshape(B, S, 3)
    raw_sigma = acts["sigma"].reshape(B, S)

    # compositing forward (unit-norm dirs)
    dist = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
    sigma = torch.clamp_min(raw_sigma, 0.0)
    rgb = torch.sigmoid(raw_rgb)
    alpha = 1.0 - torch.exp(-sigma * dist)
    # max(1 - alpha, 0) + eps in this order: u stays >= 1e-10 at opaque
    # samples, which the division below needs
    u = torch.clamp_min(1.0 - alpha, 0.0) + 1e-10
    T = torch.cat([torch.ones_like(u[:, :1]), torch.cumprod(u[:, :-1], dim=-1)], dim=-1)
    wgt = alpha * T
    comp = (wgt[..., None] * rgb).sum(dim=1)
    acc = wgt.sum(dim=1, keepdim=True)
    if white_bkgd:
        comp = comp + (1.0 - acc)

    # loss = mean over (B, 3) of err^2  ->  dL/dcomp = 2 err / (B * 3)
    err = comp - target
    dcomp = (err * (2.0 / (B * 3.0)))[:, None, :]
    d_rgb = wgt[..., None] * dcomp
    # G = dL/dw_s = <dcomp, rgb_s> - white * <dcomp, 1>; the white term goes
    # through the same suffix sum as the kernel's, not the closed form
    G = (dcomp * rgb).sum(dim=-1)
    if white_bkgd:
        G = G - dcomp.sum(dim=-1)
    wG = wgt * G
    P = torch.cat([torch.flip(torch.cumsum(torch.flip(wG[:, 1:], [-1]), -1), [-1]),
                   torch.zeros_like(wG[:, :1])], dim=-1)  # sum_{j > s} w_j G_j
    d_alpha = T * G - P / u
    d_sigma = d_alpha * dist * (1.0 - alpha)
    g_rgb = d_rgb * rgb * (1.0 - rgb)  # sigmoid'
    g_sigma = torch.where(raw_sigma > 0, d_sigma, torch.zeros_like(d_sigma))  # relu'

    grads = bwd_from_acts(enc, venc, g_rgb.reshape(B * S, 3), g_sigma.reshape(B * S, 1), acts,
                          packed)
    return (err * err).sum(), wgt, grads


def fused_level_train_grads(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    target: torch.Tensor,
    white_bkgd: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One training level, fully fused.

    ``t_vals`` (B, S) sorted sample positions; ``rays_o``, unit-norm
    ``rays_d``, ``viewdirs``, ``target`` (B, 3); ``packed`` float32-packed
    weights.  Returns ``(sq_err_sum, weights (B, S), packed weight grads)``:
    ``sq_err_sum`` is the sum over rays of the 3-channel squared error (level
    loss = sq_err_sum / (B * 3)) and the grads are d(level loss)/d(packed) in
    float32.  CUDA tensors launch the kernel; CPU tensors run the plain twin.
    """
    if t_vals.device.type == "cpu":
        return fused_level_train_grads_plain(packed, enc_consts, t_vals, rays_o, rays_d, viewdirs,
                                             target, white_bkgd)
    if t_vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {t_vals.device}")
    device = t_vals.device
    B, S = t_vals.shape
    if S > MAX_SAMPLES:
        raise ValueError(f"{S} samples per ray exceed the kernel's {MAX_SAMPLES}")
    check_float32(device, t_vals=(t_vals, (B, S)), rays_o=(rays_o, (B, 3)), rays_d=(rays_d, (B, 3)),
                  viewdirs=(viewdirs, (B, 3)), target=(target, (B, 3)))
    _check_enc_consts(enc_consts, device)
    tblob, bblob, items, n_items, grid = train_sm90.launch_inputs(
        train_blobs(packed), B * S, device)
    act, grad, mask, raw_rgb, raw_sigma = train_workspaces(B * S, device)
    g = torch.empty(B * S, 4, dtype=torch.float32, device=device)
    weights = torch.empty(B, S, dtype=torch.float32, device=device)
    # zeroed on the launch's stream: the kernels add into both
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES + 1, dtype=torch.float32, device=device)
    sq_err_sum = gw[-1:]
    err = _build.library("level_train").aon_level_train_launch(
        t_vals.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(), viewdirs.data_ptr(),
        target.data_ptr(), *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        tblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        g.data_ptr(), act.data_ptr(), grad.data_ptr(), mask.data_ptr(), weights.data_ptr(),
        sq_err_sum.data_ptr(), gw.data_ptr(), items.data_ptr(), n_items, B, S,
        int(bool(white_bkgd)), grid, torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "fused_level_train_grads")
    fused_level_train_grads.launches += 1
    return sq_err_sum[0], weights, grads_from_blob(gw)


fused_level_train_grads.launches = 0


def make_fused_step_fn(
    near: float,
    far: float,
    white_bkgd: bool,
    num_coarse: int = 64,
    num_fine: int = 128,
    max_deg: int = 10,
    deg_view: int = 4,
    lindisp: bool = False,
) -> Callable:
    """v3 step: returns ``fn(params, batch, generator=None, draws=None) ->
    (loss, aux, grads)`` with the gradients already computed: no autograd
    runs around it (``fn.returns_grads`` is True).

    ``params`` is the ``VanillaNeRF`` state dict and the gradients come back
    under the same names.  Sampling and resampling stay outside the level
    kernel (stratified coarse samples, the resample kernel), as on the
    two-kernel route.  ``draws`` injects the uniforms instead of drawing them
    from ``generator``: ``t_rand`` (B, num_coarse + 1) and ``u`` (B,
    num_fine), each row of ``u`` ascending.
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

        packed_c = pack_vanilla_mlp_params_f32(mlp_params(params, "coarse_mlp"))
        packed_f = pack_vanilla_mlp_params_f32(mlp_params(params, "fine_mlp"))

        t_vals, _ = sampling.sample_along_rays(
            rays_o, rays_d, num_coarse, *effective_intervals(batch, near, far),
            randomized=True, lindisp=lindisp, generator=generator, ray_ids=ray_ids,
            t_rand=draws.get("t_rand"),
        )
        err0, wgt, g_c = fused_level_train_grads(
            packed_c, consts, t_vals, rays_o, rays_d, viewdirs, target, white_bkgd)

        t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_union, _ = sample_pdf_fused(
            t_mids, wgt[..., 1:-1], rays_o, rays_d, t_vals, num_fine, randomized=True,
            generator=generator, ray_ids=ray_ids, u=draws.get("u"),
        )
        err1, _, g_f = fused_level_train_grads(
            packed_f, consts, t_union, rays_o, rays_d, viewdirs, target, white_bkgd)

        loss0 = err0 / (B * 3.0)
        loss1 = err1 / (B * 3.0)
        grads = {f"coarse_mlp.{k}": v for k, v in unpack_vanilla_mlp_grads(g_c).items()}
        grads.update({f"fine_mlp.{k}": v for k, v in unpack_vanilla_mlp_grads(g_f).items()})
        return loss0 + loss1, {"loss0": loss0, "loss1": loss1}, grads

    step_fn.returns_grads = True
    return step_fn
