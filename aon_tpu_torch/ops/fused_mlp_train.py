"""Fused NeRF MLP from raw coordinates, encodings computed in the kernel:
the eval forward and the two-kernel training route (port of the xyz entry
points of ``aon_tpu/ops/fused_mlp_train.py``).

``fused_nerf_mlp_xyz_eval`` launches the CUDA kernel ``ops/csrc/fused_mlp_eval.cu``
on CUDA tensors and runs its plain twin, ``fused_nerf_mlp_xyz_eval_plain``,
on CPU tensors.  ``fused_mlp_bwd_xyz`` is the backward that pairs with it: it
recomputes the forward and returns the 26 weight gradients for a cotangent
``g``, through ``ops/csrc/level_train.cu`` on CUDA tensors and through
``fused_mlp_bwd_xyz_plain`` on CPU tensors.  ``fused_mlp_train_xyz`` joins the
two as a ``torch.autograd.Function`` whose gradients flow to the weights only.
The entry points on pre-encoded inputs (``fused_mlp_train``) are not ported
yet (ROADMAP.md slice 6).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from aon_tpu_torch.ops import _build
from aon_tpu_torch.ops.fused_mlp import (
    ENC_ORDER,
    N_KERNEL_BIASES,
    N_KERNEL_WEIGHTS,
    POS_PAD,
    SHAPES,
    VIEW_PAD,
    grads_from_blob,
    kernel_blobs,
    pack_vanilla_mlp_params_f32,
    round_packed,
    train_blobs,
    unpack_vanilla_mlp_grads,
)

# 2 * 3.14159265358979, the TPU kernel's constant (float32 once in a tensor)
TWO_PI = 6.28318530717958

# plain-twin rows per block: bounds the f32 activations to ~1 GB at width 256
_PLAIN_BLOCK_ROWS = 1 << 20

# The kernel against its twin, on raw outputs.  Both round the same bf16
# operands, but the kernel sums in another order, so a few activations land
# on the other side of a bf16 rounding boundary: max error 4.2e-3 at 61,440
# rays x 193 samples on an H100 (chip_smoke.py), hence the max limit.  Only a
# few rows flip, so a layout or indexing bug shows in the mean (9.9e-6 there).
TWIN_TOL_MAX = 1e-2
TWIN_TOL_MEAN = 1e-4

# The training kernels' gradients against their twins, per tensor: the largest
# error relative to the tensor's largest magnitude, and the mean error
# relative to its mean magnitude (``grad_errors``).  Both sides round the same
# values to bf16 at the same places, but the sums run in another order (and,
# through atomicAdd, in an order that changes from run to run), so single
# activations land on the other side of a bf16 rounding boundary or of a relu
# and carry that step on.  Where few sample rows hold most of the gradient (a
# ray's last sample at a random init), one relu that flips on such a row moves
# single entries by several percent: hence the wide max limit.  A layout or
# indexing bug moves a whole tensor by O(1) and shows in the mean.  Largest
# seen on an H100: PERF.md.
GRAD_TOL_REL = 1e-1
GRAD_TOL_MEAN_REL = 2e-2
# the same launch twice: only the atomicAdd order differs
GRAD_TOL_REPEAT = 1e-4

# columns per row of the training kernels' two bf16 workspaces
# (ops/csrc/mlp_common.cuh LDA, ops/csrc/level_train.cu LDG)
_WS_ACT_COLS = 2528
_WS_GRAD_COLS = 2432
_TILE_ROWS = 64


def encode_plain(x: torch.Tensor, s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The kernel's positional encoding in PyTorch: x (N, 3) f32 -> (N, width) f32.

    ``pre = x0*s0 + x1*s1 + x2*s2 + p``, then channels >= 3 take
    ``sin(pre - 2pi * floor(pre / 2pi + 0.5))``: the explicit range reduction
    of ``_encode_in_kernel`` (arguments reach ~3000 rad at degree 9).  The
    subtraction is rounded once, as a fused multiply-add, as the CUDA kernel
    does (``__fmaf_rn``) and as XLA does where it contracts that line.
    """
    pre = x[:, 0:1] * s[0:1] + x[:, 1:2] * s[1:2] + x[:, 2:3] * s[2:3] + p
    # a device tensor, not a Python float: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which is not the kernel's IEEE division
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=x.device)
    k = torch.floor(pre / two_pi + 0.5)
    # in float64 the product and the difference are exact, so the cast back
    # to float32 is the single rounding of the fused multiply-add
    reduced = (pre.double() - two_pi.double() * k.double()).float()
    col = torch.arange(pre.shape[1], device=x.device)
    return torch.where(col < 3, pre, torch.sin(reduced))


def _mlp_compute(enc: torch.Tensor, venc: torch.Tensor, w: Mapping[str, torch.Tensor]):
    """Trunk + heads of ``_mlp_compute``: operands in the packed dtype, products
    accumulated in float32, activations rounded to that dtype between layers."""
    dtype = w["w0"].dtype

    def dot(a, b):  # bf16 operands are exact in f32, so this is bf16 x bf16 -> f32
        return a.float() @ b.float()

    def relu_to(x):
        return torch.clamp_min(x, 0.0).to(dtype)

    h = relu_to(dot(enc, w["w0"]) + w["b0"])
    for i in (1, 2, 3, 4):
        h = relu_to(dot(h, w[f"w{i}"]) + w[f"b{i}"])
    h = relu_to(dot(h, w["w5a"]) + dot(enc, w["w5b"]) + w["b5"])
    for i in (6, 7):
        h = relu_to(dot(h, w[f"w{i}"]) + w[f"b{i}"])
    sigma = dot(h, w["wd"]) + w["bd"]
    bottleneck = (dot(h, w["wb"]) + w["bb"]).to(dtype)
    v = relu_to(dot(bottleneck, w["wva"]) + dot(venc, w["wvb"]) + w["bv"])
    rgb = dot(v, w["wrgb"]) + w["brgb"]
    return rgb, sigma


def fused_nerf_mlp_xyz_eval_plain(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel, on any device.

    With bf16-packed weights it rounds the operands to bf16 and multiplies in
    float32 (TF32 must be off, the PyTorch default for matmul); with
    float32-packed weights it is float32 throughout, like the JAX kernel.
    """
    if samples.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain MLP is a float32 reference: set allow_tf32 = False")
    B, S, _ = samples.shape
    dtype = packed["w0"].dtype
    x = samples.reshape(B * S, 3)
    vd = torch.repeat_interleave(viewdirs, S, dim=0)
    rgb = torch.empty(B * S, 3, dtype=torch.float32, device=samples.device)
    sigma = torch.empty(B * S, 1, dtype=torch.float32, device=samples.device)
    for i in range(0, B * S, _PLAIN_BLOCK_ROWS):
        j = min(i + _PLAIN_BLOCK_ROWS, B * S)
        enc = encode_plain(x[i:j], enc_consts["s_pos"], enc_consts["p_pos"]).to(dtype)
        venc = encode_plain(vd[i:j], enc_consts["s_view"], enc_consts["p_view"]).to(dtype)
        rgb[i:j], sigma[i:j] = _mlp_compute(enc, venc, packed)
    return rgb.reshape(B, S, 3), sigma.reshape(B, S, 1)


def _check_enc_consts(enc_consts: Mapping[str, torch.Tensor], device: torch.device) -> None:
    for k, shape in zip(ENC_ORDER, ((4, POS_PAD), (1, POS_PAD), (4, VIEW_PAD), (1, VIEW_PAD))):
        v = enc_consts[k]
        if (tuple(v.shape) != shape or v.dtype != torch.float32 or not v.is_contiguous()
                or v.device != device):
            raise ValueError(f"enc_consts[{k!r}] must be contiguous float32 {shape} on {device}")


def fused_nerf_mlp_xyz_eval(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (B, S, 3) samples + per-ray (B, 3) viewdirs -> (raw_rgb (B, S, 3),
    raw_sigma (B, S, 1)) float32, encodings computed in the kernel.

    ``packed`` comes from ``pack_vanilla_mlp_params`` (bf16 on CUDA),
    ``enc_consts`` from ``make_posenc_constants``.  CUDA tensors launch the
    kernel; CPU tensors run the plain twin.  A caller that already holds
    ``kernel_blobs(packed)`` passes them as ``blobs``.
    """
    if samples.device.type == "cpu":
        return fused_nerf_mlp_xyz_eval_plain(packed, enc_consts, samples, viewdirs)
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    B, S, _ = samples.shape
    for name, t, shape in (("samples", samples, (B, S, 3)), ("viewdirs", viewdirs, (B, 3))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != samples.device):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {samples.device}")
    _check_enc_consts(enc_consts, samples.device)
    wblob, bblob = blobs if blobs is not None else kernel_blobs(packed)
    if wblob.device != samples.device or bblob.device != samples.device:
        raise ValueError(f"packed weights must be on {samples.device}")
    raw_rgb = torch.empty(B, S, 3, dtype=torch.float32, device=samples.device)
    raw_sigma = torch.empty(B, S, 1, dtype=torch.float32, device=samples.device)
    err = _build.library("fused_mlp_eval").aon_mlp_eval_launch(
        samples.data_ptr(), viewdirs.data_ptr(),
        *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        wblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        B * S, S, torch.cuda.current_stream(samples.device).cuda_stream,
    )
    _build.check(err, "fused_nerf_mlp_xyz_eval")
    fused_nerf_mlp_xyz_eval.launches += 1
    return raw_rgb, raw_sigma


fused_nerf_mlp_xyz_eval.launches = 0


def posenc_in_kernel(x: torch.Tensor, s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The kernel's f32 positional encoding alone, (N, 3) -> (N, width), on CUDA.

    A check entry, not on the render path: it runs the same device function
    the MLP kernel encodes with, so the range reduction can be held against
    ``encode_plain`` and the exact sine.
    """
    if not x.is_cuda:
        raise ValueError("posenc_in_kernel runs on CUDA tensors only")
    width = s.shape[1]
    for name, t, shape in (("x", x, (x.shape[0], 3)), ("s", s, (4, width)), ("p", p, (1, width))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {x.device}")
    out = torch.empty(x.shape[0], width, dtype=torch.float32, device=x.device)
    err = _build.library("fused_mlp_eval").aon_posenc_launch(
        x.data_ptr(), s.data_ptr(), p.data_ptr(), width, x.shape[0], out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "posenc_in_kernel")
    return out


# --------------------------------------------------------------- training


def _bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32: both operands rounded to bf16, product in float32."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def fwd_activations(enc: torch.Tensor, venc: torch.Tensor,
                    w: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Forward returning every tensor the backward needs (``_fwd_activations``):
    bf16 operands, float32 sums, activations stored as bf16, rgb and sigma
    float32.  ``w`` is float32-packed (``SHAPES``)."""
    bf = torch.bfloat16
    acts = {}
    a = torch.clamp_min(_bf16_dot(enc, w["w0"]) + w["b0"], 0.0).to(bf)
    acts["a0"] = a
    for i in (1, 2, 3, 4):
        a = torch.clamp_min(_bf16_dot(a, w[f"w{i}"]) + w[f"b{i}"], 0.0).to(bf)
        acts[f"a{i}"] = a
    a = torch.clamp_min(_bf16_dot(a, w["w5a"]) + _bf16_dot(enc, w["w5b"]) + w["b5"], 0.0).to(bf)
    acts["a5"] = a
    for i in (6, 7):
        a = torch.clamp_min(_bf16_dot(a, w[f"w{i}"]) + w[f"b{i}"], 0.0).to(bf)
        acts[f"a{i}"] = a
    acts["sigma"] = _bf16_dot(a, w["wd"]) + w["bd"]
    acts["bottleneck"] = (_bf16_dot(a, w["wb"]) + w["bb"]).to(bf)
    acts["v"] = torch.clamp_min(
        _bf16_dot(acts["bottleneck"], w["wva"]) + _bf16_dot(venc, w["wvb"]) + w["bv"], 0.0).to(bf)
    acts["rgb"] = _bf16_dot(acts["v"], w["wrgb"]) + w["brgb"]
    return acts


def bwd_from_acts(enc, venc, g_rgb, g_sigma, acts, w) -> Dict[str, torch.Tensor]:
    """The 26 weight gradients from live activations (``_bwd_from_acts``),
    written out layer by layer so the roundings are the kernel's: every
    product rounds both operands to bf16, the float32 gradients included;
    relu masks come from the bf16 activations; bias gradients are float32
    column sums."""

    def dot_tn(a, b):  # a^T @ b
        return _bf16_dot(a.t(), b)

    def dot_nt(a, b):  # a @ b^T
        return _bf16_dot(a, b.t())

    def bias_grad(g):
        return g.sum(dim=0, keepdim=True)

    def relu_mask(a):
        return (a.float() > 0).float()

    gw = {"wrgb": dot_tn(acts["v"], g_rgb), "brgb": bias_grad(g_rgb)}
    dv = dot_nt(g_rgb, w["wrgb"]) * relu_mask(acts["v"])
    gw["wva"], gw["wvb"], gw["bv"] = dot_tn(acts["bottleneck"], dv), dot_tn(venc, dv), bias_grad(dv)
    dbott = dot_nt(dv, w["wva"])
    gw["wb"], gw["bb"] = dot_tn(acts["a7"], dbott), bias_grad(dbott)
    gw["wd"], gw["bd"] = dot_tn(acts["a7"], g_sigma), bias_grad(g_sigma)
    da = (dot_nt(dbott, w["wb"]) + dot_nt(g_sigma, w["wd"])) * relu_mask(acts["a7"])
    gw["w7"], gw["b7"] = dot_tn(acts["a6"], da), bias_grad(da)
    da = dot_nt(da, w["w7"]) * relu_mask(acts["a6"])
    gw["w6"], gw["b6"] = dot_tn(acts["a5"], da), bias_grad(da)
    da = dot_nt(da, w["w6"]) * relu_mask(acts["a5"])
    gw["w5a"], gw["w5b"], gw["b5"] = dot_tn(acts["a4"], da), dot_tn(enc, da), bias_grad(da)
    da = dot_nt(da, w["w5a"]) * relu_mask(acts["a4"])
    for i in (4, 3, 2, 1):
        gw[f"w{i}"], gw[f"b{i}"] = dot_tn(acts[f"a{i - 1}"], da), bias_grad(da)
        da = dot_nt(da, w[f"w{i}"]) * relu_mask(acts[f"a{i - 1}"])
    gw["w0"], gw["b0"] = dot_tn(enc, da), bias_grad(da)
    return gw


def encode_rows(enc_consts, xyz: torch.Tensor, viewdirs: torch.Tensor, samples_per_ray: int):
    """bf16 encodings of (N, 3) sample rows and their rays' (B, 3) viewdirs."""
    bf = torch.bfloat16
    enc = encode_plain(xyz, enc_consts["s_pos"], enc_consts["p_pos"]).to(bf)
    vd = torch.repeat_interleave(viewdirs, samples_per_ray, dim=0)
    venc = encode_plain(vd, enc_consts["s_view"], enc_consts["p_view"]).to(bf)
    return enc, venc


def fused_mlp_bwd_xyz_plain(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    g: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch twin of ``fused_mlp_bwd_xyz``, on any device."""
    if samples.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain MLP is a float32 reference: set allow_tf32 = False")
    B, S, _ = samples.shape
    enc, venc = encode_rows(enc_consts, samples.reshape(B * S, 3), viewdirs, S)
    acts = fwd_activations(enc, venc, packed)
    g = g.reshape(B * S, 4).float()
    return bwd_from_acts(enc, venc, g[:, :3], g[:, 3:4], acts, packed)


def grad_errors(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor]):
    """``(max_rel, mean_rel)`` of a dict of gradients against a reference of
    the same layout: over its tensors, the worst of max|got - want| /
    max|want| and the worst of mean|got - want| / mean|want|."""
    tiny = 1e-30
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(tiny)).item()
                  for k in want)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(tiny)).item()
                   for k in want)
    return max_rel, mean_rel


def check_float32(device: torch.device, **tensors) -> None:
    """Raise unless every ``name=(tensor, shape)`` is contiguous float32 of
    that shape on ``device``: what the kernels take."""
    for name, (t, shape) in tensors.items():
        if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name} must be contiguous float32 {tuple(shape)} on {device}")


def train_workspaces(n_rows: int, device: torch.device):
    """Scratch of one launch of a training kernel: the bf16 activation and
    gradient workspaces (rows padded to whole 64-row tiles) and the float32
    raw outputs; ``torch.empty``, so the caching allocator hands the same
    blocks back every step."""
    n_pad = -(-n_rows // _TILE_ROWS) * _TILE_ROWS
    act = torch.empty(n_pad, _WS_ACT_COLS, dtype=torch.bfloat16, device=device)
    grad = torch.empty(n_pad, _WS_GRAD_COLS, dtype=torch.bfloat16, device=device)
    raw_rgb = torch.empty(n_rows, 3, dtype=torch.float32, device=device)
    raw_sigma = torch.empty(n_rows, 1, dtype=torch.float32, device=device)
    return act, grad, raw_rgb, raw_sigma


def fused_mlp_bwd_xyz(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    g: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Weight gradients of the fused MLP for the cotangent ``g`` (B, S, 4) =
    ``cat(g_rgb, g_sigma)``: the forward is recomputed from raw (B, S, 3)
    samples and per-ray (B, 3) viewdirs, nothing is kept from the forward
    call.  ``packed`` is float32-packed (``pack_vanilla_mlp_params_f32``);
    returns float32 gradients in the same layout (``SHAPES``).  CUDA tensors
    launch the kernel; CPU tensors run the plain twin.  A caller that already
    holds ``train_blobs(packed)`` passes them as ``blobs``.
    """
    if samples.device.type == "cpu":
        return fused_mlp_bwd_xyz_plain(packed, enc_consts, samples, viewdirs, g)
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    device = samples.device
    B, S, _ = samples.shape
    check_float32(device, samples=(samples, (B, S, 3)), viewdirs=(viewdirs, (B, 3)),
                  g=(g, (B, S, 4)))
    _check_enc_consts(enc_consts, device)
    wblob, bblob = blobs if blobs is not None else train_blobs(packed)
    if wblob.device != device:
        raise ValueError(f"packed weights must be on {device}")
    act, grad, raw_rgb, raw_sigma = train_workspaces(B * S, device)
    # zeroed on the launch's stream: the kernels add into it
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES, dtype=torch.float32, device=device)
    err = _build.library("level_train").aon_mlp_bwd_launch(
        samples.data_ptr(), viewdirs.data_ptr(), g.data_ptr(),
        *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        wblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        act.data_ptr(), grad.data_ptr(), gw.data_ptr(), B * S, S,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "fused_mlp_bwd_xyz")
    fused_mlp_bwd_xyz.launches += 1
    return grads_from_blob(gw)


fused_mlp_bwd_xyz.launches = 0


class _FusedMLPTrainXYZ(torch.autograd.Function):
    """Forward through the eval kernel, backward through ``fused_mlp_bwd_xyz``;
    the MLP's parameters arrive as ``names`` + ``*values`` and are the only
    inputs that receive a gradient."""

    @staticmethod
    def forward(ctx, enc_consts, samples, viewdirs, names, *values):
        # packed and rounded once per step: both launches read the same blobs
        packed = pack_vanilla_mlp_params_f32(dict(zip(names, values)))
        rounded = round_packed(packed)
        blobs = kernel_blobs(rounded)
        ctx.names, ctx.enc_consts, ctx.packed, ctx.blobs = names, enc_consts, packed, blobs
        ctx.save_for_backward(samples, viewdirs)
        return fused_nerf_mlp_xyz_eval(rounded, enc_consts, samples, viewdirs, blobs=blobs)

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        samples, viewdirs = ctx.saved_tensors
        g = torch.cat([g_rgb, g_sigma], dim=-1).float().contiguous()
        grads = unpack_vanilla_mlp_grads(
            fused_mlp_bwd_xyz(ctx.packed, ctx.enc_consts, samples, viewdirs, g, blobs=ctx.blobs))
        return (None, None, None, None, *(grads[n] for n in ctx.names))


def fused_mlp_train_xyz(
    mlp_params: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused MLP of the two-kernel training route: takes the
    ``NeRFMLP`` state dict itself, raw (B, S, 3) samples and per-ray (B, 3)
    viewdirs; returns ``(raw_rgb (B, S, 3), raw_sigma (B, S, 1))``.  The
    weights are packed once, in the forward, and the gradients come back in
    the state dict's layout; ``samples`` and ``viewdirs`` get none."""
    names = tuple(sorted(mlp_params))
    return _FusedMLPTrainXYZ.apply(enc_consts, samples.detach(), viewdirs.detach(), names,
                                   *(mlp_params[n] for n in names))
