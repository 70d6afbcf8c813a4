"""Fused NeRF MLP training entry points and the eval forward from raw
coordinates (port of ``aon_tpu/ops/fused_mlp_train.py``).

``fused_nerf_mlp_xyz_eval`` launches the CUDA kernel ``ops/csrc/fused_mlp_eval.cu``
on CUDA tensors and runs its plain twin, ``fused_nerf_mlp_xyz_eval_plain``,
on CPU tensors.  ``fused_mlp_bwd_xyz`` is the backward that pairs with it: it
recomputes the forward and returns the 26 weight gradients for a cotangent
``g``, through ``ops/csrc/level_train.cu`` on CUDA tensors and through
``fused_mlp_bwd_xyz_plain`` on CPU tensors.  ``fused_mlp_train_xyz`` joins the
two as a ``torch.autograd.Function`` whose gradients flow to the weights only.

The same on pre-encoded inputs: ``fused_mlp_train`` joins the forward of
``ops.fused_mlp.fused_nerf_mlp`` with ``fused_mlp_bwd``, whose kernel
(``ops/csrc/level_train.cu``) recomputes the forward from the given
encodings.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from aon_tpu_torch.ops import _build, train_sm90
from aon_tpu_torch.ops.bench_variants import encode_plain as encode_variant_plain
from aon_tpu_torch.ops.fused_mlp import (  # noqa: F401  (TWO_PI, _mlp_compute: shared names)
    ENC_ORDER,
    ENCODERS,
    N_KERNEL_BIASES,
    N_KERNEL_WEIGHTS,
    POS_PAD,
    SHAPES,
    TWO_PI,
    VIEW_PAD,
    _check_enc_consts,
    _kernel_device,
    _mlp_compute,
    _require_float32_reference,
    check_float32,
    encode_plain,
    eval_blobs,
    fused_nerf_mlp,
    fused_nerf_mlp_xyz_plain,
    grads_from_blob,
    kernel_blobs,
    pack_vanilla_mlp_params_f32,
    pad_features,
    round_packed,
    train_blobs,
    unpack_vanilla_mlp_grads,
    xyz_launch,
)

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

# Rows 1 and 8 of the kernel table compute the same function from the same
# inputs (the TPU laid their inputs out differently): one twin serves both.
fused_nerf_mlp_xyz_eval_plain = fused_nerf_mlp_xyz_plain


def fused_nerf_mlp_xyz_eval(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (B, S, 3) samples + per-ray (B, 3) viewdirs -> (raw_rgb (B, S, 3),
    raw_sigma (B, S, 1)) float32, encodings computed in the kernel.

    ``packed`` comes from ``pack_vanilla_mlp_params`` (float32-packed weights
    are rounded to bf16 for the launch), ``enc_consts`` from
    ``make_posenc_constants``.  CUDA tensors launch the kernel (kernel table
    row 1); CPU tensors run the plain twin.  A caller that already holds
    ``launch_blobs(packed)`` passes them as ``blobs``.
    """
    device = _kernel_device(samples)
    if device is None:
        return fused_nerf_mlp_xyz_eval_plain(packed, enc_consts, samples, viewdirs)
    out = xyz_launch("aon_mlp_eval_launch", "fused_nerf_mlp_xyz_eval", device, packed,
                     enc_consts, samples, viewdirs, blobs)
    fused_nerf_mlp_xyz_eval.launches += 1
    return out


fused_nerf_mlp_xyz_eval.launches = 0


def posenc_in_kernel(x: torch.Tensor, s: torch.Tensor, p: torch.Tensor,
                     encoder: str = "elementwise") -> torch.Tensor:
    """The kernel's f32 positional encoding alone, (N, 3) -> (N, width), on CUDA.

    A check entry, not on the render path (kernel table row 14): it runs the
    device functions the MLP kernels encode with, ``encoder`` one of
    ``ENCODERS`` (``elementwise``: ``_encode_in_kernel``, rows 1, 8 and 13;
    ``mxu`` and ``doubling``: the kernel bench's two others, row 13), so the
    range reduction can be held against the twin and the exact sine column by
    column.  CPU tensors run the twin, ``bench_variants.encode_plain``.
    """
    device = _kernel_device(x)
    if device is None:
        return encode_variant_plain(x, s, p, encoder)
    width = s.shape[1]
    for name, t, shape in (("x", x, (x.shape[0], 3)), ("s", s, (4, width)), ("p", p, (1, width))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {x.device}")
    out = torch.empty(x.shape[0], width, dtype=torch.float32, device=x.device)
    err = _build.library("fused_mlp_eval").aon_posenc_launch(
        x.data_ptr(), s.data_ptr(), p.data_ptr(), width, x.shape[0], ENCODERS.index(encoder),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "posenc_in_kernel")
    posenc_in_kernel.launches += 1
    return out


posenc_in_kernel.launches = 0


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


def train_workspaces(n_rows: int, device: torch.device):
    """Scratch of one launch of a vanilla training kernel
    (``ops/csrc/train_sm90.cuh``): the blocked bf16 activation and gradient
    workspaces (``train_sm90.to_blocked``) and the relu-mask bytes, rows
    padded to whole 128-row tiles (``train_sm90.padded_rows``), and the
    float32 raw outputs; ``torch.empty``, so the caching allocator hands the
    same blocks back every step."""
    n_pad = train_sm90.padded_rows(n_rows)
    blocks = (n_pad // train_sm90.BLOCK_ROWS, train_sm90.BLOCK_ROWS, train_sm90.K_CHUNK)
    act = torch.empty(blocks[0], train_sm90.ACT_CHUNKS, *blocks[1:], dtype=torch.bfloat16,
                      device=device)
    grad = torch.empty(blocks[0], train_sm90.GRAD_CHUNKS, *blocks[1:], dtype=torch.bfloat16,
                       device=device)
    mask = torch.empty(n_pad, train_sm90.MASK_BYTES, dtype=torch.uint8, device=device)
    raw_rgb = torch.empty(n_rows, 3, dtype=torch.float32, device=device)
    raw_sigma = torch.empty(n_rows, 1, dtype=torch.float32, device=device)
    return act, grad, mask, raw_rgb, raw_sigma


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
    tblob, bblob, items, n_items, grid = train_sm90.launch_inputs(
        blobs if blobs is not None else train_blobs(packed), B * S, device)
    act, grad, mask, raw_rgb, raw_sigma = train_workspaces(B * S, device)
    # zeroed on the launch's stream: the kernels add into it
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES, dtype=torch.float32, device=device)
    err = _build.library("level_train").aon_mlp_bwd_launch(
        samples.data_ptr(), viewdirs.data_ptr(), g.data_ptr(),
        *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        tblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        act.data_ptr(), grad.data_ptr(), mask.data_ptr(), gw.data_ptr(), items.data_ptr(),
        n_items, B * S, S, grid, torch.cuda.current_stream(device).cuda_stream,
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
        # packed and rounded once per step: both launches read the same
        # weights, the forward in the eval kernel's layout
        packed = pack_vanilla_mlp_params_f32(dict(zip(names, values)))
        rounded = round_packed(packed)
        blobs = kernel_blobs(rounded)
        ctx.names, ctx.enc_consts, ctx.packed, ctx.blobs = names, enc_consts, packed, blobs
        ctx.save_for_backward(samples, viewdirs)
        return fused_nerf_mlp_xyz_eval(rounded, enc_consts, samples, viewdirs,
                                       blobs=eval_blobs(blobs))

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


# ------------------------------------------------------ pre-encoded inputs


def fused_mlp_bwd_plain(
    packed: Mapping[str, torch.Tensor],
    enc: torch.Tensor,
    venc: torch.Tensor,
    g: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch twin of ``fused_mlp_bwd`` (``_bwd_kernel``), on any
    device: ``fwd_activations`` and ``bwd_from_acts`` on the given encodings,
    which every product rounds to bf16."""
    _require_float32_reference(enc)
    enc, venc = pad_features(enc.float(), venc.float())
    acts = fwd_activations(enc, venc, packed)
    g = g.float()
    return bwd_from_acts(enc, venc, g[:, :3], g[:, 3:4], acts, packed)


def fused_mlp_bwd(
    packed: Mapping[str, torch.Tensor],
    enc: torch.Tensor,
    venc: torch.Tensor,
    g: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Weight gradients of the fused MLP for the cotangent ``g`` (N, 4) =
    ``cat(g_rgb, g_sigma)`` from pre-encoded (N, 63|64) and (N, 27|32)
    inputs: the forward is recomputed from them, nothing is kept from the
    forward call.  ``packed`` is float32-packed (``pack_vanilla_mlp_params_f32``);
    returns float32 gradients in the same layout (``SHAPES``).  CUDA tensors
    launch the kernel (kernel table row 6); CPU tensors run the plain twin.
    A caller that already holds ``train_blobs(packed)`` passes them as
    ``blobs``."""
    device = _kernel_device(enc)
    if device is None:
        return fused_mlp_bwd_plain(packed, enc, venc, g)
    n = enc.shape[0]
    enc, venc = (t.float().contiguous() for t in pad_features(enc, venc))
    check_float32(device, enc=(enc, (n, POS_PAD)), venc=(venc, (n, VIEW_PAD)), g=(g, (n, 4)))
    tblob, bblob, items, n_items, grid = train_sm90.launch_inputs(
        blobs if blobs is not None else train_blobs(packed), n, device)
    act, grad, mask, raw_rgb, raw_sigma = train_workspaces(n, device)
    # zeroed on the launch's stream: the kernels add into it
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES, dtype=torch.float32, device=device)
    err = _build.library("level_train").aon_mlp_bwd_enc_launch(
        enc.data_ptr(), venc.data_ptr(), g.data_ptr(), tblob.data_ptr(), bblob.data_ptr(),
        raw_rgb.data_ptr(), raw_sigma.data_ptr(), act.data_ptr(), grad.data_ptr(),
        mask.data_ptr(), gw.data_ptr(), items.data_ptr(), n_items, n, grid,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "fused_mlp_bwd")
    fused_mlp_bwd.launches += 1
    return grads_from_blob(gw)


fused_mlp_bwd.launches = 0


class _FusedMLPTrain(torch.autograd.Function):
    """Forward through ``fused_nerf_mlp`` on the bf16-rounded weights,
    backward through ``fused_mlp_bwd``; the float32-packed weights arrive as
    ``names`` + ``*values`` and are the only inputs that receive a gradient."""

    @staticmethod
    def forward(ctx, enc, venc, names, *values):
        packed = dict(zip(names, values))
        # rounded once: both launches read the same weights, the forward in
        # the eval kernel's layout
        rounded = round_packed(packed)
        blobs = kernel_blobs(rounded) if enc.is_cuda else None
        ctx.names, ctx.packed, ctx.blobs = names, packed, blobs
        ctx.save_for_backward(enc, venc)
        return fused_nerf_mlp(rounded, enc, venc,
                              blobs=None if blobs is None else eval_blobs(blobs))

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        enc, venc = ctx.saved_tensors
        g = torch.cat([g_rgb, g_sigma], dim=-1).float().contiguous()
        grads = fused_mlp_bwd(ctx.packed, enc, venc, g, blobs=ctx.blobs)
        return (None, None, None, *(grads[n] for n in ctx.names))


def fused_mlp_train(
    packed: Mapping[str, torch.Tensor],
    enc: torch.Tensor,
    venc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused MLP on pre-encoded inputs: float32-packed weights
    (``pack_vanilla_mlp_params_f32``), enc (N, 63|64) and venc (N, 27|32) ->
    ``(raw_rgb (N, 3), raw_sigma (N, 1))``.  Gradients flow to ``packed``
    only, in its ``SHAPES`` layout; ``enc`` and ``venc`` get none.

    The forward multiplies the weights rounded to bf16 (``round_packed``), as
    the backward does and as the TPU's matrix unit does with float32
    operands; the JAX kernel in interpret mode keeps them float32 there."""
    names = tuple(sorted(packed))
    return _FusedMLPTrain.apply(enc.detach(), venc.detach(), names,
                                *(packed[n] for n in names))
