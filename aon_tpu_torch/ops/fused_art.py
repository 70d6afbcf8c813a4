"""Fused kernels for the ARTICULATED NeRF MLP (deformation variant): the eval
forward and the two-kernel training route (port of ``aon_tpu/ops/fused_art.py``).

Key reduction, as in the JAX module: the latent codes (shape 128 /
articulation 32 / appearance 128) are constant across a training batch (one
instance and articulation per step), so every place a latent enters a
concat-then-linear it folds into an EFFECTIVE BIAS::

    [x, s, a] @ W + b  ==  x @ W_x  +  (b + s @ W_s + a @ W_a)

``fold_latents`` does the folding in plain PyTorch (three small matvecs per
MLP); the kernels see a vanilla-shaped MLP plus a 4x128 deformation prefix
whose output offsets the coordinates BEFORE the in-kernel positional encoding,
and three more 128x128 view layers.  Latent gradients fall out of the
effective-bias gradients, ``d s = W_s @ d b_eff`` summed over the three fold
sites, in ``unfold_grads``.

Unlike the vanilla kernels, the backward here needs d(enc): the trunk input
depends on the deformation output, so the backward carries ``d_enc -> d_x'``
through the encoding (``posenc_vjp``) into the deformation MLP.

``art_mlp_fwd`` and ``art_mlp_bwd`` launch ``ops/csrc/art.cu`` (on
``ops/csrc/art_sm90.cuh``; its blobs and workspaces: ``ops/art_sm90.py``) on
CUDA tensors and run their plain twins (``*_plain``, the same roundings written out in
PyTorch) on CPU tensors.  ``fused_art_mlp_eval`` folds and runs the forward;
``fused_art_mlp_train`` joins forward and backward as a
``torch.autograd.Function`` whose gradients flow to the MLP's parameters and
to the latent codes.  This module owns the kernels' weight layout (``art_blobs``,
``grads_from_blob``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from aon_tpu_torch.ops import _build
from aon_tpu_torch.ops.fused_mlp import ENC_ORDER, POS_PAD, VIEW_PAD, make_posenc_constants
from aon_tpu_torch.ops.fused_mlp_train import (
    TWO_PI,
    _bf16_dot,
    _check_enc_consts,
    check_float32,
    encode_plain,
)
from aon_tpu_torch.ops.fused_mlp_train import grad_errors as _grad_errors

# ArticulatedNeRFMLP dims (models/articulated.py)
SHAPE_DIM = 128
DEF_WIDTH = 128
POS_DIM = 63
VIEW_DIM = 27
WIDTH = 256

EFF_ORDER = (
    # deformation prefix
    "wd0x", "bd0", "wd1", "bd1", "wd2", "bd2", "wd3", "bd3", "wdo", "bdo",
    # trunk (vanilla-shaped after folding)
    "w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4",
    "w5a", "w5b", "b5", "w6", "b6", "w7", "b7",
    "wb", "bb", "wdn", "bdn", "wva", "wvb", "bv",
    # view layers 1..3 and the rgb head
    "wv1", "bv1", "wv2", "bv2", "wv3", "bv3", "wrgb", "brgb",
)

EFF_SHAPES = {
    "wd0x": (4, DEF_WIDTH), "bd0": (1, DEF_WIDTH),
    **{f"wd{i}": (DEF_WIDTH, DEF_WIDTH) for i in (1, 2, 3)},
    **{f"bd{i}": (1, DEF_WIDTH) for i in (1, 2, 3)},
    "wdo": (DEF_WIDTH, 4), "bdo": (1, 4),
    "w0": (POS_PAD, WIDTH), "w5a": (WIDTH, WIDTH), "w5b": (POS_PAD, WIDTH),
    **{f"w{i}": (WIDTH, WIDTH) for i in (1, 2, 3, 4, 6, 7)},
    **{f"b{i}": (1, WIDTH) for i in range(8)},
    "wb": (WIDTH, WIDTH), "bb": (1, WIDTH), "wdn": (WIDTH, 1), "bdn": (1, 1),
    "wva": (WIDTH, 128), "wvb": (VIEW_PAD, 128), "bv": (1, 128),
    **{f"wv{i}": (128, 128) for i in (1, 2, 3)},
    **{f"bv{i}": (1, 128) for i in (1, 2, 3)},
    "wrgb": (128, 3), "brgb": (1, 3),
}

# Layout of the two blobs the CUDA kernels read, and of their gradient blob
# (ops/csrc/art.cu fixes the same order): the vanilla kernels' blob first
# (ops/fused_mlp.py, with the density head under its name here), then the
# deformation prefix and the extra view layers.
_KERNEL_WEIGHTS = (
    "w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7", "wb", "wva", "wvb", "wdn", "wrgb",
    "wd0x", "wd1", "wd2", "wd3", "wdo", "wv1", "wv2", "wv3",
)
_KERNEL_BIASES = (
    "b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "bb", "bv", "bdn", "brgb",
    "bd0", "bd1", "bd2", "bd3", "bdo", "bv1", "bv2", "bv3",
)
N_KERNEL_WEIGHTS = sum(EFF_SHAPES[k][0] * EFF_SHAPES[k][1] for k in _KERNEL_WEIGHTS)
N_KERNEL_BIASES = sum(EFF_SHAPES[k][1] for k in _KERNEL_BIASES)
assert (N_KERNEL_WEIGHTS, N_KERNEL_BIASES) == (693888, 3336)


# plain-twin rows per block of the eval forward: bounds its f32 temporaries
_PLAIN_BLOCK_ROWS = 1 << 20

# The forward kernel against its twin, on raw outputs (max and mean absolute
# error).  Both round the same bf16 operands, but the kernel sums in another
# order, so a few activations land on the other side of a bf16 rounding
# boundary.  Here that also happens in the deformation output, which the
# encoding multiplies by up to 2^9 before the sine: one bf16 step of a hidden
# unit of the last deformation layer moves x' by ~1e-5 and the top frequency's
# phase by ~5e-3 rad, so the raw outputs of single rows move more than the
# vanilla kernel's do.  Largest seen on an H100: PERF.md.
TWIN_TOL_MAX = 5e-2
TWIN_TOL_MEAN = 2e-4
# The gradients of the training kernels against their twins, outside the
# deformation per tensor, in the max and mean measures of
# ``fused_mlp_train.grad_errors``; the reasons are the vanilla kernels'
# (``fused_mlp_train.GRAD_TOL_REL``), with the phase noise above on top.  The
# mean limit is wider than theirs for the sake of the one-element tensor
# ``bdn``: its gradient is the sum of g_sigma over all rows, positive and
# negative terms that cancel, so its "mean" error is that of one cancelling
# sum (4.6e-2 at 37 rays x 65 samples on an H100, where no other tensor is
# past 3.6e-2; 2e-2 at the training shapes).
GRAD_TOL_REL = 1e-1
GRAD_TOL_MEAN_REL = 6e-2
# The deformation's gradients, ``DEFORM_GRADS``, by direction and size: each
# tensor's cosine with the twin's at least ``DEFORM_COS``, its norm within
# ``DEFORM_NORM`` of the twin's.  They all come back through the encoding's
# VJP, d_xp, which the phase noise moves row by row, and are sums over the
# rows that can cancel: on short intervals, where the deformation's
# activations vary little over the rows, they cancel with the sum of d_xp,
# and two correct implementations then disagree entry by entry by more than
# the measures above allow while they agree by direction: JAX's own Pallas
# level against the twin on the bench's AABB batch, ``bdo`` 0.066 max / 0.087
# mean, every deformation tensor's cosine above 0.99
# (tests/test_torch_art_kernels.py); this kernel against the twin on the
# card, PERF.md.  The JAX suite holds its own kernel's deformation gradients
# by direction for the same reason (tests/test_fused_art.py).  A tensor
# zeroed, negated or scaled by a third fails.
DEFORM_GRADS = ("wd0x", "bd0", "wd1", "bd1", "wd2", "bd2", "wd3", "bd3", "wdo", "bdo")
DEFORM_COS = 0.9
DEFORM_NORM = 0.25


def grad_errors(got: Mapping[str, torch.Tensor],
                want: Mapping[str, torch.Tensor]) -> Tuple[float, float]:
    """``(max_rel, mean_rel)`` of ``fused_mlp_train.grad_errors`` over every
    gradient tensor outside ``DEFORM_GRADS``."""
    rest = [k for k in want if k not in DEFORM_GRADS]
    return _grad_errors({k: got[k] for k in rest}, {k: want[k] for k in rest})


def deform_direction(got: Mapping[str, torch.Tensor],
                     want: Mapping[str, torch.Tensor]) -> Dict[str, Tuple[float, float]]:
    """Each ``DEFORM_GRADS`` tensor's ``(cosine, norm ratio)`` against the
    twin's (``(1, 1)`` where both are zero)."""
    out = {}
    for k in DEFORM_GRADS:
        a, b = got[k].reshape(-1).double(), want[k].reshape(-1).double()
        na, nb = a.norm().item(), b.norm().item()
        if na == 0.0 and nb == 0.0:
            out[k] = (1.0, 1.0)
        else:
            out[k] = ((a @ b).item() / max(na * nb, 1e-300), na / max(nb, 1e-300))
    return out


def grads_close(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor]) -> bool:
    """Whether the articulated kernels' gradients agree with their twin's:
    ``grad_errors`` within ``GRAD_TOL_REL`` / ``GRAD_TOL_MEAN_REL``, and every
    deformation gradient within ``DEFORM_COS`` / ``DEFORM_NORM``."""
    max_rel, mean_rel = grad_errors(got, want)
    return (max_rel <= GRAD_TOL_REL and mean_rel <= GRAD_TOL_MEAN_REL
            and all(cos >= DEFORM_COS and abs(ratio - 1.0) <= DEFORM_NORM
                    for cos, ratio in deform_direction(got, want).values()))


def _split_latents(latents: Mapping[str, torch.Tensor]):
    art_key = "articulation_deg" if "articulation_deg" in latents else "articulation"
    return (latents["density"].reshape(-1), latents["color"].reshape(-1),
            latents[art_key].reshape(-1), art_key)


def fold_latents(params: Mapping[str, torch.Tensor],
                 latents: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``ArticulatedNeRFMLP`` state dict + latent codes -> effective packed
    weights (float32; (in, out) matrices, biases as (1, C); ``EFF_SHAPES``).
    Differentiable, but the train path computes its own transpose
    (``unfold_grads``)."""
    s, app, art, _ = _split_latents(latents)

    def kernel(name: str) -> torch.Tensor:  # flax layout (in, out)
        return params[f"{name}.weight"].t()

    def bias(name: str) -> torch.Tensor:
        return params[f"{name}.bias"]

    def pad_k(w: torch.Tensor, k_pad: int) -> torch.Tensor:
        return F.pad(w, (0, 0, 0, k_pad - w.shape[0]))

    e = {}
    wd0 = kernel("deform_0")  # (3 + 128 + art, 128)
    e["wd0x"] = pad_k(wd0[:3], 4)
    e["bd0"] = bias("deform_0") + s @ wd0[3:3 + SHAPE_DIM] + art @ wd0[3 + SHAPE_DIM:]
    for i in (1, 2, 3):
        e[f"wd{i}"], e[f"bd{i}"] = kernel(f"deform_{i}"), bias(f"deform_{i}")
    e["wdo"] = F.pad(kernel("deform_out"), (0, 1))  # (128, 4)
    e["bdo"] = F.pad(bias("deform_out"), (0, 1))

    w0 = kernel("pts_0")  # (63 + 128, 256)
    e["w0"] = pad_k(w0[:POS_DIM], POS_PAD)
    e["b0"] = bias("pts_0") + s @ w0[POS_DIM:]
    for i in range(1, 8):
        w = kernel(f"pts_{i}")
        if i == 5:  # (256 + 63 + 128, 256)
            e["w5a"] = w[:WIDTH]
            e["w5b"] = pad_k(w[WIDTH:WIDTH + POS_DIM], POS_PAD)
            e["b5"] = bias("pts_5") + s @ w[WIDTH + POS_DIM:]
        else:
            e[f"w{i}"], e[f"b{i}"] = w, bias(f"pts_{i}")
    e["wb"], e["bb"] = kernel("bottleneck"), bias("bottleneck")
    e["wdn"], e["bdn"] = kernel("density"), bias("density")
    wv = kernel("views_0")  # (256 + 27 + 128, 128)
    e["wva"] = wv[:WIDTH]
    e["wvb"] = pad_k(wv[WIDTH:WIDTH + VIEW_DIM], VIEW_PAD)
    e["bv"] = bias("views_0") + app @ wv[WIDTH + VIEW_DIM:]
    for i in (1, 2, 3):
        e[f"wv{i}"], e[f"bv{i}"] = kernel(f"views_{i}"), bias(f"views_{i}")
    e["wrgb"], e["brgb"] = kernel("rgb"), bias("rgb")
    return {k: (v.reshape(1, -1) if k.startswith("b") else v).float() for k, v in e.items()}


def unfold_grads(d_eff: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
                 latents: Mapping[str, torch.Tensor]):
    """Effective-weight gradients -> ``(state-dict gradients, latent
    gradients)``: the transpose of ``fold_latents`` in closed form.  The
    zero-padded K rows and the zero fourth column of ``wdo`` / ``bdo`` carry no
    parameter and are dropped."""
    s, app, art, art_key = _split_latents(latents)

    def put(name: str, kernel: torch.Tensor, bias: torch.Tensor) -> None:
        dp[f"{name}.weight"] = kernel.t().contiguous()
        dp[f"{name}.bias"] = bias.reshape(-1)

    dp: Dict[str, torch.Tensor] = {}
    dbd0, db0, db5, dbv = d_eff["bd0"][0], d_eff["b0"][0], d_eff["b5"][0], d_eff["bv"][0]
    put("deform_0", torch.cat([d_eff["wd0x"][:3], torch.outer(s, dbd0), torch.outer(art, dbd0)]),
        dbd0)
    for i in (1, 2, 3):
        put(f"deform_{i}", d_eff[f"wd{i}"], d_eff[f"bd{i}"])
    put("deform_out", d_eff["wdo"][:, :3], d_eff["bdo"][0, :3])
    put("pts_0", torch.cat([d_eff["w0"][:POS_DIM], torch.outer(s, db0)]), db0)
    for i in range(1, 8):
        if i == 5:
            put("pts_5", torch.cat([d_eff["w5a"], d_eff["w5b"][:POS_DIM], torch.outer(s, db5)]),
                db5)
        else:
            put(f"pts_{i}", d_eff[f"w{i}"], d_eff[f"b{i}"])
    put("bottleneck", d_eff["wb"], d_eff["bb"])
    put("density", d_eff["wdn"], d_eff["bdn"])
    put("views_0", torch.cat([d_eff["wva"], d_eff["wvb"][:VIEW_DIM], torch.outer(app, dbv)]), dbv)
    for i in (1, 2, 3):
        put(f"views_{i}", d_eff[f"wv{i}"], d_eff[f"bv{i}"])
    put("rgb", d_eff["wrgb"], d_eff["brgb"])

    wd0 = params["deform_0.weight"].t()
    w0, w5, wv = (params[f"{n}.weight"].t() for n in ("pts_0", "pts_5", "views_0"))
    d_lat = {
        "density": (wd0[3:3 + SHAPE_DIM] @ dbd0 + w0[POS_DIM:] @ db0
                    + w5[WIDTH + POS_DIM:] @ db5).reshape(latents["density"].shape),
        "color": (wv[WIDTH + VIEW_DIM:] @ dbv).reshape(latents["color"].shape),
        art_key: (wd0[3 + SHAPE_DIM:] @ dbd0).reshape(latents[art_key].shape),
    }
    for k in latents:  # zero gradients for latent keys this variant does not read
        if k not in d_lat:
            d_lat[k] = torch.zeros_like(latents[k])
    return dp, d_lat


# ------------------------------------------------------------ plain twins


def art_forward(xyz: torch.Tensor, vdir: torch.Tensor, e: Mapping[str, torch.Tensor],
                enc_consts: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The kernels' forward in PyTorch (``_art_forward``), returning every
    tensor the backward needs: xyz (N, 3) raw coords, vdir (N, 3) per-row
    viewdirs, ``e`` float32 effective weights.  Every product rounds both
    operands to bf16 and sums in float32, activations are stored as bf16, x'
    = xyz + delta stays float32 (``xp``), rgb and sigma are float32."""
    bf = torch.bfloat16

    def layer(h, w, b):
        return torch.clamp_min(_bf16_dot(h, e[w]) + e[b], 0.0).to(bf)

    acts = {}
    # K = 3: the padded fourth row of wd0x multiplies a zero coordinate
    h = torch.clamp_min(_bf16_dot(xyz, e["wd0x"][:3]) + e["bd0"], 0.0).to(bf)
    acts["hd0"] = h
    for i in (1, 2, 3):
        h = layer(h, f"wd{i}", f"bd{i}")
        acts[f"hd{i}"] = h
    delta = _bf16_dot(h, e["wdo"][:, :3]) + e["bdo"][:, :3]
    xp = xyz.float() + delta
    acts["xp"] = xp
    enc = encode_plain(xp, enc_consts["s_pos"], enc_consts["p_pos"]).to(bf)
    venc = encode_plain(vdir, enc_consts["s_view"], enc_consts["p_view"]).to(bf)
    acts["enc"], acts["venc"] = enc, venc

    a = layer(enc, "w0", "b0")
    acts["a0"] = a
    for i in (1, 2, 3, 4):
        a = layer(a, f"w{i}", f"b{i}")
        acts[f"a{i}"] = a
    a = torch.clamp_min(_bf16_dot(a, e["w5a"]) + _bf16_dot(enc, e["w5b"]) + e["b5"], 0.0).to(bf)
    acts["a5"] = a
    for i in (6, 7):
        a = layer(a, f"w{i}", f"b{i}")
        acts[f"a{i}"] = a
    acts["sigma"] = _bf16_dot(a, e["wdn"]) + e["bdn"]
    acts["bottleneck"] = (_bf16_dot(a, e["wb"]) + e["bb"]).to(bf)
    v = torch.clamp_min(
        _bf16_dot(acts["bottleneck"], e["wva"]) + _bf16_dot(venc, e["wvb"]) + e["bv"], 0.0).to(bf)
    acts["v0"] = v
    for i in (1, 2, 3):
        v = layer(v, f"wv{i}", f"bv{i}")
        acts[f"v{i}"] = v
    acts["rgb"] = _bf16_dot(v, e["wrgb"]) + e["brgb"]
    return acts


def posenc_vjp(d_enc: torch.Tensor, xp: torch.Tensor, s_pos: torch.Tensor,
               p_pos: torch.Tensor) -> torch.Tensor:
    """VJP of the in-kernel positional encoding at ``xp``: d_enc (N, 64) ->
    d_xp (N, 3).  Identity columns pass through, the rest multiply by the
    cosine of the forward's reduced argument; ``d_pre`` is rounded to bf16 for
    the product with ``s`` (powers of two, exact in bf16)."""
    pre = xp[:, 0:1] * s_pos[0:1] + xp[:, 1:2] * s_pos[1:2] + xp[:, 2:3] * s_pos[2:3] + p_pos
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=xp.device)
    k = torch.floor(pre / two_pi + 0.5)
    reduced = (pre.double() - two_pi.double() * k.double()).float()  # one rounding, as the forward
    col = torch.arange(pre.shape[1], device=xp.device)
    d_pre = torch.where(col < 3, d_enc, d_enc * torch.cos(reduced))
    return _bf16_dot(d_pre, s_pos[:3].t())


def art_bwd_from_acts(xyz, g_rgb, g_sigma, acts, e, enc_consts) -> Dict[str, torch.Tensor]:
    """The 42 effective gradients from live activations
    (``_art_bwd_from_acts``), written out layer by layer so the roundings are
    the kernels': every product rounds both operands to bf16, the float32
    gradients included; relu masks come from the bf16 activations; bias
    gradients are float32 column sums.  The padding of ``wd0x`` (row 3) and of
    ``wdo`` / ``bdo`` (column 3) comes back zero."""

    def dot_tn(a, b):  # a^T @ b
        return _bf16_dot(a.t(), b)

    def dot_nt(a, b):  # a @ b^T
        return _bf16_dot(a, b.t())

    def bias_grad(g):
        return g.sum(dim=0, keepdim=True)

    def relu_mask(a):
        return (a.float() > 0).float()

    ge = {"wrgb": dot_tn(acts["v3"], g_rgb), "brgb": bias_grad(g_rgb)}
    dv = dot_nt(g_rgb, e["wrgb"]) * relu_mask(acts["v3"])
    for i in (3, 2, 1):
        ge[f"wv{i}"], ge[f"bv{i}"] = dot_tn(acts[f"v{i - 1}"], dv), bias_grad(dv)
        dv = dot_nt(dv, e[f"wv{i}"]) * relu_mask(acts[f"v{i - 1}"])
    ge["wva"], ge["wvb"] = dot_tn(acts["bottleneck"], dv), dot_tn(acts["venc"], dv)
    ge["bv"] = bias_grad(dv)
    dbott = dot_nt(dv, e["wva"])

    ge["wb"], ge["bb"] = dot_tn(acts["a7"], dbott), bias_grad(dbott)
    ge["wdn"], ge["bdn"] = dot_tn(acts["a7"], g_sigma), bias_grad(g_sigma)
    da = (dot_nt(dbott, e["wb"]) + dot_nt(g_sigma, e["wdn"])) * relu_mask(acts["a7"])

    ge["w7"], ge["b7"] = dot_tn(acts["a6"], da), bias_grad(da)
    da = dot_nt(da, e["w7"]) * relu_mask(acts["a6"])
    ge["w6"], ge["b6"] = dot_tn(acts["a5"], da), bias_grad(da)
    da = dot_nt(da, e["w6"]) * relu_mask(acts["a5"])
    ge["w5a"], ge["w5b"] = dot_tn(acts["a4"], da), dot_tn(acts["enc"], da)
    ge["b5"] = bias_grad(da)
    d_enc = dot_nt(da, e["w5b"])  # the skip path's share
    da = dot_nt(da, e["w5a"]) * relu_mask(acts["a4"])
    for i in (4, 3, 2, 1):
        ge[f"w{i}"], ge[f"b{i}"] = dot_tn(acts[f"a{i - 1}"], da), bias_grad(da)
        da = dot_nt(da, e[f"w{i}"]) * relu_mask(acts[f"a{i - 1}"])
    ge["w0"], ge["b0"] = dot_tn(acts["enc"], da), bias_grad(da)
    d_enc = d_enc + dot_nt(da, e["w0"])

    # through the positional encoding into the deformation output
    d_xp = posenc_vjp(d_enc, acts["xp"], enc_consts["s_pos"], enc_consts["p_pos"])  # (N, 3)
    ge["wdo"] = F.pad(dot_tn(acts["hd3"], d_xp), (0, 1))
    ge["bdo"] = F.pad(bias_grad(d_xp), (0, 1))
    dh = dot_nt(d_xp, e["wdo"][:, :3]) * relu_mask(acts["hd3"])
    for i in (3, 2, 1):
        ge[f"wd{i}"], ge[f"bd{i}"] = dot_tn(acts[f"hd{i - 1}"], dh), bias_grad(dh)
        dh = dot_nt(dh, e[f"wd{i}"]) * relu_mask(acts[f"hd{i - 1}"])
    ge["wd0x"] = F.pad(dot_tn(xyz, dh), (0, 0, 0, 1))
    ge["bd0"] = bias_grad(dh)
    return ge


def _require_float32_reference(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain MLP is a float32 reference: set allow_tf32 = False")


def art_mlp_fwd_plain(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``art_mlp_fwd``, on any device."""
    _require_float32_reference(samples)
    B, S, _ = samples.shape
    x = samples.reshape(B * S, 3)
    vd = torch.repeat_interleave(viewdirs, S, dim=0)
    rgb = torch.empty(B * S, 3, dtype=torch.float32, device=samples.device)
    sigma = torch.empty(B * S, 1, dtype=torch.float32, device=samples.device)
    for i in range(0, B * S, _PLAIN_BLOCK_ROWS):
        j = min(i + _PLAIN_BLOCK_ROWS, B * S)
        acts = art_forward(x[i:j], vd[i:j], packed, enc_consts)
        rgb[i:j], sigma[i:j] = acts["rgb"], acts["sigma"]
    return rgb.reshape(B, S, 3), sigma.reshape(B, S, 1)


def art_mlp_bwd_plain(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    g: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch twin of ``art_mlp_bwd``, on any device."""
    _require_float32_reference(samples)
    B, S, _ = samples.shape
    x = samples.reshape(B * S, 3)
    acts = art_forward(x, torch.repeat_interleave(viewdirs, S, dim=0), packed, enc_consts)
    g = g.reshape(B * S, 4).float()
    return art_bwd_from_acts(x, g[:, :3], g[:, 3:4], acts, packed, enc_consts)


# ---------------------------------------------------------- kernel wrappers


def art_blobs(packed: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 effective weights as the two flat blobs the CUDA kernels read,
    after checking every shape: the matrices rounded to bf16 (the rounding
    every product of the kernels applies to them), the biases float32."""
    for k, shape in EFF_SHAPES.items():
        v = packed[k]
        if tuple(v.shape) != shape or v.dtype != torch.float32:
            raise ValueError(
                f"packed[{k!r}] is {tuple(v.shape)} {v.dtype}, the kernel takes {shape} float32")
    wblob = torch.cat([packed[k].reshape(-1) for k in _KERNEL_WEIGHTS]).to(torch.bfloat16)
    bblob = torch.cat([packed[k].reshape(-1) for k in _KERNEL_BIASES])
    return wblob, bblob


def grads_from_blob(blob: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The training kernels' float32 gradient blob (weights in the order of the
    weight blob, then the biases) as views in the ``EFF_SHAPES`` layout."""
    out, offset = {}, 0
    for k in _KERNEL_WEIGHTS + _KERNEL_BIASES:
        rows, cols = EFF_SHAPES[k]
        out[k] = blob[offset:offset + rows * cols].view(rows, cols)
        offset += rows * cols
    return out


def train_workspaces(n_rows: int, device: torch.device):
    """Scratch of one launch of a training kernel (``ops/csrc/art_sm90.cuh``):
    the blocked bf16 activation and gradient workspaces, the relu-mask bytes
    and the float32 x' (rows padded to whole 128-row tiles), and the float32
    raw outputs: ``art_sm90.workspaces``."""
    from aon_tpu_torch.ops import art_sm90  # it reads this module's layout

    return art_sm90.workspaces(n_rows, device)



def art_mlp_fwd(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (B, S, 3) samples + per-ray (B, 3) viewdirs -> (raw_rgb (B, S, 3),
    raw_sigma (B, S, 1)) float32 through the articulated MLP with the
    effective weights ``packed`` (``fold_latents``).  CUDA tensors launch the
    kernel; CPU tensors run the plain twin.  A caller that already holds
    ``art_blobs(packed)`` passes them as ``blobs``."""
    if samples.device.type == "cpu":
        return art_mlp_fwd_plain(packed, enc_consts, samples, viewdirs)
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    device = samples.device
    B, S, _ = samples.shape
    check_float32(device, samples=(samples, (B, S, 3)), viewdirs=(viewdirs, (B, 3)))
    _check_enc_consts(enc_consts, device)
    from aon_tpu_torch.ops import art_sm90

    blobs = blobs if blobs is not None else art_blobs(packed)
    wblob, bblob, grid = art_sm90.eval_inputs(blobs, B * S, device)
    raw_rgb = torch.empty(B, S, 3, dtype=torch.float32, device=device)
    raw_sigma = torch.empty(B, S, 1, dtype=torch.float32, device=device)
    err = _build.library("art").aon_art_fwd_launch(
        samples.data_ptr(), viewdirs.data_ptr(), *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        wblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        B * S, S, grid, torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "art_mlp_fwd")
    art_mlp_fwd.launches += 1
    return raw_rgb, raw_sigma


art_mlp_fwd.launches = 0


def art_mlp_bwd(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    g: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The 42 effective gradients of the articulated MLP for the cotangent
    ``g`` (B, S, 4) = ``cat(g_rgb, g_sigma)``: the forward is recomputed from
    raw (B, S, 3) samples and per-ray (B, 3) viewdirs, nothing is kept from
    the forward call.  Returns float32 gradients in the ``EFF_SHAPES`` layout.
    CUDA tensors launch the kernel; CPU tensors run the plain twin."""
    if samples.device.type == "cpu":
        return art_mlp_bwd_plain(packed, enc_consts, samples, viewdirs, g)
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    device = samples.device
    B, S, _ = samples.shape
    check_float32(device, samples=(samples, (B, S, 3)), viewdirs=(viewdirs, (B, 3)),
                  g=(g, (B, S, 4)))
    _check_enc_consts(enc_consts, device)
    from aon_tpu_torch.ops import art_sm90

    tblob, bblob, items, n_items, grid = art_sm90.train_inputs(
        blobs if blobs is not None else art_blobs(packed), B * S, device)
    act, grad, mask, xp, raw_rgb, raw_sigma = train_workspaces(B * S, device)
    # zeroed on the launch's stream: the kernels add into it
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES, dtype=torch.float32, device=device)
    err = _build.library("art").aon_art_bwd_launch(
        samples.data_ptr(), viewdirs.data_ptr(), g.data_ptr(),
        *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        tblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        act.data_ptr(), xp.data_ptr(), grad.data_ptr(), mask.data_ptr(), gw.data_ptr(),
        items.data_ptr(), n_items, B * S, S, grid, torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "art_mlp_bwd")
    art_mlp_bwd.launches += 1
    return grads_from_blob(gw)


art_mlp_bwd.launches = 0


def _enc_consts_for(enc_consts, device):
    return enc_consts if enc_consts is not None else make_posenc_constants(device=device)


@torch.no_grad()
def fused_art_mlp_eval(
    mlp_params: Mapping[str, torch.Tensor],
    latents: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    enc_consts: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-only fused articulated MLP: ``ArticulatedNeRFMLP`` state dict +
    latent codes + raw (B, S, 3) samples + (B, 3) viewdirs -> (raw_rgb,
    raw_sigma)."""
    enc_consts = _enc_consts_for(enc_consts, samples.device)
    return art_mlp_fwd(fold_latents(mlp_params, latents), enc_consts, samples.contiguous(),
                       viewdirs.contiguous())


class _FusedArtMLPTrain(torch.autograd.Function):
    """Forward through ``art_mlp_fwd``, backward through ``art_mlp_bwd`` and
    ``unfold_grads``; the MLP's parameters and the latent codes arrive as
    names + ``*values`` and are the only inputs that receive a gradient."""

    @staticmethod
    def forward(ctx, enc_consts, samples, viewdirs, names, lat_names, *values):
        params = dict(zip(names, values[:len(names)]))
        latents = dict(zip(lat_names, values[len(names):]))
        # folded and rounded once per step: both launches read the same blobs
        packed = fold_latents(params, latents)
        blobs = art_blobs(packed) if samples.is_cuda else None
        ctx.meta = (names, lat_names, enc_consts, packed, blobs)
        ctx.save_for_backward(samples, viewdirs, *values)
        return art_mlp_fwd(packed, enc_consts, samples, viewdirs, blobs=blobs)

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        names, lat_names, enc_consts, packed, blobs = ctx.meta
        samples, viewdirs, *values = ctx.saved_tensors
        params = dict(zip(names, values[:len(names)]))
        latents = dict(zip(lat_names, values[len(names):]))
        g = torch.cat([g_rgb, g_sigma], dim=-1).float().contiguous()
        d_eff = art_mlp_bwd(packed, enc_consts, samples, viewdirs, g, blobs=blobs)
        dp, d_lat = unfold_grads(d_eff, params, latents)
        return (None, None, None, None, None, *(dp[n] for n in names),
                *(d_lat[n] for n in lat_names))


def fused_art_mlp_train(
    mlp_params: Mapping[str, torch.Tensor],
    latents: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    enc_consts: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused articulated MLP of the two-kernel training route.

    ``mlp_params``: the ``ArticulatedNeRFMLP`` state dict; ``latents``:
    density / color / articulation (or articulation_deg) codes, (1, C) or
    (C,).  ``samples`` (B, S, 3) raw coords; ``viewdirs`` (B, 3).  Returns
    ``(raw_rgb (B, S, 3), raw_sigma (B, S, 1))``; gradients flow to
    ``mlp_params`` and ``latents``, ``samples`` and ``viewdirs`` get none."""
    enc_consts = _enc_consts_for(enc_consts, samples.device)
    names, lat_names = tuple(sorted(mlp_params)), tuple(sorted(latents))
    return _FusedArtMLPTrain.apply(
        enc_consts, samples.detach().contiguous(), viewdirs.detach().contiguous(), names, lat_names,
        *(mlp_params[n] for n in names), *(latents[n] for n in lat_names))
