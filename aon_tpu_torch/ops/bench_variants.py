"""The kernel bench's variants of the fused NeRF MLP forward (port of the two
kernels that ``scripts/bench_kernels.py`` builds itself).

Kernel table row 12, the inner ``kernel`` of ``_make_fwd``: the function of
row 5 (pre-encoded (n, 64) and (n, 32) inputs) with one of three bodies,
``BODIES``:

  * ``base``: ``_mlp_body`` of the JAX package (row 5's kernel instance);
  * ``2s``: ``_mlp_body_2s``, the tile's two halves as two independent
    streams through the layer chain: per row the same arithmetic as ``base``;
  * ``bf16acc``: ``_mlp_body_bf16acc``, every trunk and view product rounded
    to bf16 as it leaves its accumulator, bf16 biases, bf16 sums and relu;
    the density head and the bottleneck in float32.

Kernel table row 13, the inner ``kernel`` of ``bench_xyz_body``: raw xyz and
viewdir per sample, encoded in the kernel by one of three encoders,
``ENCODERS`` (``elementwise``: ``_encode_in_kernel``; ``mxu``:
``_encode_mxu``; ``doubling``: ``_encode_doubling``), then ``_mlp_body``.

Each variant has its own entry, ``mlp_body_<body>`` and ``xyz_body_<encoder>``
(by name in ``MLP_BODY`` and ``XYZ_BODY``), with its own launch count
``.launches``.  On CUDA tensors an entry launches its kernel
(``ops/csrc/fused_mlp_eval.cu``: ``aon_mlp_body_launch``,
``aon_mlp_xyz_body_launch``) on the bf16-rounded weights (``blobs``: the
eval kernel's, ``fused_mlp.launch_blobs``); on CPU tensors it
runs the plain twin, ``mlp_body_plain`` or ``xyz_body_plain``, in the
packing's dtype.  ``encode_plain`` is the plain twin of the three encoders.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from aon_tpu_torch.ops import _build
from aon_tpu_torch.ops.fused_mlp import (
    ENC_ORDER,
    ENCODERS,
    POS_PAD,
    TWO_PI,
    VIEW_PAD,
    _check_enc_consts,
    _checked_blobs,
    _kernel_device,
    _mlp_compute,
    _mlp_rows,
    _outputs,
    _require_float32_reference,
    check_float32,
    eval_grid,
    pad_features,
)
from aon_tpu_torch.ops.fused_mlp import encode_plain as _encode_elementwise

BODIES = ("base", "2s", "bf16acc")

# 1 / (2 * 3.14159265358979) in float32: the reciprocal both bench encoders
# multiply by (`_encode_mxu`, `_encode_doubling`)
INV_TWO_PI = float(np.float32(1.0 / TWO_PI))

# --------------------------------------------------------------- plain twins


def _round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bf16, kept in float32."""
    return x.to(torch.bfloat16).float()


def _bf16acc_compute(enc: torch.Tensor, venc: torch.Tensor, w: Mapping[str, torch.Tensor]):
    """``_mlp_body_bf16acc``: each trunk and view product rounded to bf16 from
    its float32 sum, biases rounded to bf16, every add and the relu in bf16
    (rounded after each op); the density head and the bottleneck in float32."""

    def dot(a, b):
        return a.float() @ b.float()

    def dotb(a, b):
        return _round(dot(a, b))

    def layer(pre, bias):
        return torch.clamp_min(_round(pre + _round(bias)), 0.0)

    h = layer(dotb(enc, w["w0"]), w["b0"])
    for i in (1, 2, 3, 4):
        h = layer(dotb(h, w[f"w{i}"]), w[f"b{i}"])
    h = layer(_round(dotb(h, w["w5a"]) + dotb(enc, w["w5b"])), w["b5"])
    for i in (6, 7):
        h = layer(dotb(h, w[f"w{i}"]), w[f"b{i}"])
    sigma = dot(h, w["wd"]) + w["bd"]
    bottleneck = _round(dot(h, w["wb"]) + w["bb"])
    v = layer(_round(dotb(bottleneck, w["wva"]) + dotb(venc, w["wvb"])), w["bv"])
    rgb = dot(v, w["wrgb"]) + w["brgb"]
    return rgb, sigma


# the bodies' arithmetic per row: the two-stream body splits the tile, not
# the function
_BODY_COMPUTE: Dict[str, Callable] = {"base": _mlp_compute, "2s": _mlp_compute,
                                      "bf16acc": _bf16acc_compute}


def mlp_body_plain(enc: torch.Tensor, venc: torch.Tensor, w: Mapping[str, torch.Tensor],
                   body: str = "base") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of row 12: encodings (n, 63|64) and (n, 27|32) in
    float32, cast to the packing's dtype as ``_make_fwd``'s kernel does, through
    ``body`` -> (raw_rgb (n, 3), raw_sigma (n, 1)) float32."""
    _require_float32_reference(enc)
    dtype = w["w0"].dtype
    enc, venc = pad_features(enc, venc)
    return _mlp_rows(w, enc.shape[0], enc.device,
                     lambda i, j: (enc[i:j].to(dtype), venc[i:j].to(dtype)),
                     compute=_BODY_COMPUTE[body])


def _reduced(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x - 2pi * k with one rounding, as the kernel's fused multiply-add: the
    float64 product and difference are exact."""
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=x.device).double()
    return (x.double() - two_pi * k.double()).float()


def _encode_mxu(x: torch.Tensor, s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    # pre = x4 @ s + p is exact in float32 (one power of two per column of s)
    # and equal to the elementwise encoder's; the reduction multiplies by the
    # float32 reciprocal of 2pi
    pre = x[:, 0:1] * s[0:1] + x[:, 1:2] * s[1:2] + x[:, 2:3] * s[2:3] + p
    k = torch.floor(pre * torch.tensor(INV_TWO_PI, device=x.device) + 0.5)
    col = torch.arange(pre.shape[1], device=x.device)
    return torch.where(col < 3, pre, torch.sin(_reduced(pre, k)))


def _encode_doubling(x: torch.Tensor, width: int) -> torch.Tensor:
    deg = (width // 3 - 1) // 2  # 64 -> 10, 32 -> 4
    k = torch.floor(x * torch.tensor(INV_TWO_PI, device=x.device) + 0.5)
    r = _reduced(x, k)
    sn, cs = torch.sin(r), torch.cos(r)
    col = torch.arange(width, device=x.device)
    # identity and padding columns: the raw coordinate of their column
    out = x[:, torch.where(col < 3, col, (col - 3) % 3)].clone()
    for d in range(deg):
        out[:, 3 + 3 * d:6 + 3 * d] = sn
        out[:, 3 + 3 * deg + 3 * d:6 + 3 * deg + 3 * d] = cs
        two_s = 2.0 * sn
        sn, cs = two_s * cs, 1.0 - two_s * sn
    return out


def encode_plain(x: torch.Tensor, s: torch.Tensor, p: torch.Tensor,
                 encoder: str = "elementwise") -> torch.Tensor:
    """The in-kernel encoders in PyTorch: x (N, 3) float32 -> (N, width) float32.

    ``elementwise`` is ``fused_mlp.encode_plain`` (``_encode_in_kernel``).
    ``mxu`` (``_encode_mxu``) reduces with ``pre * (1/2pi)`` instead of
    ``pre / 2pi``.  ``doubling`` (``_encode_doubling``) takes the sine and
    cosine of each reduced coordinate once and doubles the angle with
    ``s' = 2sc``, ``c' = 1 - 2s^2`` (each product rounded), reads only the
    width of ``s``, and leaves the raw coordinate in the padding columns, as
    the JAX encoder does.  Every subtraction of 2pi k is rounded once, as the
    kernel's fused multiply-add.
    """
    if encoder == "elementwise":
        return _encode_elementwise(x, s, p)
    if encoder == "mxu":
        return _encode_mxu(x, s, p)
    if encoder == "doubling":
        return _encode_doubling(x, s.shape[1])
    raise ValueError(f"encoder must be one of {ENCODERS}, not {encoder!r}")


def xyz_body_plain(packed: Mapping[str, torch.Tensor], enc_consts: Mapping[str, torch.Tensor],
                   xyz: torch.Tensor, vdir: torch.Tensor, encoder: str = "elementwise"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of row 13: per-sample xyz (n, 3) and viewdirs (n, 3)
    encoded in float32 by ``encoder``, cast to the packing's dtype, then
    ``_mlp_body`` -> (raw_rgb (n, 3), raw_sigma (n, 1)) float32."""
    _require_float32_reference(xyz)
    dtype = packed["w0"].dtype
    return _mlp_rows(packed, xyz.shape[0], xyz.device, lambda i, j: (
        encode_plain(xyz[i:j], enc_consts["s_pos"], enc_consts["p_pos"], encoder).to(dtype),
        encode_plain(vdir[i:j], enc_consts["s_view"], enc_consts["p_view"], encoder).to(dtype)))


# ------------------------------------------------------------ kernel entries


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _body_entry(body: str) -> Callable:
    index = BODIES.index(body)

    def entry(packed: Mapping[str, torch.Tensor], enc: torch.Tensor, venc: torch.Tensor,
              blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        device = _kernel_device(enc)
        if device is None:
            return mlp_body_plain(enc, venc, packed, body)
        n = enc.shape[0]
        enc, venc = (t.float().contiguous() for t in pad_features(enc, venc))
        check_float32(device, enc=(enc, (n, POS_PAD)), venc=(venc, (n, VIEW_PAD)))
        wblob, bblob = _checked_blobs(packed, blobs, device)
        raw_rgb, raw_sigma = _outputs(n, device)
        err = _build.library("fused_mlp_eval").aon_mlp_body_launch(
            enc.data_ptr(), venc.data_ptr(), wblob.data_ptr(), bblob.data_ptr(),
            raw_rgb.data_ptr(), raw_sigma.data_ptr(), n, index, eval_grid(n, device),
            _stream(device))
        _build.check(err, entry.__name__)
        entry.launches += 1
        return raw_rgb, raw_sigma

    entry.__name__ = entry.__qualname__ = f"mlp_body_{body}"
    entry.__doc__ = (f"Row 12 with the ``{body}`` body: encodings (n, 63|64) and (n, 27|32) "
                     "-> (raw_rgb (n, 3), raw_sigma (n, 1)) float32 (``mlp_body_plain`` on "
                     "CPU tensors).")
    entry.launches = 0
    return entry


def _xyz_entry(encoder: str) -> Callable:
    index = ENCODERS.index(encoder)

    def entry(packed: Mapping[str, torch.Tensor], enc_consts: Mapping[str, torch.Tensor],
              xyz: torch.Tensor, vdir: torch.Tensor,
              blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        device = _kernel_device(xyz)
        if device is None:
            return xyz_body_plain(packed, enc_consts, xyz, vdir, encoder)
        n = xyz.shape[0]
        check_float32(device, xyz=(xyz, (n, 3)), vdir=(vdir, (n, 3)))
        _check_enc_consts(enc_consts, device)
        wblob, bblob = _checked_blobs(packed, blobs, device)
        raw_rgb, raw_sigma = _outputs(n, device)
        err = _build.library("fused_mlp_eval").aon_mlp_xyz_body_launch(
            xyz.data_ptr(), vdir.data_ptr(), *(enc_consts[k].data_ptr() for k in ENC_ORDER),
            wblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(), n,
            index, eval_grid(n, device), _stream(device))
        _build.check(err, entry.__name__)
        entry.launches += 1
        return raw_rgb, raw_sigma

    entry.__name__ = entry.__qualname__ = f"xyz_body_{encoder}"
    entry.__doc__ = (f"Row 13 with the ``{encoder}`` encoder: xyz (n, 3) and viewdirs (n, 3) "
                     "per sample -> (raw_rgb (n, 3), raw_sigma (n, 1)) float32 "
                     "(``xyz_body_plain`` on CPU tensors).")
    entry.launches = 0
    return entry


mlp_body_base, mlp_body_2s, mlp_body_bf16acc = (_body_entry(b) for b in BODIES)
xyz_body_elementwise, xyz_body_mxu, xyz_body_doubling = (_xyz_entry(e) for e in ENCODERS)
MLP_BODY = dict(zip(BODIES, (mlp_body_base, mlp_body_2s, mlp_body_bf16acc)))
XYZ_BODY = dict(zip(ENCODERS, (xyz_body_elementwise, xyz_body_mxu, xyz_body_doubling)))
