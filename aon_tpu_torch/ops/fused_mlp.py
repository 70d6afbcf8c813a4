"""Packing of the vanilla NeRF MLP for the fused kernels (port of the packing
in ``aon_tpu/ops/fused_mlp.py`` and ``aon_tpu/ops/fused_mlp_train.py``).

The skip concat is algebraized: layer 5's (319, 256) kernel splits into a
(256, 256) part on the activation and a (64, 256) zero-padded part on the
encoded input, and the view layer's input splits the same way, so no kernel
concatenates.  Encoded-input K dims are zero-padded 63 -> 64 and 27 -> 32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aon_tpu_torch.utils.device import DeviceLike, resolve_device

POS_PAD = 64  # (2*10 + 1) * 3 = 63 encoded channels, zero-padded
VIEW_PAD = 32  # (2*4 + 1) * 3 = 27
WIDTH = 256
COND_WIDTH = 128

WEIGHT_ORDER = (
    "w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4",
    "w5a", "w5b", "b5", "w6", "b6", "w7", "b7",
    "wb", "bb", "wd", "bd", "wva", "wvb", "bv", "wrgb", "brgb",
)
ENC_ORDER = ("s_pos", "p_pos", "s_view", "p_view")

# Layout of the two blobs the CUDA kernel reads (ops/csrc/fused_mlp_eval.cu
# fixes the same order): bf16 (in, out) matrices, then f32 biases.
_KERNEL_WEIGHTS = (
    "w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7", "wb", "wva", "wvb", "wd", "wrgb",
)
_KERNEL_BIASES = ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "bb", "bv", "bd", "brgb")
PACKED_SHAPES = {
    "w0": (POS_PAD, WIDTH),
    **{f"w{i}": (WIDTH, WIDTH) for i in (1, 2, 3, 4, 6, 7)},
    "w5a": (WIDTH, WIDTH), "w5b": (POS_PAD, WIDTH), "wb": (WIDTH, WIDTH), "wd": (WIDTH, 1),
    "wva": (WIDTH, COND_WIDTH), "wvb": (VIEW_PAD, COND_WIDTH), "wrgb": (COND_WIDTH, 3),
    **{f"b{i}": (WIDTH,) for i in range(8)},
    "bb": (WIDTH,), "bd": (1,), "bv": (COND_WIDTH,), "brgb": (3,),
}
# (rows, cols) of every float32-packed tensor and of every gradient the training
# kernels return, biases as (1, C) (``_SHAPES`` of the JAX package)
SHAPES = {k: (v if len(v) == 2 else (1, v[0])) for k, v in PACKED_SHAPES.items()}
N_KERNEL_WEIGHTS = sum(PACKED_SHAPES[k][0] * PACKED_SHAPES[k][1] for k in _KERNEL_WEIGHTS)
N_KERNEL_BIASES = sum(PACKED_SHAPES[k][0] for k in _KERNEL_BIASES)


def pack_vanilla_mlp_params(
    params: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16
) -> Dict[str, torch.Tensor]:
    """Pack a ``NeRFMLP`` state dict (``pts_0.weight`` ...) for the kernel.

    Returns the JAX package's packed names with (in, out) matrices in
    ``dtype`` and float32 biases.
    """

    def kernel(name: str) -> torch.Tensor:  # flax layout (in, out)
        return params[f"{name}.weight"].t()

    def bias(name: str) -> torch.Tensor:
        return params[f"{name}.bias"].float().contiguous()

    def pad_k(w: torch.Tensor, k_pad: int) -> torch.Tensor:
        return F.pad(w, (0, 0, 0, k_pad - w.shape[0]))

    out = {"w0": pad_k(kernel("pts_0"), POS_PAD), "b0": bias("pts_0")}
    for i in range(1, 8):
        if i == 5:  # (256 + 63, 256) -> split
            w = kernel("pts_5")
            out["w5a"] = w[:WIDTH]
            out["w5b"] = pad_k(w[WIDTH:], POS_PAD)
        else:
            out[f"w{i}"] = kernel(f"pts_{i}")
        out[f"b{i}"] = bias(f"pts_{i}")
    out["wb"], out["bb"] = kernel("bottleneck"), bias("bottleneck")
    out["wd"], out["bd"] = kernel("density"), bias("density")
    wv = kernel("views_0")
    out["wva"] = wv[:WIDTH]
    out["wvb"] = pad_k(wv[WIDTH:], VIEW_PAD)
    out["bv"] = bias("views_0")
    out["wrgb"], out["brgb"] = kernel("rgb"), bias("rgb")
    return {
        k: (v.to(dtype).contiguous() if k.startswith("w") else v) for k, v in out.items()
    }


def pack_vanilla_mlp_params_f32(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """float32 packing of the training path: float32 (in, out) matrices and
    (1, C) biases, the layout of the kernels' gradients (``SHAPES``)."""
    packed = pack_vanilla_mlp_params(params, dtype=torch.float32)
    return {k: v.reshape(1, -1) if v.ndim == 1 else v for k, v in packed.items()}


def unpack_vanilla_mlp_grads(
    d: Mapping[str, torch.Tensor], pos_dim: int = 63, view_dim: int = 27
) -> Dict[str, torch.Tensor]:
    """Packed-layout gradients -> the ``NeRFMLP`` state-dict layout
    (``pts_0.weight`` (out, in), ``pts_0.bias`` ...).

    Inverse of the pad and split of ``pack_vanilla_mlp_params``: the
    zero-padded K rows carry zero gradient, so slicing them off is exact.
    """
    kernels = {
        "pts_0": d["w0"][:pos_dim],
        "bottleneck": d["wb"],
        "density": d["wd"],
        "views_0": torch.cat([d["wva"], d["wvb"][:view_dim]], dim=0),
        "rgb": d["wrgb"],
    }
    biases = {"pts_0": d["b0"], "bottleneck": d["bb"], "density": d["bd"], "views_0": d["bv"],
              "rgb": d["brgb"]}
    for i in range(1, 8):
        kernels[f"pts_{i}"] = (torch.cat([d["w5a"], d["w5b"][:pos_dim]], dim=0) if i == 5
                               else d[f"w{i}"])
        biases[f"pts_{i}"] = d[f"b{i}"]
    out = {}
    for name, kernel in kernels.items():
        out[f"{name}.weight"] = kernel.t().contiguous()
        out[f"{name}.bias"] = biases[name].reshape(-1)
    return out


def make_posenc_constants(
    max_deg: int = 10, view_deg: int = 4, device: DeviceLike = "cuda"
) -> Dict[str, torch.Tensor]:
    """Constants of the in-kernel positional encoding from raw coords.

    ``pre = x @ S + P; enc = where(col < 3, pre, sin(pre))`` with S (4, width)
    scattering ``x_c * 2^d`` into the frequency-major layout of
    ``core.sampling.pos_enc`` and P (1, width) holding the pi/2 phase of the
    cos block.
    """

    def build(deg: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
        s = np.zeros((4, width), np.float32)
        p = np.zeros((1, width), np.float32)
        for c in range(3):
            s[c, c] = 1.0
        for d in range(deg):
            for c in range(3):
                s[c, 3 + d * 3 + c] = 2.0**d
                s[c, 3 + 3 * deg + d * 3 + c] = 2.0**d
                p[0, 3 + 3 * deg + d * 3 + c] = 0.5 * np.pi
        return s, p

    device = resolve_device(device)
    s_pos, p_pos = build(max_deg, POS_PAD)
    s_view, p_view = build(view_deg, VIEW_PAD)
    arrays = {"s_pos": s_pos, "p_pos": p_pos, "s_view": s_view, "p_view": p_view}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


class EncConstsCache:
    """``make_posenc_constants`` of one (max_deg, view_deg), made once per device."""

    def __init__(self, max_deg: int = 10, view_deg: int = 4):
        self._degs, self._by_device = (max_deg, view_deg), {}

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._by_device:
            self._by_device[device] = make_posenc_constants(*self._degs, device=device)
        return self._by_device[device]


def kernel_blobs(packed: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed bf16 weights and f32 biases as the two flat blobs the CUDA
    kernel reads, after checking every shape and dtype."""
    for k, shape in PACKED_SHAPES.items():
        v = packed[k]
        want = torch.bfloat16 if k.startswith("w") else torch.float32
        if tuple(v.shape) != shape or v.dtype != want:
            raise ValueError(
                f"packed[{k!r}] is {tuple(v.shape)} {v.dtype}, the kernel takes {shape} {want}")
    wblob = torch.cat([packed[k].reshape(-1) for k in _KERNEL_WEIGHTS])
    bblob = torch.cat([packed[k].reshape(-1) for k in _KERNEL_BIASES])
    return wblob, bblob


def round_packed(packed: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """float32-packed training weights in the eval kernel's packing: matrices
    rounded to bf16, biases flat float32.

    The rounding is what every product of the training kernels does with the
    matrices (and what the TPU's matrix unit does with float32 operands at
    default precision)."""
    return {k: (v.to(torch.bfloat16) if k.startswith("w") else v.reshape(-1))
            for k, v in packed.items()}


def train_blobs(packed: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two blobs of ``kernel_blobs`` from float32-packed training weights,
    rounded once (``round_packed``)."""
    return kernel_blobs(round_packed(packed))


def grads_from_blob(blob: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The training kernels' float32 gradient blob (weights in the order of
    the weight blob, then the biases) as views in the ``SHAPES`` layout."""
    out, offset = {}, 0
    for k in _KERNEL_WEIGHTS + _KERNEL_BIASES:
        rows, cols = SHAPES[k]
        out[k] = blob[offset:offset + rows * cols].view(rows, cols)
        offset += rows * cols
    return out
