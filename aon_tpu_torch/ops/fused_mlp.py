"""The fused vanilla NeRF MLP's eval entry points and its packing (port of
``aon_tpu/ops/fused_mlp.py`` and of the packing in
``aon_tpu/ops/fused_mlp_train.py``).

Three entry points run one trunk and differ in how they take their input:

  * ``fused_nerf_mlp``: per-sample encodings (N, 63|64) and (N, 27|32);
  * ``fused_nerf_mlp_per_ray``: per-sample position encodings (B, S, 63|64)
    and per-ray view encodings (B, 27|32);
  * ``fused_nerf_mlp_xyz``: raw (B, S, 3) samples and per-ray (B, 3)
    viewdirs, both encoded in the kernel.

Each launches its CUDA kernel (``ops/csrc/fused_mlp_eval.cu`` on the trunk
of ``ops/csrc/trunk_sm90.cuh``) on CUDA tensors and runs its plain PyTorch
twin (``*_plain``) on CPU tensors.  The
twins take the packing's dtype as their compute dtype, as the JAX kernels
do: float32 packing computes in float32, bf16 packing rounds operands and
activations to bf16.  The CUDA kernels take bf16 weights only: float32-packed
weights are rounded to bf16 once (``round_packed``) before the launch, which
is what the TPU's matrix unit does with float32 operands.

The skip concat is algebraized: layer 5's (319, 256) kernel splits into a
(256, 256) part on the activation and a (64, 256) zero-padded part on the
encoded input, and the view layer's input splits the same way, so no kernel
concatenates.  Encoded-input K dims are zero-padded 63 -> 64 and 27 -> 32.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aon_tpu_torch.ops import _build
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
# the in-kernel encoders, in the order of the CUDA launchers' encoder argument
# (ops/csrc/fused_mlp_eval.cu): `_encode_in_kernel` and the kernel bench's
# `_encode_mxu` and `_encode_doubling` (scripts/bench_kernels.py)
ENCODERS = ("elementwise", "mxu", "doubling")

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
# Multiply-adds per sample of the MLP forward at the function's own widths (63
# position and 27 view channels): 63x256 + 7x256x256 (w1-w4, w5a, w6, w7) +
# 63x256 (w5b) + 256x256 (bottleneck) + 256 (density) + 283x128 (view) +
# 128x3.  The kernels' zero padding of K to 64 and 32 (N_KERNEL_WEIGHTS,
# 594,560) is their own overhead, not the work's.  Bounds and TFLOP/s of the
# vanilla MLP kernels count this.
MLP_MACS_PER_SAMPLE = 593408


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
    """The packed bf16 weights and f32 biases as the two flat blobs the
    training kernels read (and the eval kernel's ``eval_blobs`` gather),
    after checking every shape and dtype."""
    for k, shape in PACKED_SHAPES.items():
        v = packed[k]
        want = torch.bfloat16 if k.startswith("w") else torch.float32
        if tuple(v.shape) != shape or v.dtype != want:
            raise ValueError(
                f"packed[{k!r}] is {tuple(v.shape)} {v.dtype}, the kernel takes {shape} {want}")
    wblob = torch.cat([packed[k].reshape(-1) for k in _KERNEL_WEIGHTS])
    bblob = torch.cat([packed[k].reshape(-1) for k in _KERNEL_BIASES])
    return wblob, bblob


# The eval kernel's weight blob (ops/csrc/trunk_sm90.cuh): every matrix of
# the trunk and the view layer as wgmma reads it from shared memory, then the
# two heads as in the kernel blob.  A (K, N) matrix becomes N rows of its K
# zero-padded to a multiple of 64, cut into slabs of 64 K-columns (128 bytes
# a row); in a slab, the 16-byte group g of row n holds K-columns
# 8 * (g ^ (n % 8)) .. + 7 (the 128-byte swizzle).  Slabs follow the order the
# layers read them.
_EVAL_SLABS = ("w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7", "wb", "wva", "wvb")
_EVAL_HEADS = ("wd", "wrgb")
EVAL_K_CHUNK = 64
EVAL_SLAB_BYTES = 2 * sum(-(-PACKED_SHAPES[k][0] // EVAL_K_CHUNK) * EVAL_K_CHUNK
                          * PACKED_SHAPES[k][1] for k in _EVAL_SLABS)  # 1,196,032
N_EVAL_WEIGHTS = EVAL_SLAB_BYTES // 2 + sum(
    PACKED_SHAPES[k][0] * PACKED_SHAPES[k][1] for k in _EVAL_HEADS)  # 598,656
# The eval kernel's launch: persistent blocks, at most one per SM, over tiles
# of this many sample rows; no thread-block clusters (each block streams the
# weights from L2 itself).
EVAL_TILE_ROWS = 128
EVAL_CLUSTER = 1


@functools.lru_cache(maxsize=None)
def _eval_blob_index() -> np.ndarray:
    """For each entry of the eval weight blob, its index in the kernel blob
    (``kernel_blobs``), or ``N_KERNEL_WEIGHTS`` for a zero of the padding."""
    offsets, o = {}, 0
    for k in _KERNEL_WEIGHTS:
        offsets[k] = o
        o += PACKED_SHAPES[k][0] * PACKED_SHAPES[k][1]
    parts = []
    for name in _EVAL_SLABS:
        K, N = PACKED_SHAPES[name]
        s, n, g, e = np.meshgrid(np.arange(-(-K // EVAL_K_CHUNK)), np.arange(N), np.arange(8),
                                 np.arange(8), indexing="ij")
        k = EVAL_K_CHUNK * s + 8 * (g ^ (n % 8)) + e  # the K-column stored there
        parts.append(np.where(k < K, offsets[name] + k * N + n, N_KERNEL_WEIGHTS).reshape(-1))
    for name in _EVAL_HEADS:
        parts.append(offsets[name] + np.arange(PACKED_SHAPES[name][0] * PACKED_SHAPES[name][1]))
    index = np.concatenate(parts)
    assert index.size == N_EVAL_WEIGHTS
    return index


@functools.lru_cache(maxsize=None)
def _eval_index(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_eval_blob_index()).to(device)


def eval_blobs(blobs: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval kernel's two blobs from ``kernel_blobs``: the weights gathered
    into the eval layout (``_eval_blob_index``), the biases as they are."""
    wblob, bblob = blobs
    return torch.cat([wblob, wblob.new_zeros(1)])[_eval_index(wblob.device)], bblob


def eval_launch_shape(n_rows: int, sm_count: int) -> Tuple[int, int]:
    """``(tiles, grid)`` of the eval kernel for ``n_rows``: 128-row tiles, the
    last one ragged, and one persistent block per SM, never more blocks than
    tiles; block b takes tiles b, b + grid, ..."""
    tiles = -(-n_rows // EVAL_TILE_ROWS)
    return tiles, min(tiles, sm_count)


def eval_l2_weight_bytes(n_rows: int, sm_count: int) -> int:
    """Bytes of weights the eval kernel streams from L2 into shared memory for
    ``n_rows``: every slab once per tile (once per cluster of tiles, were the
    blocks clustered), and the heads once per block."""
    tiles, grid = eval_launch_shape(n_rows, sm_count)
    heads = 2 * (N_EVAL_WEIGHTS - EVAL_SLAB_BYTES // 2)
    return -(-tiles // EVAL_CLUSTER) * EVAL_SLAB_BYTES + grid * heads


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def eval_grid(n_rows: int, device: torch.device) -> int:
    return eval_launch_shape(n_rows, sm_count(device))[1]


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


# --------------------------------------------------------------- plain math

# 2 * 3.14159265358979, the TPU kernel's constant (float32 once in a tensor)
TWO_PI = 6.28318530717958

# plain-twin rows per block: bounds the f32 activations to ~1 GB at width 256
_PLAIN_BLOCK_ROWS = 1 << 20


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


def _require_float32_reference(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain MLP is a float32 reference: set allow_tf32 = False")


def _mlp_rows(packed: Mapping[str, torch.Tensor], n: int, device: torch.device, stage,
              compute=_mlp_compute):
    """``compute`` (``_mlp_compute`` unless a variant body is given) over n
    rows in blocks; ``stage(i, j)`` gives the encodings of rows i..j in the
    packing's dtype."""
    rgb = torch.empty(n, 3, dtype=torch.float32, device=device)
    sigma = torch.empty(n, 1, dtype=torch.float32, device=device)
    for i in range(0, n, _PLAIN_BLOCK_ROWS):
        j = min(i + _PLAIN_BLOCK_ROWS, n)
        rgb[i:j], sigma[i:j] = compute(*stage(i, j), packed)
    return rgb, sigma


def pad_features(enc: torch.Tensor, venc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encodings zero-padded on their last dim to 64 and 32 (``_pad_features``);
    the given tensors where they are that wide already."""

    def pad(t, width):
        return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))

    return pad(enc, POS_PAD), pad(venc, VIEW_PAD)


def fused_nerf_mlp_plain(packed, samples_enc, viewdirs_enc):
    """Plain PyTorch twin of ``fused_nerf_mlp`` (``_kernel``), on any device."""
    _require_float32_reference(samples_enc)
    dtype = packed["w0"].dtype
    enc, venc = pad_features(samples_enc, viewdirs_enc)
    return _mlp_rows(packed, enc.shape[0], enc.device,
                     lambda i, j: (enc[i:j].to(dtype), venc[i:j].to(dtype)))


def fused_nerf_mlp_per_ray_plain(packed, samples_enc, viewdirs_enc):
    """Plain PyTorch twin of ``fused_nerf_mlp_per_ray`` (``_kernel_per_ray``):
    the view encoding is rounded to the compute dtype per ray, then repeated
    over the ray's samples, as the selection product does."""
    _require_float32_reference(samples_enc)
    B, S, _ = samples_enc.shape
    dtype = packed["w0"].dtype
    enc, venc = pad_features(samples_enc.reshape(B * S, -1), viewdirs_enc)
    venc = torch.repeat_interleave(venc.to(dtype), S, dim=0)
    rgb, sigma = _mlp_rows(packed, B * S, enc.device,
                           lambda i, j: (enc[i:j].to(dtype), venc[i:j]))
    return rgb.reshape(B, S, 3), sigma.reshape(B, S, 1)


def fused_nerf_mlp_xyz_plain(packed, enc_consts, samples, viewdirs):
    """Plain PyTorch twin of ``fused_nerf_mlp_xyz`` (``_kernel_xyz_per_ray``)
    and of ``fused_nerf_mlp_xyz_eval``: the viewdir is repeated per sample in
    float32, both encodings are computed in float32 and cast to the compute
    dtype."""
    _require_float32_reference(samples)
    B, S, _ = samples.shape
    dtype = packed["w0"].dtype
    x = samples.reshape(B * S, 3)
    vd = torch.repeat_interleave(viewdirs, S, dim=0)
    rgb, sigma = _mlp_rows(packed, B * S, samples.device, lambda i, j: (
        encode_plain(x[i:j], enc_consts["s_pos"], enc_consts["p_pos"]).to(dtype),
        encode_plain(vd[i:j], enc_consts["s_view"], enc_consts["p_view"]).to(dtype)))
    return rgb.reshape(B, S, 3), sigma.reshape(B, S, 1)


# ------------------------------------------------------------ kernel entries


def check_float32(device: torch.device, **tensors) -> None:
    """Raise unless every ``name=(tensor, shape)`` is contiguous float32 of
    that shape on ``device``: what the kernels take."""
    for name, (t, shape) in tensors.items():
        if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name} must be contiguous float32 {tuple(shape)} on {device}")


def _check_enc_consts(enc_consts: Mapping[str, torch.Tensor], device: torch.device) -> None:
    for k, shape in zip(ENC_ORDER, ((4, POS_PAD), (1, POS_PAD), (4, VIEW_PAD), (1, VIEW_PAD))):
        v = enc_consts[k]
        if (tuple(v.shape) != shape or v.dtype != torch.float32 or not v.is_contiguous()
                or v.device != device):
            raise ValueError(f"enc_consts[{k!r}] must be contiguous float32 {shape} on {device}")


def _kernel_device(t: torch.Tensor) -> Optional[torch.device]:
    """None for a CPU tensor (the caller runs the twin), the device for a CUDA
    tensor; raises for any other."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return t.device


def launch_blobs(packed: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval kernel's two blobs (``eval_blobs``) from bf16- or
    float32-packed weights (the latter rounded to bf16 once)."""
    if packed["w0"].dtype != torch.bfloat16:
        packed = round_packed(packed)
    return eval_blobs(kernel_blobs(packed))


def _checked_blobs(packed, blobs, device: torch.device):
    """The eval blobs given (``launch_blobs``) or made from ``packed``;
    raises unless they are on ``device``, of the eval layout's size and type
    and 16-byte aligned (the kernel copies the weights in 16-byte units)."""
    wblob, bblob = blobs if blobs is not None else launch_blobs(packed)
    for name, t, n, dtype in (("weights", wblob, N_EVAL_WEIGHTS, torch.bfloat16),
                              ("biases", bblob, N_KERNEL_BIASES, torch.float32)):
        if (t.device != device or t.dtype != dtype or t.numel() != n or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"the eval kernel's {name} must be a contiguous, 16-byte aligned "
                             f"{dtype} blob of {n} on {device} (launch_blobs)")
    return wblob, bblob


def _outputs(n: int, device: torch.device):
    return (torch.empty(n, 3, dtype=torch.float32, device=device),
            torch.empty(n, 1, dtype=torch.float32, device=device))


def fused_nerf_mlp(
    packed: Mapping[str, torch.Tensor],
    samples_enc: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample encodings (N, 63|64) and (N, 27|32) -> (raw_rgb (N, 3),
    raw_sigma (N, 1)) float32, any N.

    ``packed`` comes from ``pack_vanilla_mlp_params`` (bf16 or float32) or
    ``pack_vanilla_mlp_params_f32``.  CUDA tensors launch the kernel (kernel
    table row 5) on the bf16-rounded weights; CPU tensors run the plain twin
    in the packing's dtype.  A caller that already holds the kernel's blobs
    (``launch_blobs``) passes them as ``blobs``."""
    device = _kernel_device(samples_enc)
    if device is None:
        return fused_nerf_mlp_plain(packed, samples_enc, viewdirs_enc)
    n = samples_enc.shape[0]
    enc, venc = (t.float().contiguous() for t in pad_features(samples_enc, viewdirs_enc))
    check_float32(device, samples_enc=(enc, (n, POS_PAD)), viewdirs_enc=(venc, (n, VIEW_PAD)))
    wblob, bblob = _checked_blobs(packed, blobs, device)
    raw_rgb, raw_sigma = _outputs(n, device)
    err = _build.library("fused_mlp_eval").aon_mlp_enc_launch(
        enc.data_ptr(), venc.data_ptr(), wblob.data_ptr(), bblob.data_ptr(),
        raw_rgb.data_ptr(), raw_sigma.data_ptr(), n, eval_grid(n, device),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "fused_nerf_mlp")
    fused_nerf_mlp.launches += 1
    return raw_rgb, raw_sigma


fused_nerf_mlp.launches = 0


def fused_nerf_mlp_per_ray(
    packed: Mapping[str, torch.Tensor],
    samples_enc: torch.Tensor,
    viewdirs_enc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample position encodings (B, S, 63|64) and per-ray view encodings
    (B, 27|32) -> (raw_rgb (B, S, 3), raw_sigma (B, S, 1)) float32, any B and
    S.  The view encoding is read once per ray.  CUDA tensors launch the
    kernel (kernel table row 7) on the bf16-rounded weights; CPU tensors run
    the plain twin in the packing's dtype."""
    device = _kernel_device(samples_enc)
    if device is None:
        return fused_nerf_mlp_per_ray_plain(packed, samples_enc, viewdirs_enc)
    B, S, _ = samples_enc.shape
    enc, venc = (t.float().contiguous() for t in pad_features(samples_enc, viewdirs_enc))
    check_float32(device, samples_enc=(enc, (B, S, POS_PAD)), viewdirs_enc=(venc, (B, VIEW_PAD)))
    wblob, bblob = _checked_blobs(packed, None, device)
    raw_rgb, raw_sigma = _outputs(B * S, device)
    err = _build.library("fused_mlp_eval").aon_mlp_enc_per_ray_launch(
        enc.data_ptr(), venc.data_ptr(), wblob.data_ptr(), bblob.data_ptr(),
        raw_rgb.data_ptr(), raw_sigma.data_ptr(), B * S, S, eval_grid(B * S, device),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "fused_nerf_mlp_per_ray")
    fused_nerf_mlp_per_ray.launches += 1
    return raw_rgb.reshape(B, S, 3), raw_sigma.reshape(B, S, 1)


fused_nerf_mlp_per_ray.launches = 0


def xyz_launch(entry: str, what: str, device: torch.device, packed, enc_consts, samples, viewdirs,
               blobs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs of a raw-coordinate entry point and launch its kernel
    through the library's ``entry``: kernel table rows 1 and 8 run the same
    kernel through entries of their own, so each counts its launches."""
    B, S, _ = samples.shape
    check_float32(device, samples=(samples, (B, S, 3)), viewdirs=(viewdirs, (B, 3)))
    _check_enc_consts(enc_consts, device)
    wblob, bblob = _checked_blobs(packed, blobs, device)
    raw_rgb, raw_sigma = _outputs(B * S, device)
    err = getattr(_build.library("fused_mlp_eval"), entry)(
        samples.data_ptr(), viewdirs.data_ptr(), *(enc_consts[k].data_ptr() for k in ENC_ORDER),
        wblob.data_ptr(), bblob.data_ptr(), raw_rgb.data_ptr(), raw_sigma.data_ptr(),
        B * S, S, eval_grid(B * S, device), torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, what)
    return raw_rgb.reshape(B, S, 3), raw_sigma.reshape(B, S, 1)


def fused_nerf_mlp_xyz(
    packed: Mapping[str, torch.Tensor],
    enc_consts: Mapping[str, torch.Tensor],
    samples: torch.Tensor,
    viewdirs: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (B, S, 3) samples + per-ray (B, 3) viewdirs -> (raw_rgb (B, S, 3),
    raw_sigma (B, S, 1)) float32, encodings computed in the kernel, any B and
    S.  ``enc_consts`` comes from ``make_posenc_constants``.  CUDA tensors
    launch the kernel (kernel table row 8) on the bf16-rounded weights; CPU
    tensors run the plain twin in the packing's dtype.  A caller that already
    holds the kernel's blobs (``launch_blobs``) passes them as ``blobs``."""
    device = _kernel_device(samples)
    if device is None:
        return fused_nerf_mlp_xyz_plain(packed, enc_consts, samples, viewdirs)
    out = xyz_launch("aon_mlp_xyz_per_ray_launch", "fused_nerf_mlp_xyz", device, packed,
                     enc_consts, samples, viewdirs, blobs)
    fused_nerf_mlp_xyz.launches += 1
    return out


fused_nerf_mlp_xyz.launches = 0
