"""Host side of the articulated kernels for Hopper (``ops/csrc/art_sm90.cuh``,
run by ``ops/csrc/art.cu``): the eval and training blobs they read, the
workspaces' chunk and mask layouts, and the weight gradients' work list.

The blobs are gathers of the row-major kernel blob (``fused_art.art_blobs``),
whose head is the vanilla kernel blob:

* the eval blob is the vanilla eval blob (``fused_mlp.eval_blobs``), then
  wd1..wd3 and wv1..wv3 as wgmma reads them (128 rows of K = 128 in two
  64-wide slabs, the 16-byte group g of row n holding K-columns
  8 * (g ^ (n % 8)) .. + 7), then wd0x (4 x 128) and wdo (128 x 4)
  row-major;
* the training blob is the eval blob, the vanilla backward blob
  (``train_sm90``), then W^T of wv3, wv2, wv1, w0, w5b, wd3, wd2, wd1 (each
  as its inputs' rows, zero-padded to 128, of its outputs' K, in 64-wide
  slabs), in the order the backward reads them.

The workspaces are the vanilla ones (``train_sm90.to_blocked``) with columns
appended: 54 activation chunks a 64-row block (hd0..hd3 and v1..v3 after the
vanilla 40) and 50 gradient chunks (dv1..dv3 and dh1..dh3 after the vanilla
38), beside the vanilla relu-mask bytes of a0..a7 (the backward takes the
128-wide layers' masks from their stored values) and x' as float32 (n_pad,
4).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from aon_tpu_torch.ops import fused_art as fa
from aon_tpu_torch.ops import train_sm90 as ts
from aon_tpu_torch.ops.fused_mlp import N_EVAL_WEIGHTS, sm_count
from aon_tpu_torch.ops.fused_mlp import _eval_blob_index as _vanilla_eval_index
from aon_tpu_torch.ops.fused_mlp import N_KERNEL_WEIGHTS as N_VANILLA_WEIGHTS

DEF = 128  # width of the deformation MLP and of the view branch
K_CHUNK = ts.K_CHUNK

# the slabs the eval blob appends, in the order the forward reads them
# (deformation first, view branch last), and the backward's W^T
EVAL_SLABS = ("wd1", "wd2", "wd3", "wv1", "wv2", "wv3")
EVAL_HEADS = ("wd0x", "wdo")
BWD_SLABS = ("wv3", "wv2", "wv1", "w0", "w5b", "wd3", "wd2", "wd1")
N_ART_EVAL_WEIGHTS = N_EVAL_WEIGHTS + len(EVAL_SLABS) * DEF * DEF + 2 * 4 * DEF  # 697,984
N_ART_TRAIN_WEIGHTS = N_ART_EVAL_WEIGHTS + ts.N_BWD_WEIGHTS + 6 * DEF * DEF + 2 * DEF * 256
assert N_ART_TRAIN_WEIGHTS == 1418880

# workspaces (ops/csrc/art_sm90.cuh)
ACT_C_HD0 = ts.ACT_CHUNKS        # hd_l at ACT_C_HD0 + 2 l, l = 0..3
ACT_C_V1 = ACT_C_HD0 + 8         # v_l at ACT_C_V1 + 2 (l - 1), l = 1..3
ACT_CHUNKS = ACT_C_V1 + 6        # 54
GR_C_V1 = ts.GRAD_CHUNKS         # dv_l at GR_C_V1 + 2 (l - 1)
GR_C_DH1 = GR_C_V1 + 6           # dh_l at GR_C_DH1 + 2 (l - 1)
GRAD_CHUNKS = GR_C_DH1 + 6       # 50


def kernel_offsets():
    """Offset of each matrix in the articulated kernel blob (and gradient blob)."""
    offsets, o = {}, 0
    for k in fa._KERNEL_WEIGHTS:
        offsets[k] = o
        o += fa.EFF_SHAPES[k][0] * fa.EFF_SHAPES[k][1]
    return offsets


def _k_major(offset: int, k: int, n: int, n_pad: int, k_of_row) -> np.ndarray:
    """Indices of a matrix cut into 64-wide K-major slabs of ``n_pad`` rows
    with the 128-byte swizzle; ``k_of_row(n, k)`` is the matrix entry of row
    n and K-column k, or -1 past the rows."""
    s, row, g, e = np.meshgrid(np.arange(-(-k // K_CHUNK)), np.arange(n_pad), np.arange(8),
                               np.arange(8), indexing="ij")
    col = K_CHUNK * s + 8 * (g ^ (row % 8)) + e
    idx = np.where(row < n, k_of_row(row, col), -1)
    return np.where(idx >= 0, offset + idx, fa.N_KERNEL_WEIGHTS).reshape(-1)


@functools.lru_cache(maxsize=None)
def _eval_blob_index() -> np.ndarray:
    """For each entry of the eval blob, its index in the kernel blob, or
    ``N_KERNEL_WEIGHTS`` for a zero of the padding."""
    off = kernel_offsets()
    head = _vanilla_eval_index()
    parts = [np.where(head == N_VANILLA_WEIGHTS, fa.N_KERNEL_WEIGHTS, head)]
    for name in EVAL_SLABS:  # (K, N) = (in, out): N rows of K
        k_in, n_out = fa.EFF_SHAPES[name]
        parts.append(_k_major(off[name], k_in, n_out, n_out, lambda n, k: k * n_out + n))
    for name in EVAL_HEADS:
        parts.append(off[name] + np.arange(fa.EFF_SHAPES[name][0] * fa.EFF_SHAPES[name][1]))
    index = np.concatenate(parts)
    assert index.size == N_ART_EVAL_WEIGHTS
    return index


@functools.lru_cache(maxsize=None)
def _train_blob_index() -> np.ndarray:
    """For each entry of the training blob, its index in the kernel blob."""
    off = kernel_offsets()
    parts = [_eval_blob_index(), ts._bwd_blob_index()]
    for name in BWD_SLABS:  # W^T: the inputs' rows (padded to 128) of the outputs' K
        n_in, n_out = fa.EFF_SHAPES[name]
        parts.append(_k_major(off[name], n_out, n_in, DEF, lambda n, k: n * n_out + k))
    index = np.concatenate(parts)
    assert index.size == N_ART_TRAIN_WEIGHTS
    return index


@functools.lru_cache(maxsize=None)
def _index_on(which: str, device: torch.device) -> torch.Tensor:
    index = _eval_blob_index() if which == "eval" else _train_blob_index()
    return torch.from_numpy(index).to(device)


def _gather(wblob: torch.Tensor, which: str) -> torch.Tensor:
    return torch.nn.functional.pad(wblob, (0, 1))[_index_on(which, wblob.device)]


def eval_blob(wblob: torch.Tensor) -> torch.Tensor:
    """The eval kernel's weight blob from the kernel blob's bf16 weights."""
    return _gather(wblob, "eval")


def train_blob(wblob: torch.Tensor) -> torch.Tensor:
    """The training kernels' weight blob from the kernel blob's bf16 weights."""
    return _gather(wblob, "train")


def wgrad_units():
    """The weight gradients' output tiles (``train_sm90.wgrad_units``'s
    fields): the vanilla 21 over the workspaces' common head, then wd1..wd3
    (X = hd0..hd2, D = dh1..dh3) and wv1..wv3 (X = v0..v2, D = dv1..dv3),
    128 x 128 each."""
    off = kernel_offsets()
    units = list(ts.wgrad_units())
    for i in (1, 2, 3):
        units.append((ACT_C_HD0 + 2 * (i - 1), DEF, GR_C_DH1 + 2 * (i - 1), DEF, off[f"wd{i}"],
                      DEF))
        x_chunk = ts.ACT_V // K_CHUNK if i == 1 else ACT_C_V1 + 2 * (i - 2)
        units.append((x_chunk, DEF, GR_C_V1 + 2 * (i - 1), DEF, off[f"wv{i}"], DEF))
    return units


def wgrad_items(n_pad: int, sm_count: int) -> np.ndarray:
    """``train_sm90.wgrad_items`` over the 27 output tiles of ``wgrad_units``."""
    return ts.wgrad_items(n_pad, sm_count, wgrad_units())


@functools.lru_cache(maxsize=64)
def _items_on(n_pad: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(wgrad_items(n_pad, sm_count(device))).to(device)


def workspaces(n_rows: int, device: torch.device):
    """Scratch of one training launch: the blocked bf16 act and grad
    workspaces, the relu-mask bytes and x' (rows padded to whole 128-row
    tiles), and the float32 raw outputs; ``torch.empty``, so the caching
    allocator hands the same blocks back every step."""
    n_pad = ts.padded_rows(n_rows)
    blocks = n_pad // ts.BLOCK_ROWS
    act = torch.empty(blocks, ACT_CHUNKS, ts.BLOCK_ROWS, K_CHUNK, dtype=torch.bfloat16,
                      device=device)
    grad = torch.empty(blocks, GRAD_CHUNKS, ts.BLOCK_ROWS, K_CHUNK, dtype=torch.bfloat16,
                       device=device)
    mask = torch.empty(n_pad, ts.MASK_BYTES, dtype=torch.uint8, device=device)
    xp = torch.empty(n_pad, 4, dtype=torch.float32, device=device)
    raw_rgb = torch.empty(n_rows, 3, dtype=torch.float32, device=device)
    raw_sigma = torch.empty(n_rows, 1, dtype=torch.float32, device=device)
    return act, grad, mask, xp, raw_rgb, raw_sigma


def _check_blobs(blobs, device: torch.device, what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    wblob, bblob = blobs
    for name, t, n, dtype in (("weights", wblob, fa.N_KERNEL_WEIGHTS, torch.bfloat16),
                              ("biases", bblob, fa.N_KERNEL_BIASES, torch.float32)):
        if t.device != device or t.dtype != dtype or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"the articulated {what}'s {name} must be a contiguous {dtype} blob "
                             f"of {n} on {device} (fused_art.art_blobs)")
    return wblob, bblob


def eval_inputs(blobs, n_rows: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """What an eval launch reads besides its data, from the kernel blobs
    (``fused_art.art_blobs``): the eval blob, the bias blob and the grid.
    Raises unless the blobs are the kernel blobs' sizes and types on
    ``device``."""
    wblob, bblob = _check_blobs(blobs, device, "eval kernel")
    return eval_blob(wblob), bblob, ts.launch_grid(n_rows, device)


def train_inputs(blobs, n_rows: int, device: torch.device):
    """What a training launch reads besides its data: the training blob, the
    bias blob, the weight gradients' work list and its length, and the grid."""
    wblob, bblob = _check_blobs(blobs, device, "training kernels")
    items = _items_on(ts.padded_rows(n_rows), device)
    return train_blob(wblob), bblob, items, items.shape[0], ts.launch_grid(n_rows, device)
