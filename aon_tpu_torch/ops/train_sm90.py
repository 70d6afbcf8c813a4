"""Host side of the vanilla training kernels for Hopper
(``ops/csrc/train_sm90.cuh``, run by ``ops/csrc/level_train.cu``): the
training blob they read, the workspaces' column layouts, the weight
gradients' work list, and the weight-gradient kernel alone with its plain
twin (the check of the wgmma layouts it reads).

The activation and gradient workspaces are blocked: each 64 sample rows are
a run of chunks of 64 columns, a chunk 64 rows of 128 bytes with the same
128-byte swizzle (the image of the kernels' shared-memory tiles), so tiles
go out and come in as single bulk copies.  ``to_blocked`` and
``from_blocked`` convert between that and the plain (rows, columns) matrix
whose columns are ``ACT_*`` / ``GR_*`` below.

The training blob is the eval blob (``fused_mlp.eval_blobs``) followed by the
backward blob: W^T of wva, wb, w7, w6, w5a, w4, w3, w2 and w1, in the order the
backward's chain reads them, each as 256 rows (the layer's inputs) of its K'
(the layer's outputs) cut into slabs of 64 K'-columns, 128 bytes a row, the
16-byte group g of row n holding K'-columns 8 * (g ^ (n % 8)) .. + 7 (the
128-byte swizzle of the eval blob).  Both are one gather of the kernel blob
(``fused_mlp.kernel_blobs``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from aon_tpu_torch.ops import _build
from aon_tpu_torch.ops.fused_mlp import (
    _KERNEL_WEIGHTS,
    N_EVAL_WEIGHTS,
    N_KERNEL_BIASES,
    N_KERNEL_WEIGHTS,
    PACKED_SHAPES,
    POS_PAD,
    VIEW_PAD,
    WIDTH,
    _eval_blob_index,
    _kernel_device,
    sm_count,
)

COND = 128
K_CHUNK = 64
TILE_ROWS = 128  # sample rows per tile of the forward and the backward
BLOCK_ROWS = 64  # sample rows per workspace block (and ring stage of the weight gradients)

# the backward blob: the matrices whose transposes the chain multiplies by
BWD_SLABS = ("wva", "wb", "w7", "w6", "w5a", "w4", "w3", "w2", "w1")
N_BWD_WEIGHTS = sum(PACKED_SHAPES[k][0] * PACKED_SHAPES[k][1] for k in BWD_SLABS)  # 557,056
N_TRAIN_WEIGHTS = N_EVAL_WEIGHTS + N_BWD_WEIGHTS  # 1,155,712

# columns of the activation workspace (mlp_common.cuh ACT_*): [enc | a0..a7 |
# bottleneck | v | venc]
ACT_ENC = 0
ACT_A0 = POS_PAD
ACT_BOTT = ACT_A0 + 8 * WIDTH
ACT_V = ACT_BOTT + WIDTH
ACT_VENC = ACT_V + COND
ACT_COLS = ACT_VENC + VIEW_PAD  # 2,528
ACT_CHUNKS = -(-ACT_COLS // K_CHUNK)  # 40: venc's 32 columns in a chunk of its own
# columns of the gradient workspace (train_common.cuh GR_*): [D0..D7 | dbott | dv]
GR_BOTT = 8 * WIDTH
GR_V = GR_BOTT + WIDTH
GRAD_COLS = GR_V + COND  # 2,432
GRAD_CHUNKS = GRAD_COLS // K_CHUNK  # 38
# bytes of the relu-mask workspace per row: a0..a7, one bit a column
MASK_BYTES = 8 * WIDTH // 8  # 256

# the weight gradients' work items: int32 fields of ops/csrc/train_sm90.cuh
# WgradItem
ITEM_FIELDS = ("x_chunk", "m_count", "d_chunk", "n_count", "out", "ld_out", "block_begin",
               "block_end")


def padded_rows(n_rows: int) -> int:
    """Workspace rows for ``n_rows`` samples: whole 128-row tiles."""
    return -(-n_rows // TILE_ROWS) * TILE_ROWS


def kernel_offsets() -> Dict[str, int]:
    """Offset of each matrix in the kernel blob (and in the gradient blob)."""
    offsets, o = {}, 0
    for k in _KERNEL_WEIGHTS:
        offsets[k] = o
        o += PACKED_SHAPES[k][0] * PACKED_SHAPES[k][1]
    return offsets


@functools.lru_cache(maxsize=None)
def _bwd_blob_index() -> np.ndarray:
    """For each entry of the backward blob, its index in the kernel blob."""
    offsets = kernel_offsets()
    parts = []
    for name in BWD_SLABS:
        n_in, n_out = PACKED_SHAPES[name]  # W (in, out); B' = W^T (K' = out, N' = in)
        s, n, g, e = np.meshgrid(np.arange(n_out // K_CHUNK), np.arange(n_in), np.arange(8),
                                 np.arange(8), indexing="ij")
        k = K_CHUNK * s + 8 * (g ^ (n % 8)) + e  # the output column stored there
        parts.append((offsets[name] + n * n_out + k).reshape(-1))
    index = np.concatenate(parts)
    assert index.size == N_BWD_WEIGHTS
    return index


@functools.lru_cache(maxsize=None)
def _train_index(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([_eval_blob_index(), _bwd_blob_index()])).to(device)


def train_blob(wblob: torch.Tensor) -> torch.Tensor:
    """The training kernels' weight blob from the kernel blob's bf16 weights:
    the eval blob, then the backward blob (one gather; the eval blob's K
    padding reads the appended zero)."""
    return torch.cat([wblob, wblob.new_zeros(1)])[_train_index(wblob.device)]


def wgrad_units():
    """The weight gradients' output tiles, before their rows are split:
    ``(x_chunk, m_count, d_chunk, n_count, out, ld_out)``, at most 128 rows
    of dW (two warpgroups of 64) by all its columns (256 or 128); X starts at
    chunk ``x_chunk`` of the act workspace and D at ``d_chunk`` of the grad
    workspace."""
    off = kernel_offsets()
    ww = WIDTH * WIDTH
    jobs = [  # (X column, rows of dW, D column, columns of dW, dW offset)
        (ACT_ENC, POS_PAD, 0, WIDTH, off["w0"]),
        *((ACT_A0 + (i - 1) * WIDTH, WIDTH, i * WIDTH, WIDTH, off["w1"] + (i - 1) * ww)
          for i in (1, 2, 3, 4)),
        (ACT_A0 + 4 * WIDTH, WIDTH, 5 * WIDTH, WIDTH, off["w5a"]),
        (ACT_ENC, POS_PAD, 5 * WIDTH, WIDTH, off["w5b"]),
        (ACT_A0 + 5 * WIDTH, WIDTH, 6 * WIDTH, WIDTH, off["w6"]),
        (ACT_A0 + 6 * WIDTH, WIDTH, 7 * WIDTH, WIDTH, off["w7"]),
        (ACT_A0 + 7 * WIDTH, WIDTH, GR_BOTT, WIDTH, off["wb"]),
        (ACT_BOTT, WIDTH, GR_V, COND, off["wva"]),
        (ACT_VENC, VIEW_PAD, GR_V, COND, off["wvb"]),
    ]
    units = []
    for x_col, kx, d_col, nd, out in jobs:
        for m0 in range(0, kx, 2 * K_CHUNK):
            units.append(((x_col + m0) // K_CHUNK, min(kx - m0, 2 * K_CHUNK), d_col // K_CHUNK,
                          nd, out + m0 * nd, nd))
    return units


def wgrad_items(n_pad: int, sm_count: int, units=None) -> np.ndarray:
    """The weight gradients' work list for ``n_pad`` workspace rows (whole
    64-row blocks): one item a thread block, (n_items, 8) int32 in
    ``ITEM_FIELDS`` order.  Each output tile's row blocks are cut into
    contiguous ranges, as many as its share of the work gives it of
    ``sm_count`` thread blocks (a 128-column tile counts half), so that one
    wave runs every item; each thread block adds its sums to dW once.
    ``units``: the output tiles (``wgrad_units``, the default, or the
    articulated kernels' ``art_sm90.wgrad_units``)."""
    assert n_pad > 0 and n_pad % BLOCK_ROWS == 0
    units = wgrad_units() if units is None else units
    blocks = n_pad // BLOCK_ROWS
    cost = np.array([1.0 if u[3] == WIDTH else 0.5 for u in units])
    share = cost * max(sm_count, len(units)) / cost.sum()
    splits = np.maximum(np.floor(share).astype(int), 1)
    # the thread blocks left over go to the largest remainders
    for i in np.argsort(-(share - np.floor(share)), kind="stable"):
        if splits.sum() >= max(sm_count, len(units)):
            break
        splits[i] += 1
    splits = np.minimum(splits, blocks)
    items = []
    for unit, s in zip(units, splits):
        bounds = [blocks * j // s for j in range(s + 1)]
        items += [(*unit, bounds[j], bounds[j + 1]) for j in range(s)]
    return np.asarray(items, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _items_on(n_pad: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(wgrad_items(n_pad, sm_count(device))).to(device)


def items_on(n_pad: int, device: torch.device) -> Tuple[torch.Tensor, int]:
    """``wgrad_items`` for the device, on it (cached by row count): the
    tensor and its item count."""
    items = _items_on(n_pad, device)
    return items, items.shape[0]


def launch_grid(n_rows: int, device: torch.device) -> int:
    """Persistent blocks of the forward and the backward: one per SM, never
    more than the 128-row tiles."""
    return min(padded_rows(n_rows) // TILE_ROWS, sm_count(device))


def launch_inputs(blobs: Tuple[torch.Tensor, torch.Tensor], n_rows: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, int]:
    """What a launch of the training kernels reads besides its data, from
    the kernel blobs (``fused_mlp.kernel_blobs``): the training blob, the
    bias blob, the weight gradients' work list and its length, and the grid
    of the forward and the backward.  Raises unless the blobs are the kernel
    blobs' sizes and types on ``device``."""
    wblob, bblob = blobs
    for name, t, n, dtype in (("weights", wblob, N_KERNEL_WEIGHTS, torch.bfloat16),
                              ("biases", bblob, N_KERNEL_BIASES, torch.float32)):
        if t.device != device or t.dtype != dtype or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"the training kernels' {name} must be a contiguous {dtype} blob of "
                             f"{n} on {device} (kernel_blobs)")
    items, n_items = items_on(padded_rows(n_rows), device)
    return train_blob(wblob), bblob, items, n_items, launch_grid(n_rows, device)


# ---------------------------------------------------- the blocked workspaces


@functools.lru_cache(maxsize=None)
def _swizzle_index() -> torch.Tensor:
    """For each (row, column) of a 64 x 64 chunk, its element in the
    chunk's swizzled image: the 16-byte group g of row r at g ^ (r % 8)."""
    r = np.arange(BLOCK_ROWS)[:, None]
    c = np.arange(K_CHUNK)[None, :]
    return torch.from_numpy(r * K_CHUNK + 8 * ((c // 8) ^ (r % 8)) + c % 8)


def to_blocked(rows: torch.Tensor, chunks: int) -> torch.Tensor:
    """A (n_pad, <= 64 chunks) matrix as a blocked workspace (n_pad / 64,
    chunks, 64, 64); columns past its width are zero."""
    n_pad = rows.shape[0]
    full = rows.new_zeros(n_pad, chunks * K_CHUNK)
    full[:, :rows.shape[1]] = rows
    tiles = full.view(n_pad // BLOCK_ROWS, BLOCK_ROWS, chunks, K_CHUNK).transpose(1, 2)
    out = torch.empty(n_pad // BLOCK_ROWS, chunks, BLOCK_ROWS * K_CHUNK, dtype=rows.dtype,
                      device=rows.device)
    out[:, :, _swizzle_index().to(rows.device).reshape(-1)] = tiles.reshape(
        n_pad // BLOCK_ROWS, chunks, -1)
    return out.view(n_pad // BLOCK_ROWS, chunks, BLOCK_ROWS, K_CHUNK)


def from_blocked(blocked: torch.Tensor) -> torch.Tensor:
    """A blocked workspace (n_blocks, chunks, 64, 64) as the (n_blocks * 64,
    chunks * 64) matrix of its rows and columns."""
    n_blocks, chunks = blocked.shape[:2]
    flat = blocked.reshape(n_blocks, chunks, -1)[:, :, _swizzle_index().to(blocked.device)]
    return flat.transpose(1, 2).reshape(n_blocks * BLOCK_ROWS, chunks * K_CHUNK)


# ------------------------------------------------- the weight gradients alone


def weight_grads_plain(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``weight_grads``: the f32 gradient blob with dW = X^T D
    of the 12 wide matrices (bf16 operands, f32 sums) and zeros elsewhere."""
    x_rows, d_rows = from_blocked(act), from_blocked(grad)
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES, dtype=torch.float32, device=act.device)
    for x_chunk, m, d_chunk, n, out, ld in wgrad_units():
        x = x_rows[:, K_CHUNK * x_chunk:K_CHUNK * x_chunk + m].float()
        d = d_rows[:, K_CHUNK * d_chunk:K_CHUNK * d_chunk + n].float()
        gw[out:out + m * ld].view(m, ld).add_(x.t() @ d)
    return gw


def weight_grads(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The weight-gradient kernel alone over given blocked bf16 workspaces
    ``act`` (n_pad / 64, 40, 64, 64) and ``grad`` (n_pad / 64, 38, 64, 64):
    the f32 gradient blob with dW = X^T D of the 12 wide matrices.  CUDA
    tensors launch ``aon_wgrad_run``; CPU tensors run ``weight_grads_plain``."""
    device = _kernel_device(act)
    if device is None:
        return weight_grads_plain(act, grad)
    n_blocks = act.shape[0]
    for name, t, chunks in (("act", act, ACT_CHUNKS), ("grad", grad, GRAD_CHUNKS)):
        shape = (n_blocks, chunks, BLOCK_ROWS, K_CHUNK)
        if (n_blocks == 0 or tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name} must be a contiguous bfloat16 blocked workspace {shape} "
                             f"on {device}")
    n_pad = n_blocks * BLOCK_ROWS
    items, n_items = items_on(n_pad, device)
    gw = torch.zeros(N_KERNEL_WEIGHTS + N_KERNEL_BIASES, dtype=torch.float32, device=device)
    err = _build.library("level_train").aon_wgrad_run(
        act.data_ptr(), grad.data_ptr(), gw.data_ptr(), items.data_ptr(), n_items,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "weight_grads")
    weight_grads.launches += 1
    return gw


weight_grads.launches = 0
