"""Fused inverse-CDF resampling (port of ``aon_tpu/ops/resample_pallas.py``).

Two entries launch the one CUDA kernel of ``ops/csrc/resample.cu`` on CUDA
tensors and run plain twins on CPU tensors:

* ``resample_union(t_vals, bins, cdf, u)`` takes the CDF, as the TPU kernel
  body does; its twin ``resample_union_plain`` is the ``sample_pdf``
  formulation with ``torch.sort`` of the union.
* ``fused_resample(t_vals, bins, weights, u)`` is the JAX wrapper's function:
  the kernel builds the CDF from the weights itself, in the order of
  ``pdf_cdf_ordered``, which with ``resample_union_plain`` is its exact twin
  on the card.  It is one launch in all, and it reads ``weights`` with its
  row stride (the callers' ``wgt[..., 1:-1]`` window is not copied).  On CPU
  tensors it runs ``core.sampling.pdf_cdf`` and ``resample_union_plain``, so
  the CPU routes sample exactly as ``core.sampling.sample_pdf`` does.

``resample_union.launches`` counts the launches of both.  ``resample_plan``
sizes the kernel's ray tiles and persistent grid from the shapes.

Randomized draws: the reference draws iid uniforms and relies on the final
union sort; the merge needs sorted u.  ``sorted_uniform`` builds sorted iid
uniforms directly from the order-statistics identity u_(k) = S_k / S_{n+1},
S the partial sums of iid Exp(1) draws, so the sorted sample set has the
distribution of sorted iid draws.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from aon_tpu_torch.core.sampling import (
    cast_rays,
    draw_uniform,
    per_ray_uniform,
    eval_quantiles,
    invert_cdf,
    pdf_cdf,
)
from aon_tpu_torch.ops import _build

# The kernel's launch shape (ops/csrc/resample.cu): blocks of 256 threads (a
# warp per ray at a time), two stages of ray tiles of at most TILE_RAYS rays,
# at most MAX_BLOCKS_PER_SM blocks an SM (its register budget, 64 a thread),
# and the H100's shared memory (227 KB a block at most, 228 KB an SM, 1 KB of
# each block's reserved).  16-ray tiles let four blocks share an SM at the
# render chunk.  Row strides stay below MAX_STRIDE floats.
TILE_RAYS = 16
STAGES = 2
SMEM_BLOCK_MAX = 232448
SMEM_SM, SMEM_RESERVED = 233472, 1024
MAX_BLOCKS_PER_SM = 4
MAX_STRIDE = 1 << 24
H100_SMS = 132
CDF_EPS = 1e-5  # pdf_cdf's mass padding (helper.py:217-226)


def pdf_cdf_ordered(weights: torch.Tensor) -> torch.Tensor:
    """``core.sampling.pdf_cdf`` with its sums in the kernel's order: (B, N-1)
    bin masses -> (B, N) CDF.

    The mass of each ray summed left to right, one column at a time, then
    padded to at least eps and spread over the bins; each padded mass over the
    padded sum; the running sum left to right, clamped at 1; 0 and 1 at the
    ends.  Every step is one float32 operation, as in the kernel's
    ``build_cdfs``.  ``pdf_cdf`` sums in torch's order, so the two differ by
    float32 rounding (up to about 1e-6 in the CDF).
    """
    n = weights.shape[-1]
    total = weights[..., 0]
    for k in range(1, n):
        total = total + weights[..., k]
    pad = torch.clamp_min(CDF_EPS - total, 0.0)
    # a tensor divisor: PyTorch on CUDA divides by a Python number as a
    # multiply by its reciprocal, which is not the kernel's division
    padded = weights + (pad / torch.full_like(pad, n))[..., None]
    pdf = padded / (total + pad)[..., None]
    acc = torch.zeros_like(total)
    cols = [acc]
    for k in range(n - 1):
        acc = acc + pdf[..., k]
        cols.append(torch.clamp_max(acc, 1.0))
    cols.append(torch.ones_like(total))
    return torch.stack(cols, dim=-1)


def resample_union_plain(
    t_vals: torch.Tensor, bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Plain twin: inverse CDF at u, then ``torch.sort`` of the coarse/fine union."""
    samples = invert_cdf(bins, cdf, u.expand(bins.shape[0], u.shape[-1]))
    return torch.sort(torch.cat([t_vals, samples], dim=-1), dim=-1).values


def _region(stride: int, length: int, rays: int) -> int:
    """Floats of the kernel's shared-memory region for ``rays`` rows of an
    array as one span at any offset within a 16-byte line (``region`` in
    ``resample.cu``)."""
    return ((rays - 1) * stride + length + 6) // 4 * 4


def _smem_bytes(rays: int, n_t: int, n_bins: int, n_u: int, strides: Tuple[int, int, int, int],
                fused: bool) -> int:
    """The kernel's shared memory for tiles of ``rays`` rays (``Layout`` in
    ``resample.cu``); ``strides``: the row strides of t, bins, the CDF or the
    weights, and u (0: one shared row)."""
    t_s, b_s, c_s, u_s = strides
    n_c = n_bins - 1 if fused else n_bins
    stage = (_region(t_s, n_t, rays) + _region(b_s, n_bins, rays) + _region(c_s, n_c, rays)
             + (_region(u_s, n_u, rays) if u_s else 0))
    shared_u = 0 if u_s else _region(0, n_u, 1)
    stats = -(-2 * rays // 4) * 4 if fused else 0  # each ray's padding and sum
    cdf = -(-rays * (n_bins | 1) // 4) * 4 if fused else 0  # odd row stride
    fine = -(-rays * n_u // 4) * 4
    return 4 * (STAGES * stage + shared_u + stats + cdf + fine
                + _region(n_t + n_u, n_t + n_u, rays))


def resample_plan(n_rays: int, n_t: int, n_bins: int, n_u: int,
                  strides: Optional[Tuple[int, int, int, int]] = None, fused: bool = False,
                  n_sm: int = H100_SMS) -> dict:
    """The kernel's launch shape: ``tile_rays`` rays a tile (at most
    TILE_RAYS, and about two tiles for every SM where there are the rays: a
    training microbatch of 2,048 rays gets 8-ray tiles, a warp's ray each),
    ``tiles``, persistent ``grid`` blocks (as many as fit on each SM, at most
    one a tile), ``blocks_per_sm``, ``smem_bytes`` a block and ``stages``.  ``strides`` default to contiguous rows with per-ray u.
    Raises ValueError where one ray's rows do not fit in shared memory."""
    if strides is None:
        strides = (n_t, n_bins, n_bins - 1 if fused else n_bins, n_u)
    rays = max(1, min(TILE_RAYS, -(-n_rays // (2 * n_sm))))
    while rays > 1 and _smem_bytes(rays, n_t, n_bins, n_u, strides, fused) > SMEM_BLOCK_MAX:
        rays //= 2
    smem = _smem_bytes(rays, n_t, n_bins, n_u, strides, fused)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"row sizes n_t={n_t} n_bins={n_bins} n_u={n_u} (strides {strides}) "
                         "exceed the kernel's shared memory")
    tiles = -(-n_rays // rays)
    per_sm = min(MAX_BLOCKS_PER_SM, SMEM_SM // (smem + SMEM_RESERVED))
    return {"tile_rays": rays, "tiles": tiles, "grid": min(tiles, per_sm * n_sm),
            "blocks_per_sm": per_sm, "smem_bytes": smem, "stages": STAGES}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows(name: str, t: torch.Tensor, shape: Tuple[int, int], device: torch.device,
          shared_ok: bool = False) -> int:
    """Checks that ``t`` is float32 ``shape`` on ``device`` with unit column
    stride and rows that do not overlap (or, ``shared_ok``, one row expanded);
    returns its row stride."""
    stride = t.stride(0) if t.dim() == 2 else -1
    if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device
            or t.stride(-1) != 1 or stride > MAX_STRIDE
            or not (stride >= shape[1] or (shared_ok and stride == 0) or shape[0] == 1)):
        what = ("contiguous rows at most MAX_STRIDE floats apart"
                + (" or one row expanded" if shared_ok else ""))
        raise ValueError(f"{name} must be float32 {shape} on {device} with {what}")
    return stride


def _launch(t_vals: torch.Tensor, bins: torch.Tensor, third: torch.Tensor, u: torch.Tensor,
            fused: bool) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors: ``third`` is the CDF, or
    with ``fused`` the weights."""
    device = t_vals.device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if t_vals.dim() != 2 or bins.dim() != 2 or u.dim() != 2:
        raise ValueError("t_vals, bins and u must be (B, n)")
    B, n_t = t_vals.shape
    n_bins, n_u = bins.shape[-1], u.shape[-1]
    if n_bins < (2 if fused else 1) or n_u < 1:
        raise ValueError(f"row sizes n_bins={n_bins} n_u={n_u} are too small")
    strides = (_rows("t_vals", t_vals, (B, n_t), device),
               _rows("bins", bins, (B, n_bins), device),
               _rows("weights" if fused else "cdf", third,
                     (B, n_bins - 1 if fused else n_bins), device),
               _rows("u", u, (B, n_u), device, shared_ok=True))
    plan = resample_plan(B, n_t, n_bins, n_u, strides, fused, _sm_count(device))
    out = torch.empty(B, n_t + n_u, dtype=torch.float32, device=device)
    if B == 0:
        return out
    err = _build.library("resample").aon_resample_launch(
        t_vals.data_ptr(), strides[0], bins.data_ptr(), strides[1], third.data_ptr(), strides[2],
        int(fused), u.data_ptr(), strides[3], out.data_ptr(), B, n_t, n_bins, n_u,
        plan["tile_rays"], plan["grid"], torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "fused_resample" if fused else "resample_union")
    resample_union.launches += 1
    return out


def resample_union(
    t_vals: torch.Tensor, bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """(B, n_t) ascending coarse t-values, (B, n_bins) bins and CDF, (B, n_u)
    ascending quantiles -> (B, n_t + n_u) sorted union.

    ``u`` may be one row expanded over the rays (stride 0), as the eval
    quantiles are.  Rows may lie any stride apart.  CUDA tensors launch the
    kernel; CPU tensors run the twin.
    """
    if t_vals.device.type == "cpu":
        return resample_union_plain(t_vals, bins, cdf, u)
    return _launch(t_vals, bins, cdf, u, fused=False)


resample_union.launches = 0  # launches of the kernel from either entry


def sorted_uniform(uniforms: torch.Tensor) -> torch.Tensor:
    """Sorted iid-uniform order statistics without a sort: (..., n + 1)
    uniforms in [0, 1) -> (..., n) ascending, by a cumsum of the exponentials
    ``-log1p(-uniforms)``."""
    s = torch.cumsum(-torch.log1p(-uniforms), dim=-1)
    return s[..., :-1] / s[..., -1:]


def sorted_per_ray_uniform(key, ray_ids: torch.Tensor, n: int,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-ray-seeded sorted uniforms (B, n) from ``uniform(fold_in(key,
    ray_id), (n + 1,))`` (``aon_tpu/ops/resample_pallas.py:52-60``):
    independent of batch layout, like ``core.sampling.per_ray_uniform``."""
    return sorted_uniform(per_ray_uniform(key, ray_ids, n + 1, dtype))


def fused_resample(
    t_vals: torch.Tensor, bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """(B, n_t) sorted coarse t-values + piecewise-constant pdf ``weights``
    (B, n_bins - 1) + sorted quantiles u -> sorted union (B, n_t + n_u).

    Matches ``sampling.sample_pdf``'s t-value output for sorted u; the CDF
    (eps=1e-5 mass padding, clamped cumsum, 0/1 endpoints) is helper.py:217-226,
    built in the kernel in the order of ``pdf_cdf_ordered``.  ``weights`` may
    be a window of a wider array (rows any stride apart).  CUDA tensors launch
    the kernel once; CPU tensors run ``pdf_cdf`` and the twin, bit for bit
    ``sample_pdf``'s samples.  The two CDF orders agree to a few ulps of the
    CDF, and the samples with them except where a bin's mass is tiny: there
    the inverse CDF magnifies an ulp up to the bin's width.
    """
    if t_vals.device.type == "cpu":
        return resample_union_plain(t_vals, bins, pdf_cdf(weights), u)
    return _launch(t_vals, bins, weights, u, fused=True)


def sample_pdf_fused(
    bins: torch.Tensor,
    weights: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    num_samples: int,
    randomized: bool = False,
    key: Optional[torch.Tensor] = None,
    ray_ids: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``core.sampling.sample_pdf`` on the fused paths: the sorted
    coarse/fine union and its recast coordinates.

    Randomized quantiles are order statistics, sorted by construction
    (``sorted_uniform``), seeded per ray where ``ray_ids`` is given; a caller
    may pass them as ``u`` (B, num_samples), each row ascending.
    """
    if not randomized:
        u = eval_quantiles(num_samples, device=bins.device).expand(bins.shape[0], num_samples)
    elif u is None and ray_ids is not None:
        u = sorted_per_ray_uniform(key, ray_ids, num_samples, bins.dtype)
    elif u is None:
        u = sorted_uniform(draw_uniform((bins.shape[0], num_samples + 1), key, bins.device,
                                        bins.dtype))
    u = u.detach()
    if u.stride(0) != 0:
        u = u.contiguous()
    t_union = fused_resample(t_vals.detach(), bins.detach(), weights.detach(), u)
    return t_union, cast_rays(t_union, origins, directions)
