"""Fused inverse-CDF resampling (port of ``aon_tpu/ops/resample_pallas.py``).

``resample_union`` launches the CUDA kernel ``ops/csrc/resample.cu`` on CUDA
tensors and runs its plain twin, ``resample_union_plain`` (the
``sample_pdf`` formulation with ``torch.sort`` of the union), on CPU tensors.
The CDF is built in PyTorch before the kernel, as the JAX wrapper builds it
in XLA.

Randomized draws: the reference draws iid uniforms and relies on the final
union sort; the merge needs sorted u.  ``sorted_uniform`` builds sorted iid
uniforms directly from the order-statistics identity u_(k) = S_k / S_{n+1},
S the partial sums of iid Exp(1) draws, so the sorted sample set has the
distribution of sorted iid draws.
"""

from __future__ import annotations

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

# shared memory per 8-ray block: 8 * (n_t + 2 * n_bins + n_u) floats <= 48 KB
_MAX_ROW_FLOATS = 1536


def resample_union_plain(
    t_vals: torch.Tensor, bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Plain twin: inverse CDF at u, then ``torch.sort`` of the coarse/fine union."""
    samples = invert_cdf(bins, cdf, u.expand(bins.shape[0], u.shape[-1]))
    return torch.sort(torch.cat([t_vals, samples], dim=-1), dim=-1).values


def resample_union(
    t_vals: torch.Tensor, bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """(B, n_t) ascending coarse t-values, (B, n_bins) bins and CDF, (B, n_u)
    ascending quantiles -> (B, n_t + n_u) sorted union.

    ``u`` may be one row expanded over the rays (stride 0), as the eval
    quantiles are.  CUDA tensors launch the kernel; CPU tensors run the twin.
    """
    if t_vals.device.type == "cpu":
        return resample_union_plain(t_vals, bins, cdf, u)
    if t_vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {t_vals.device}")
    B, n_t = t_vals.shape
    n_bins, n_u = bins.shape[-1], u.shape[-1]
    for name, t, shape in (("t_vals", t_vals, (B, n_t)), ("bins", bins, (B, n_bins)),
                           ("cdf", cdf, (B, n_bins))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != t_vals.device):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {t_vals.device}")
    if (tuple(u.shape) != (B, n_u) or u.dtype != torch.float32 or u.stride(-1) != 1
            or u.stride(0) not in (0, n_u) or u.device != t_vals.device):
        raise ValueError(f"u must be float32 ({B}, {n_u}) with rows contiguous or expanded")
    if n_bins < 1 or n_t + 2 * n_bins + n_u > _MAX_ROW_FLOATS:
        raise ValueError(f"row sizes n_t={n_t} n_bins={n_bins} n_u={n_u} exceed the kernel's")
    out = torch.empty(B, n_t + n_u, dtype=torch.float32, device=t_vals.device)
    err = _build.library("resample").aon_resample_launch(
        t_vals.data_ptr(), bins.data_ptr(), cdf.data_ptr(), u.data_ptr(), u.stride(0),
        out.data_ptr(), B, n_t, n_bins, n_u, torch.cuda.current_stream(t_vals.device).cuda_stream,
    )
    _build.check(err, "resample_union")
    resample_union.launches += 1
    return out


resample_union.launches = 0


def sorted_uniform(uniforms: torch.Tensor) -> torch.Tensor:
    """Sorted iid-uniform order statistics without a sort: (..., n + 1)
    uniforms in [0, 1) -> (..., n) ascending, by a cumsum of the exponentials
    ``-log1p(-uniforms)``."""
    s = torch.cumsum(-torch.log1p(-uniforms), dim=-1)
    return s[..., :-1] / s[..., -1:]


def sorted_per_ray_uniform(generator: torch.Generator, ray_ids: torch.Tensor, n: int,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-ray-seeded sorted uniforms (B, n): independent of batch layout, like
    ``core.sampling.per_ray_uniform``."""
    return sorted_uniform(per_ray_uniform(generator, ray_ids, n + 1, dtype))


def fused_resample(
    t_vals: torch.Tensor, bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """(B, n_t) sorted coarse t-values + piecewise-constant pdf ``weights``
    (B, n_bins - 1) + sorted quantiles u -> sorted union (B, n_t + n_u).

    Matches ``sampling.sample_pdf``'s t-value output for sorted u; the CDF
    (eps=1e-5 mass padding, clamped cumsum, 0/1 endpoints) is helper.py:217-226.
    """
    return resample_union(t_vals, bins, pdf_cdf(weights).contiguous(), u)


def sample_pdf_fused(
    bins: torch.Tensor,
    weights: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    num_samples: int,
    randomized: bool = False,
    generator: Optional[torch.Generator] = None,
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
        u = sorted_per_ray_uniform(generator, ray_ids, num_samples, bins.dtype)
    elif u is None:
        u = sorted_uniform(draw_uniform((bins.shape[0], num_samples + 1), generator, bins.device,
                                        bins.dtype))
    u = u.detach()
    if u.stride(0) != 0:
        u = u.contiguous()
    t_union = fused_resample(t_vals.detach(), bins.detach(), weights.detach(), u)
    return t_union, cast_rays(t_union, origins, directions)
