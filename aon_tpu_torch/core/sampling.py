"""Ray sampling math for hierarchical NeRF rendering (PyTorch port of
``aon_tpu/core/sampling.py``).

Behavioral contracts match the reference (``models/vanilla_nerf/helper.py``):

* ``sample_along_rays`` (helper.py:106-133): ``num_samples + 1`` t-values
  per ray, optional lindisp spacing.
* ``pos_enc`` (helper.py:136-140): ``sin(cat([xb, xb + pi/2]))`` with the
  identity channels prepended, frequency-major layout.
* ``sorted_piecewise_constant_pdf`` (helper.py:203-243): eps=1e-5 weight
  padding, CDF with 0/1 endpoints, deterministic u in ``[0, 1 - 2**-32]``,
  piecewise-linear inverse CDF by comparison count.
* ``sample_pdf`` (helper.py:246-252): sorted union of coarse and fine
  t-values, recast into sample coordinates.

Randomness comes from an explicit ``torch.Generator`` (the JAX package's
keys), and every randomized function also takes the uniforms themselves
(``t_rand=``, ``u=``): torch and JAX streams differ, so a test that compares
the two injects one set of draws into both.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

NEEDS_GENERATOR = "randomized sampling requires a torch.Generator or the draws themselves"


def unit_linspace(num: int, device=None) -> torch.Tensor:
    """float32 ``jnp.linspace(0, 1, num)``, bit for bit.

    XLA evaluates ``iota / div`` as ``iota * f32(1 / div)``; ``torch.linspace``
    rounds 4 of the 128 eval quantiles one ulp away from that.  Built on the
    host in numpy float32, then moved to ``device``.
    """
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = np.arange(num - 1, dtype=np.float32) * (np.float32(1) / np.float32(num - 1))
    out = np.concatenate([step, [np.float32(1)]]).astype(np.float32)
    return torch.from_numpy(out).to(device)


def cast_rays(
    t_vals: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor
) -> torch.Tensor:
    """o + t*d for every t. t_vals: (..., S); origins/directions: (..., 3) -> (..., S, 3)."""
    return origins[..., None, :] + t_vals[..., None] * directions[..., None, :]


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds) on int64 tensors
    that hold 32-bit values."""
    m = 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & m
    x = ((x ^ (x >> 15)) * 0x846CA68B) & m
    return x ^ (x >> 16)


def per_ray_uniform(
    generator: torch.Generator, ray_ids: torch.Tensor, n: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, n) uniforms in [0, 1) where row i depends only on the generator's
    state and ``ray_ids[i]``: independent of batch size and microbatching.

    The JAX package folds the key with the global ray index; here one seed is
    drawn from ``generator`` (so the generator advances by the same amount
    whatever the batch) and hashed with the ray index and the column.
    """
    if generator is None:
        raise ValueError(NEEDS_GENERATOR)
    device = ray_ids.device
    seed = torch.randint(0, 2**31 - 1, (2,), generator=generator, device=generator.device).to(device)
    row = _mix32((ray_ids.to(torch.int64) & 0xFFFFFFFF) ^ seed[0])[:, None]
    col = torch.arange(n, device=device, dtype=torch.int64)[None, :]
    bits = _mix32(((row + col * 0x9E3779B1) & 0xFFFFFFFF) ^ seed[1])
    return ((bits >> 8).to(torch.float32) * 2.0**-24).to(dtype)


def draw_uniform(
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator],
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    ray_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``shape`` (B, n) uniforms from ``generator``: per ray where ``ray_ids``
    is given, one block draw otherwise."""
    if ray_ids is not None:
        return per_ray_uniform(generator, ray_ids, shape[-1], dtype)
    if generator is None:
        raise ValueError(NEEDS_GENERATOR)
    return torch.rand(shape, generator=generator, device=generator.device, dtype=dtype).to(device)


def sample_along_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    num_samples: int,
    near: Union[float, torch.Tensor],
    far: Union[float, torch.Tensor],
    randomized: bool = False,
    lindisp: bool = False,
    generator: Optional[torch.Generator] = None,
    ray_ids: Optional[torch.Tensor] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified coarse sampling along rays: ``(t_vals (B, S+1), coords (B, S+1, 3))``.

    ``near`` / ``far`` may be scalars or per-ray ``(B,)`` tensors.  When
    ``randomized``, each of the S+1 points is jittered uniformly within its
    midpoint-bounded bin (reference helper.py:122-127) by ``t_rand`` (B, S+1)
    in [0, 1), drawn from ``generator`` unless given.
    """
    bsz = rays_o.shape[0]
    dtype, device = rays_o.dtype, rays_o.device
    near = torch.as_tensor(near, dtype=dtype, device=device)
    far = torch.as_tensor(far, dtype=dtype, device=device)
    if near.ndim >= 1:
        near = near.reshape(-1, 1)
    if far.ndim >= 1:
        far = far.reshape(-1, 1)
    t_vals = unit_linspace(num_samples + 1, device=device).to(dtype)
    if lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        t_vals = near * (1.0 - t_vals) + far * t_vals
    if randomized:
        if t_rand is None:
            t_rand = draw_uniform((bsz, num_samples + 1), generator, device, dtype, ray_ids)
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
        lower = torch.cat([t_vals[..., :1], mids], dim=-1)
        t_vals = (lower + (upper - lower) * t_rand).contiguous()
    else:
        t_vals = t_vals.expand(bsz, num_samples + 1).contiguous()
    t_vals = t_vals.detach()  # sample positions carry no parameter gradients
    return t_vals, cast_rays(t_vals, rays_o, rays_d)


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """Positional encoding with identity passthrough.

    Output channels ``(2*(max_deg - min_deg) + 1) * C`` laid out as
    ``[x, sin(x*2^d0), ..., sin(x*2^dk), cos(x*2^d0), ..., cos(x*2^dk)]``
    with cos taken as sin(x + pi/2), as the reference does.
    """
    if max_deg == min_deg:
        return x
    scales = torch.tensor(
        [2.0**i for i in range(min_deg, max_deg)], dtype=x.dtype, device=x.device
    )
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([x, four_feat], dim=-1)


def pdf_cdf(weights: torch.Tensor) -> torch.Tensor:
    """(B, N-1) bin masses -> (B, N) CDF ``cat([0, min(1, cumsum(pdf[:-1])), 1])``
    after padding the total mass to at least eps=1e-5 (helper.py:217-226)."""
    eps = 1e-5
    weight_sum = weights.sum(-1, keepdim=True)
    padding = torch.clamp_min(eps - weight_sum, 0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp_max(torch.cumsum(pdf[..., :-1], dim=-1), 1.0)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)


def eval_quantiles(num_samples: int, device=None) -> torch.Tensor:
    """The deterministic eval u, ``linspace(0, 1 - 2**-32, num_samples)``
    (helper.py:227-229).  ``1 - 2**-32`` rounds to 1.0 in float32, so these
    are the values of ``linspace(0, 1)`` and the last u is exactly 1."""
    return unit_linspace(num_samples, device=device)


def invert_cdf(bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear inverse CDF at ``u`` (helper.py:232-243).

    ``idx = #{i : cdf_i <= u}``; ``bin0 = bins[idx-1]``, ``bin1 = bins[idx]``
    (clamped), which equals the reference's masked max/min selection.
    """
    n = cdf.shape[-1]
    idx = (u[..., None, :] >= cdf[..., :, None]).sum(dim=-2)
    lo = torch.clamp(idx - 1, 0, n - 1)
    hi = torch.clamp(idx, 0, n - 1)
    bin0 = torch.gather(bins, -1, lo)
    bin1 = torch.gather(bins, -1, hi)
    cdf0 = torch.gather(cdf, -1, lo)
    cdf1 = torch.gather(cdf, -1, hi)
    denom = cdf1 - cdf0
    t = torch.clip(torch.nan_to_num((u - cdf0) / denom, nan=0.0), 0.0, 1.0)
    t = torch.where(denom <= 0, torch.zeros_like(t), t)
    return bin0 + t * (bin1 - bin0)


def sorted_piecewise_constant_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    randomized: bool = False,
    generator: Optional[torch.Generator] = None,
    ray_ids: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF samples ``(B, num_samples)`` from a piecewise-constant pdf.

    bins: (B, N) sorted positions; weights: (B, N - 1) bin masses.  When
    ``randomized`` the quantiles are iid uniforms ``u`` (B, num_samples),
    drawn from ``generator`` unless given; otherwise the eval quantiles.
    """
    cdf = pdf_cdf(weights)
    if not randomized:
        u = eval_quantiles(num_samples, cdf.device).to(cdf.dtype)
        u = u.expand(*cdf.shape[:-1], num_samples)
    elif u is None:
        u = draw_uniform((*cdf.shape[:-1], num_samples), generator, cdf.device, cdf.dtype, ray_ids)
    return invert_cdf(bins, cdf, u)


def sample_pdf(
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
    """Fine resampling: ``(t_union_sorted (B, T + n), coords (B, T + n, 3))``."""
    t_samples = sorted_piecewise_constant_pdf(
        bins, weights, num_samples, randomized, generator=generator, ray_ids=ray_ids, u=u
    ).detach()
    t_vals = torch.sort(torch.cat([t_vals, t_samples], dim=-1), dim=-1).values.detach()
    return t_vals, cast_rays(t_vals, origins, directions)
