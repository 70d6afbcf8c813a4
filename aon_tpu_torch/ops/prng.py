"""The threefry uniforms on the card: one launch of ``csrc/prng.cu`` a draw.

``threefry_uniform(key, ray_ids, shape, device)`` is ``jax.random.uniform``
of ``key`` over ``shape`` (``ray_ids`` None) or, with ``ray_ids`` (B,),
the (B, n) rows ``uniform(fold_in(key, ray_ids[i]), (n,))``, in float32 on
[0, 1).  On a CUDA device it launches the kernel; on the CPU it runs the
twin, ``core/prng.py``'s ``random_bits_plain`` / ``per_ray_uniform_plain``,
bit for bit the same values.  ``core/prng.py::uniform`` and
``per_ray_uniform`` draw through it.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch

from aon_tpu_torch.core import prng
from aon_tpu_torch.ops import _build

THREADS = 256
FLAT_BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def threefry_uniform(key, ray_ids: Optional[torch.Tensor], shape: Sequence[int],
                     device, row0: int = 0) -> torch.Tensor:
    """(``shape``) float32 uniforms on [0, 1): per ray where ``ray_ids`` is
    given (``shape`` is then (B, n)), else the flat draw of ``key`` from row
    ``row0`` on (``core.prng.uniform``)."""
    device = torch.device(device)
    shape = tuple(int(s) for s in shape)
    if device.type == "cpu":
        if ray_ids is None:
            return prng.bits_to_unit(prng.random_bits_plain(key, shape, row0=row0))
        return prng.per_ray_uniform_plain(key, ray_ids, shape[-1])
    if device.type != "cuda":
        raise ValueError(f"threefry_uniform runs on a CUDA or the CPU device, not {device}")
    if ray_ids is None:
        rows, n, ids_ptr = math.prod(shape), 1, None
        offset = row0 * math.prod(shape[1:])
    else:
        if ray_ids.device.type != "cuda" or ray_ids.dim() != 1 or len(shape) != 2 \
                or shape[0] != ray_ids.numel():
            raise ValueError(f"per-ray draws take (B,) ray ids on {device} and a (B, n) shape, "
                             f"got ids {tuple(ray_ids.shape)} on {ray_ids.device}, shape {shape}")
        ray_ids = ray_ids.to(torch.int64).contiguous()
        rows, n, ids_ptr, offset = shape[0], shape[1], ray_ids.data_ptr(), 0
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    k0, k1 = (int(w) for w in torch.as_tensor(key).reshape(2).tolist())
    sms = _sm_count(torch.cuda.current_device() if device.index is None else device.index)
    grid = max(1, min(-(-rows * n // THREADS), sms * FLAT_BLOCKS_PER_SM))
    err = _build.library("prng").aon_threefry_uniform_launch(
        k0, k1, ids_ptr, rows, n, offset, out.data_ptr(), grid,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "threefry_uniform")
    threefry_uniform.launches += 1
    return out


threefry_uniform.launches = 0
