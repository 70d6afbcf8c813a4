"""Ranks and ray blocks (port of ``aon_tpu/parallel/mesh.py``).

The JAX package runs one process over a 1-D device mesh with the ray batch
sharded on its "data" axis.  The PyTorch idiom is one process per GPU
(``torch.distributed``), with the mesh's semantics:

* each rank owns a contiguous block of every ray entry (``RAY_KEYS``); in a
  stacked ``(k, m, ...)`` batch, a contiguous block of every microbatch, as
  the mesh shards the microbatch axis;
* every other entry (``instance_id``, ``src_imgs``, ``deg``, the ramps) is
  replicated;
* the parameters are replicated and every rank applies the same all-reduced
  update (``train/microbatch.py::make_train_many_sharded``).

A process group of ``None`` is one process: every helper then does what it
did before there were ranks.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from aon_tpu_torch.utils.device import DeviceLike, resolve_device

# Batch entries with a leading per-ray axis (split over the ranks).  The
# classification is by key, not by shape: a shape test misfiles e.g. a
# (1, 3, H, W) src_imgs over one rank.
RAY_KEYS = (
    "rays_o", "rays_d", "viewdirs", "target", "instance_mask", "radii",
    "ray_ids", "t_near", "t_far", "hit", "loss_w",
)

# a rendezvous that does not complete within this raises
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def _is_ray_entry(k: str, v: np.ndarray, n_dev: int) -> bool:
    if k not in RAY_KEYS:
        return False
    if v.ndim < 1 or v.shape[0] % n_dev != 0 or v.shape[0] < n_dev:
        raise ValueError(f"ray entry '{k}' has batch axis {v.shape} not shardable over "
                         f"{n_dev} devices")
    return True


def maybe_initialize_distributed(device: DeviceLike = "cuda") -> torch.device:
    """Join the process group when launched as one rank of several, and
    return this rank's device.

    With ``AON_DISTRIBUTED=1``, ``torch.distributed.init_process_group`` reads
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` from the
    environment (``python -m torch.distributed.run`` sets them), on NCCL for
    ``cuda`` and gloo for ``cpu``; the rank's device is ``cuda:LOCAL_RANK``.
    A rendezvous that fails raises.  Without it the process runs alone on
    ``device``, and a ``WORLD_SIZE`` above 1 raises rather than letting every
    rank train alone.
    """
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if os.environ.get("AON_DISTRIBUTED", "0") != "1":
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE={world} but AON_DISTRIBUTED is not 1: every rank "
                               "would train alone; set AON_DISTRIBUTED=1")
        return resolve_device(device)
    if device.type == "cuda":
        device = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", timeout=RENDEZVOUS_TIMEOUT)
    return device


def get_group(n_devices: int = 0) -> Optional[dist.ProcessGroup]:
    """The data-parallel group: every rank, or None in a process that runs
    alone.  ``n_devices`` (``cfg.num_devices``; 0 means all ranks) must be the
    world size: a run never quietly trains on fewer ranks than it asked for."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices not in (0, world):
        raise ValueError(f"num_devices={n_devices} but the world size is {world} "
                         "(launch one rank per device, or set num_devices=0)")
    return dist.group.WORLD if world > 1 else None


def rank_of(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def size_of(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def comm_device(group: Optional[dist.ProcessGroup], device: torch.device) -> torch.device:
    """Where a collective's tensors must lie: on the rank's card for NCCL, on
    the host for gloo (which gathers no CUDA tensors)."""
    if group is not None and dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")


def all_reduce_mean(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]
                    ) -> list:
    """The mean over the ranks of each tensor, in one all-reduce of their
    float32 concatenation; each comes back in its own dtype and device."""
    if group is None:
        return list(tensors)
    device = tensors[0].device
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = flat.to(comm_device(group, device))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = (flat / size_of(group)).to(device)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum over the ranks of ``x`` (``x`` itself without a group)."""
    if group is None:
        return x
    y = x.detach().to(comm_device(group, x.device), torch.float32).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device, x.dtype)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad ``axis`` up to a multiple by repeating the last row.

    Eval frames (e.g. 640*480 = 307,200 rays) pad to a whole number of chunks
    and, over several ranks, of rank blocks."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width, mode="edge")


def _rank_block(v: np.ndarray, axis: int, rank: int, world: int) -> np.ndarray:
    """The ``rank``-th of ``world`` contiguous blocks of ``axis``."""
    per = v.shape[axis] // world
    return np.take(v, np.arange(rank * per, (rank + 1) * per), axis=axis)


def stack_step_batches(batches: Sequence[Mapping[str, np.ndarray]],
                       microbatch: Optional[int] = None,
                       device: DeviceLike = "cuda",
                       group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """Stack T host batches into one superbatch for ``train_many``.

    Ray entries become (T, k, m, ...) with m = ``microbatch`` (the whole
    batch if None, or if it is larger), of which this rank keeps its
    contiguous block of every microbatch, (T, k, m / world, ...); every other
    entry becomes (T, ...), the same on every rank.  Raises where the batch
    axis is not a multiple of m, or m not of the world size.
    """
    device = resolve_device(device)
    rank, world = rank_of(group), size_of(group)
    out = {}
    for k in batches[0]:
        vs = np.stack([np.asarray(b[k]) for b in batches])
        if _is_ray_entry(k, vs[0], world):
            n = vs.shape[1]
            m = min(microbatch or n, n)
            if n % m != 0:
                raise ValueError(f"batch axis {n} not divisible by microbatch {m} ({k})")
            vs = vs.reshape(len(batches), n // m, m, *vs.shape[2:])
            _is_ray_entry(k, vs[0, 0], world)
            vs = _rank_block(vs, 2, rank, world)
        out[k] = torch.from_numpy(np.ascontiguousarray(vs)).to(device)
    return out


def shard_ray_batch(batch: Mapping[str, np.ndarray],
                    microbatch: Optional[int] = None,
                    device: DeviceLike = "cuda",
                    group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """One host batch on ``device`` with this rank's block of its rays.

    Ray entries keep this rank's contiguous block of axis 0, or, with
    ``microbatch``, are reshaped to (k, microbatch, ...) first and keep their
    block of every microbatch; every other entry is replicated."""
    stacked = stack_step_batches([batch], microbatch, device, group)
    if microbatch is None:
        return {k: (v[0, 0] if k in RAY_KEYS else v[0]) for k, v in stacked.items()}
    return {k: v[0] for k, v in stacked.items()}
