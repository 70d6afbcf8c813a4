"""Multi-process eval-frame assembly (port of ``aon_tpu/parallel/multihost.py``).

The reference assembles eval outputs across DDP ranks with Lightning's
``all_gather`` in ``alter_gather_cat`` (``models/interface.py:31-51``).
Here each rank renders a contiguous block of the frame's rays
(``process_ray_slice``) and ``alter_gather_cat`` concatenates its chunk
outputs, all-gathers the blocks and reshapes them to images: contiguous
blocks keep the gather a plain concatenation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aon_tpu_torch.parallel.mesh import comm_device, rank_of, size_of


def process_ray_slice(n_rays: int, process_id: Optional[int] = None,
                      process_count: Optional[int] = None,
                      group: Optional[dist.ProcessGroup] = None) -> Tuple[int, int]:
    """[start, stop) of this rank's equal-size ray block.

    Blocks are ceil(n/p) long; the last rank's block may run past
    ``n_rays``: render it against an edge-padded ray buffer
    (``pad_to_multiple``) and ``alter_gather_cat`` trims the tail.  The rank
    and count default to ``group``'s.
    """
    pc = process_count if process_count is not None else size_of(group)
    pid = process_id if process_id is not None else rank_of(group)
    per = -(-n_rays // pc)
    return pid * per, (pid + 1) * per


def gather_blocks(v: np.ndarray, group: Optional[dist.ProcessGroup],
                  device: Optional[torch.device] = None) -> np.ndarray:
    """Every rank's equal-length block of ``v`` concatenated in rank order
    (``v`` itself without a group)."""
    if group is None:
        return v
    t = torch.from_numpy(np.ascontiguousarray(v)).to(
        comm_device(group, device or torch.device("cpu")))
    parts = [torch.empty_like(t) for _ in range(size_of(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, 0).cpu().numpy()


def alter_gather_cat(chunk_outputs: List[Dict[str, np.ndarray]], img_wh: Tuple[int, int],
                     group: Optional[dist.ProcessGroup] = None,
                     device: Optional[torch.device] = None) -> Dict[str, np.ndarray]:
    """Concatenate per key over chunks, all-gather over the ranks, reshape to
    (h, w, C) images (reference interface.py:31-51).

    Every rank returns the same assembled frame, as Lightning's all_gather
    does, so gating on rank 0 stays a logging concern.  ``device`` is the
    rank's card, where an NCCL group gathers.
    """
    w, h = int(img_wh[0]), int(img_wh[1])
    out = {}
    for k in chunk_outputs[0]:
        v = np.concatenate([np.asarray(c[k]) for c in chunk_outputs], axis=0)
        v = gather_blocks(v, group, device)[: h * w]
        out[k] = v.reshape(h, w, *v.shape[1:]) if v.ndim > 1 else v.reshape(h, w)
    return out
