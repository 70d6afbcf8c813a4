"""Full-frame rendering in fixed-size chunks (port of ``aon_tpu/eval/render.py``).

Rays are padded (edge mode) to a whole number of chunks, rendered chunk by
chunk on one device, and the padded tail is dropped.  A 640x480 frame at
``chunk=61440`` is five calls.

AABB path: when the frame carries a per-ray ``hit`` mask and ``miss_fill`` is
given, only hit rays go through the model; missed rays take their fill value,
and per-ray outputs with no listed fill take NaN (0 for integer outputs).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from aon_tpu_torch.utils.device import DeviceLike, resolve_device

# per-ray frame entries forwarded to the renderer when present
_RAY_INPUT_KEYS = ("rays_o", "rays_d", "viewdirs", "t_near", "t_far")


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad ``axis`` up to a multiple by repeating the last row (copy of
    ``aon_tpu/parallel/mesh.py::pad_to_multiple``)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width, mode="edge")


def _render_rays(
    render_chunk: Callable, rays_in: Dict[str, np.ndarray], chunk: int,
    device: torch.device, **extra,
) -> Dict[str, np.ndarray]:
    n = rays_in["rays_o"].shape[0]
    chunk = max(8, (chunk + 7) // 8 * 8)
    rays_full = {
        k: torch.from_numpy(np.ascontiguousarray(pad_to_multiple(v, chunk))).to(device)
        for k, v in rays_in.items()
    }
    n_pad = rays_full["rays_o"].shape[0]

    outs: Dict[str, list] = {}
    for i in range(0, n_pad, chunk):
        res = render_chunk({k: v[i : i + chunk] for k, v in rays_full.items()}, **extra)
        for k, v in res.items():
            outs.setdefault(k, []).append(v)
    return {
        k: (torch.cat(v, 0)[:n] if v[0].ndim >= 1 and v[0].shape[0] == chunk
            else torch.cat([torch.atleast_1d(x) for x in v], 0)).cpu().numpy()
        for k, v in outs.items()
    }


def render_frame(
    render_chunk: Callable,
    frame: Dict[str, np.ndarray],
    chunk: int,
    miss_fill: Optional[Dict[str, float]] = None,
    device: DeviceLike = "cuda",
    **extra,
) -> Dict[str, np.ndarray]:
    """Render all rays of one frame.

    Args:
      render_chunk: fn(rays_dict, **extra) -> dict of per-ray output tensors.
      frame: host dict with rays_o/rays_d/viewdirs (N, 3) [+ t_near/t_far/hit].
      chunk: rays per call, rounded up to a multiple of 8.
      miss_fill: per-output fill value for rays with ``frame["hit"] == False``;
        enables the AABB compaction path (only hit rays are rendered).
      device: where the chunks are rendered.
      extra: per-frame arguments handed to every ``render_chunk`` call as they
        are (the auto-decoder's ``instance_id``, ``articulation_id`` and
        ``is_test``).

    Returns host numpy arrays.
    """
    device = resolve_device(device)
    rays_in = {k: np.asarray(frame[k]) for k in _RAY_INPUT_KEYS if k in frame}
    n = rays_in["rays_o"].shape[0]

    if miss_fill is None or "hit" not in frame:
        return _render_rays(render_chunk, rays_in, chunk, device, **extra)

    sel = np.flatnonzero(np.asarray(frame["hit"]))
    proto = _render_rays(
        render_chunk, {k: v[sel] for k, v in rays_in.items()}, chunk, device, **extra
    ) if len(sel) else {}
    outs: Dict[str, np.ndarray] = {}
    for k, v in proto.items():
        if v.ndim >= 1 and v.shape[0] == len(sel):  # per-ray output: scatter
            # no explicit miss value -> NaN, not 0: a 0-fill would shrink
            # whole-frame means by the hit fraction
            default = np.nan if np.issubdtype(v.dtype, np.floating) else 0
            full = np.full((n, *v.shape[1:]), miss_fill.get(k, default), v.dtype)
            full[sel] = v
            outs[k] = full
        else:  # per-frame output: pass through
            outs[k] = v
    if not outs:  # frame entirely misses the box
        outs = {
            k: np.full((n, 3) if k == "comp_rgb" else (n,), f, np.float32)
            for k, f in miss_fill.items()
        }
    return outs
