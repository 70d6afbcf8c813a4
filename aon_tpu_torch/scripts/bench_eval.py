"""Eval render latency benchmark: one full 640x480 frame on the card (port of
``scripts/bench_eval.py``).

Two modes:

* default (no args): the REFERENCE-CONTRACT path -- seeded random rays
  (``rng(0)`` unit directions from radius-4 origins), 64 + 128 samples over
  the global [2, 6] interval, no AABB, bf16 weights from a seeded init.
  Prints one JSON line per chunk size:
  ``{"chunk": N, "frame_ms": M, "frames_per_sec": F}``, each chunk edge-padded
  to its static size, after a line with the peak device memory of that chunk's
  frames (``torch.cuda.max_memory_allocated`` above what was allocated before
  them: the frame's own working set).  ``--chunks a,b,...`` picks the chunk
  sizes.

* ``--config configs/quality_...json``: the PRODUCTION path -- the val frame 0
  of the config's single-scene dataset through ``eval/render.py::render_frame``
  as the trainer renders it (AABB per-ray intervals and hit-ray compaction
  when ``use_aabb``, the config's samples and chunk).  Prints
  ``{"mode": "production", "config", "img_wh", "samples", "use_aabb",
  "hit_frac", "chunk", "frame_ms", "frames_per_sec"}``.  The chunk is the
  config's, as the JAX script takes it off the TPU.

Timing: one warm frame, then 3 (reference) or 5 (production) timed frames,
each ended by a readback of the frame's last chunk (reference) or the frame
on the host (production).  The first line names the card and its power limit.

    python -m aon_tpu_torch.scripts.bench_eval [--chunks 30720,61440] [--config CFG]

Runs on ``cuda``; ``main(argv, device="cpu")`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from aon_tpu_torch.data import dataset_dict
from aon_tpu_torch.eval.render import render_frame
from aon_tpu_torch.train.systems import VanillaSystem, build_system
from aon_tpu_torch.utils.config import Config, get_config
from aon_tpu_torch.utils.device import DeviceLike, card_name, resolve_device

REFERENCE_WH = (640, 480)
REFERENCE_CHUNKS = (30720, 61440, 153600, 307200)
REFERENCE_REPS, PRODUCTION_REPS = 3, 5


def reference_frame(w: int = REFERENCE_WH[0], h: int = REFERENCE_WH[1]) -> Dict[str, np.ndarray]:
    """The contract's rays: ``rng(0)`` unit directions, origins at -4 d."""
    g = np.random.default_rng(0)
    d = g.normal(size=(w * h, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d}


def chunk_pieces(rays: Dict[str, torch.Tensor], chunk: int) -> List[Dict[str, torch.Tensor]]:
    """The frame in ``chunk``-ray pieces, the last edge-padded to ``chunk``."""
    n = rays["rays_o"].shape[0]
    pieces = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        piece = {k: v[lo:hi] for k, v in rays.items()}
        if hi - lo < chunk:
            piece = {k: torch.cat([v, v[-1:].expand(chunk - (hi - lo), *v.shape[1:])])
                     for k, v in piece.items()}
        pieces.append(piece)
    return pieces


def _reset_peak(device: torch.device) -> Optional[int]:
    """Start a peak-memory window: the bytes allocated at its start (None on the CPU)."""
    if device.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peak_since(device: torch.device, base: Optional[int]) -> Optional[int]:
    """The most device memory held at once in the window above its start."""
    return None if base is None else torch.cuda.max_memory_allocated(device) - base


def _line(rec: dict) -> str:
    """A record as the JAX script prints it (times rounded as it rounds them)."""
    return json.dumps(dict(rec, frame_ms=round(rec["frame_ms"], 1),
                           frames_per_sec=round(rec["frames_per_sec"], 2)))


def bench_reference_contract(chunks: Sequence[int] = REFERENCE_CHUNKS,
                             device: DeviceLike = "cuda") -> List[dict]:
    """Frame time at each chunk size; returns one record per chunk with the
    unrounded times and the peak device memory (bytes, None on the CPU)."""
    device = resolve_device(device)
    system = VanillaSystem(Config(compute_dtype="bfloat16"), near=2.0, far=6.0, white_bkgd=True,
                           device=device)
    state = system.init_state(torch.Generator(device=device).manual_seed(0))
    rays = {k: torch.from_numpy(v).to(device) for k, v in reference_frame().items()}
    records = []
    for chunk in chunks:
        pieces = chunk_pieces(rays, chunk)

        def frame():
            return [system.render_chunk(state.params, p)["comp_rgb"] for p in pieces]

        base = _reset_peak(device)
        _ = frame()[-1][0, 0].item()  # warm
        t0 = time.perf_counter()
        for _ in range(REFERENCE_REPS):
            _ = frame()[-1][0, 0].item()  # forced readback
        dt = (time.perf_counter() - t0) / REFERENCE_REPS
        peak = _peak_since(device, base)
        print(json.dumps({"chunk": chunk, "peak_device_bytes": peak}), flush=True)
        rec = {"chunk": chunk, "frame_ms": dt * 1e3, "frames_per_sec": 1.0 / dt}
        print(_line(rec), flush=True)
        records.append(dict(rec, peak_device_bytes=peak, pieces=len(pieces)))
    return records


def bench_production(cfg: Config, device: DeviceLike = "cuda") -> dict:
    """The trainer's eval path on the config's dataset (seeded random weights:
    with AABB compaction the latency depends on the scene's geometry, not on
    the fit).  Returns the printed record unrounded, with the frame's length
    and the peak device memory."""
    device = resolve_device(device)
    ds = dataset_dict[cfg.dataset_name](
        split="val", root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh),
        white_back=cfg.white_back, use_aabb=cfg.use_aabb, aabb_pad=cfg.aabb_pad,
        use_occgrid=cfg.use_occgrid, occgrid_res=cfg.occgrid_res,
        occgrid_dilate=cfg.occgrid_dilate,
    )
    if not hasattr(ds, "full_frame"):
        raise SystemExit(
            "--config production mode drives single-scene (sapien) datasets; "
            "articulated eval frames are 320x240 (reference README.md:105) — "
            "far below the 640x480 latency budget this benchmark measures"
        )
    system = build_system(cfg, ds.near, ds.far, cfg.white_back, device=device)
    state = system.init_state(torch.Generator(device=device).manual_seed(0))
    frame = ds.full_frame(0)
    n = frame["rays_o"].shape[0]
    hit_frac = float(np.mean(frame["hit"])) if "hit" in frame else 1.0
    chunk = cfg.chunk
    miss_fill = None
    if "hit" in frame:
        bg = 1.0 if cfg.white_back else 0.0
        miss_fill = {"comp_rgb": bg, "acc": 0.0, "depth": 0.0}

    def run():
        return render_frame(lambda rays: system.render_chunk(state.params, rays), frame, chunk,
                            miss_fill=miss_fill, device=device)

    base = _reset_peak(device)
    out = run()  # warm
    assert out["comp_rgb"].shape[0] == n
    t0 = time.perf_counter()
    for _ in range(PRODUCTION_REPS):
        out = run()
        _ = float(out["comp_rgb"][0, 0])  # render_frame returns host numpy
    dt = (time.perf_counter() - t0) / PRODUCTION_REPS
    peak = _peak_since(device, base)
    print(json.dumps({"mode": "production", "peak_device_bytes": peak}), flush=True)
    rec = {"mode": "production", "config": cfg.config, "img_wh": list(cfg.img_wh),
           "samples": [cfg.N_samples, cfg.N_importance], "use_aabb": bool(cfg.use_aabb),
           "hit_frac": hit_frac, "chunk": chunk, "frame_ms": dt * 1e3,
           "frames_per_sec": 1.0 / dt}
    print(_line(dict(rec, hit_frac=round(hit_frac, 4))), flush=True)
    return dict(rec, n_rays=n, peak_device_bytes=peak, comp_rgb=out["comp_rgb"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default=None,
                    help="comma-separated chunk sizes of the reference contract")
    return ap


def main(argv: Optional[List[str]] = None, device: DeviceLike = "cuda"):
    """``--config`` (with the CLI's config flags) runs the production mode and
    returns its record; otherwise the reference contract's records."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    print(json.dumps({"card": card_name(device)}), flush=True)
    if any(a.startswith("--config") for a in argv):
        return bench_production(get_config(argv), device)
    args = build_parser().parse_args(argv)
    chunks = tuple(int(c) for c in args.chunks.split(",")) if args.chunks else REFERENCE_CHUNKS
    return bench_reference_contract(chunks, device)


if __name__ == "__main__":
    main()
