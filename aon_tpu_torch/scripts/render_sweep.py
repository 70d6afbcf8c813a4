"""Fixed-camera articulation sweep from a trained auto-decoder checkpoint
(port of ``scripts/render_sweep.py``).

The reference's README demo GIFs show the object articulating under a held
camera (the test split instead moves the camera AND the articulation
together, reference sapien_multi.py:438-479).  This renders one camera pose
across the full interpolated latent table — 2N-1 articulation ids: even =
train codes, odd = midpoints (reference model_autodecoder.py latent
interpolation) — and writes ``ckpts/{exp_name}/{out}/sweep*.jpg`` and a video
(``eval/artifacts.py::store_video``) under the working directory.

The state is restored from ``{output_path}/{exp_name}/{--ckpt}``
(``train.checkpoint``).  Runs on ``cuda``; ``main(argv, device="cpu")`` runs
the plain PyTorch path.

Usage:
  python -m aon_tpu_torch.scripts.render_sweep --config configs/quality_laptop_autodec.json \\
      [--ckpt last.ckpt] [--image_id 0] [--instance 0] [--out sweep] [--fps 8]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from aon_tpu_torch.eval.artifacts import store_image, store_video
from aon_tpu_torch.train.trainer import Trainer
from aon_tpu_torch.utils.config import get_config
from aon_tpu_torch.utils.device import DeviceLike


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="articulation sweep under a held camera")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default="last.ckpt")
    ap.add_argument("--image_id", type=int, default=0, help="camera frame (0_degree split)")
    ap.add_argument("--instance", type=int, default=0)
    ap.add_argument("--out", default="sweep")
    ap.add_argument("--fps", type=int, default=8)
    return ap


def main(argv=None, device: DeviceLike = "cuda") -> dict:
    """Render the sweep; returns ``{"out_dir", "frames" (list of (h, w, 3)),
    "video"}`` (``video`` None where no mp4 encoder imports)."""
    args = build_parser().parse_args(argv)
    cfg = get_config(["--config", args.config])
    if cfg.exp_type != "vanilla_autodecoder":
        raise SystemExit("articulation sweeps need exp_type=vanilla_autodecoder")
    cfg.run_eval = True
    cfg.render_name = args.out

    trainer = Trainer(cfg, device=device)
    trainer.state = trainer.ckpt.restore(trainer.state, args.ckpt)
    ds = trainer.test_dataset
    instance = args.instance % len(ds.ids)
    instance_dir = ds.ids[instance]
    rays_o, viewdirs, rays_d, img, seg, aabb = ds._read_frame(
        instance_dir, "0_degree", args.image_id)
    frame = ds._to_sample(rays_o, viewdirs, rays_d, img, seg, aabb=aabb)
    frame["instance_id"] = np.int32(instance)
    frame["img_wh"] = np.array(ds.img_wh)

    n_ids = 2 * len(ds._degree_dirs(instance_dir)) - 1
    w, h = ds.img_wh
    rgbs = []
    for art_id in range(n_ids):
        frame["articulation_id"] = np.int32(art_id)
        ret = trainer._render_full(trainer.state.params, frame, is_test=True)
        rgbs.append(np.asarray(ret["comp_rgb"]).reshape(h, w, 3))
        print(f"rendered articulation {art_id + 1}/{n_ids}", flush=True)

    out_dir = os.path.join("ckpts", cfg.exp_name, args.out)
    store_image(out_dir, rgbs, "sweep")
    video = store_video(out_dir, rgbs, fps=args.fps)
    print(f"wrote {n_ids} frames under {out_dir}" + (f" + {video}" if video else ""))
    return {"out_dir": out_dir, "frames": rgbs, "video": video}


if __name__ == "__main__":
    main()
