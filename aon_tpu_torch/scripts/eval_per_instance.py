"""Per-instance test sweep for multi-instance (N_max_objs > 1) scenes (port
of ``scripts/eval_per_instance.py``).

The reference's test path evaluates ONE seeded instance per sweep
(``sapien_multi.py`` test split picks a random ``val_idx``); for the
latent-capacity evidence (e.g. the 4-instance laptop scene) this scores the
19-frame spheric sweep separately for EVERY instance in the code library.
Writes ``ckpts/<exp_name>/per_instance.json`` under the working directory::

    {"instances": [{"instance": 0, "id": ..., "PSNR": ..., "PSNR_obj": ...,
                    "SSIM": ..., "each": [...]}, ...],
     "interp": {"learned_mean": ..., "interp_mean": ...,
                "adjacent_abs_dpsnr_mean": ...}}

The state is restored from ``{output_path}/{exp_name}/{ckpt_path}``.  Runs on
``cuda``; ``main(argv, device="cpu")`` runs the plain PyTorch path.

Usage:
    python -m aon_tpu_torch.scripts.eval_per_instance --config configs/quality_laptop4_autodec.json
"""

from __future__ import annotations

import json
import os

import numpy as np

from aon_tpu_torch.eval import metrics as M
from aon_tpu_torch.train.trainer import Trainer
from aon_tpu_torch.utils.config import get_config
from aon_tpu_torch.utils.device import DeviceLike


def main(argv=None, device: DeviceLike = "cuda") -> dict:
    """Score every instance's sweep; returns what ``per_instance.json`` holds."""
    cfg = get_config(argv)
    cfg.run_eval = True
    trainer = Trainer(cfg, device=device)
    trainer.state = trainer.ckpt.restore(trainer.state, cfg.ckpt_path)
    ds = trainer.test_dataset
    n_frames = len(ds)
    w, h = cfg.img_wh
    rows = []
    for inst in range(len(ds.ids)):
        psnrs, objs, ssims = [], [], []
        for i in range(n_frames):
            frame = ds.test_frame(i, seed=cfg.seed, instance=inst)
            ret = trainer._render_full(trainer.state.params, frame, is_test=True)
            pred = ret["comp_rgb"].reshape(h, w, 3)
            tgt = np.asarray(frame["target"]).reshape(h, w, 3)
            msk = np.asarray(frame["instance_mask"]).reshape(h, w)
            psnrs.append(M.psnr(pred, tgt))
            objs.append(M.psnr_masked(pred, tgt, msk))
            ssims.append(M.ssim(pred, tgt))
        rows.append({
            "instance": inst,
            "id": str(ds.ids[inst]),
            "PSNR": float(np.mean(psnrs)),
            "PSNR_obj": float(np.nanmean(objs)),
            "SSIM": float(np.mean(ssims)),
            "each": [float(v) for v in psnrs],
        })
        print(f"instance {inst} ({ds.ids[inst]}): PSNR {rows[-1]['PSNR']:.2f} "
              f"obj {rows[-1]['PSNR_obj']:.2f} SSIM {rows[-1]['SSIM']:.4f}", flush=True)
    # interpolation smoothness: even frames use LEARNED articulation codes
    # (trained degrees 0, 10, .., 90 at 5 degrees a frame), odd ones the 2N-1
    # midpoint-interpolated codes
    all_each = np.array([r["each"] for r in rows])
    out = {
        "instances": rows,
        "interp": {
            "learned_mean": float(all_each[:, ::2].mean()),
            "interp_mean": float(all_each[:, 1::2].mean()),
            "adjacent_abs_dpsnr_mean": float(np.abs(np.diff(all_each, axis=1)).mean()),
        },
    }
    path = os.path.join("ckpts", cfg.exp_name, "per_instance.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
