"""Metric logging front-end over pluggable sinks (port of
``aon_tpu/train/logging.py``; val images written by ``utils/imageio.py``).

Reference metric names preserved (SURVEY.md §5): train/psnr0, train/psnr1,
train/loss, train/loss/reg, train/lr, val/psnr, val/psnr_obj,
test/{psnr,ssim,lpips,psnr_obj}, val/state_error_rad.  The reference routes
these to wandb (run.py:12,75; utils/train_helper.py:138-159); here the sink
set is explicit: jsonl + stdout always by default (the committed-evidence
formats), wandb when WANDB_PROJECT is set, tensorboard on request —
``Config.metric_sinks`` selects, ``sinks.register_sink`` extends.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from aon_tpu_torch.train.sinks import StdoutSink, WandbSink, make_sink
from aon_tpu_torch.utils.imageio import write_png


class MetricLogger:
    def __init__(self, logdir: str, stdout_every: int = 50,
                 sinks: Optional[Sequence[str]] = None):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")  # back-compat attr
        self._t0 = time.time()
        names = list(sinks) if sinks else ["jsonl", "stdout"]
        if "wandb" not in names and os.environ.get("WANDB_PROJECT"):
            names.append("wandb")
        self._sinks = [
            make_sink(n, logdir, every=stdout_every) if n == "stdout"
            else make_sink(n, logdir)
            for n in names
        ]

    def log(self, step: int, metrics: Dict[str, float], force_stdout: bool = False) -> None:
        rec = {"step": int(step), "time": time.time() - self._t0}
        for k, v in metrics.items():
            try:
                rec[k] = float(np.asarray(v))
            except (TypeError, ValueError):
                rec[k] = v
        for s in self._sinks:
            r = dict(rec)
            if force_stdout and isinstance(s, StdoutSink):
                r["_force_stdout"] = True
            s.log_scalars(step, r)

    def log_image(self, step: int, tag: str, image: np.ndarray, logdir: str) -> str:
        imgdir = os.path.join(logdir, "val_images")
        os.makedirs(imgdir, exist_ok=True)
        path = os.path.join(imgdir, f"{tag.replace('/', '_')}_{step}.png")
        write_png(path, (np.clip(image, 0, 1) * 255).astype(np.uint8))
        for s in self._sinks:
            s.log_image(step, tag, path)
        return path

    def close(self):
        for s in self._sinks:
            s.close()


# re-export for back-compat with external imports
__all__ = ["MetricLogger", "StdoutSink", "WandbSink"]
