"""The port's runner: ``run.py``'s CLI surface on one CUDA device.

    python -m aon_tpu_torch.run --config configs/quality_laptop_vanilla_refsched_occ16.json [flags]
    python -m aon_tpu_torch.run --config <cfg> --ckpt_path last.ckpt          # resume
    python -m aon_tpu_torch.run --config <cfg> --run_eval --render_name X     # evaluate

The flags and JSON configs are ``run.py``'s (``utils/config.py::get_config``),
and so is the output layout: ``{output_path}/{exp_name}/`` holds
``metrics.jsonl``, ``val_images/``, ``index.json``, ``last.ckpt`` and the
ranked ``epoch=N.ckpt``; ``--run_eval --render_name X`` writes
``ckpts/{exp_name}/X/image*.jpg`` and ``depth*.jpg`` and
``ckpts/{exp_name}/results.json`` under the working directory.  The port's
checkpoints are ``torch.save`` files (``train/checkpoint.py``).

Runs on ``cuda``; ``main(cfg, device="cpu")`` runs the plain PyTorch path.
"""

from __future__ import annotations

import torch

from aon_tpu_torch.train.trainer import Trainer
from aon_tpu_torch.utils.config import Config, get_config
from aon_tpu_torch.utils.device import DeviceLike


def main(cfg: Config, device: DeviceLike = "cuda") -> Trainer:
    """Fit (resuming from ``cfg.ckpt_path`` when it is set) or, with
    ``cfg.run_eval``, evaluate; returns the trainer."""
    if cfg.debug_nans:  # the analogue of jax_debug_nans
        torch.autograd.set_detect_anomaly(True)
    trainer = Trainer(cfg, device=device)
    if cfg.run_eval:
        trainer.test()
    else:
        trainer.fit(resume=cfg.ckpt_path is not None)
    return trainer


if __name__ == "__main__":
    main(get_config())
