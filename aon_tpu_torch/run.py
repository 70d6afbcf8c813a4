"""The port's runner: ``run.py``'s CLI surface on CUDA devices.

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

Data-parallel over N GPUs of one host, one process per GPU:

    AON_DISTRIBUTED=1 python -m torch.distributed.run --nproc_per_node N \
        -m aon_tpu_torch.run --config <cfg> [flags]

Each rank trains on its block of every batch and renders its block of every
eval frame (``parallel/``); rank 0 alone writes the outputs.  On the CPU the
ranks meet over gloo.  ``AON_DEBUG_NANS=1`` (or ``debug_nans``) turns on
autograd's anomaly detection.
"""

from __future__ import annotations

from aon_tpu_torch.parallel.mesh import maybe_initialize_distributed
from aon_tpu_torch.train.trainer import Trainer
from aon_tpu_torch.utils.config import Config, get_config
from aon_tpu_torch.utils.device import DeviceLike
from aon_tpu_torch.utils.profiling import maybe_enable_debug_nans


def main(cfg: Config, device: DeviceLike = "cuda") -> Trainer:
    """Fit (resuming from ``cfg.ckpt_path`` when it is set) or, with
    ``cfg.run_eval``, evaluate; returns the trainer.  Joins the process group
    first where the process is one rank of several (``AON_DISTRIBUTED=1``)."""
    device = maybe_initialize_distributed(device)
    maybe_enable_debug_nans(cfg.debug_nans)
    trainer = Trainer(cfg, device=device)
    if cfg.run_eval:
        trainer.test()
    else:
        trainer.fit(resume=cfg.ckpt_path is not None)
    return trainer


if __name__ == "__main__":
    main(get_config())
