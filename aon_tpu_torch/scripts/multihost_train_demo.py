"""Multi-process data-parallel training, checked against one process (port of
``scripts/multihost_train_demo.py``).

The reference's primary training mode is multi-process DDP, one process per
GPU with an NCCL gradient all-reduce (``run.py:109,129,151``).  The port's is
the same: ``torch.distributed`` ranks, each training on its block of every
batch's rays, the gradients all-reduced before the one update that every
rank applies (``train/microbatch.py::make_train_many_sharded``).

This demo trains any of the three systems for a few steps on one fixed
seeded batch, on one process or on N ranks, and writes the final loss, the
parameters (flat, float32, in name order), their digest (the sum of their
magnitudes) and each step's seconds.  N ranks reach the one process's loss
and parameters:

    # one process
    python -m aon_tpu_torch.scripts.multihost_train_demo --system ae --device cpu --out /tmp/t_single.npz
    # 2 ranks (gloo on the CPU)
    python -m aon_tpu_torch.scripts.multihost_train_demo --system ae --device cpu --num_processes 2 --process_id 0 --out /tmp/t_p0.npz &
    python -m aon_tpu_torch.scripts.multihost_train_demo --system ae --device cpu --num_processes 2 --process_id 1 --out /tmp/t_p1.npz

What crosses the ranks, by system:
  vanilla      the MLPs' gradients of each rank's rays;
  autodecoder  the code tables' rows (one optimizer over model + codes);
  ae           the ResNet-34 encoder's, the degree table's and the
               joint-state head's gradients, and the masked-MSE denominator,
               which spans every rank's rays (model_ae_art.py:380-387).

Without ``--config`` the systems are the JAX demo's (4 + 4 samples, float32,
the plain route, 48x48 source images); with it, the config's widths,
samples, dtype, route and rays per step.  ``--backend`` joins a process group
even of one rank (NCCL on one card, say); by default one process joins none,
N ranks join over NCCL on ``cuda`` and gloo on ``cpu``.  ``--timed_steps N``
adds N steps under ``torch.profiler``: their seconds and the device's idle
share.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from aon_tpu_torch.core import prng
from aon_tpu_torch.parallel.mesh import RENDEZVOUS_TIMEOUT, stack_step_batches
from aon_tpu_torch.train.systems import build_system
from aon_tpu_torch.utils.config import Config, get_config
from aon_tpu_torch.utils.device import resolve_device
from aon_tpu_torch.utils.profiling import device_idle

EXP_TYPES = {"vanilla": "vanilla", "autodecoder": "vanilla_autodecoder", "ae": "vanilla_ae_art"}


def join_group(args, device: torch.device) -> Optional[dist.ProcessGroup]:
    """The process group of ``--num_processes`` ranks (None: one process and
    no ``--backend``), or the one this process has joined already.  A
    rendezvous that fails raises."""
    if args.num_processes == 1 and args.backend is None:
        return None
    if not dist.is_initialized():
        backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_processes, rank=args.process_id,
                                timeout=RENDEZVOUS_TIMEOUT)
    return dist.group.WORLD


def demo_config(system: str, config: Optional[str]) -> Config:
    if config:
        cfg = get_config(["--config", config])
        cfg.exp_type = EXP_TYPES[system]
        return cfg
    return Config(exp_type=EXP_TYPES[system], N_samples=4, N_importance=4,
                  compute_dtype="float32", use_pallas=False, N_max_objs=4, img_wh=[48, 48])


def demo_batch(system: str, cfg: Config, n_rays: int) -> dict:
    """The one seeded batch every rank reads whole (the JAX demo's)."""
    g = np.random.default_rng(0)
    d = g.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d,
             "target": g.uniform(size=(n_rays, 3)).astype(np.float32)}
    if system == "autodecoder":  # every rank's rays reach the same code rows
        batch["instance_id"] = np.asarray(1, np.int32)
        batch["articulation_id"] = np.asarray(2, np.int32)
    elif system == "ae":
        w, h = cfg.img_wh
        batch["src_imgs"] = g.normal(size=(1, 3, h, w)).astype(np.float32)
        batch["deg"] = np.asarray(0.7, np.float32)  # ~40 degrees
        batch["instance_mask"] = (g.uniform(size=(n_rays,)) > 0.5).astype(np.float32)
    return batch


def train(system: str, cfg: Config, n_rays: int, steps: int, device: torch.device,
          group: Optional[dist.ProcessGroup], timed_steps: int = 0) -> dict:
    """``steps`` steps of ``system`` on the demo batch, each through
    ``train_many`` with the JAX demo's key ``fold_in(key 7, i)``, then ``timed_steps`` more
    under ``torch.profiler`` for the step time and the device's idle share
    (the loss and parameters are those after ``steps``); every rank returns
    the same record, but for the times."""
    sys_ = build_system(cfg, near=2.0, far=6.0, white_bkgd=(system == "vanilla"),
                        device=device, group=group)
    state = sys_.init_state(prng.key(0))
    superbatch = stack_step_batches([demo_batch(system, cfg, n_rays)], cfg.microbatch_rays,
                                    device, group)

    def step(state, i):
        t0 = time.perf_counter()
        state, metrics = sys_.train_many(state, superbatch, prng.fold_in(prng.key(7), i))
        loss = float(metrics["train/loss"])  # waits for the step
        return state, loss, time.perf_counter() - t0

    losses, seconds = [], []
    for i in range(steps):
        state, loss, dt = step(state, i)
        losses.append(loss)
        seconds.append(dt)
    names = sorted(state.params)
    flat = torch.cat([state.params[k].detach().float().reshape(-1).cpu() for k in names])
    rec = {"loss": losses[-1], "losses": np.asarray(losses), "params": flat.numpy(),
           "params_digest": float(flat.double().abs().sum()),
           "processes": 1 if group is None else dist.get_world_size(group),
           "step_seconds": np.asarray(seconds)}
    if timed_steps:
        timed = []
        with device_idle(device) as window:
            for i in range(steps, steps + timed_steps):
                state, _, dt = step(state, i)
                timed.append(dt)
        rec.update(timed_step_seconds=np.asarray(timed),
                   **{k: v for k, v in window.items() if v is not None})
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--coordinator", default="localhost:19244", help="host:port of rank 0")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="rays per step (64, or the config's rays per step)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--system", default="vanilla", choices=sorted(EXP_TYPES))
    ap.add_argument("--config", default=None, help="a config whose widths and samples to take")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timed_steps", type=int, default=0,
                    help="steps after --steps timed under torch.profiler")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.index is not None:
        torch.cuda.set_device(device)
    created = not dist.is_initialized()
    group = join_group(args, device)
    try:
        cfg = demo_config(args.system, args.config)
        n_rays = args.batch or (64 if not args.config else
                                cfg.ray_batch_size if cfg.dataset_name == "sapien_multi"
                                else cfg.batch_size)
        rec = train(args.system, cfg, n_rays, args.steps, device, group, args.timed_steps)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    np.savez(args.out, **rec)
    print(f"p{args.process_id}: loss={rec['loss']:.6f} params_digest={rec['params_digest']:.4f} "
          f"processes={rec['processes']}", flush=True)
    return rec


if __name__ == "__main__":
    main()
