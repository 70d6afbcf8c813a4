"""Training orchestration (port of ``aon_tpu/train/trainer.py`` for the
vanilla NeRF on the single-scene dataset and the auto-decoder on the
multi-instance articulated one).

Reference behavior reproduced (``run.py:86-166``):
  * epochs of ``steps_per_epoch`` batches, hard step cap ``run_max_steps``;
  * validation every ``check_val_every_n_epoch`` epochs over at most
    ``limit_val_batches`` full frames, logging val/psnr and val/psnr_obj and
    a [GT|pred|depth|opacity] grid image;
  * checkpoints: last every epoch + val/psnr-ranked top-k every
    ``ckpt_every_n_epochs``;
  * NaN detection on the host loss (the reference runs Lightning with
    ``detect_anomaly=True``).

Ray batches stream from the host as fixed-shape numpy (the loader's
``np.random.default_rng`` stream, so they are the JAX trainer's bit for bit:
``batch_size`` random rays of the single-scene dataset, or one (instance,
articulation) frame's ``ray_batch_size`` rays of ``sapien_multi``) and
``steps_per_dispatch`` steps at a time go through ``system.train_many``.  The
keys are the JAX trainer's (``aon_tpu/train/trainer.py:193-194``, ``:313``):
``base_key, init_key = split(key(cfg.seed))``, the state from ``init_key``
and the dispatch that starts at ``global_step`` from ``fold_in(base_key,
global_step)``, so a run starts from the JAX run's weights, draws its
uniforms, and does not depend on how its steps were cut into epochs or
calls.  ``profile_dir`` takes a ``utils.profiling.trace`` of the first
trained epoch.

Over several ranks (``torch.distributed``, one process per GPU) every rank
reads the same batch stream and trains on its block of each batch's rays
(``parallel.mesh.stack_step_batches``); the systems all-reduce the
gradients, so every rank holds the same parameters and the same all-reduced
metrics, which the NaN check and the sentinels read.  Every rank renders its
block of each val and test frame and receives the whole frame.  Rank 0 alone
logs and writes the sinks, images, checkpoints and ``results.json``.

Multi-instance runs validate on five seeded train frames and test on the
19-frame spheric sweep, with a video beside the jpgs: the auto-decoder renders
from its interpolated articulation codes, the auto-encoder from the encoding
of each frame's own ground-truth image at the frame's joint angle, and its
validation also logs the joint-state errors ``val/state_error_rad`` and
``val/abs_state_error_deg``.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from aon_tpu_torch.core import prng
from aon_tpu_torch.data import dataset_dict
from aon_tpu_torch.eval import artifacts
from aon_tpu_torch.eval import metrics as M
from aon_tpu_torch.eval.lpips import lpips_weights_kind
from aon_tpu_torch.eval.render import render_frame
from aon_tpu_torch.parallel.mesh import get_group, rank_of, stack_step_batches
from aon_tpu_torch.train.checkpoint import CheckpointManager
from aon_tpu_torch.train.logging import MetricLogger
from aon_tpu_torch.train.systems import build_system
from aon_tpu_torch.utils import profiling
from aon_tpu_torch.utils.config import Config
from aon_tpu_torch.utils.device import DeviceLike, resolve_device
from aon_tpu_torch.utils.viz import val_grid


class TrainingCollapsed(RuntimeError):
    """The model has collapsed to a constant render; resuming is useless."""


class TrainingPlateaued(RuntimeError):
    """Val quality has stalled below the configured floor; resuming is useless."""


class CollapseSentinel:
    """Abort hopeless runs instead of burning unattended device time.

    A collapsed NeRF renders pure background on the seed-fixed val frames, so
    the full-precision val/psnr mean repeats BIT-IDENTICALLY epoch after
    epoch; a healthy run never repeats it even once.  ``limit`` consecutive
    equal values raise :class:`TrainingCollapsed` — deliberately not the
    watchdog's exit code: a relaunch would restore the same dead basin from
    last.ckpt.
    """

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._prev: Optional[float] = None
        self._run = 1  # length of the current equal-value run

    def update(self, val_psnr: float, step: int) -> None:
        if self.limit <= 0:
            return
        self._run = self._run + 1 if val_psnr == self._prev else 1
        self._prev = val_psnr
        if self._run >= self.limit:
            raise TrainingCollapsed(
                f"val/psnr bit-identical ({val_psnr:.6f} dB) for {self._run} "
                f"consecutive val epochs (through step {step}): the model has "
                "collapsed to a constant render. Aborting — do NOT resume "
                "from last.ckpt; restart with a gentler interval anneal "
                "(aabb_warmup_steps) or wider intervals."
            )


class PlateauSentinel:
    """Catch the collapse sentinel's blind spot: slow-drift plateaus.

    Tracks the best val/psnr seen; once past ``start_step``, if the best
    improves by less than ``eps_db`` across ``epochs`` consecutive val epochs
    while still below ``floor_psnr``, it warns — and raises
    :class:`TrainingPlateaued` when ``abort`` is set (non-resumable by design,
    like TrainingCollapsed).  ``epochs <= 0`` disables.
    """

    def __init__(self, epochs: int, eps_db: float = 0.3, floor_psnr: float = 25.0,
                 start_step: int = 0, abort: bool = False):
        self.epochs = int(epochs)
        self.eps_db = float(eps_db)
        self.floor_psnr = float(floor_psnr)
        self.start_step = int(start_step)
        self.abort = bool(abort)
        self._bests: list = []  # best-so-far val/psnr after each counted epoch

    def update(self, val_psnr: float, step: int) -> None:
        if self.epochs <= 0 or step < self.start_step:
            return
        best = max(self._bests[-1] if self._bests else -float("inf"), val_psnr)
        self._bests.append(best)
        if len(self._bests) <= self.epochs:
            return
        gain = self._bests[-1] - self._bests[-1 - self.epochs]
        if gain >= self.eps_db or self._bests[-1] >= self.floor_psnr:
            return
        msg = (
            f"val/psnr plateaued: best improved {gain:.3f} dB (< "
            f"{self.eps_db}) over the last {self.epochs} val epochs and is "
            f"still {self._bests[-1]:.2f} dB (< floor {self.floor_psnr}) at "
            f"step {step}. The run is in an absorbing basin; do NOT resume "
            "from last.ckpt — restart with lr_max_steps pinned at the proven "
            "horizon."
        )
        if self.abort:
            raise TrainingPlateaued(msg)
        warnings.warn(msg, stacklevel=2)


def inject_ramps(cfg: Config, batch: Dict[str, np.ndarray], step: int) -> None:
    """The per-step scalar ramps of a batch: the AE background-loss weight
    (``bg_loss_warmup_steps``) and the interval-tightening anneal
    (``aabb_warmup_steps``, read by ``core/rays.py::effective_intervals``)."""
    if cfg.bg_loss_warmup_steps > 0:
        batch["bg_scale"] = np.float32(min(1.0, step / cfg.bg_loss_warmup_steps))
    if cfg.aabb_warmup_steps > 0:
        batch["interval_ramp"] = np.float32(min(1.0, step / cfg.aabb_warmup_steps))


class _RankLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def log(self, *args, **kwargs) -> None:
        pass

    def log_image(self, *args, **kwargs) -> None:
        pass


class Trainer:
    def __init__(self, cfg: Config, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.is_multi = cfg.dataset_name == "sapien_multi"
        self.device = resolve_device(device)
        # the ranks that share each batch (None: this process alone)
        self.group = get_group(cfg.num_devices)
        self.is_main = rank_of(self.group) == 0
        self.result_dir = Path(cfg.output_path) / cfg.exp_name
        self.result_dir.mkdir(parents=True, exist_ok=True)

        ds_cls = dataset_dict[cfg.dataset_name]
        common = dict(
            root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh), white_back=cfg.white_back,
            use_aabb=cfg.use_aabb, aabb_pad=cfg.aabb_pad,
            use_occgrid=cfg.use_occgrid, occgrid_res=cfg.occgrid_res,
            occgrid_dilate=cfg.occgrid_dilate,
        )
        if self.is_multi:
            if cfg.obj_ray_oversample > 0 and cfg.exp_type == "vanilla_ae_art":
                # the AE's instance-masked MSE would need the importance
                # weights in both its numerator and its mask-count denominator
                raise ValueError("obj_ray_oversample is only supported for "
                                 "exp_type=vanilla_autodecoder (plain-MSE objective)")
            common.update(
                samples_per_epoch=cfg.samples_per_epoch,
                ray_batch_size=cfg.ray_batch_size,
                obj_ray_oversample=cfg.obj_ray_oversample,
                # only the auto-encoder's encoder reads src_imgs
                need_src_imgs=cfg.exp_type == "vanilla_ae_art",
            )
        if cfg.run_eval:
            self.test_dataset = ds_cls(
                split="test_val", eval_inference=cfg.render_name or "render", **common
            )
            near, far = self.test_dataset.near, self.test_dataset.far
        else:
            self.train_dataset = ds_cls(split="train", **common)
            self.val_dataset = ds_cls(split="val", **common)
            near, far = self.train_dataset.near, self.train_dataset.far

        self.system = build_system(cfg, near, far, cfg.white_back, device=self.device,
                                   group=self.group)
        self.ckpt = CheckpointManager(str(self.result_dir), save_top_k=cfg.save_top_k)
        self.logger = MetricLogger(
            str(self.result_dir), stdout_every=cfg.log_every_n_steps, sinks=cfg.metric_sinks,
        ) if self.is_main else _RankLogger()

        self.global_step = 0
        self._heartbeat = time.time()
        self._watchdog_started = False
        self._start_watchdog()
        self.base_key, init_key = prng.split(prng.key(cfg.seed))
        self.state = self.system.init_state(init_key)
        self._beat()

    def step_key(self, step: int) -> torch.Tensor:
        """The sampling draws' key of the dispatch that starts at ``step``."""
        return prng.fold_in(self.base_key, step)

    # ------------------------------------------------------------- watchdog

    WATCHDOG_EXIT_CODE = 17

    def _beat(self) -> None:
        self._heartbeat = time.time()

    def _start_watchdog(self) -> None:
        """No-progress watchdog: a dispatch that hangs leaves the trainer
        thread waiting forever.  A checkpoint save from here would hang on the
        same device, so the process exits nonzero instead, to be relaunched
        with ``--ckpt_path last.ckpt`` (checkpoints save every val epoch; at
        most one epoch is lost)."""
        timeout = float(self.cfg.watchdog_timeout or 0.0)
        if timeout <= 0 or self._watchdog_started:
            return
        self._watchdog_started = True

        def _watch():
            while True:
                time.sleep(min(30.0, timeout / 4))
                stalled = time.time() - self._heartbeat
                if stalled > timeout:
                    print(
                        f"[watchdog] no dispatch progress for {stalled:.0f}s "
                        f"(> {timeout:.0f}s) at step {self.global_step}; "
                        f"exiting {self.WATCHDOG_EXIT_CODE} — relaunch with "
                        "--ckpt_path last.ckpt to resume",
                        flush=True,
                    )
                    os._exit(self.WATCHDOG_EXIT_CODE)

        threading.Thread(target=_watch, daemon=True, name="aon-watchdog").start()

    # ------------------------------------------------------------------ fit

    def _train_iterator(self):
        # fold the restored global_step into the seed: a resumed run draws a
        # fresh ray stream instead of replaying consumed batches from step 0
        seed = self.cfg.seed + self.global_step
        if self.is_multi:
            return self.train_dataset.train_batches(seed=seed)
        return self.train_dataset.ray_batches(self.cfg.batch_size, seed=seed)

    def _steps_per_epoch(self) -> int:
        if self.is_multi:
            return self.cfg.samples_per_epoch
        return self.train_dataset.steps_per_epoch(self.cfg.batch_size)

    def _rays_per_step(self) -> int:
        return self.cfg.ray_batch_size if self.is_multi else self.cfg.batch_size

    def _dispatch(self, it, n_steps: int):
        """``n_steps`` optimizer steps from the ray stream ``it``: through
        ``train_many`` when there are several, else ``train_step``."""
        cfg = self.cfg
        batches = [next(it) for _ in range(n_steps)]
        for j, b in enumerate(batches):
            inject_ramps(cfg, b, self.global_step + j)
        stacked = stack_step_batches(batches, microbatch=cfg.microbatch_rays, device=self.device,
                                     group=self.group)
        key = self.step_key(self.global_step)
        if n_steps > 1:
            return self.system.train_many(self.state, stacked, key)
        return self.system.train_step(self.state, {k: v[0] for k, v in stacked.items()}, key)

    def fit(self, resume: bool = False) -> None:
        cfg = self.cfg
        # finetuning variants resume from last.ckpt / ckpt_path and
        # checkpoint every epoch (reference run.py:37-90)
        finetune = bool(cfg.is_optimize) or cfg.finetune_lpips
        if finetune:
            resume = True
        if resume:
            try:
                self.state = self.ckpt.restore(self.state, cfg.ckpt_path)
                self.global_step = int(self.state.step)
                print(f"resumed from step {self.global_step}")
            except FileNotFoundError:
                print("no checkpoint to resume from; starting fresh")
        ckpt_every = 1 if finetune else cfg.ckpt_every_n_epochs

        self._beat()
        sentinel = CollapseSentinel(cfg.collapse_abort_vals)
        plateau = PlateauSentinel(cfg.plateau_abort_epochs, cfg.plateau_eps_db,
                                  cfg.plateau_floor_psnr, cfg.plateau_start_step,
                                  cfg.plateau_abort)
        it = self._train_iterator()
        steps_per_epoch = self._steps_per_epoch()
        rays_per_step = self._rays_per_step()
        start_epoch = self.global_step // max(1, steps_per_epoch)
        t_dispatch = max(1, cfg.steps_per_dispatch)

        profiler = contextlib.ExitStack()
        if cfg.profile_dir:  # every rank traces its own first epoch
            trace_dir = cfg.profile_dir if self.is_main else os.path.join(
                cfg.profile_dir, f"rank{rank_of(self.group)}")
            profiler.enter_context(profiling.trace(trace_dir))

        for epoch in range(start_epoch, cfg.num_epochs):
            t_epoch = time.time()
            n_rays = 0
            steps_done = 0
            metrics = None
            while steps_done < steps_per_epoch and self.global_step < cfg.run_max_steps:
                t_now = min(t_dispatch, steps_per_epoch - steps_done,
                            cfg.run_max_steps - self.global_step)
                self.state, metrics = self._dispatch(it, t_now)
                self.global_step += t_now
                steps_done += t_now
                n_rays += rays_per_step * t_now
                self._beat()
                if self.global_step % cfg.log_every_n_steps < t_now:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    if math.isnan(metrics["train/loss"]):
                        raise FloatingPointError(
                            f"NaN loss at step {self.global_step} (detect_anomaly)")
                    metrics["train/lr"] = float(self.system.lr_schedule(self.global_step))
                    self.logger.log(self.global_step, metrics)

            # host readback before timing: the device runs behind the host
            _ = float(metrics["train/loss"]) if metrics else None
            dt = time.time() - t_epoch
            self.logger.log(
                self.global_step,
                {"epoch": epoch, "train/rays_per_sec": n_rays / max(dt, 1e-9)},
                force_stdout=True,
            )

            if cfg.profile_dir and epoch == start_epoch:  # the first trained epoch only
                profiler.close()
                print(f"profiler trace written to {cfg.profile_dir}")

            if (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                val_psnr = self.validate(epoch)
                # sentinel BEFORE save_last: never overwrite a live
                # checkpoint with the collapsed state it would resume into
                sentinel.update(val_psnr, self.global_step)
                plateau.update(val_psnr, self.global_step)
                if self.is_main:
                    self.ckpt.save_last(self.state, epoch)
                    if (epoch + 1) % ckpt_every == 0:
                        self.ckpt.save_ranked(self.state, epoch, val_psnr)

            if self.global_step >= cfg.run_max_steps:
                break
        profiler.close()  # where no epoch was left to train
        if self.is_main:
            self.ckpt.save_last(self.state, cfg.num_epochs - 1)

    # ------------------------------------------------------------ validation

    def _val_frames(self):
        cfg = self.cfg
        if self.is_multi:  # five random train frames, fixed by the seed
            for i in range(min(cfg.limit_val_batches, 5)):
                yield self.val_dataset.val_frame(seed=cfg.seed + i)
            return
        n = min(cfg.limit_val_batches, len(self.val_dataset.img_files))
        for i in range(n):
            yield self.val_dataset.full_frame(i)

    def _render_full(self, params, frame: Dict[str, np.ndarray],
                     is_test: bool = False) -> Dict[str, np.ndarray]:
        """Render one frame; the auto-decoder's frame carries its instance and
        articulation, and ``is_test`` indexes the 2N-1 interpolated codes; the
        auto-encoder encodes the frame's own image at its joint angle."""
        extra = {}
        if self.cfg.exp_type == "vanilla_autodecoder":
            extra = dict(instance_id=int(frame["instance_id"]),
                         articulation_id=int(frame["articulation_id"]), is_test=is_test)
        elif self.cfg.exp_type == "vanilla_ae_art":
            extra = dict(src_imgs=np.asarray(frame["src_imgs"], np.float32)[None],
                         deg=float(frame.get("deg", 0.0)))
        miss_fill = None
        if "hit" in frame:
            # AABB path: rays missing the box ARE the background — skip them
            bg = 1.0 if self.cfg.white_back else 0.0
            miss_fill = {"comp_rgb": bg, "acc": 0.0, "depth": 0.0}
        return render_frame(lambda rays, **ex: self.system.render_chunk(params, rays, **ex),
                            frame, self.cfg.chunk, miss_fill=miss_fill, device=self.device,
                            group=self.group, **extra)

    def validate(self, epoch: int) -> float:
        psnrs, psnrs_obj = [], []
        state_sq_errs, state_deg_errs = [], []
        first_viz = None
        for frame in self._val_frames():
            ret = self._render_full(self.state.params, frame)
            self._beat()
            psnrs.append(M.psnr(ret["comp_rgb"], frame["target"]))
            psnrs_obj.append(
                M.psnr_masked(ret["comp_rgb"], frame["target"], frame["instance_mask"]))
            if "pred_state" in ret and "deg" in frame:
                # joint-state metrics (model_ae_art.py:519-523): the squared
                # error in radians and round(deg(pred)) - round(deg(gt)).
                # pred_state is one value per frame; the AABB path fills miss
                # rays with NaN, so reduce over the hit rays only
                pred, gt = float(np.nanmean(ret["pred_state"])), float(frame["deg"])
                state_sq_errs.append((pred - gt) ** 2)
                state_deg_errs.append(float(np.round(np.rad2deg(pred)) - np.round(np.rad2deg(gt))))
            if first_viz is None:
                w, h = frame["img_wh"]
                first_viz = val_grid((w, h), frame["target"], ret["comp_rgb"], ret.get("depth"),
                                     ret.get("acc"))
        val_psnr = float(np.mean(psnrs))
        logs = {"val/psnr": val_psnr, "epoch": epoch}
        if psnrs_obj:
            logs["val/psnr_obj"] = float(np.nanmean(psnrs_obj))
        if state_sq_errs:
            logs["val/state_error_rad"] = float(np.mean(state_sq_errs))
            logs["val/abs_state_error_deg"] = float(np.mean(state_deg_errs))
        self.logger.log(self.global_step, logs, force_stdout=True)
        if first_viz is not None:
            self.logger.log_image(self.global_step, "val/GT_pred_rgb", first_viz,
                                  str(self.result_dir))
        return val_psnr

    # ------------------------------------------------------------------ test

    def test(self, ckpt_name: Optional[str] = None) -> dict:
        """Render every test frame (the 19-frame spheric sweep of a
        multi-instance dataset, with a video), write the eval artifacts under
        ``ckpts/{exp_name}/{render_name}/`` and ``ckpts/{exp_name}/results.json``
        of the working directory, as the JAX trainer does: PSNR, SSIM,
        PSNR_obj and, where there are VGG weights, LPIPS with
        ``"lpips_weights"`` (``"synthetic"`` or ``"pretrained"``) beside it;
        without them ``test/lpips`` is None.  Rank 0 alone writes."""
        cfg = self.cfg
        try:
            self.state = self.ckpt.restore(self.state, ckpt_name or cfg.ckpt_path)
        except FileNotFoundError as e:
            print(f"warning: checkpoint not found ({e}); evaluating current params")

        n_frames = len(self.test_dataset)
        rgbs, targets, masks, depths = [], [], [], []
        w, h = cfg.img_wh
        for i in range(n_frames):
            if self.is_multi:
                frame = self.test_dataset.test_frame(i, seed=cfg.seed)
            else:
                frame = self.test_dataset.full_frame(i)
            ret = self._render_full(self.state.params, frame, is_test=self.is_multi)
            self._beat()
            rgbs.append(ret["comp_rgb"].reshape(h, w, 3))
            targets.append(np.asarray(frame["target"]).reshape(h, w, 3))
            masks.append(np.asarray(frame["instance_mask"]).reshape(h, w))
            if "depth" in ret:
                depths.append(ret["depth"].reshape(h, w))
            print(f"rendered test frame {i + 1}/{n_frames}", flush=True)

        psnr_stats = M.summarize("PSNR", [M.psnr(p, t) for p, t in zip(rgbs, targets)])
        ssim_stats = M.summarize("SSIM", [M.ssim(p, t) for p, t in zip(rgbs, targets)])
        lpips_vals = [M.lpips(p, t, device=self.device) for p, t in zip(rgbs, targets)]
        lpips_stats = (M.summarize("LPIPS", lpips_vals)
                       if any(v is not None for v in lpips_vals) else None)
        psnr_obj_stats = M.summarize(
            "PSNR_obj", [M.psnr_masked(p, t, m) for p, t, m in zip(rgbs, targets, masks)])

        if self.is_main:
            image_dir = os.path.join("ckpts", cfg.exp_name, cfg.render_name or "render")
            artifacts.store_image(image_dir, rgbs, "image")
            if depths:
                artifacts.store_depth_img(image_dir, depths, "depth")
            if self.is_multi:
                artifacts.store_video(image_dir, rgbs)
            # label the weights' provenance: "synthetic" LPIPS values are a
            # plumbing proof, not a perceptual metric (weights/README.md)
            extra = {"lpips_weights": lpips_weights_kind()} if lpips_stats else None
            artifacts.write_stats(os.path.join("ckpts", cfg.exp_name, "results.json"),
                                  psnr_stats, ssim_stats, lpips_stats, psnr_obj_stats,
                                  extra=extra)
        results = {
            "test/psnr": psnr_stats["test"],
            "test/ssim": ssim_stats["test"],
            "test/lpips": lpips_stats["test"] if lpips_stats else None,
            "test/psnr_obj": psnr_obj_stats["test"],
        }
        self.logger.log(self.global_step, {k: v for k, v in results.items() if v is not None},
                        force_stdout=True)
        return results
