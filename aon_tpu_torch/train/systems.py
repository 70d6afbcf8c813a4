"""Training systems per exp_type (port of the vanilla and auto-decoder
systems of ``aon_tpu/train/systems.py``; the auto-encoder's is
``train/system_ae.py``).

Each system exposes

  * ``init_state(key)`` -> ``TrainState`` (params, optimizer moments, step)
  * ``train_step(state, batch, key)`` -> ``(state, metrics)``
  * ``train_many(state, superbatch, key)`` -> T steps from one call
  * ``render_chunk(params, rays, ...)`` -> deterministic renderer of eval

With ``cfg.use_pallas`` on a CUDA device both the step and the renderer go
through the CUDA kernels: the v3 step (``ops/train_fused_level.py`` /
``ops/train_fused_level_art.py``, one launch per level) when
``cfg.fused_train == "v3"`` and ``cfg.noise_std == 0``, else the two-kernel
v2 loss (``ops/train_pallas.py`` / ``ops/train_art_pallas.py``) under
autograd.  On a CPU device, or with ``use_pallas`` off, the plain module runs
under autograd, as the JAX systems fall back off the TPU.

Loss and metric contracts:
  vanilla      (model.py:256-282):             MSE(coarse) + MSE(fine)
  autodecoder  (model_autodecoder.py:395-477): + 1e-4 * latent-norm reg
``train/loss``, ``train/psnr0``, ``train/psnr1`` (+ ``train/loss/reg``).
Metrics stay tensors on the system's device: ``train_step`` never waits for
the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from aon_tpu_torch.core import prng
from aon_tpu_torch.core.rays import effective_intervals
from aon_tpu_torch.core.rendering import img2mse, mse2psnr
from aon_tpu_torch.models.articulated import ArticulatedNeRF
from aon_tpu_torch.models.code_library import CodeLibraryArticulated
from aon_tpu_torch.models.init import flax_init_
from aon_tpu_torch.models.nerf import VanillaNeRF
from aon_tpu_torch.ops.render_fused import make_fused_render_fn, mlp_params
from aon_tpu_torch.ops.train_art_pallas import (
    make_fused_art_render_fn,
    make_fused_autodecoder_loss_fn,
    weighted_mse,
)
from aon_tpu_torch.ops.train_fused_level_art import latent_reg, make_fused_autodecoder_step_fn
from aon_tpu_torch.train.microbatch import accumulated_grads, make_train_many_sharded
from aon_tpu_torch.train.optim import make_optimizer
from aon_tpu_torch.utils.config import Config
from aon_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Params, the optimizer's moments and the host-side step count (the flax
    ``TrainState`` of the JAX package): ``mu`` the first moment (SGD's
    momentum trace), ``nu`` the second (empty for SGD).  Immutable:
    ``apply_gradients`` returns the next state."""

    step: int
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    tx: Any

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        params, mu, nu = self.tx.update(self.params, grads, self.mu, self.nu, self.step)
        return dataclasses.replace(self, step=self.step + 1, params=params, mu=mu, nu=nu)


def _dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class _System:
    """What the systems share: a subclass sets ``device``, ``tx`` and
    ``loss_fn``, calls ``_set_dispatch`` and defines ``init_params`` and
    ``_metrics``."""

    group: Optional[dist.ProcessGroup] = None

    def _set_dispatch(self, group: Optional[dist.ProcessGroup]) -> None:
        """``train_many`` on one process, or over the ranks of ``group`` (the
        JAX systems' ``_fused_multichip`` route, here for every route: each
        rank holds its block of the rays and the gradients are all-reduced)."""
        self.group = group
        self.train_many = make_train_many_sharded(self.loss_fn, self._metrics, group)

    def init_state(self, key: torch.Tensor) -> TrainState:
        """Fresh parameters from the threefry ``key`` (those of the JAX
        system's ``init_state(key)``), zero Adam moments, step 0."""
        params = self.init_params(key)
        mu, nu = self.tx.init(params)
        return TrainState(step=0, params=params, mu=mu, nu=nu, tx=self.tx)

    def train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor],
                   key: Optional[torch.Tensor] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None):
        """One optimizer step: ``(state, metrics)``.  ``batch`` holds rays_o,
        rays_d, viewdirs, target as (B, 3) or stacked (k, m, 3) microbatches
        (+ optional per-ray ``loss_w``, ``t_near``, ``t_far``) and, for the
        auto-decoder, the step's one ``instance_id`` and ``articulation_id``;
        the sampling uniforms come from ``key``, or from ``draws``
        (``core.sampling`` names them) where a caller injects them.  Over
        several ranks ``batch`` holds this rank's block of the rays
        (``parallel.mesh.shard_ray_batch``) and the step goes through
        ``train_many``, which draws per ray where one process draws one
        block, as the JAX package's ``sharded_step`` does."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self.group is not None:
            # one step through the ranks' train_many, as the JAX sharded_step
            if draws is not None:
                raise ValueError("draws cannot be injected into a step over several ranks")
            return self.train_many(state, {k: v[None] for k, v in batch.items()}, key)
        loss, aux, grads = accumulated_grads(self.loss_fn, state.params, batch, key, draws)
        return state.apply_gradients(grads), self._metrics(loss, aux)


class VanillaSystem(_System):
    """exp_type="vanilla": single-scene two-level NeRF."""

    def __init__(self, cfg: Config, near: float, far: float, white_bkgd: bool,
                 device: DeviceLike = "cuda", group: Optional[dist.ProcessGroup] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.near, self.far, self.white_bkgd = float(near), float(far), bool(white_bkgd)
        self.model = VanillaNeRF(
            num_coarse_samples=cfg.N_samples,
            num_fine_samples=cfg.N_importance,
            min_deg_point=0,
            max_deg_point=cfg.N_emb_xyz,
            deg_view=cfg.N_emb_dir,
            noise_std=cfg.noise_std,
            lindisp=cfg.lindisp,
            dtype=_dtype(cfg),
            device=self.device,
        )
        self.tx, self.lr_schedule = make_optimizer(cfg)
        self._fused = None
        levels = dict(num_coarse=cfg.N_samples, num_fine=cfg.N_importance,
                      max_deg=cfg.N_emb_xyz, deg_view=cfg.N_emb_dir, lindisp=cfg.lindisp)
        use_fused = cfg.use_pallas and self.device.type == "cuda"
        if use_fused:
            self._fused = make_fused_render_fn(self.near, self.far, self.white_bkgd, **levels)
        if use_fused and cfg.fused_train == "v3" and cfg.noise_std == 0:
            # one kernel launch per level (forward, compositing, loss and
            # backward); the gradients come back from the kernels
            from aon_tpu_torch.ops.train_fused_level import make_fused_step_fn

            self.loss_fn = make_fused_step_fn(self.near, self.far, self.white_bkgd, **levels)
        elif use_fused:
            from aon_tpu_torch.ops.train_pallas import make_fused_loss_fn

            self.loss_fn = make_fused_loss_fn(self.near, self.far, self.white_bkgd,
                                              noise_std=cfg.noise_std, **levels)
        else:
            self.loss_fn = self._plain_loss_fn
        self._set_dispatch(group)

    def _plain_loss_fn(self, params, batch, key=None, draws=None):
        rays = {k: batch[k] for k in ("rays_o", "rays_d", "viewdirs", "draw_row0")
                if k in batch}
        out = torch.func.functional_call(
            self.model, dict(params),
            (rays, self.white_bkgd, *effective_intervals(batch, self.near, self.far)),
            dict(randomized=True, key=key, draws=draws),
        )
        loss0 = img2mse(out[0][0], batch["target"])
        loss1 = img2mse(out[1][0], batch["target"])
        return loss0 + loss1, {"loss0": loss0, "loss1": loss1}

    @staticmethod
    def _metrics(loss: torch.Tensor, aux: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"train/loss": loss, "train/psnr0": mse2psnr(aux["loss0"]),
                "train/psnr1": mse2psnr(aux["loss1"])}

    def init_params(self, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fresh xavier-uniform weights and zero biases drawn from ``key`` as
        the JAX system's flax ``init(key)`` draws them
        (``aon_tpu/train/systems.py:153-159``), as a ``VanillaNeRF`` state
        dict on the system's device."""
        flax_init_(self.model, key)
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def render_chunk(self, params: Mapping[str, torch.Tensor],
                     rays: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Deterministic render of one chunk: ``{comp_rgb (B, 3), acc (B,), depth (B,)}``
        of the fine level.  ``rays`` holds (B, 3) rays_o/rays_d/viewdirs
        (+ optional per-ray t_near/t_far)."""
        rays = {k: torch.as_tensor(v, device=self.device) for k, v in rays.items()}
        if self._fused is not None:
            return self._fused(params, rays)
        out = torch.func.functional_call(
            self.model, dict(params),
            ({k: rays[k] for k in ("rays_o", "rays_d", "viewdirs")}, self.white_bkgd,
             rays.get("t_near", self.near), rays.get("t_far", self.far)),
        )
        comp_rgb, acc, depth = out[1]
        return {"comp_rgb": comp_rgb, "acc": acc, "depth": depth}


ART_TABLE = "code_library.embedding_instance_articulation.weight"


def _with_art_smoothness(loss_fn, weight: float):
    """Add ``weight * sum ||z_{i+1} - z_i||^2`` over the articulation table.

    The test-time sweep decodes MIDPOINT latents the training objective never
    constrains (``models/code_library.interpolate_articulations``); this term
    pulls consecutive articulation codes toward a locally linear trajectory so
    those midpoints decode to intermediate geometry.  Works with both loss
    conventions: the term depends only on ``params``, so for a step that
    returns its gradients its gradient, ``2 w (2 z_i - z_{i-1} - z_{i+1})``
    inside the table, is added in closed form.
    """

    def smooth(params):
        d = params[ART_TABLE][1:] - params[ART_TABLE][:-1]
        return weight * torch.sum(d * d), d

    if getattr(loss_fn, "returns_grads", False):

        def wrapped(params, batch, key=None, draws=None):
            loss, aux, grads = loss_fn(params, batch, key, draws)
            sval, d = smooth(params)
            sgrad = torch.zeros_like(params[ART_TABLE])
            sgrad[1:] += 2.0 * weight * d
            sgrad[:-1] -= 2.0 * weight * d
            grads = dict(grads, **{ART_TABLE: grads[ART_TABLE] + sgrad})
            return loss + sval, dict(aux, reg=aux["reg"] + sval), grads

        wrapped.returns_grads = True
    else:

        def wrapped(params, batch, key=None, draws=None):
            loss, aux = loss_fn(params, batch, key, draws)
            sval, _ = smooth(params)
            return loss + sval, dict(aux, reg=aux["reg"] + sval)

    return wrapped


class AutoDecoderSystem(_System):
    """exp_type="vanilla_autodecoder": articulated NeRF + latent code library.

    The code library is just another part of the state dict (``model.*`` and
    ``code_library.*``), so the reference's "optimizer over model +
    embeddings" is the single Adam update here."""

    def __init__(self, cfg: Config, near: float, far: float, white_bkgd: bool,
                 device: DeviceLike = "cuda", group: Optional[dist.ProcessGroup] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.near, self.far, self.white_bkgd = float(near), float(far), bool(white_bkgd)
        self.model = ArticulatedNeRF(
            num_coarse_samples=cfg.N_samples,
            num_fine_samples=cfg.N_importance,
            min_deg_point=0,
            max_deg_point=cfg.N_emb_xyz,
            deg_view=cfg.N_emb_dir,
            noise_std=cfg.noise_std,
            lindisp=cfg.lindisp,
            sigma_activation="softplus_bias",
            rgb_padding=0.001,
            density_bias=-1.0,
            shape_dim=cfg.N_obj_code_length,
            dtype=_dtype(cfg),
            device=self.device,
        )
        self.code_library = CodeLibraryArticulated(
            n_max_objs=cfg.N_max_objs, n_obj_code_length=cfg.N_obj_code_length,
            device=self.device)
        self.tx, self.lr_schedule = make_optimizer(cfg)
        self._fused = None
        levels = dict(num_coarse=cfg.N_samples, num_fine=cfg.N_importance,
                      max_deg=cfg.N_emb_xyz, deg_view=cfg.N_emb_dir, lindisp=cfg.lindisp)
        use_fused = cfg.use_pallas and self.device.type == "cuda"
        if use_fused:
            self._fused = make_fused_art_render_fn(
                self.code_library, self.near, self.far, self.white_bkgd, **levels)
        if use_fused and cfg.fused_train == "v3" and cfg.noise_std == 0:
            # one kernel launch per level (forward, compositing, loss and
            # backward); the gradients come back from the kernels
            loss_fn = make_fused_autodecoder_step_fn(
                self.code_library, self.near, self.far, self.white_bkgd, **levels)
        elif use_fused:
            loss_fn = make_fused_autodecoder_loss_fn(
                self.code_library, self.near, self.far, self.white_bkgd, **levels)
        else:
            loss_fn = self._plain_loss_fn
        if cfg.art_code_smoothness > 0:
            loss_fn = _with_art_smoothness(loss_fn, cfg.art_code_smoothness)
        self.loss_fn = loss_fn
        self._set_dispatch(group)

    def _latents(self, params, batch, is_test: bool = False):
        return torch.func.functional_call(
            self.code_library, mlp_params(params, "code_library"),
            (batch["instance_id"], batch["articulation_id"]), dict(is_test=is_test))

    def _plain_loss_fn(self, params, batch, key=None, draws=None):
        latents = self._latents(params, batch)
        rays = {k: batch[k] for k in ("rays_o", "rays_d", "viewdirs", "draw_row0")
                if k in batch}
        out = torch.func.functional_call(
            self.model, mlp_params(params, "model"),
            (rays, latents, self.white_bkgd, *effective_intervals(batch, self.near, self.far)),
            dict(randomized=True, key=key, draws=draws),
        )
        loss0 = weighted_mse(out[0][0], batch["target"], batch.get("loss_w"))
        loss1 = weighted_mse(out[1][0], batch["target"], batch.get("loss_w"))
        reg = latent_reg(latents)
        return loss0 + loss1 + reg, {"loss0": loss0, "loss1": loss1, "reg": reg}

    @staticmethod
    def _metrics(loss: torch.Tensor, aux: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"train/loss": loss, "train/loss/reg": aux["reg"],
                "train/psnr0": mse2psnr(aux["loss0"]), "train/psnr1": mse2psnr(aux["loss1"])}

    def init_params(self, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fresh xavier-uniform weights and code tables and zero biases drawn
        as the JAX system draws them, the model from ``split(key)[0]`` and the
        code library from ``split(key)[1]`` (``aon_tpu/train/systems.py:301-316``):
        the flat state dict ``{"model.*", "code_library.*"}``
        on the system's device."""
        k1, k2 = prng.split(key)
        flax_init_(self.model, k1)
        self.code_library.reset_parameters(k2)
        params = {f"model.{k}": v.detach().clone() for k, v in self.model.state_dict().items()}
        params.update({f"code_library.{k}": v.detach().clone()
                       for k, v in self.code_library.state_dict().items()})
        return params

    @torch.no_grad()
    def render_chunk(self, params: Mapping[str, torch.Tensor], rays: Mapping[str, torch.Tensor],
                     instance_id, articulation_id, is_test: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Deterministic render of one chunk for one instance and articulation:
        ``{comp_rgb (B, 3), acc (B,), depth (B,)}`` of the fine level.  With
        ``is_test`` the articulation id indexes the 2N-1 interpolated table."""
        rays = {k: torch.as_tensor(v, device=self.device) for k, v in rays.items()}
        if self._fused is not None:
            return self._fused(params, rays, instance_id, articulation_id, is_test=is_test)
        latents = self._latents(
            params, {"instance_id": instance_id, "articulation_id": articulation_id}, is_test)
        out = torch.func.functional_call(
            self.model, mlp_params(params, "model"),
            ({k: rays[k] for k in ("rays_o", "rays_d", "viewdirs")}, latents, self.white_bkgd,
             rays.get("t_near", self.near), rays.get("t_far", self.far)),
        )
        comp_rgb, acc, depth = out[1]
        return {"comp_rgb": comp_rgb, "acc": acc, "depth": depth}


def build_system(cfg: Config, near: float, far: float, white_bkgd: bool,
                 device: DeviceLike = "cuda", group: Optional[dist.ProcessGroup] = None):
    """The system of ``cfg.exp_type`` on ``device``, training over the ranks
    of ``group`` where it is given."""
    if cfg.exp_type == "vanilla":
        return VanillaSystem(cfg, near, far, white_bkgd, device=device, group=group)
    if cfg.exp_type == "vanilla_autodecoder":
        return AutoDecoderSystem(cfg, near, far, white_bkgd, device=device, group=group)
    if cfg.exp_type == "vanilla_ae_art":
        from aon_tpu_torch.train.system_ae import AutoEncoderSystem

        return AutoEncoderSystem(cfg, near, far, white_bkgd, device=device, group=group)
    raise ValueError(f"unknown exp_type: {cfg.exp_type}")
