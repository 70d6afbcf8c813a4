"""Auto-encoder articulated system, exp_type="vanilla_ae_art" (port of
``aon_tpu/train/system_ae.py``).

Contract from reference ``models/vanilla_nerf/model_ae_art.py:209-418``:

* latents come from a ResNet-34 multi-head encoder on the seg-masked source
  image (``models/resnet.py``);
* the joint state is regressed from the articulation latent
  (``models/joint_state.py``) with an MSE loss against the GT radians;
* the NeRF conditions on a degree-indexed embedding (91 x 32 rows of
  round(rad2deg(deg)), clipped to 0..90);
* the photometric MSE is masked to instance pixels, over the whole ray batch
  (``prepare_shared``), optionally plus a background MSE
  (``bg_loss_lambda``, ramped by ``bg_scale``);
* opacity loss 0.5 * [BCEWithLogits(acc0, mask) + BCEWithLogits(acc1, mask)],
  acc fed as the logits (the reference's quirk, kept);
* un-padded sigmoid rgb; relu sigma, or ``softplus(raw - 1)`` with
  ``ae_sigma_activation="softplus_bias"``.

The state dict is flat: ``model.*`` (the two ``ArticulatedNeRFMLP`` levels),
``encoder.*``, ``joint_state.*`` and ``deg_embedding.*``, all under the one
Adam update.  Routes as ``AutoDecoderSystem``'s: on a CUDA device with
``use_pallas`` the v3 step (``make_fused_ae_step_fn``, one level kernel per
level) when ``fused_train == "v3"`` and ``noise_std == 0``, else the v2
two-kernel loss under autograd; on the CPU the plain module under autograd.
The encoder's convolutions are PyTorch's (cuDNN on the card), as the JAX
package leaves them to XLA, and run in float32 whatever ``compute_dtype``
says (the NeRF's kernels follow it).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from aon_tpu_torch.core import prng
from aon_tpu_torch.core.rays import effective_intervals
from aon_tpu_torch.core.rendering import mse2psnr
from aon_tpu_torch.models.articulated import ArticulatedNeRF
from aon_tpu_torch.models.joint_state import JointStateDecoder
from aon_tpu_torch.models.init import flax_init_
from aon_tpu_torch.models.resnet import ImgEncoderMultiHeadArt
from aon_tpu_torch.ops.fused_mlp import EncConstsCache
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.train_art_pallas import fused_art_render, fused_two_level_train
from aon_tpu_torch.ops.train_fused_level_art import (
    ae_loss_weights,
    ae_prepare_shared,
    make_fused_ae_step_fn,
)
from aon_tpu_torch.ops.train_fused_level_art import bce_with_logits as _bce_with_logits
from aon_tpu_torch.train.optim import make_optimizer
from aon_tpu_torch.train.systems import _dtype, _System
from aon_tpu_torch.utils.config import Config
from aon_tpu_torch.utils.device import DeviceLike, resolve_device

OPACITY_LAMBDA = 0.5  # hard-coded inside reference opacity_loss_CE (:647)
N_DEG_EMBEDDINGS = 91  # 0..90 inclusive (model_ae_art.py:240)
DEG_CODE_LENGTH = 32
# the repo's default converted backbone (weights/README.md); absent unless made
RESNET_WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "..", "weights", "resnet34.npz")


def deg_index(deg: torch.Tensor) -> torch.Tensor:
    """Row of the degree table for a joint angle in radians:
    ``round(rad2deg(deg))`` (half to even, as ``jnp.round``) clipped to 0..90."""
    return torch.clamp(torch.round(torch.rad2deg(deg)).long(), 0, N_DEG_EMBEDDINGS - 1)


class DegEmbedding(nn.Module):
    """The 91 x 32 degree table; flax ``nn.Embed``'s default init,
    ``variance_scaling(1, fan_in, normal)``: a normal of std 1/sqrt(32)."""

    def __init__(self, device=None, key: Optional[torch.Tensor] = None):
        super().__init__()
        self.deg_embedding = nn.Embedding(N_DEG_EMBEDDINGS, DEG_CODE_LENGTH, device="meta")
        # built on the meta device so no default init draws from the global RNG
        self.to_empty(device=torch.device("cpu") if device is None else device)
        self.reset_parameters(key)

    def reset_parameters(self, key: Optional[torch.Tensor]) -> None:
        flax_init_(self, key, "embed_normal")

    def forward(self, deg_idx: torch.Tensor) -> torch.Tensor:
        return self.deg_embedding(torch.atleast_1d(deg_idx))


class AutoEncoderSystem(_System):
    def __init__(self, cfg: Config, near: float, far: float, white_bkgd: bool,
                 device: DeviceLike = "cuda", group: Optional[dist.ProcessGroup] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.near, self.far, self.white_bkgd = float(near), float(far), bool(white_bkgd)
        # relu (the reference), or softplus(raw - 1), the auto-decoder's
        # activation (model_autodecoder.py:265-267)
        self.sigma_act = cfg.ae_sigma_activation
        self.density_bias = -1.0 if self.sigma_act == "softplus_bias" else 0.0
        self.model = ArticulatedNeRF(
            num_coarse_samples=cfg.N_samples,
            num_fine_samples=cfg.N_importance,
            min_deg_point=0,
            max_deg_point=cfg.N_emb_xyz,
            deg_view=cfg.N_emb_dir,
            noise_std=cfg.noise_std,
            lindisp=cfg.lindisp,
            sigma_activation=self.sigma_act,
            density_bias=self.density_bias,
            rgb_padding=0.0,
            use_deg_embedding=True,
            dtype=_dtype(cfg),
            device=self.device,
        )
        # float32 whatever compute_dtype says, as the heads: with cuDNN's bf16
        # convolutions and norms the opacity BCE leaves its all-background
        # plateau ~4,000 steps later than the JAX package's on a TPU (ROADMAP.md,
        # held differences); float32 (cuDNN's TF32) reaches the JAX curve
        self.encoder = ImgEncoderMultiHeadArt(dtype=torch.float32, device=self.device)
        self.joint_state = JointStateDecoder(device=self.device)
        self.deg_embedding = DegEmbedding(device=self.device)
        self.tx, self.lr_schedule = make_optimizer(cfg)

        levels = dict(num_coarse=cfg.N_samples, num_fine=cfg.N_importance, lindisp=cfg.lindisp)
        self._fused = cfg.use_pallas and self.device.type == "cuda"
        self._consts = EncConstsCache(cfg.N_emb_xyz, cfg.N_emb_dir)
        if self._fused and cfg.fused_train == "v3" and cfg.noise_std == 0:
            # one kernel launch per level (forward, compositing, masked MSE,
            # opacity BCE and backward); the encoder's gradients come from
            # the kernels' latent cotangents
            self.loss_fn = make_fused_ae_step_fn(
                self._encode, self.near, self.far, self.white_bkgd,
                opacity_lambda=OPACITY_LAMBDA, bg_lambda=float(cfg.bg_loss_lambda),
                sigma_act=self.sigma_act, density_bias=self.density_bias,
                max_deg=cfg.N_emb_xyz, deg_view=cfg.N_emb_dir, **levels)
        else:
            self.loss_fn = self._loss_fn
        self._set_dispatch(group)

    def init_params(self, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fresh weights drawn as the JAX system's ``init_state(key)`` draws
        them (``aon_tpu/train/system_ae.py:93-112``): ``split(key, 4)`` for the
        NeRF (xavier-uniform), the encoder, the joint-state head (flax's
        ``lecun_normal``) and the degree table (flax's ``Embed`` normal); the
        encoder's conv kernels from ``_maybe_pretrained_encoder`` where a
        converted backbone exists.  The flat state dict on the system's
        device."""
        names = ("model", "encoder", "joint_state", "deg_embedding")
        keys = dict(zip(names, prng.split(key, 4)))
        flax_init_(self.model, keys["model"])
        params = {}
        for name in names:
            module = getattr(self, name)
            if name != "model":
                module.reset_parameters(keys[name])
            sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
            if name == "encoder":
                sd = self._maybe_pretrained_encoder(sd)
            params.update({f"{name}.{k}": v for k, v in sd.items()})
        return params

    @staticmethod
    def _maybe_pretrained_encoder(encoder_params: Mapping[str, torch.Tensor]):
        """Overlay converted torchvision ResNet-34 weights when they exist
        (the reference inits from ImageNet resnet34, resnet_encoder.py:311):
        ``$AON_RESNET_WEIGHTS``, else ``weights/resnet34.npz`` of the repo."""
        path = os.environ.get("AON_RESNET_WEIGHTS")
        if not (path and os.path.exists(path)):
            path = os.path.abspath(RESNET_WEIGHTS)
        if os.path.exists(path):
            print(f"initializing AE encoder backbone from {path}")
            return ImgEncoderMultiHeadArt.params_from_npz(encoder_params, path)
        return dict(encoder_params)

    def _encode(self, params: Mapping[str, torch.Tensor], src_imgs, deg):
        """``(latents, pred_state)``: the encoder's three heads on ``src_imgs``
        (B, 3, H, W), the joint state regressed from the articulation head,
        and ``articulation_deg``, the degree table's row of ``deg``."""
        src_imgs = torch.as_tensor(src_imgs, device=self.device)
        deg = torch.as_tensor(deg, dtype=torch.float32, device=self.device)
        latents = torch.func.functional_call(self.encoder, mlp_params(params, "encoder"),
                                             (src_imgs,))
        pred_state = torch.func.functional_call(
            self.joint_state, mlp_params(params, "joint_state"), (latents["articulation"],))
        latents["articulation_deg"] = torch.func.functional_call(
            self.deg_embedding, mlp_params(params, "deg_embedding"), (deg_index(deg),))
        return latents, pred_state

    def _loss_fn(self, params, batch, key=None, draws=None):
        """The plain (CPU) or v2 (two-kernel) loss under autograd."""
        src = batch["src_imgs"]
        if src.ndim == 3:
            src = src[None]
        latents, pred_state = self._encode(params, src, batch["deg"])
        if self._fused:
            out = fused_two_level_train(
                mlp_params(params, "model"), latents, batch,
                self._consts.on(batch["rays_o"].device), self.near, self.far, self.white_bkgd,
                self.cfg.N_samples, self.cfg.N_importance, sigma_activation=self.sigma_act,
                rgb_padding=0.0, density_bias=self.density_bias, lindisp=self.cfg.lindisp,
                key=key, draws=draws)
        else:
            rays = {k: batch[k] for k in ("rays_o", "rays_d", "viewdirs", "draw_row0")
                if k in batch}
            out = torch.func.functional_call(
                self.model, mlp_params(params, "model"),
                (rays, latents, self.white_bkgd,
                 *effective_intervals(batch, self.near, self.far)),
                dict(randomized=True, key=key, draws=draws),
            )
        mask, lw = ae_loss_weights(batch, float(self.cfg.bg_loss_lambda))

        def masked_mse(pred):
            return torch.sum(lw[:, None] * (pred - batch["target"]) ** 2)

        loss0, loss1 = masked_mse(out[0][0]), masked_mse(out[1][0])
        loss_state = torch.mean((pred_state - batch["deg"]) ** 2)
        opacity = OPACITY_LAMBDA * (_bce_with_logits(out[0][1], mask)
                                    + _bce_with_logits(out[1][1], mask))
        loss = loss0 + loss1 + loss_state + opacity
        return loss, {"loss0": loss0, "loss1": loss1, "loss_state": loss_state,
                      "opacity_loss": opacity}

    _loss_fn.prepare_shared = ae_prepare_shared

    @staticmethod
    def _metrics(loss: torch.Tensor, aux: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"train/loss": loss, "train/loss_state": aux["loss_state"],
                "train/opacity_loss": aux["opacity_loss"],
                "train/psnr0": mse2psnr(aux["loss0"]), "train/psnr1": mse2psnr(aux["loss1"])}

    @torch.no_grad()
    def render_chunk(self, params: Mapping[str, torch.Tensor], rays: Mapping[str, torch.Tensor],
                     src_imgs, deg) -> Dict[str, torch.Tensor]:
        """Deterministic render of one chunk from the encoding of ``src_imgs``
        (1, 3, H, W) at joint angle ``deg``: ``{comp_rgb (B, 3), acc (B,),
        depth (B,), pred_state (B,)}`` of the fine level, the regressed joint
        state broadcast per ray."""
        rays = {k: torch.as_tensor(v, device=self.device) for k, v in rays.items()}
        latents, pred_state = self._encode(params, src_imgs, deg)
        if self._fused:
            out = fused_art_render(
                params, latents, rays, self._consts.on(self.device), self.near, self.far,
                self.white_bkgd, self.cfg.N_samples, self.cfg.N_importance, self.sigma_act,
                0.0, self.density_bias, self.cfg.lindisp)
        else:
            comp_rgb, acc, depth = torch.func.functional_call(
                self.model, mlp_params(params, "model"),
                ({k: rays[k] for k in ("rays_o", "rays_d", "viewdirs")}, latents,
                 self.white_bkgd, rays.get("t_near", self.near), rays.get("t_far", self.far)),
            )[1]
            out = {"comp_rgb": comp_rgb, "acc": acc, "depth": depth}
        out["pred_state"] = pred_state.reshape(-1)[:1].expand(out["comp_rgb"].shape[0])
        return out
