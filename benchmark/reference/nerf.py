"""The plain reference: the published two-level NeRF and articulated NeRF in
float32 PyTorch (TF32 off), with no kernel, cache or batching of the
measured program.

* ``layout(model)``: the parameters of each model, by name and shape, as
  the published architectures define them (vanilla ``model.py:39-120``:
  8 x 256 trunk re-reading the encoded input after layer 4, density head,
  256 bottleneck, one 128-wide view layer, rgb head; articulated
  ``model_autodecoder.py:60-337``: a 4 x 128 deformation MLP on [xyz, shape
  code, articulation code] whose 3-vector offset moves xyz before the
  encoding, the trunk on [enc, shape code], a 4 x 128 view branch on
  [bottleneck, view enc, appearance code]; the code tables).
* ``render_rays``: coarse stratified samples, the inverse-CDF fine samples
  over the interior coarse weights, compositing (last interval 1e10,
  alpha = 1 - exp(-sigma delta), transmittance the exclusive product of
  ``max(1 - alpha, 0) + 1e-10``), both levels' (rgb, acc, depth).
* ``loss_and_grads``: the two levels' MSE (plus the auto-decoder's 1e-4
  latent norm) and its gradients by autograd.
* ``adam_step``: optax's Adam (b1 0.9, b2 0.999, eps 1e-8) at the NeRF
  log-lerp schedule with its sine delay (``model.py:391-419``).

``precision="fp8"`` rounds both operands of every matrix product to
float8 e4m3, and in the backward the incoming gradient to e5m2 (one scale a
tensor), before a float32 product: the control.  ``precision="bfloat16"``
rounds all three to bf16, the configurations' stated precision: the
yardstick of how far a sound bf16 computation of the same seed lies from
float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

def layout(model: str, n_objs: int = 8, code: int = 128, art_code: int = 32,
           n_art: int = 10, xyz_deg: int = 10, view_deg: int = 4) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter; a layer's weight is (out, in)."""
    enc, venc = 3 * (2 * xyz_deg + 1), 3 * (2 * view_deg + 1)
    out = []

    def dense(name, n_in, n_out):
        out.append((f"{name}.weight", (n_out, n_in)))
        out.append((f"{name}.bias", (n_out,)))

    for level in ("coarse_mlp", "fine_mlp"):
        pre = level if model == "vanilla" else f"model.{level}"
        trunk_in = enc
        if model == "articulated":
            width = 3 + code + art_code
            for i in range(4):
                dense(f"{pre}.deform_{i}", width, 128)
                width = 128
            dense(f"{pre}.deform_out", 128, 3)
            trunk_in = enc + code
        width = trunk_in
        for i in range(8):
            dense(f"{pre}.pts_{i}", width, 256)
            width = 256 + (trunk_in if i == 4 else 0)
        dense(f"{pre}.density", width, 1)
        dense(f"{pre}.bottleneck", width, 256)
        width = 256 + venc + (code if model == "articulated" else 0)
        for i in range(1 if model == "vanilla" else 4):
            dense(f"{pre}.views_{i}", width, 128)
            width = 128
        dense(f"{pre}.rgb", 128, 3)
    if model == "articulated":
        out += [("code_library.embedding_instance_shape.weight", (n_objs, code)),
                ("code_library.embedding_instance_appearance.weight", (n_objs, code)),
                ("code_library.embedding_instance_articulation.weight", (n_art, art_code))]
    return out


def _round(x: torch.Tensor, precision: str, grad: bool = False) -> torch.Tensor:
    """x rounded to bf16, or to fp8 at one scale for the tensor (e4m3 for
    operands, e5m2 for gradients, as fp8 training rounds them)."""
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    fmt, top = (torch.float8_e5m2, 57344.0) if grad else (torch.float8_e4m3fn, 448.0)
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(fmt).to(torch.float32) * scale


class _LowLinear(torch.autograd.Function):
    """``x @ w.T + b`` with both operands rounded, and in the backward the
    incoming gradient rounded too, each product accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w, b, precision):
        xq, wq = _round(x, precision), _round(w, precision)
        ctx.save_for_backward(xq, wq)
        ctx.precision = precision
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _round(gy, ctx.precision, grad=True)
        return gq @ wq, gq.t() @ xq, gy.sum(0), None


class Ref:
    """One model's reference: float32, the bf16 yardstick or the fp8 control."""

    def __init__(self, model: str, white_bkgd: bool, near: float = 2.0, far: float = 6.0,
                 num_coarse: int = 64, num_fine: int = 128, xyz_deg: int = 10,
                 view_deg: int = 4, precision: str = "float32"):
        self.model, self.white_bkgd = model, bool(white_bkgd)
        self.near, self.far = near, far
        self.num_coarse, self.num_fine = num_coarse, num_fine
        self.xyz_deg, self.view_deg = xyz_deg, view_deg
        self.precision = precision

    # ---------------------------------------------------------- the MLPs

    def _lin(self, p, name, x):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if self.precision != "float32":
            return _LowLinear.apply(x, w, b, self.precision)
        return F.linear(x, w, b)

    @staticmethod
    def posenc(x: torch.Tensor, deg: int) -> torch.Tensor:
        scales = 2.0 ** torch.arange(deg, dtype=x.dtype, device=x.device)
        xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
        return torch.cat([x, torch.sin(xb), torch.sin(xb + 0.5 * math.pi)], dim=-1)

    def mlp(self, p, pre: str, pts: torch.Tensor, viewdirs: torch.Tensor,
            codes: Optional[Dict[str, torch.Tensor]] = None):
        """pts (B, S, 3), viewdirs (B, 3) -> raw rgb (B, S, 3), raw sigma (B, S)."""
        B, S, _ = pts.shape
        x = pts.reshape(B * S, 3)
        venc = self.posenc(viewdirs, self.view_deg)[:, None, :].expand(B, S, -1)
        venc = venc.reshape(B * S, -1)
        if self.model == "articulated":
            shape = codes["density"].reshape(1, -1).expand(B * S, -1)
            app = codes["color"].reshape(1, -1).expand(B * S, -1)
            art = codes["articulation"].reshape(1, -1).expand(B * S, -1)
            h = torch.cat([x, shape, art], -1)
            for i in range(4):
                h = torch.relu(self._lin(p, f"{pre}.deform_{i}", h))
            x = x + self._lin(p, f"{pre}.deform_out", h)
            inp = torch.cat([self.posenc(x, self.xyz_deg), shape], -1)
        else:
            inp = self.posenc(x, self.xyz_deg)
        h = inp
        for i in range(8):
            h = torch.relu(self._lin(p, f"{pre}.pts_{i}", h))
            if i == 4:
                h = torch.cat([h, inp], -1)
        sigma = self._lin(p, f"{pre}.density", h)
        v = torch.cat([self._lin(p, f"{pre}.bottleneck", h), venc]
                      + ([app] if self.model == "articulated" else []), -1)
        for i in range(1 if self.model == "vanilla" else 4):
            v = torch.relu(self._lin(p, f"{pre}.views_{i}", v))
        rgb = self._lin(p, f"{pre}.rgb", v)
        return rgb.reshape(B, S, 3), sigma.reshape(B, S)

    def activations(self, raw_rgb, raw_sigma):
        if self.model == "articulated":
            return torch.sigmoid(raw_rgb) * 1.002 - 0.001, F.softplus(raw_sigma - 1.0)
        return torch.sigmoid(raw_rgb), torch.relu(raw_sigma)

    # ------------------------------------------------- sampling, compositing

    def composite(self, rgb, sigma, t, rays_d):
        dist = torch.cat([t[:, 1:] - t[:, :-1], torch.full_like(t[:, :1], 1e10)], -1)
        dist = dist * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-sigma * dist)
        trans = torch.cumprod(torch.clamp_min(1.0 - alpha, 0.0) + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        w = alpha * trans
        comp = (w[..., None] * rgb).sum(1)
        acc = w.sum(1)
        if self.white_bkgd:
            comp = comp + (1.0 - acc[:, None])
        return comp, acc, (w * t).sum(1), w

    def coarse_t(self, n_rays: int, device, t_rand: Optional[torch.Tensor]):
        lin = torch.arange(self.num_coarse + 1, dtype=torch.float32, device=device)
        lin = lin / self.num_coarse
        t = (self.near * (1.0 - lin) + self.far * lin).expand(n_rays, -1)
        if t_rand is None:
            return t.contiguous()
        mids = 0.5 * (t[:, 1:] + t[:, :-1])
        upper = torch.cat([mids, t[:, -1:]], -1)
        lower = torch.cat([t[:, :1], mids], -1)
        return lower + (upper - lower) * t_rand

    @staticmethod
    def inverse_cdf(bins, weights, u):
        """Piecewise-constant pdf over ``bins`` (B, N) with masses ``weights``
        (B, N - 1), padded to a total of at least 1e-5, at quantiles u."""
        total = weights.sum(-1, keepdim=True)
        pad = torch.clamp_min(1e-5 - total, 0.0)
        pdf = (weights + pad / weights.shape[-1]) / (total + pad)
        cdf = torch.clamp_max(torch.cumsum(pdf[:, :-1], -1), 1.0)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], -1)
        idx = torch.searchsorted(cdf, u.contiguous(), right=True)
        lo = torch.clamp(idx - 1, 0, cdf.shape[-1] - 1)
        hi = torch.clamp(idx, 0, cdf.shape[-1] - 1)
        c0, c1 = torch.gather(cdf, -1, lo), torch.gather(cdf, -1, hi)
        b0, b1 = torch.gather(bins, -1, lo), torch.gather(bins, -1, hi)
        den = c1 - c0
        frac = torch.where(den > 0, torch.clip((u - c0) / torch.where(den > 0, den, 1.0), 0, 1),
                           torch.zeros_like(u))
        return b0 + frac * (b1 - b0)

    def render_rays(self, p, rays_o, rays_d, codes=None, t_rand=None, u=None):
        """Both levels' (comp_rgb, acc, depth); ``t_rand`` (B, S + 1) and ``u``
        (B, n) are the training draws, None for the deterministic render."""
        pres = ("coarse_mlp", "fine_mlp") if self.model == "vanilla" else (
            "model.coarse_mlp", "model.fine_mlp")
        t = self.coarse_t(rays_o.shape[0], rays_o.device, t_rand)
        out = []
        for level, pre in enumerate(pres):
            if level == 1:
                mids = 0.5 * (t[:, 1:] + t[:, :-1])
                if u is None:
                    u = (torch.arange(self.num_fine, dtype=torch.float32, device=t.device)
                         / (self.num_fine - 1)).expand(t.shape[0], -1)
                fine = self.inverse_cdf(mids, w[:, 1:-1].detach(), u).detach()
                t = torch.sort(torch.cat([t, fine], -1), -1).values
            pts = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
            raw_rgb, raw_sigma = self.mlp(p, pre, pts, rays_d, codes)
            rgb, sigma = self.activations(raw_rgb, raw_sigma)
            comp, acc, depth, w = self.composite(rgb, sigma, t, rays_d)
            out.append((comp, acc, depth))
        return out

    # -------------------------------------------------------------- training

    def codes(self, p, instance_id: int, articulation_id: int, is_test: bool = False):
        if self.model != "articulated":
            return None
        art = p["code_library.embedding_instance_articulation.weight"]
        if is_test:
            mids = 0.5 * (art[:-1] + art[1:])
            art = torch.stack([art[:-1], mids], 1).reshape(-1, art.shape[1])
            art = torch.cat([art, p["code_library.embedding_instance_articulation.weight"][-1:]])
        return {"density": p["code_library.embedding_instance_shape.weight"][instance_id],
                "color": p["code_library.embedding_instance_appearance.weight"][instance_id],
                "articulation": art[articulation_id]}

    def loss_and_grads(self, params: Dict[str, torch.Tensor], batch, t_rand, u):
        """(loss, grads) of one step on the whole batch."""
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        codes = None
        if self.model == "articulated":
            codes = self.codes(p, int(batch["instance_id"]), int(batch["articulation_id"]))
        (c0, _, _), (c1, _, _) = self.render_rays(p, batch["rays_o"], batch["rays_d"], codes,
                                                 t_rand, u)
        tgt = batch["target"]
        loss = ((c0 - tgt) ** 2).mean() + ((c1 - tgt) ** 2).mean()
        if codes is not None:
            loss = loss + 1e-4 * sum(c.abs().mean() for c in codes.values())
        names = list(p)
        grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
        return float(loss.detach()), {k: (torch.zeros_like(p[k]) if g is None else g)
                             for k, g in zip(names, grads)}


def nerf_lr(step: int, lr_init: float, lr_final: float, delay_steps: int, delay_mult: float,
            max_steps: int) -> float:
    f32 = np.float32
    ramp = np.clip(f32(step) / f32(delay_steps), f32(0), f32(1)) if delay_steps > 0 else f32(1)
    delay = (f32(delay_mult) + f32(1 - delay_mult) * np.sin(f32(0.5 * math.pi) * ramp,
                                                          dtype=f32)) if delay_steps > 0 else f32(1)
    t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    return float(f32(delay * np.exp(f32(math.log(lr_init)) * (f32(1) - t)
                                    + f32(math.log(lr_final)) * t, dtype=f32)))


def adam_step(params, grads, mu, nu, step: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """optax Adam from the state after ``step`` updates."""
    out_p, out_m, out_v = {}, {}, {}
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(step + 1))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(step + 1))
    for k, g in grads.items():
        m = (1 - b1) * g + b1 * mu[k]
        v = (1 - b2) * g * g + b2 * nu[k]
        out_p[k] = params[k] - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        out_m[k], out_v[k] = m, v
    return out_p, out_m, out_v
