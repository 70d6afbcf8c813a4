"""chip_smoke.py's forward check of the two training levels
(``level_forward_check``), on constructed raw outputs and on the levels' CPU
routes.

On the card chip_smoke holds a level's forward in two parts: the kernel's
raw rgb and sigma against the twin's at the forward kernels' tolerance
(``TWIN_TOL_MAX`` / ``TWIN_TOL_MEAN`` of the vanilla or the articulated
kernels), and the kernel's weights, acc and loss against the port's plain
float32 compositing of the kernel's own raw outputs at the unchanged
``tol_forward`` (the same ``TWIN_TOL_MAX``).  The constructed cases:

  * a twin raw sigma of -0.0003 and a kernel raw sigma of +0.0002 on a last
    (1e10) interval: both parts pass, though the weight there is the ray's
    transmittance on one side and 0 on the other (the flip that made the
    entry-by-entry comparison of the weights depend on the draws);
  * the same raw outputs with one weight moved by 0.02: the second part fails;
  * one raw sigma moved beyond the raw tolerance: the first part fails.

The articulated levels hold the max of the first part on the same launch
with the deformation's output layer zeroed, and the mean on both: a live
deformation's phase noise moves single raw outputs past the max (seen on an
H100 at the auto-encoder quality config's arguments: 0.162 live, 7.5e-3
zeroed, over 12 seeds; the mean 8.1e-5 live).  Their live launch is held
through a map with no jump at the unchanged ``tol_forward``: with
``softplus_bias`` its weights, acc and loss against the twin's (the check
chip_smoke made before the split), with ``relu`` its rgb and sigma after the
activations.  Cases: a zeroed entry past the max, or a live or zeroed mean
past its bound, fails; one live entry that moves the live forward by 3x the
tolerance fails in both activations; the last-interval flip passes there too.

No JAX here: the check is the port's own arithmetic, and its compositing is
held to the levels' twins (whose compositing the JAX suite holds to the
Pallas kernels in tests/test_torch_train_kernels.py and
tests/test_torch_art_kernels.py) on their CPU routes.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from aon_tpu_torch.core.rendering import volumetric_rendering
from aon_tpu_torch.models.init import seeded_params
from aon_tpu_torch.ops import fused_art
from aon_tpu_torch.ops.fused_mlp import make_posenc_constants, pack_vanilla_mlp_params_f32
from aon_tpu_torch.ops.fused_mlp_train import TWIN_TOL_MAX, TWIN_TOL_MEAN
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.train_fused_level import fused_level_train_grads
from aon_tpu_torch.ops.train_fused_level_art import fused_level_train_art_grads
from aon_tpu_torch.train.systems import build_system
from aon_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parent.parent
B, S = 64, 17

torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()

# (level arguments of the check, raw tolerance): the vanilla level, the
# auto-decoder's (softplus_bias, density bias -1, rgb padding, loss_w, black
# background) and the auto-encoder's (relu sigma, no padding)
MODES = {
    "vanilla": (dict(white_bkgd=True), (TWIN_TOL_MAX, TWIN_TOL_MEAN)),
    "autodecoder": (dict(white_bkgd=False, sigma_act="softplus_bias", density_bias=-1.0,
                         rgb_padding=0.001), (fused_art.TWIN_TOL_MAX, fused_art.TWIN_TOL_MEAN)),
    "autoencoder": (dict(white_bkgd=False, sigma_act="relu", density_bias=0.0, rgb_padding=0.0),
                    (fused_art.TWIN_TOL_MAX, fused_art.TWIN_TOL_MEAN)),
}


def _rays(seed, n=B):
    g = np.random.default_rng(seed)
    rays_d = g.normal(size=(n, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = (-4.0 * rays_d + 0.3 * g.normal(size=(n, 3))).astype(np.float32)
    t = np.sort(2.0 + 4.0 * g.random((n, S)), axis=-1).astype(np.float32)
    target = g.random((n, 3)).astype(np.float32)
    loss_w = (g.random(n) + 0.5).astype(np.float32) / (3.0 * n)
    return {k: torch.from_numpy(v) for k, v in dict(
        rays_o=rays_o, rays_d=rays_d, t_vals=t, target=target, loss_w=loss_w).items()}


def _composite(raw_rgb, raw_sigma, r, mode):
    """The outputs a level computes from its raw outputs: weights, acc and
    loss (a consistent kernel)."""
    kw, _ = MODES[mode]
    if kw.get("sigma_act") == "softplus_bias":
        sigma = torch.nn.functional.softplus(raw_sigma + kw["density_bias"])
    else:
        sigma = torch.clamp_min(raw_sigma, 0.0)
    pad = kw.get("rgb_padding", 0.0)
    rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * pad) - pad
    comp, acc, weights, _ = volumetric_rendering(rgb, sigma[..., None], r["t_vals"], r["rays_d"],
                                                 kw["white_bkgd"])
    sq = ((comp - r["target"]) ** 2).sum(-1)
    loss = sq.sum() if mode == "vanilla" else (sq * r["loss_w"]).sum()
    out = {"raw_rgb": raw_rgb, "raw_sigma": raw_sigma, "weights": weights, "loss": loss}
    if mode != "vanilla":
        out["acc"] = acc
    return out


def _check(got, twin, r, mode, zeroed=None):
    kw, tol_raw = MODES[mode]
    extra = {} if mode == "vanilla" else {"loss_w": r["loss_w"]}
    return chip_smoke.level_forward_check(
        torch, got, twin, r["t_vals"], r["rays_d"], r["target"], tol_raw=tol_raw,
        tol_forward=tol_raw[0], zeroed=zeroed, **kw, **extra)


def _flip_case(n=B):
    """Twin and kernel raw outputs 1e-4 apart over ``n`` rays, an empty ray 0
    and its last raw sigma -0.0003 (twin) against +0.0002 (kernel)."""
    r = _rays(3, n)
    g = torch.Generator().manual_seed(5)
    twin_rgb = torch.randn(n, S, 3, generator=g)
    twin_sigma = torch.randn(n, S, generator=g) * 2.0
    twin_sigma[0] = -1.0
    twin_sigma[0, -1] = -0.0003
    noise = lambda *s: (torch.rand(*s, generator=g) * 2.0 - 1.0) * 1e-4  # noqa: E731
    k_rgb, k_sigma = twin_rgb + noise(n, S, 3), twin_sigma + noise(n, S)
    k_sigma[0, -1] = 0.0002
    return r, {"raw_rgb": twin_rgb, "raw_sigma": twin_sigma}, k_rgb, k_sigma


@pytest.mark.parametrize("mode", ["vanilla", "autoencoder"])
def test_last_interval_flip_passes(mode):
    r, twin, k_rgb, k_sigma = _flip_case()
    got = _composite(k_rgb, k_sigma, r, mode)
    rec = _check(got, twin, r, mode)
    assert rec["ok"], rec
    assert rec["weights_max_abs_err"] <= 1e-6 and rec["loss_rel_err"] <= 1e-6, rec
    # the flip itself: held entry by entry against the twin's weights, as the
    # check was before, the last weight of ray 0 parts by the transmittance
    want = _composite(twin["raw_rgb"], twin["raw_sigma"], r, mode)
    assert want["weights"][0, -1].item() == 0.0
    assert (got["weights"] - want["weights"]).abs().max().item() > 0.9 > TWIN_TOL_MAX
    if mode == "autoencoder":  # and the live part, after the relu, does not see it
        rec = _check(got, want, r, mode, zeroed=({"raw_rgb": k_rgb, "raw_sigma": k_sigma}, twin))
        assert rec["ok"] and rec["live_forward_max_err"] < 1e-3, rec


@pytest.mark.parametrize("mode", list(MODES))
def test_a_weight_moved_by_0_02_fails(mode):
    r, twin, k_rgb, k_sigma = _flip_case()
    got = _composite(k_rgb, k_sigma, r, mode)
    assert _check(got, twin, r, mode)["ok"]
    moved = got["weights"].clone()
    moved[7, 5] += 0.02
    rec = _check(dict(got, weights=moved), twin, r, mode)
    # the raw outputs still agree, the weights do not (0.02 > 1e-2, and for
    # the articulated levels the weights are held at 5e-2: move by 0.06 there)
    assert rec["raw_max_abs_err"] <= MODES[mode][1][0]
    if mode == "vanilla":
        assert not rec["ok"] and abs(rec["weights_max_abs_err"] - 0.02) < 1e-6, rec
    else:
        assert rec["ok"], rec
        moved[7, 5] += 0.04
        rec = _check(dict(got, weights=moved), twin, r, mode)
        assert not rec["ok"] and abs(rec["weights_max_abs_err"] - 0.06) < 1e-6, rec


@pytest.mark.parametrize("mode", list(MODES))
def test_a_raw_sigma_beyond_the_raw_tolerance_fails(mode):
    r, twin, k_rgb, k_sigma = _flip_case()
    tol_max = MODES[mode][1][0]
    moved = k_sigma.clone()
    moved[9, 3] += 1.5 * tol_max
    got = _composite(k_rgb, moved, r, mode)  # a kernel consistent with its raw outputs
    rec = _check(got, twin, r, mode)
    assert rec["weights_max_abs_err"] <= 1e-6, rec
    assert not rec["ok"] and rec["raw_max_abs_err"] > tol_max, rec
    # an acc or a loss moved alone fails the second part
    base = _composite(k_rgb, k_sigma, r, mode)
    if mode != "vanilla":
        rec = _check(dict(base, acc=base["acc"] + 0.1), twin, r, mode)
        assert not rec["ok"] and rec["acc_max_abs_err"] > tol_max, rec
    rec = _check(dict(base, loss=base["loss"] * 1.5), twin, r, mode)
    assert not rec["ok"] and rec["loss_rel_err"] > tol_max, rec


@pytest.mark.parametrize("mode", ["autodecoder", "autoencoder"])
def test_the_articulated_max_is_held_with_the_deformation_zeroed(mode):
    r, twin_raw, k_rgb, k_sigma = _flip_case()
    tol_max, tol_mean = MODES[mode][1]
    twin = _composite(twin_raw["raw_rgb"], twin_raw["raw_sigma"], r, mode)
    got = _composite(k_rgb, k_sigma, r, mode)
    agree = ({"raw_rgb": k_rgb, "raw_sigma": k_sigma}, twin_raw)
    rec = _check(got, twin, r, mode, zeroed=agree)
    assert rec["ok"] and rec["raw_max_is"] == "deform_out zeroed", rec
    # an entry past the max on the zeroed launch fails
    noisy = k_sigma.clone()
    noisy[9, 3] += 3.0 * tol_max
    rec = _check(got, twin, r, mode, zeroed=({"raw_rgb": k_rgb, "raw_sigma": noisy}, twin_raw))
    assert not rec["ok"] and rec["raw_max_abs_err"] > tol_max, rec
    # so does a live mean past its bound, or a zeroed one
    shifted = k_sigma + 2.0 * tol_mean * 4.0  # rgb's three entries agree: 1/4 of the mean
    rec = _check(_composite(k_rgb, shifted, r, mode), twin, r, mode, zeroed=agree)
    assert not rec["ok"] and rec["raw_mean_abs_err"] > tol_mean, rec
    rec = _check(got, twin, r, mode, zeroed=({"raw_rgb": k_rgb, "raw_sigma": shifted}, twin_raw))
    assert not rec["ok"] and rec["raw_zeroed_mean_abs_err"] > tol_mean, rec


@pytest.mark.parametrize("mode", ["autodecoder", "autoencoder"])
def test_a_live_entry_off_by_3x_the_tolerance_fails(mode):
    """One live raw sigma wrong (a deformation wrong on one ray) while the
    zeroed launch agrees, on 1,024 rays so that the raw mean stays inside
    its bound: the live part alone fails.  With ``relu`` the entry moves
    sigma by 3x the tolerance; with ``softplus_bias`` it moves the ray's
    weight there by more than 3x the tolerance (a raw move of 4)."""
    n = 1024
    r, twin_raw, k_rgb, k_sigma = _flip_case(n)
    tol_max, tol_mean = MODES[mode][1]
    twin = _composite(twin_raw["raw_rgb"], twin_raw["raw_sigma"], r, mode)
    moved = k_sigma.clone()
    if mode == "autoencoder":
        i, j = (twin_raw["raw_sigma"][1:] > 0.5).nonzero()[0].tolist()
        moved[i + 1, j] += 3.0 * tol_max
    else:  # ray 0 is empty: its widest interval but the last
        j = int(torch.argmax(r["t_vals"][0, 1:] - r["t_vals"][0, :-1]))
        moved[0, j] += 4.0
    got = _composite(k_rgb, moved, r, mode)
    rec = _check(got, twin, r, mode, zeroed=({"raw_rgb": k_rgb, "raw_sigma": k_sigma}, twin_raw))
    assert rec["raw_max_abs_err"] <= tol_max and rec["raw_mean_abs_err"] <= tol_mean, rec
    assert rec["raw_zeroed_mean_abs_err"] <= tol_mean, rec
    assert rec["weights_max_abs_err"] <= 1e-6 and rec["loss_rel_err"] <= 1e-5, rec
    assert not rec["ok"] and rec["live_forward_max_err"] > 3.0 * tol_max, rec


def _level_inputs(mode):
    r = _rays(11)
    consts = make_posenc_constants(device="cpu")
    if mode == "vanilla":
        system = build_system(Config(), 2.0, 6.0, True, device="cpu")
        p = seeded_params(system, torch.Generator().manual_seed(1))
        packed = pack_vanilla_mlp_params_f32(mlp_params(p, "coarse_mlp"))
        return r, (packed, consts, r["t_vals"], r["rays_o"], r["rays_d"], r["rays_d"],
                   r["target"], True), {}
    system = build_system(Config(exp_type="vanilla_autodecoder", N_max_objs=4), 2.0, 6.0,
                          False, device="cpu")
    p = seeded_params(system, torch.Generator().manual_seed(7))
    lat = {k: v.detach() for k, v in system._latents(
        p, {"instance_id": 1, "articulation_id": 2}).items()}
    packed = fused_art.fold_latents(mlp_params(p, "model.fine_mlp"), lat)
    mask = (r["target"].sum(-1) > 1.5).float()
    kw, _ = MODES[mode]
    return r, (packed, consts, r["t_vals"], r["rays_o"], r["rays_d"], r["rays_d"], r["target"],
               r["loss_w"], mask), dict(kw, bce_weight=0.5 if mode == "autoencoder" else 0.0)


@pytest.mark.parametrize("mode", list(MODES))
def test_the_levels_cpu_routes_pass_their_own_check(mode):
    """The wrappers hand back the raw outputs their compositing read, and the
    check's plain compositing of them is the twins' compositing: weights,
    acc and loss to float32 rounding."""
    r, args, kw = _level_inputs(mode)
    raws = {}
    fn = fused_level_train_grads if mode == "vanilla" else fused_level_train_art_grads
    out = fn(*args, **kw, raws=raws)
    assert raws["raw_rgb"].shape == (B, S, 3) and raws["raw_sigma"].shape == (B, S)
    again = fn(*args, **kw)
    for a, b in zip(out[:-1], again[:-1]):  # the raws option changes nothing
        assert torch.equal(a, b)
    got = dict(raws, loss=out[0], weights=out[1], **({} if mode == "vanilla" else {"acc": out[2]}))
    zeroed = None
    if mode != "vanilla":  # chip_smoke's second launch, the deformation's output zeroed
        packed = args[0]
        still = dict(packed, wdo=torch.zeros_like(packed["wdo"]),
                     bdo=torch.zeros_like(packed["bdo"]))
        zeroed = ({}, {})
        fn(still, *args[1:], **kw, raws=zeroed[0])
        fused_level_train_art_grads(still, *args[1:], **kw, raws=zeroed[1])
        assert not torch.equal(zeroed[0]["raw_sigma"], raws["raw_sigma"])
    rec = _check(got, got, r, mode, zeroed=zeroed)
    assert rec["ok"], rec
    assert rec["raw_max_abs_err"] == 0.0
    assert rec["weights_max_abs_err"] <= 1e-6 and rec["loss_rel_err"] <= 1e-5, rec
    if mode != "vanilla":
        assert rec["acc_max_abs_err"] <= 1e-6, rec
