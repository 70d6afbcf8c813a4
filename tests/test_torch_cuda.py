"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips where torch.cuda.is_available() is False,
as on a CPU-only host.  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances, and why:
  * kernel 1 against its twin: TWIN_TOL_MAX absolute on raw outputs and
    TWIN_TOL_MEAN on their mean, the limits chip_smoke.py holds it to (their
    reasons stand beside them in aon_tpu_torch/ops/fused_mlp_train.py);
  * the in-kernel encoding against encode_plain: 1e-6 (an ulp of the sine);
    against the exact sine at the 2^9 frequency: 2e-3, the TPU suite's bound;
  * kernel 2 against its twin: 1e-6; the same f32 operations in the same
    order, so the union is expected to be bit-identical;
  * the training kernels (one fused level, the MLP backward) against their
    twins: every gradient tensor's largest error within GRAD_TOL_REL of its
    own largest magnitude and its mean error within GRAD_TOL_MEAN_REL of its
    mean magnitude, and the same launch twice within GRAD_TOL_REPEAT (only
    the atomicAdd order differs); their reasons stand beside them in
    aon_tpu_torch/ops/fused_mlp_train.py.  The level's compositing weights
    and squared error: TWIN_TOL_MAX, as the raw outputs they are made from;
  * the three articulated kernels against their twins: the forward within
    fused_art.TWIN_TOL_MAX / TWIN_TOL_MEAN, the gradients within
    fused_art.GRAD_TOL_REL / GRAD_TOL_MEAN_REL (wider than the vanilla
    kernels': a bf16 step in the deformation output is multiplied by up to 2^9
    inside the encoding), the deformation's gradients by direction and size
    (fused_art.grads_close); the reasons stand beside them in
    aon_tpu_torch/ops/fused_art.py);
  * the public API's kernels (rows 5, 7 and 8: one MLP, three stagings of
    its input; row 6: the weight backward from given encodings) against
    their twins: the limits of kernels 1 and 4 above, for the same reasons;
  * the extraction's sigma grid on the card against its plain twins' grid:
    TWIN_TOL_MAX / TWIN_TOL_MEAN of the kernel its system runs (sigma is
    relu or softplus of the raw output, which moves no value further);
  * the kernel bench's variants (rows 12 and 13) against their twins: the
    limits of kernel 1, for the same reasons (the bf16acc body rounds more
    often, each rounding as likely to flip as kernel 1's one per layer); the
    base and two-stream bodies bit-identical to row 5 (the same products,
    K in the same order), the elementwise encoder bit-identical to row 1;
    row 14's wrapper with each encoder: the limits stated above its test;
  * the eval kernel (rows 1, 5, 7, 8, 12, 13: one persistent wgmma kernel
    on 128-row tiles) at row counts around its tiles and with rays that
    straddle them: the limits of kernel 1, the two-stream body bit-identical
    to the base body, rows 1 and 8 bit-identical to each other;
  * the scripts (bench_eval, bench_art, profile_ae_host, roofline_ae,
    demo_sphere, visualize_cameras) through their main() at small sizes: the
    exact launches of the rows each runs, finite outputs, and the sphere's
    image on the card against the CPU's under the same draws within one level
    on all but 0.5% of its pixels (chip_smoke's TOL_SPHERE_OFF_SHARE: a
    sample within the two devices' rounding of the surface lies on either
    side of it).
"""

import numpy as np
import pytest
import torch

import json
import math
import types
from pathlib import Path

from aon_tpu_torch.core.sampling import eval_quantiles, pdf_cdf
from aon_tpu_torch.eval.render import render_frame
from aon_tpu_torch.ops import bench_variants as bv
from aon_tpu_torch.ops import fused_art
from aon_tpu_torch.ops import fused_mlp as tfm
from aon_tpu_torch.ops import fused_mlp_train as tfmt
from aon_tpu_torch.ops import train_sm90 as ts
from aon_tpu_torch.ops.fused_mlp import (
    SHAPES,
    make_posenc_constants,
    pack_vanilla_mlp_params,
    pack_vanilla_mlp_params_f32,
)
from aon_tpu_torch.ops.fused_mlp_train import (
    GRAD_TOL_MEAN_REL,
    GRAD_TOL_REL,
    GRAD_TOL_REPEAT,
    TWIN_TOL_MAX,
    TWIN_TOL_MEAN,
    encode_plain,
    fused_mlp_bwd_xyz,
    fused_mlp_bwd_xyz_plain,
    fused_mlp_train_xyz,
    fused_nerf_mlp_xyz_eval,
    fused_nerf_mlp_xyz_eval_plain,
    grad_errors,
    posenc_in_kernel,
)
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.resample import resample_union, resample_union_plain, sorted_uniform
from aon_tpu_torch.ops.train_fused_level import (
    fused_level_train_grads,
    fused_level_train_grads_plain,
)
from aon_tpu_torch.ops.train_fused_level_art import (
    fused_level_train_art_grads,
    fused_level_train_art_grads_plain,
)
from aon_tpu_torch.scripts import extract_geometry
from aon_tpu_torch.train.checkpoint import CheckpointManager
from aon_tpu_torch.train.systems import build_system
from aon_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(device, seed=0):
    system = build_system(Config(), 2.0, 6.0, True, device=device)
    return system.init_params(torch.Generator(device=device).manual_seed(seed))


@pytest.mark.parametrize("B,S", [(37, 65), (64, 193)])  # ragged and whole 64-row tiles
def test_mlp_kernel_matches_plain_twin(cuda, B, S):
    g = torch.Generator(device=cuda).manual_seed(1)
    packed = pack_vanilla_mlp_params(mlp_params(_params(cuda), "fine_mlp"))
    consts = make_posenc_constants(device=cuda)
    samples = torch.rand(B, S, 3, generator=g, device=cuda) * 6 - 3
    vd = torch.nn.functional.normalize(torch.randn(B, 3, generator=g, device=cuda), dim=-1)
    before = fused_nerf_mlp_xyz_eval.launches
    rgb, sigma = fused_nerf_mlp_xyz_eval(packed, consts, samples, vd)
    torch.cuda.synchronize()
    assert fused_nerf_mlp_xyz_eval.launches == before + 1
    rgb_p, sigma_p = fused_nerf_mlp_xyz_eval_plain(packed, consts, samples, vd)
    assert torch.isfinite(rgb).all() and torch.isfinite(sigma).all()
    err = torch.cat([(rgb - rgb_p).reshape(-1), (sigma - sigma_p).reshape(-1)]).abs()
    assert err.max().item() <= TWIN_TOL_MAX
    assert err.mean().item() <= TWIN_TOL_MEAN


def test_posenc_range_reduction(cuda):
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.uniform(-6, 6, (4096, 3)).astype(np.float32)).to(cuda)
    consts = make_posenc_constants(device=cuda)
    for s, p in (("s_pos", "p_pos"), ("s_view", "p_view")):
        got = posenc_in_kernel(x, consts[s], consts[p])
        assert (got - encode_plain(x, consts[s], consts[p])).abs().max().item() <= 1e-6
        s64, p64 = consts[s].double().cpu().numpy(), consts[p].double().cpu().numpy()
        pre = x.double().cpu().numpy() @ s64[:3] + p64
        exact = np.where(np.arange(pre.shape[1]) < 3, pre, np.sin(pre))
        assert np.abs(got.cpu().numpy() - exact).max() <= 2e-3


@pytest.mark.parametrize("B", [1001, 2048])  # ragged against the 8-ray blocks; a train batch
def test_resample_kernel_matches_plain_twin(cuda, B):
    g = torch.Generator(device=cuda).manual_seed(2)
    t_vals = torch.sort(torch.rand(B, 65, generator=g, device=cuda) * 4 + 2, dim=-1).values
    bins = 0.5 * (t_vals[:, 1:] + t_vals[:, :-1])
    weights = torch.rand(B, 63, generator=g, device=cuda)
    weights[0] = 0.0
    weights[1, :60] = 0.0
    cdf = pdf_cdf(weights).contiguous()
    for u in (eval_quantiles(128, device=cuda).expand(B, 128),  # shared row, last u = 1
              torch.sort(torch.rand(B, 128, generator=g, device=cuda), dim=-1).values,
              # training's per-ray order statistics: unshared rows, sorted by construction
              sorted_uniform(torch.rand(B, 129, generator=g, device=cuda))):
        before = resample_union.launches
        got = resample_union(t_vals, bins, cdf, u)
        torch.cuda.synchronize()
        assert resample_union.launches == before + 1
        want = resample_union_plain(t_vals, bins, cdf, u)
        assert (got - want).abs().max().item() <= 1e-6


def test_render_frame_goes_through_both_kernels(cuda):
    system = build_system(Config(), 2.0, 6.0, True, device=cuda)
    params = system.init_params(torch.Generator(device=cuda).manual_seed(0))
    g = np.random.default_rng(3)
    d = g.normal(size=(150, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    frame = {"rays_o": -4 * d, "rays_d": d, "viewdirs": d}
    mlp0, res0 = fused_nerf_mlp_xyz_eval.launches, resample_union.launches
    out = render_frame(lambda r: system.render_chunk(params, r), frame, chunk=64, device=cuda)
    assert fused_nerf_mlp_xyz_eval.launches - mlp0 == 6  # 3 chunks x 2 levels
    assert resample_union.launches - res0 == 3
    assert out["comp_rgb"].shape == (150, 3) and np.isfinite(out["comp_rgb"]).all()
    assert (out["acc"] >= 0).all() and (out["acc"] <= 1 + 1e-5).all()


def assert_grads_close(got, want):
    for k, shape in SHAPES.items():
        assert tuple(got[k].shape) == shape and torch.isfinite(got[k]).all(), k
    max_rel, mean_rel = grad_errors(got, want)
    assert max_rel <= GRAD_TOL_REL and mean_rel <= GRAD_TOL_MEAN_REL, (max_rel, mean_rel)


def _level_inputs(cuda, B, S, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    packed = pack_vanilla_mlp_params_f32(mlp_params(_params(cuda), "coarse_mlp"))
    # positive density bias so that rays are partly opaque, as a trained scene's are
    packed["bd"] = packed["bd"] + 0.3
    consts = make_posenc_constants(device=cuda)
    d = torch.nn.functional.normalize(torch.randn(B, 3, generator=g, device=cuda), dim=-1)
    o = -4.0 * d + 0.3 * torch.randn(B, 3, generator=g, device=cuda)
    t = torch.sort(torch.rand(B, S, generator=g, device=cuda) * 4 + 2, dim=-1).values.contiguous()
    target = torch.rand(B, 3, generator=g, device=cuda)
    return packed, consts, t, o, d, target


@pytest.mark.parametrize("B,S,white", [(37, 65, True), (5, 17, False), (2048, 193, True)])
def test_level_kernel_matches_plain_twin(cuda, B, S, white):
    packed, consts, t, o, d, target = _level_inputs(cuda, B, S, seed=4)
    before = fused_level_train_grads.launches
    sq, wgt, grads = fused_level_train_grads(packed, consts, t, o, d, d, target, white)
    torch.cuda.synchronize()
    assert fused_level_train_grads.launches == before + 1
    sq_p, wgt_p, grads_p = fused_level_train_grads_plain(packed, consts, t, o, d, d, target, white)
    assert wgt.shape == (B, S) and torch.isfinite(wgt).all()
    assert (wgt - wgt_p).abs().max().item() <= TWIN_TOL_MAX
    assert abs(sq.item() - sq_p.item()) <= TWIN_TOL_MAX * sq_p.item()
    assert_grads_close(grads, grads_p)
    # the same launch again: only the order of the atomic sums differs
    sq2, wgt2, grads2 = fused_level_train_grads(packed, consts, t, o, d, d, target, white)
    assert torch.equal(wgt, wgt2)
    assert grad_errors(grads2, grads)[0] <= GRAD_TOL_REPEAT


@pytest.mark.parametrize("B,S", [(37, 65), (2048, 193)])
def test_mlp_bwd_kernel_matches_plain_twin(cuda, B, S):
    packed, consts, t, o, d, _ = _level_inputs(cuda, B, S, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    samples = (o[:, None, :] + t[..., None] * d[:, None, :]).contiguous()
    cot = torch.randn(B, S, 4, generator=g, device=cuda) / (B * S)
    cot[:, ::3] = 0.0  # rows without a cotangent
    before = fused_mlp_bwd_xyz.launches
    grads = fused_mlp_bwd_xyz(packed, consts, samples, d, cot)
    torch.cuda.synchronize()
    assert fused_mlp_bwd_xyz.launches == before + 1
    assert_grads_close(grads, fused_mlp_bwd_xyz_plain(packed, consts, samples, d, cot))
    again = fused_mlp_bwd_xyz(packed, consts, samples, d, cot)
    assert grad_errors(again, grads)[0] <= GRAD_TOL_REPEAT


def test_fused_mlp_train_xyz_backward_launches_the_kernel(cuda):
    params = {k: v.requires_grad_(True) for k, v in mlp_params(_params(cuda), "fine_mlp").items()}
    consts = make_posenc_constants(device=cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    samples = torch.rand(9, 33, 3, generator=g, device=cuda) * 4 - 2
    vd = torch.nn.functional.normalize(torch.randn(9, 3, generator=g, device=cuda), dim=-1)
    fwd0, bwd0 = fused_nerf_mlp_xyz_eval.launches, fused_mlp_bwd_xyz.launches
    rgb, sigma = fused_mlp_train_xyz(params, consts, samples, vd)
    (rgb.sum() + 2 * sigma.sum()).backward()
    assert (fused_nerf_mlp_xyz_eval.launches, fused_mlp_bwd_xyz.launches) == (fwd0 + 1, bwd0 + 1)
    cot = torch.cat([torch.ones_like(rgb), 2 * torch.ones_like(sigma)], dim=-1)
    want = fused_mlp_bwd_xyz_plain(
        pack_vanilla_mlp_params_f32({k: v.detach() for k, v in params.items()}), consts, samples,
        vd, cot)
    got = params["pts_3.weight"].grad.t()
    assert (got - want["w3"]).abs().max() <= GRAD_TOL_REL * want["w3"].abs().max()
    assert samples.grad is None


def test_train_many_runs_the_v3_route_with_per_ray_streams(cuda):
    cfg = Config(N_samples=16, N_importance=16)
    system = build_system(cfg, 2.0, 6.0, True, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = system.init_state(gen)
    T, k, m = 2, 2, 48
    d = torch.nn.functional.normalize(torch.randn(T, k, m, 3, generator=gen, device=cuda), dim=-1)
    superbatch = {"rays_o": -4.0 * d, "rays_d": d, "viewdirs": d,
                  "target": torch.rand(T, k, m, 3, generator=gen, device=cuda)}
    level0, res0 = fused_level_train_grads.launches, resample_union.launches
    state, metrics = system.train_many(state, superbatch, gen)
    torch.cuda.synchronize()
    assert state.step == T
    assert fused_level_train_grads.launches - level0 == 2 * T * k  # two levels per microbatch
    assert resample_union.launches - res0 == T * k
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(torch.isfinite(v).all() for v in state.params.values())


# ------------------------------------------------------ articulated kernels


def _art_system(device, **overrides):
    cfg = Config(exp_type="vanilla_autodecoder", N_max_objs=4, white_back=False, **overrides)
    return build_system(cfg, 2.0, 6.0, False, device=device)


def _art_inputs(cuda, B, S, seed):
    """Effective weights of a seeded articulated MLP (live biases, a density
    bias that makes rays partly opaque) and one level's ray inputs."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    system = _art_system(cuda)
    params = system.init_params(g)
    mlp = {k: (v if v.ndim == 2 else 0.05 * torch.randn(v.shape, generator=g, device=cuda))
           for k, v in mlp_params(params, "model.coarse_mlp").items()}
    mlp["density.bias"] = mlp["density.bias"] + 1.5
    latents = {"density": 0.1 * torch.randn(1, 128, generator=g, device=cuda),
               "color": 0.1 * torch.randn(1, 128, generator=g, device=cuda),
               "articulation": 0.1 * torch.randn(1, 32, generator=g, device=cuda)}
    packed = fused_art.fold_latents(mlp, latents)
    consts = make_posenc_constants(device=cuda)
    d = torch.nn.functional.normalize(torch.randn(B, 3, generator=g, device=cuda), dim=-1)
    o = -4.0 * d + 0.3 * torch.randn(B, 3, generator=g, device=cuda)
    t = torch.sort(torch.rand(B, S, generator=g, device=cuda) * 4 + 2, dim=-1).values.contiguous()
    target = torch.rand(B, 3, generator=g, device=cuda)
    return packed, consts, t, o, d, target, g


def assert_art_grads_close(got, want):
    assert set(got) == set(fused_art.EFF_SHAPES) and all(
        tuple(got[k].shape) == fused_art.EFF_SHAPES[k] for k in got)
    assert all(torch.isfinite(v).all() for v in got.values())
    assert fused_art.grads_close(got, want), (
        fused_art.grad_errors(got, want), fused_art.deform_direction(got, want))


@pytest.mark.parametrize("B,S", [(37, 65), (5, 17), (64, 193)])  # ragged and whole tiles
def test_art_fwd_kernel_matches_plain_twin(cuda, B, S):
    packed, consts, t, o, d, _, _ = _art_inputs(cuda, B, S, seed=11)
    samples = (o[:, None, :] + t[..., None] * d[:, None, :]).contiguous()
    before = fused_art.art_mlp_fwd.launches
    rgb, sigma = fused_art.art_mlp_fwd(packed, consts, samples, d)
    torch.cuda.synchronize()
    assert fused_art.art_mlp_fwd.launches == before + 1
    rgb_p, sigma_p = fused_art.art_mlp_fwd_plain(packed, consts, samples, d)
    assert torch.isfinite(rgb).all() and torch.isfinite(sigma).all()
    err = torch.cat([(rgb - rgb_p).reshape(-1), (sigma - sigma_p).reshape(-1)]).abs()
    assert err.max().item() <= fused_art.TWIN_TOL_MAX
    assert err.mean().item() <= fused_art.TWIN_TOL_MEAN


@pytest.mark.parametrize("B,S", [(37, 65), (5, 17), (512, 193)])
def test_art_bwd_kernel_matches_plain_twin(cuda, B, S):
    packed, consts, t, o, d, _, g = _art_inputs(cuda, B, S, seed=12)
    samples = (o[:, None, :] + t[..., None] * d[:, None, :]).contiguous()
    cot = torch.randn(B, S, 4, generator=g, device=cuda) / (B * S)
    cot[:, ::3] = 0.0  # rows without a cotangent
    before = fused_art.art_mlp_bwd.launches
    grads = fused_art.art_mlp_bwd(packed, consts, samples, d, cot)
    torch.cuda.synchronize()
    assert fused_art.art_mlp_bwd.launches == before + 1
    assert_art_grads_close(grads, fused_art.art_mlp_bwd_plain(packed, consts, samples, d, cot))
    assert not grads["wd0x"][3].any() and not grads["wdo"][:, 3].any()  # the padding
    again = fused_art.art_mlp_bwd(packed, consts, samples, d, cot)
    assert grad_errors(again, grads)[0] <= GRAD_TOL_REPEAT


ART_LEVEL_CASES = {
    "autodecoder": dict(white_bkgd=False, rgb_padding=0.001, density_bias=-1.0, bce_weight=0.0,
                        sigma_act="softplus_bias"),
    "autoencoder": dict(white_bkgd=False, rgb_padding=0.0, density_bias=0.0, bce_weight=0.5,
                        sigma_act="relu"),
    "white_bkgd": dict(white_bkgd=True, rgb_padding=0.001, density_bias=-1.0, bce_weight=0.0,
                       sigma_act="softplus_bias"),
}


@pytest.mark.parametrize("case", list(ART_LEVEL_CASES))
@pytest.mark.parametrize("B,S", [(37, 65), (5, 17), (512, 193)])
def test_art_level_kernel_matches_plain_twin(cuda, B, S, case):
    packed, consts, t, o, d, target, g = _art_inputs(cuda, B, S, seed=13)
    mask = (torch.rand(B, generator=g, device=cuda) > 0.4).float()
    lw = (mask / (3.0 * mask.sum()).clamp_min(1.0) if case == "autoencoder"
          else (0.5 + torch.rand(B, generator=g, device=cuda)) / (3.0 * B))
    args = (packed, consts, t, o, d, d, target, lw.contiguous(), mask)
    kw = ART_LEVEL_CASES[case]
    before = fused_level_train_art_grads.launches
    photo, wgt, acc, grads = fused_level_train_art_grads(*args, **kw)
    torch.cuda.synchronize()
    assert fused_level_train_art_grads.launches == before + 1
    photo_p, wgt_p, acc_p, grads_p = fused_level_train_art_grads_plain(*args, **kw)
    assert wgt.shape == (B, S) and acc.shape == (B,) and torch.isfinite(wgt).all()
    assert acc_p.max().item() > 0.05  # the rays do hit something
    assert (wgt - wgt_p).abs().max().item() <= fused_art.TWIN_TOL_MAX
    assert (acc - acc_p).abs().max().item() <= fused_art.TWIN_TOL_MAX
    assert abs(photo.item() - photo_p.item()) <= fused_art.TWIN_TOL_MAX * photo_p.item()
    assert_art_grads_close(grads, grads_p)
    again = fused_level_train_art_grads(*args, **kw)
    assert torch.equal(wgt, again[1])
    assert grad_errors(again[3], grads)[0] <= GRAD_TOL_REPEAT


def test_fused_art_mlp_train_backward_launches_the_kernel(cuda):
    params = _art_system(cuda).init_params(torch.Generator(device=cuda).manual_seed(3))
    mlp = {k: v.requires_grad_(True) for k, v in mlp_params(params, "model.fine_mlp").items()}
    g = torch.Generator(device=cuda).manual_seed(7)
    latents = {k: (0.1 * torch.randn(1, n, generator=g, device=cuda)).requires_grad_(True)
               for k, n in (("density", 128), ("color", 128), ("articulation", 32))}
    samples = torch.rand(9, 33, 3, generator=g, device=cuda) * 4 - 2
    vd = torch.nn.functional.normalize(torch.randn(9, 3, generator=g, device=cuda), dim=-1)
    fwd0, bwd0 = fused_art.art_mlp_fwd.launches, fused_art.art_mlp_bwd.launches
    rgb, sigma = fused_art.fused_art_mlp_train(mlp, latents, samples, vd)
    (rgb.sum() + 2 * sigma.sum()).backward()
    assert (fused_art.art_mlp_fwd.launches, fused_art.art_mlp_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in mlp.values())
    assert all(v.grad is not None and v.grad.abs().max() > 0 for v in latents.values())
    assert samples.grad is None


@pytest.mark.parametrize("fused_train", ["v3", "v2"])
def test_autodecoder_step_and_render_go_through_the_kernels(cuda, fused_train):
    system = _art_system(cuda, N_samples=16, N_importance=16, fused_train=fused_train)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = system.init_state(gen)
    k, m = 2, 48
    d = torch.nn.functional.normalize(torch.randn(k, m, 3, generator=gen, device=cuda), dim=-1)
    batch = {"rays_o": -4.0 * d, "rays_d": d, "viewdirs": d,
             "target": torch.rand(k, m, 3, generator=gen, device=cuda),
             "instance_id": 1, "articulation_id": 2}
    counters = (fused_level_train_art_grads, fused_art.art_mlp_fwd, fused_art.art_mlp_bwd,
                resample_union)
    before = [c.launches for c in counters]
    new_state, metrics = system.train_step(state, batch, gen)
    torch.cuda.synchronize()
    delta = [c.launches - b for c, b in zip(counters, before)]
    assert delta == ([2 * k, 0, 0, k] if fused_train == "v3" else [0, 2 * k, 2 * k, k])
    assert all(torch.isfinite(v).all() for v in metrics.values())
    # only the indexed rows of the code tables move
    for name, row in (("embedding_instance_shape", 1), ("embedding_instance_appearance", 1),
                      ("embedding_instance_articulation", 2)):
        moved = (new_state.params[f"code_library.{name}.weight"]
                 - state.params[f"code_library.{name}.weight"]).abs().sum(dim=1) > 0
        assert moved.nonzero().flatten().tolist() == [row], name
    before = [c.launches for c in counters]
    rays = {key: batch[key][0] for key in ("rays_o", "rays_d", "viewdirs")}
    out = system.render_chunk(new_state.params, rays, 1, 3, is_test=True)
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 2, 0, 1]
    assert out["comp_rgb"].shape == (m, 3) and all(torch.isfinite(v).all() for v in out.values())


# ------------------------------------------------------- public kernel API


def _encodings(cuda, B, S, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    consts = make_posenc_constants(device=cuda)
    samples = torch.rand(B, S, 3, generator=g, device=cuda) * 6 - 3
    vd = torch.nn.functional.normalize(torch.randn(B, 3, generator=g, device=cuda), dim=-1)
    enc = encode_plain(samples.reshape(-1, 3), consts["s_pos"], consts["p_pos"])
    venc = encode_plain(vd, consts["s_view"], consts["p_view"])
    return consts, samples, vd, enc, venc, g


def _assert_twin(got, want):
    err = torch.cat([(a - b).reshape(-1) for a, b in zip(got, want)]).abs()
    assert all(torch.isfinite(t).all() for t in got)
    assert err.max().item() <= TWIN_TOL_MAX and err.mean().item() <= TWIN_TOL_MEAN


@pytest.mark.parametrize("B,S,width", [(37, 65, 63), (64, 193, 64)])  # ragged, whole tiles
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoded_input_kernels_match_their_twins(cuda, B, S, width, dtype):
    params = mlp_params(_params(cuda), "fine_mlp")
    packed = pack_vanilla_mlp_params(params, dtype=dtype)
    twin_packed = tfm.round_packed(packed) if dtype == torch.float32 else packed
    _, _, _, enc, venc, _ = _encodings(cuda, B, S, seed=21)
    vwidth = 32 if width == 64 else 27
    enc, venc = enc[:, :width].contiguous(), venc[:, :vwidth].contiguous()
    venc_rows = torch.repeat_interleave(venc, S, dim=0)
    counters = (tfm.fused_nerf_mlp, tfm.fused_nerf_mlp_per_ray)
    before = [c.launches for c in counters]
    flat = tfm.fused_nerf_mlp(packed, enc, venc_rows)
    per_ray = tfm.fused_nerf_mlp_per_ray(packed, enc.reshape(B, S, -1), venc)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1]
    assert flat[0].shape == (B * S, 3) and per_ray[1].shape == (B, S, 1)
    _assert_twin(flat, tfm.fused_nerf_mlp_plain(twin_packed, enc, venc_rows))
    _assert_twin(per_ray, tfm.fused_nerf_mlp_per_ray_plain(twin_packed, enc.reshape(B, S, -1),
                                                           venc))
    # the same rows, the view row gathered per ray: the same values
    assert torch.equal(per_ray[0].reshape(-1, 3), flat[0])


@pytest.mark.parametrize("B,S", [(37, 65), (512, 128)])  # ragged; the extraction's block
def test_xyz_per_ray_kernel_matches_its_twin_and_row_1(cuda, B, S):
    packed = pack_vanilla_mlp_params(mlp_params(_params(cuda), "fine_mlp"))
    consts, samples, vd, _, _, _ = _encodings(cuda, B, S, seed=22)
    before = (tfm.fused_nerf_mlp_xyz.launches, fused_nerf_mlp_xyz_eval.launches)
    got = tfm.fused_nerf_mlp_xyz(packed, consts, samples, vd)
    torch.cuda.synchronize()
    assert (tfm.fused_nerf_mlp_xyz.launches, fused_nerf_mlp_xyz_eval.launches) == (
        before[0] + 1, before[1])
    _assert_twin(got, tfm.fused_nerf_mlp_xyz_plain(packed, consts, samples, vd))
    row1 = fused_nerf_mlp_xyz_eval(packed, consts, samples, vd)
    assert torch.equal(got[0], row1[0]) and torch.equal(got[1], row1[1])


@pytest.mark.parametrize("B,S", [(37, 65), (2048, 193)])
def test_encoded_bwd_kernel_matches_twin_and_the_xyz_backward(cuda, B, S):
    packed, consts, t, o, d, _ = _level_inputs(cuda, B, S, seed=23)
    g = torch.Generator(device=cuda).manual_seed(24)
    samples = (o[:, None, :] + t[..., None] * d[:, None, :]).contiguous()
    cot = torch.randn(B, S, 4, generator=g, device=cuda) / (B * S)
    cot[:, ::3] = 0.0
    enc = encode_plain(samples.reshape(-1, 3), consts["s_pos"], consts["p_pos"])
    venc = encode_plain(torch.repeat_interleave(d, S, 0), consts["s_view"], consts["p_view"])
    before = tfmt.fused_mlp_bwd.launches
    grads = tfmt.fused_mlp_bwd(packed, enc[:, :63], venc[:, :27], cot.reshape(-1, 4))
    torch.cuda.synchronize()
    assert tfmt.fused_mlp_bwd.launches == before + 1
    assert_grads_close(grads, tfmt.fused_mlp_bwd_plain(packed, enc, venc, cot.reshape(-1, 4)))
    # the encodings are the in-kernel ones to a sine ulp: row 4's gradients
    assert_grads_close(grads, fused_mlp_bwd_xyz(packed, consts, samples, d, cot))
    again = tfmt.fused_mlp_bwd(packed, enc, venc, cot.reshape(-1, 4))
    assert grad_errors(again, grads)[0] <= GRAD_TOL_REPEAT


def test_fused_mlp_train_runs_rows_5_and_6(cuda):
    packed = {k: v.requires_grad_(True) for k, v in pack_vanilla_mlp_params_f32(
        mlp_params(_params(cuda), "fine_mlp")).items()}
    _, _, _, enc, venc, _ = _encodings(cuda, 9, 33, seed=25)
    venc_rows = torch.repeat_interleave(venc, 33, dim=0)
    before = (tfm.fused_nerf_mlp.launches, tfmt.fused_mlp_bwd.launches)
    rgb, sigma = tfmt.fused_mlp_train(packed, enc, venc_rows)
    (rgb.sum() + 2 * sigma.sum()).backward()
    assert (tfm.fused_nerf_mlp.launches, tfmt.fused_mlp_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    cot = torch.cat([torch.ones_like(rgb), 2 * torch.ones_like(sigma)], dim=-1)
    plain = {k: v.detach() for k, v in packed.items()}
    assert_grads_close({k: v.grad for k, v in packed.items()},
                       tfmt.fused_mlp_bwd_plain(plain, enc, venc_rows, cot))
    _assert_twin((rgb, sigma), tfm.fused_nerf_mlp_plain(tfm.round_packed(plain), enc, venc_rows))


@pytest.mark.parametrize("exp_type", ["vanilla", "vanilla_autodecoder"])
def test_extract_geometry_goes_through_its_kernel(cuda, tmp_path, monkeypatch, exp_type):
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"exp_type": exp_type, "exp_name": "geo", "N_max_objs": 4,
                                    "output_path": str(tmp_path / "results")}))
    cfg = Config(exp_type=exp_type, N_max_objs=4)
    system = build_system(cfg, 2.0, 6.0, False, device=cuda)
    state = system.init_state(torch.Generator(device=cuda).manual_seed(0))
    CheckpointManager(str(tmp_path / "results" / "geo")).save_last(state, epoch=0)
    monkeypatch.chdir(tmp_path)
    counter = tfm.fused_nerf_mlp_xyz if exp_type == "vanilla" else fused_art.art_mlp_fwd
    before = counter.launches
    out = extract_geometry.main(["--config", str(cfg_file), "--resolution", "32", "--chunk",
                                 "4096", "--bounds", "-1.5", "-1.5", "-1.5", "1.5", "1.5", "1.5",
                                 "--instance", "1", "--articulation", "3", "--interpolated"])
    assert counter.launches - before == out["queries"] == 8
    sigma = np.load(Path(out["out_dir"]) / "density_grid.npz")["sigma"].reshape(-1)
    trainer = types.SimpleNamespace(cfg=cfg, state=state, system=system)
    args = types.SimpleNamespace(viewdir=(0.0, 0.0, -1.0), instance=1, articulation=3,
                                 interpolated=True)
    pts = torch.from_numpy(extract_geometry.voxel_centers(
        np.full(3, -1.5), 3.0 / 32, 32).reshape(-1, 3).astype(np.float32)).to(cuda)
    want = extract_geometry.density_color_fn(trainer, args, plain=True)(pts)[0].cpu().numpy()
    tol = (TWIN_TOL_MAX, TWIN_TOL_MEAN) if exp_type == "vanilla" else (
        fused_art.TWIN_TOL_MAX, fused_art.TWIN_TOL_MEAN)
    err = np.abs(sigma - want)
    assert err.max() <= tol[0] and err.mean() <= tol[1]


# ------------------------------------------------ the kernel bench's variants


def _bench_inputs(device, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return {"enc": torch.randn(n, 64, generator=g, device=device),
            "venc": torch.randn(n, 32, generator=g, device=device),
            "xyz": torch.randn(n, 3, generator=g, device=device),
            "vdir": torch.randn(n, 3, generator=g, device=device)}


@pytest.mark.parametrize("n", [1000, 65536])  # ragged against the 64-row tile; chip_smoke's
def test_mlp_body_variants_match_their_twins(cuda, n):
    packed = pack_vanilla_mlp_params(mlp_params(_params(cuda), "fine_mlp"))
    x = _bench_inputs(cuda, n, seed=31)
    outs = {}
    for body, fn in bv.MLP_BODY.items():
        before = fn.launches
        outs[body] = fn(packed, x["enc"], x["venc"])
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_twin(outs[body], bv.mlp_body_plain(x["enc"], x["venc"], packed, body))
    # the base body is row 5's kernel; the two streams compute the same per row
    row5 = tfm.fused_nerf_mlp(packed, x["enc"], x["venc"])
    for body in ("base", "2s"):
        assert torch.equal(outs[body][0], row5[0]) and torch.equal(outs[body][1], row5[1])


@pytest.mark.parametrize("n", [1000, 65536])
def test_xyz_body_variants_match_their_twins(cuda, n):
    packed = pack_vanilla_mlp_params(mlp_params(_params(cuda), "fine_mlp"))
    consts = make_posenc_constants(device=cuda)
    x = _bench_inputs(cuda, n, seed=32)
    for encoder, fn in bv.XYZ_BODY.items():
        before = fn.launches
        got = fn(packed, consts, x["xyz"], x["vdir"])
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_twin(got, bv.xyz_body_plain(packed, consts, x["xyz"], x["vdir"], encoder))
        if encoder == "elementwise":  # row 1's staging with one sample per ray
            row1 = fused_nerf_mlp_xyz_eval(packed, consts, x["xyz"][:, None], x["vdir"])
            assert torch.equal(got[0], row1[0].reshape(n, 3))


# row 14 (tests_tpu/test_kernel_parity.py::test_in_kernel_posenc_range_reduction)
# with each encoder: against the twin, 1e-6 (an ulp of the sine) for the
# elementwise and MXU encoders and 1e-4 for the doubling one, whose nine
# doublings carry an ulp of the first sine up by 2^9; against the exact sine
# in float64, the TPU suite's 2e-3.  The doubling encoder's padding columns
# hold the raw coordinates exactly.
@pytest.mark.parametrize("encoder", ["elementwise", "mxu", "doubling"])
def test_posenc_wrapper_with_each_encoder(cuda, encoder):
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.uniform(-6, 6, (256, 3)).astype(np.float32)).to(cuda)
    consts = make_posenc_constants(device=cuda)
    tol_twin = 1e-4 if encoder == "doubling" else 1e-6
    for s, p in (("s_pos", "p_pos"), ("s_view", "p_view")):
        before = posenc_in_kernel.launches
        got = posenc_in_kernel(x, consts[s], consts[p], encoder)
        assert posenc_in_kernel.launches == before + 1
        twin = bv.encode_plain(x, consts[s], consts[p], encoder)
        assert (got - twin).abs().max().item() <= tol_twin
        width = consts[s].shape[1]
        n_real = 63 if width == 64 else 27
        s64, p64 = consts[s].double().cpu().numpy(), consts[p].double().cpu().numpy()
        pre = x.double().cpu().numpy() @ s64[:3] + p64
        exact = np.where(np.arange(width) < 3, pre, np.sin(pre))[:, :n_real]
        assert np.abs(got.cpu().numpy()[:, :n_real] - exact).max() <= 2e-3
        if encoder == "doubling":
            cols = np.arange(n_real, width)
            assert torch.equal(got[:, n_real:], x[:, torch.from_numpy((cols - 3) % 3).to(cuda)])


# ------------------------------------------- the eval kernel's tiles (sm_90a)
# Every staging and body of the persistent wgmma kernel (ops/csrc/trunk_sm90.cuh)
# against its twin at the limits of kernel 1, at row counts around its
# 128-row tile: one row, a ragged single tile, one whole tile, one row into
# the second, 65,536 + 17 (513 tiles on 132 blocks) and 132 x 128 x 5 + 77
# (661 tiles: blocks walk five or six tiles each).


@pytest.mark.parametrize("n", [1, 127, 128, 129, 65536 + 17, 132 * 128 * 5 + 77])
def test_eval_kernel_every_staging_and_body_at_tile_edges(cuda, n):
    packed = pack_vanilla_mlp_params(mlp_params(_params(cuda), "fine_mlp"))
    consts = make_posenc_constants(device=cuda)
    x = _bench_inputs(cuda, n, seed=41)
    assert tfm.eval_launch_shape(n, tfm.sm_count(cuda))[0] == -(-n // 128)
    outs = {}
    for body, fn in bv.MLP_BODY.items():
        outs[body] = fn(packed, x["enc"], x["venc"])
        torch.cuda.synchronize()
        _assert_twin(outs[body], bv.mlp_body_plain(x["enc"], x["venc"], packed, body))
    for encoder, fn in bv.XYZ_BODY.items():
        got = fn(packed, consts, x["xyz"], x["vdir"])
        torch.cuda.synchronize()
        _assert_twin(got, bv.xyz_body_plain(packed, consts, x["xyz"], x["vdir"], encoder))
    # the two streams compute per row what the base body computes, bit for bit
    assert torch.equal(outs["2s"][0], outs["base"][0])
    assert torch.equal(outs["2s"][1], outs["base"][1])


@pytest.mark.parametrize("S", [65, 193])  # rays straddle the 128-row tiles
def test_eval_kernel_per_ray_stagings_across_tiles(cuda, S):
    B = 700  # 45,500 / 135,100 rows: every block walks several tiles
    packed = pack_vanilla_mlp_params(mlp_params(_params(cuda), "fine_mlp"))
    consts, samples, vd, enc, venc, _ = _encodings(cuda, B, S, seed=42)
    before = (fused_nerf_mlp_xyz_eval.launches, tfm.fused_nerf_mlp_xyz.launches,
              tfm.fused_nerf_mlp_per_ray.launches)
    row1 = fused_nerf_mlp_xyz_eval(packed, consts, samples, vd)
    row8 = tfm.fused_nerf_mlp_xyz(packed, consts, samples, vd)
    row7 = tfm.fused_nerf_mlp_per_ray(packed, enc.reshape(B, S, 64), venc)
    torch.cuda.synchronize()
    assert (fused_nerf_mlp_xyz_eval.launches, tfm.fused_nerf_mlp_xyz.launches,
            tfm.fused_nerf_mlp_per_ray.launches) == tuple(b + 1 for b in before)
    _assert_twin(row1, fused_nerf_mlp_xyz_eval_plain(packed, consts, samples, vd))
    _assert_twin(row7, tfm.fused_nerf_mlp_per_ray_plain(packed, enc.reshape(B, S, 64), venc))
    assert torch.equal(row1[0], row8[0]) and torch.equal(row1[1], row8[1])


# ------------------------------- the vanilla training kernels' tiles (sm_90a)
# The persistent wgmma forward and backward (128-row tiles) and the weight
# gradients (64-row chunks, row ranges per block) of ops/csrc/train_sm90.cuh,
# at row counts around their tiles and at the samples per ray of the render,
# the bench and the largest level: the limits of kernels 3, 4 and 6 above.


@pytest.mark.parametrize("n_pad", [64, 1024, 65664])  # one chunk; ragged ranges; 132 items
def test_weight_grads_kernel_matches_matmul(cuda, n_pad):
    """The weight gradients' MN-major wgmma operands (X^T, D) against
    torch.matmul on random bf16 workspaces: only the f32 sums' order differs."""
    g = torch.Generator(device=cuda).manual_seed(51)
    act = torch.randn(n_pad // 64, ts.ACT_CHUNKS, 64, 64, generator=g, device=cuda).bfloat16()
    grad = torch.randn(n_pad // 64, ts.GRAD_CHUNKS, 64, 64, generator=g, device=cuda).bfloat16()
    before = ts.weight_grads.launches
    got = ts.weight_grads(act, grad)
    torch.cuda.synchronize()
    assert ts.weight_grads.launches == before + 1
    want = ts.weight_grads_plain(act, grad)
    # f32 sums of n_pad products of magnitude ~1 in another order: their
    # rounding grows with n_pad (a layout fault moves entries by O(sqrt(n_pad)))
    assert (got - want).abs().max().item() <= 1e-6 * n_pad
    assert torch.equal(got == 0, want == 0)  # every entry of every dW written, nothing else


@pytest.mark.parametrize("B,S", [(59, 17), (1338, 49), (37, 193), (256, 256)])
def test_level_kernel_at_tile_edges(cuda, B, S):
    """Row 3 at 1,003 / 65,562 / 7,141 / 65,536 rows."""
    packed, consts, t, o, d, target = _level_inputs(cuda, B, S, seed=52)
    sq, wgt, grads = fused_level_train_grads(packed, consts, t, o, d, d, target, True)
    torch.cuda.synchronize()
    sq_p, wgt_p, grads_p = fused_level_train_grads_plain(packed, consts, t, o, d, d, target, True)
    assert (wgt - wgt_p).abs().max().item() <= TWIN_TOL_MAX
    assert abs(sq.item() - sq_p.item()) <= TWIN_TOL_MAX * sq_p.item()
    assert_grads_close(grads, grads_p)


@pytest.mark.parametrize("n", [1000, 65553])
def test_mlp_bwd_kernels_at_tile_edges(cuda, n):
    """Rows 4 (as n rays of one sample) and 6 on the same samples."""
    packed, consts, t, o, d, _ = _level_inputs(cuda, n, 1, seed=53)
    g = torch.Generator(device=cuda).manual_seed(54)
    samples = (o[:, None, :] + t[..., None] * d[:, None, :]).contiguous()
    cot = torch.randn(n, 1, 4, generator=g, device=cuda) / n
    row4 = fused_mlp_bwd_xyz(packed, consts, samples, d, cot)
    enc = encode_plain(samples.reshape(-1, 3), consts["s_pos"], consts["p_pos"])
    venc = encode_plain(d, consts["s_view"], consts["p_view"])
    row6 = tfmt.fused_mlp_bwd(packed, enc, venc, cot.reshape(-1, 4))
    torch.cuda.synchronize()
    assert_grads_close(row4, fused_mlp_bwd_xyz_plain(packed, consts, samples, d, cot))
    assert_grads_close(row6, tfmt.fused_mlp_bwd_plain(packed, enc, venc, cot.reshape(-1, 4)))


# ---------------------------------- articulated kernels (art_sm90.cuh) at tile edges


@pytest.mark.parametrize("B,S", [(40, 25), (21851, 3)])  # 1,000 and 65,553 rows
def test_art_sm90_fwd_and_bwd_at_tile_edges(cuda, B, S):
    """Rows 10 and 11 where the 128-row tiles and the persistent blocks end
    ragged: 1,000 rows (7 tiles, the last of 104 rows) and 65,553 (513 tiles
    over 132 blocks, the last of 17)."""
    packed, consts, t, o, d, _, g = _art_inputs(cuda, B, S, seed=21)
    samples = (o[:, None, :] + t[..., None] * d[:, None, :]).contiguous()
    rgb, sigma = fused_art.art_mlp_fwd(packed, consts, samples, d)
    rgb_p, sigma_p = fused_art.art_mlp_fwd_plain(packed, consts, samples, d)
    err = torch.cat([(rgb - rgb_p).reshape(-1), (sigma - sigma_p).reshape(-1)]).abs()
    assert err.max().item() <= fused_art.TWIN_TOL_MAX
    assert err.mean().item() <= fused_art.TWIN_TOL_MEAN
    cot = torch.randn(B, S, 4, generator=g, device=cuda) / (B * S)
    grads = fused_art.art_mlp_bwd(packed, consts, samples, d, cot)
    assert_art_grads_close(grads, fused_art.art_mlp_bwd_plain(packed, consts, samples, d, cot))


@pytest.mark.parametrize("case", ["autodecoder", "autoencoder"])  # softplus; relu + BCE
@pytest.mark.parametrize("B,S", [(40, 25), (37, 73), (11, 193), (256, 256)])
def test_art_sm90_level_at_tile_edges(cuda, B, S, case):
    """Row 9 at the bench's sample counts, the render's, and the largest S the
    compositing takes, with each head activation and the opacity BCE on and
    off."""
    packed, consts, t, o, d, target, g = _art_inputs(cuda, B, S, seed=22)
    mask = (torch.rand(B, generator=g, device=cuda) > 0.4).float()
    lw = (mask / (3.0 * mask.sum()).clamp_min(1.0) if case == "autoencoder"
          else torch.full((B,), 1.0 / (3.0 * B), device=cuda))
    args = (packed, consts, t, o, d, d, target, lw.contiguous(), mask)
    kw = ART_LEVEL_CASES[case]
    photo, wgt, acc, grads = fused_level_train_art_grads(*args, **kw)
    photo_p, wgt_p, acc_p, grads_p = fused_level_train_art_grads_plain(*args, **kw)
    assert (wgt - wgt_p).abs().max().item() <= fused_art.TWIN_TOL_MAX
    assert (acc - acc_p).abs().max().item() <= fused_art.TWIN_TOL_MAX
    assert abs(photo.item() - photo_p.item()) <= fused_art.TWIN_TOL_MAX * photo_p.item()
    assert_art_grads_close(grads, grads_p)


# ------------------------------------- rows 2 and 14 as redesigned (sm_90a)
# The resample kernel (ops/csrc/resample.cu) stages ray tiles as spans with
# a peeled head and tail: both entries against their twins at tile edges (1
# ray; 31 and 33, tiles of one ray; 1,001 and 2,048, 7- and 15-ray tiles with
# a ragged last tile; 2 x 132 x 32 -+ 1, 32-ray tiles with a last tile of 31
# rays or of one), at the paths' sample counts, with the shared eval row and
# per-ray rows of u, and with every input one float past a 16-byte line.
# resample_union and fused_resample against pdf_cdf_ordered +
# resample_union_plain: 1e-6, the same float32 operations in the same order;
# the kernel's CDF order (pdf_cdf_ordered) against pdf_cdf's on the card:
# 1e-6 on the CDF, whose 63-term sums run in another order.  The samples are
# not compared with pdf_cdf's: where a bin's mass is tiny (these weights are
# u^4, a fifth of the rays nearly empty) the inverse CDF magnifies an ulp of
# the CDF up to the bin's width: up to 2e-3 on these rays, 0.025 at the
# render chunk on an H100, where pdf_cdf taken on the host lies 0.032 from
# pdf_cdf taken on the card (chip_smoke.py's resample records).


def _one_float_in(x):
    """``x`` as a view one float past the start of its own buffer."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


@pytest.mark.parametrize("B", [1, 31, 33, 1001, 2048, 2 * 132 * 32 - 1, 2 * 132 * 32 + 1])
@pytest.mark.parametrize("n_t,n_u", [(17, 32), (25, 48), (65, 128)])
@pytest.mark.parametrize("shared", [True, False])
def test_resample_sm90_entries_at_tile_edges(cuda, B, n_t, n_u, shared):
    from aon_tpu_torch.ops.resample import fused_resample, pdf_cdf_ordered

    g = torch.Generator(device=cuda).manual_seed(B + n_t)
    t_vals = torch.sort(torch.rand(B, n_t, generator=g, device=cuda) * 4 + 2, dim=-1).values
    bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).contiguous()
    wgt = torch.rand(B, n_t, generator=g, device=cuda) ** 4
    wgt[::5] = 0.0
    wgt[1::5] *= 1e-9
    wgt[2::5, :-4] = 0.0
    if shared:
        u = eval_quantiles(n_u, device=cuda).expand(B, n_u)
    else:
        u = sorted_uniform(torch.rand(B, n_u + 1, generator=g, device=cuda))
    for misaligned in (False, True):
        if misaligned:
            t_vals, bins, wgt = map(_one_float_in, (t_vals, bins, wgt))
            u = (_one_float_in(u[0]).expand(B, n_u) if shared else _one_float_in(u))
        window = wgt[:, 1:-1]
        cdf_k = pdf_cdf_ordered(window)
        if misaligned:
            cdf_k = _one_float_in(cdf_k)
        before = resample_union.launches
        got_union = resample_union(t_vals, bins, cdf_k, u)
        got = fused_resample(t_vals, bins, window, u)
        torch.cuda.synchronize()
        assert resample_union.launches == before + 2
        want = resample_union_plain(t_vals, bins, cdf_k, u)
        assert (got_union - want).abs().max().item() <= 1e-6
        assert (got - want).abs().max().item() <= 1e-6
        assert bool((got[:, 1:] >= got[:, :-1]).all())
        assert (cdf_k - pdf_cdf(window)).abs().max().item() <= 1e-6


def test_fused_resample_launches_one_kernel(cuda):
    from torch.profiler import ProfilerActivity, profile

    from aon_tpu_torch.ops.resample import fused_resample

    g = torch.Generator(device=cuda).manual_seed(5)
    t_vals = torch.sort(torch.rand(2048, 65, generator=g, device=cuda) * 4 + 2, dim=-1).values
    bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).contiguous()
    wgt = torch.rand(2048, 65, generator=g, device=cuda)
    u = eval_quantiles(128, device=cuda).expand(2048, 128)
    fused_resample(t_vals, bins, wgt[:, 1:-1], u)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_resample(t_vals, bins, wgt[:, 1:-1], u)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.device_time_total > 0]
    assert len(kernels) == 1 and "resample_kernel" in kernels[0], kernels


# row 14's kernels (a thread per four columns; the doubling encoder's tile in
# shared memory) at row counts around their blocks of rows: each encoder
# against its twin and the exact sine at the limits of
# test_posenc_wrapper_with_each_encoder above.
@pytest.mark.parametrize("n", [1, 255, 256, 65537])
@pytest.mark.parametrize("encoder", ["elementwise", "mxu", "doubling"])
def test_posenc_sm90_at_row_edges(cuda, n, encoder):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.rand(n, 3, generator=g, device=cuda) * 12 - 6).contiguous()
    consts = make_posenc_constants(device=cuda)
    tol_twin = 1e-4 if encoder == "doubling" else 1e-6
    for s, p in (("s_pos", "p_pos"), ("s_view", "p_view")):
        before = posenc_in_kernel.launches
        got = posenc_in_kernel(x, consts[s], consts[p], encoder)
        torch.cuda.synchronize()
        assert posenc_in_kernel.launches == before + 1
        twin = bv.encode_plain(x, consts[s], consts[p], encoder)
        assert got.shape == twin.shape and bool(torch.isfinite(got).all())
        assert (got - twin).abs().max().item() <= tol_twin
        width = consts[s].shape[1]
        n_real = 63 if width == 64 else 27
        s64, p64 = consts[s].double().cpu().numpy(), consts[p].double().cpu().numpy()
        pre = x.double().cpu().numpy() @ s64[:3] + p64
        exact = np.where(np.arange(width) < 3, pre, np.sin(pre))[:, :n_real]
        assert np.abs(got.cpu().numpy()[:, :n_real] - exact).max() <= 2e-3


# ------------------------------------------------ the scripts on the card


def _launches():
    return {"row1": fused_nerf_mlp_xyz_eval.launches, "row2": resample_union.launches,
            "row9": fused_level_train_art_grads.launches, "row10": fused_art.art_mlp_fwd.launches,
            "row11": fused_art.art_mlp_bwd.launches}


def _launched(before):
    return {k: v - before[k] for k, v in _launches().items()}


def test_bench_eval_script_on_the_card(cuda, tmp_path, monkeypatch):
    from aon_tpu_torch.scripts import bench_eval, make_fixture_dataset

    before = _launches()
    recs = bench_eval.main(["--chunks", "153600"], device=cuda)
    frames = 4 * recs[0]["pieces"]  # a warm frame and three timed ones, two chunks each
    assert _launched(before)["row1"] == 2 * frames and _launched(before)["row2"] == frames
    assert recs[0]["peak_device_bytes"] > 0 and recs[0]["frame_ms"] > 0
    root = tmp_path / "data"
    make_fixture_dataset.main([str(root), "--n", "3", "--wh", "64", "48"])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"dataset_name": "sapien", "root_dir": str(root), "img_wh": [64, 48],
                               "use_aabb": True, "white_back": True, "chunk": 1024,
                               "N_samples": 16, "N_importance": 32}))
    monkeypatch.chdir(tmp_path)
    before = _launches()
    rec = bench_eval.main(["--config", str(cfg)], device=cuda)
    chunks = 6 * math.ceil(rec["hit_frac"] * rec["n_rays"] / 1024)  # six frames
    assert _launched(before)["row1"] == 2 * chunks and _launched(before)["row2"] == chunks
    assert np.isfinite(rec["comp_rgb"]).all()


@pytest.mark.parametrize("fused,rows", [("v3", ("row9", "row2")),
                                        ("v2", ("row10", "row11", "row2"))])
def test_bench_art_script_on_the_card(cuda, fused, rows):
    from aon_tpu_torch.scripts import bench_art

    before = _launches()
    rec = bench_art.main(["--batch", "256", "--steps_per_dispatch", "2", "--fused", fused],
                         device=cuda)
    steps = 6 * 2  # two warm dispatches and four timed ones
    per_step = {"row9": 2, "row2": 1, "row10": 2, "row11": 2}
    assert {k: _launched(before)[k] for k in rows} == {k: per_step[k] * steps for k in rows}
    assert all(math.isfinite(v) for v in rec["losses"]) and rec["value"] > 0


def test_ae_profile_and_roofline_scripts_on_the_card(cuda, tmp_path, monkeypatch):
    from aon_tpu_torch.scripts import make_fixture_dataset, profile_ae_host, roofline_ae

    root = tmp_path / "data"
    make_fixture_dataset.main([str(root), "--multi", "--n", "2", "--wh", "64", "48"])
    cfg = json.loads((Path(__file__).resolve().parent.parent / "configs"
                      / "smoke_ae_art.json").read_text())
    cfg.update(root_dir=str(root), output_path=str(tmp_path / "results"), steps_per_dispatch=2)
    path = tmp_path / "ae.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    before = _launches()
    rep = profile_ae_host.main(["--config", str(path), "--dispatches", "1"], device=cuda)
    assert _launched(before)["row9"] > 0 and _launched(before)["row2"] > 0
    assert 0 <= rep["dispatch_device_idle_share"] < 1 and rep["end2end_rays_per_sec"] > 0
    before = _launches()
    args = roofline_ae.build_parser().parse_args(["--dispatches", "1",
                                                  "--out", str(tmp_path / "r.json")])
    roof = roofline_ae.measure(args, device=cuda, batch=256, steps_per_dispatch=2,
                               img_wh=(64, 48))
    assert _launched(before)["row9"] > 0 and _launched(before)["row2"] > 0
    assert roof["enc_fwd_bwd_flops_per_dispatch"] > 0 and roof["ae_full_ms_per_dispatch"] > 0


def test_host_scripts_on_the_card(cuda, tmp_path):
    from aon_tpu_torch.scripts import demo_sphere, make_fixture_dataset, visualize_cameras

    g = np.random.default_rng(0)
    draws = {"t_rand": torch.from_numpy(g.random((24 * 32, 65), np.float32)),
             "u": torch.from_numpy(g.random((24 * 32, 128), np.float32))}
    argv = ["--hw", "24", "32", "--out"]
    on_card = demo_sphere.main(argv + [str(tmp_path / "a.png")], device=cuda, draws=draws)
    on_cpu = demo_sphere.main(argv + [str(tmp_path / "b.png")], device="cpu", draws=draws)
    off = np.abs(on_card["img"].astype(int) - on_cpu["img"].astype(int)).max(-1) > 1
    assert off.mean() <= 0.005  # chip_smoke's TOL_SPHERE_OFF_SHARE
    make_fixture_dataset.main([str(tmp_path / "data"), "--n", "3", "--wh", "64", "48"])
    img = visualize_cameras.main([str(tmp_path / "data"), "--out", str(tmp_path / "c.png")],
                                 device=cuda)
    assert (img != 255).any()
