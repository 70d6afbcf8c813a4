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
    inside the encoding; the reasons stand beside them in
    aon_tpu_torch/ops/fused_art.py).
"""

import numpy as np
import pytest
import torch

from aon_tpu_torch.core.sampling import eval_quantiles, pdf_cdf
from aon_tpu_torch.eval.render import render_frame
from aon_tpu_torch.ops import fused_art
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
    max_rel, mean_rel = grad_errors(got, want)
    assert max_rel <= fused_art.GRAD_TOL_REL and mean_rel <= fused_art.GRAD_TOL_MEAN_REL, (
        max_rel, mean_rel)


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
