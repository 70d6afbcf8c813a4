"""Port parity, articulated kernels: the plain twins of the three articulated
CUDA kernels against the JAX package's Pallas kernels run in interpret mode on
the CPU, from the same numpy inputs and the same converted weights.

On CPU tensors the port's wrappers run these twins; the CUDA kernels are held
against the twins on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, and why.  Both sides round every product's operands to bf16 and
store activations as bf16, but XLA's sums run in another order than
PyTorch's, so single activations land on the other side of a bf16 rounding
boundary (2^-9 relative) or of a relu.  In the articulated MLP that also
happens in the deformation output, which the encoding multiplies by up to 2^9
before the sine ("phase noise"): with a live deformation two correct
implementations agree less tightly than the vanilla kernels do.
  * ``fold_latents`` / ``unfold_grads``: float32 rounding only (1e-6 relative:
    the matvecs sum in another order), and ``unfold_grads`` is the transpose
    of ``fold_latents`` (against autograd, 1e-5);
  * forward against the Pallas kernel: 2e-2 absolute on raw outputs with a
    live deformation (seen: 4e-3), 5e-3 with ``deform_out`` zeroed; against
    float32 flax the JAX suite's own limits (tests/test_fused_art.py): rgb
    3e-2 / sigma 1.5e-1 live, 5e-3 / 2e-2 zeroed;
  * the backward alone, from the same bf16 activations and the same cotangent
    on both sides: 2e-3 of each tensor's largest and mean magnitude.  This is
    the check that the hand-written backward has the kernel's formulas and
    roundings;
  * gradients of the whole VJP (weights and latents) against the JAX
    custom_vjp, with ``deform_out`` zeroed so both sides encode the same x':
    5e-2 max / 2e-2 mean per tensor (``grad_errors``); with a live
    deformation the direction: cosine > 0.98 over all tensors;
  * the level: compositing weights and acc 5e-3 absolute, photometric loss
    5e-3 relative, gradients 1.5e-1 max / 6e-2 mean with ``deform_out``
    zeroed (the vanilla level's limits, tests/test_torch_train_kernels.py) and
    cosine > 0.98 live.
"""

import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.core.sampling import pos_enc as jax_pos_enc  # noqa: E402
from aon_tpu.models.articulated import ArticulatedNeRFMLP as FlaxArtMLP  # noqa: E402
from aon_tpu.ops import fused_art as jfa  # noqa: E402
from aon_tpu.ops import fused_mlp as jfm  # noqa: E402
from aon_tpu.ops.train_fused_level_art import (  # noqa: E402
    fused_level_train_art_grads as jax_level,
)
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.ops import fused_art as tfa  # noqa: E402
from aon_tpu_torch.ops.fused_mlp import make_posenc_constants  # noqa: E402
from aon_tpu_torch.ops.fused_mlp_train import grad_errors  # noqa: E402
from aon_tpu_torch.ops.train_fused_level_art import (  # noqa: E402
    fused_level_train_art_grads,
    fused_level_train_art_grads_plain,
)

FWD_TOL_LIVE, FWD_TOL_ZERO = 2e-2, 5e-3
SAME_ACTS_REL = 2e-3
GRAD_MAX_REL, GRAD_MEAN_REL = 5e-2, 2e-2
LEVEL_GRAD_MAX_REL, LEVEL_GRAD_MEAN_REL = 1.5e-1, 6e-2
LIVE_COS = 0.98


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _as_torch(tree):
    return {k: _t(v) for k, v in tree.items()}


def _cos(a, b, keys=None):
    keys = list(b) if keys is None else keys
    va = torch.cat([a[k].reshape(-1) for k in keys])
    vb = torch.cat([b[k].reshape(-1) for k in keys])
    return float(va @ vb / (va.norm() * vb.norm() + 1e-30))


def _zero_deform_out(flax_params):
    p = dict(flax_params)
    p["deform_out"] = {k: jnp.zeros_like(v) for k, v in flax_params["deform_out"].items()}
    return p


@pytest.fixture(scope="module")
def setup():
    g = np.random.default_rng(0)
    B, S = 6, 9
    samples = (g.normal(size=(B, S, 3)) * 1.5).astype(np.float32)
    vd = g.normal(size=(B, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    latents = {"density": (g.normal(size=(1, 128)) * 0.1).astype(np.float32),
               "color": (g.normal(size=(1, 128)) * 0.1).astype(np.float32),
               "articulation": (g.normal(size=(1, 32)) * 0.1).astype(np.float32)}
    mlp = FlaxArtMLP()
    venc = jax_pos_enc(jnp.asarray(vd), 0, 4)
    jl = {k: jnp.asarray(v) for k, v in latents.items()}
    params = mlp.init(jax.random.PRNGKey(0), jnp.asarray(samples), venc, jl)["params"]
    # live biases, so that a dropped or misplaced bias shows
    params = jax.tree.map(lambda x: x, params)
    params = {name: {"kernel": layer["kernel"],
                     "bias": jnp.asarray(g.normal(size=layer["bias"].shape).astype(np.float32)
                                         * 0.05)}
              for name, layer in params.items()}
    cot = (g.normal(size=(B, S, 4)) / (B * S)).astype(np.float32)
    return dict(B=B, S=S, samples=samples, vd=vd, latents=latents, jl=jl, mlp=mlp, venc=venc,
                params=params, cot=cot, jconsts=jfm.make_posenc_constants(),
                consts=make_posenc_constants(device="cpu"))


def test_eff_order_and_shapes_match_jax():
    assert tfa.EFF_ORDER == jfa._EFF_ORDER
    assert tfa.EFF_SHAPES == jfa._EFF_SHAPES
    assert set(tfa._KERNEL_WEIGHTS + tfa._KERNEL_BIASES) == set(tfa.EFF_ORDER)


def test_fold_latents_matches_jax(setup):
    want = jfa.fold_latents(setup["params"], setup["jl"])
    got = tfa.fold_latents(params_from_flax(setup["params"]), _as_torch(setup["latents"]))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_unfold_grads_matches_jax_and_autograd(setup):
    g = np.random.default_rng(1)
    d_eff = {k: g.normal(size=shape).astype(np.float32) for k, shape in tfa.EFF_SHAPES.items()}
    params_t = params_from_flax(setup["params"])
    lat_t = _as_torch(setup["latents"])
    dp, d_lat = tfa.unfold_grads(_as_torch(d_eff), params_t, lat_t)
    jdp, jd_lat = jfa._unfold_grads({k: jnp.asarray(v) for k, v in d_eff.items()},
                                    setup["params"], setup["jl"])
    want = params_from_flax(jax.tree.map(np.asarray, jdp))
    assert set(dp) == set(want) == set(params_t)
    for k in want:
        np.testing.assert_allclose(dp[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6)
    for k in d_lat:
        np.testing.assert_allclose(d_lat[k].numpy(), np.asarray(jd_lat[k]), rtol=1e-5, atol=1e-5)

    # the transpose of fold_latents, by autograd.  The padding (row 3 of wd0x,
    # column 3 of wdo / bdo, the K padding of w0 / w5b / wvb) holds no parameter.
    leaves = {k: v.clone().requires_grad_(True) for k, v in params_t.items()}
    lat_leaves = {k: v.clone().requires_grad_(True) for k, v in lat_t.items()}
    e = tfa.fold_latents(leaves, lat_leaves)
    sum((e[k] * _t(d_eff[k])).sum() for k in e).backward()
    for k in dp:
        np.testing.assert_allclose(dp[k].numpy(), leaves[k].grad.numpy(), rtol=1e-5, atol=1e-5)
    for k in d_lat:
        np.testing.assert_allclose(d_lat[k].numpy(), lat_leaves[k].grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_unfold_grads_articulation_deg_key(setup):
    """The auto-encoder's latents carry ``articulation_deg``: fold and unfold
    switch on the key, and latent keys the variant does not read get zeros."""
    params_t = params_from_flax(setup["params"])
    lat = _as_torch(setup["latents"])
    lat_deg = {"density": lat["density"], "color": lat["color"],
               "articulation_deg": lat["articulation"], "articulation": lat["articulation"] * 0}
    e, e_deg = tfa.fold_latents(params_t, lat), tfa.fold_latents(params_t, lat_deg)
    assert all(torch.equal(e[k], e_deg[k]) for k in e)
    d_eff = {k: torch.ones(shape) for k, shape in tfa.EFF_SHAPES.items()}
    _, d_lat = tfa.unfold_grads(d_eff, params_t, lat_deg)
    _, d_ref = tfa.unfold_grads(d_eff, params_t, lat)
    assert torch.equal(d_lat["articulation_deg"], d_ref["articulation"])
    assert not d_lat["articulation"].any()


@pytest.mark.parametrize("zero_deform", [False, True], ids=["live", "zero_deform_out"])
def test_forward_matches_pallas_and_flax(setup, zero_deform):
    s = setup
    params = _zero_deform_out(s["params"]) if zero_deform else s["params"]
    rgb_k, sigma_k = jfa.fused_art_mlp_eval(params, s["jl"], jnp.asarray(s["samples"]),
                                            jnp.asarray(s["vd"]), tile=64)
    rgb_f, sigma_f = s["mlp"].apply({"params": params}, jnp.asarray(s["samples"]), s["venc"],
                                    s["jl"])
    rgb, sigma = tfa.fused_art_mlp_eval(params_from_flax(params), _as_torch(s["latents"]),
                                        _t(s["samples"]), _t(s["vd"]), s["consts"])
    assert rgb.shape == (s["B"], s["S"], 3) and sigma.shape == (s["B"], s["S"], 1)
    tol = FWD_TOL_ZERO if zero_deform else FWD_TOL_LIVE
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_k), atol=tol)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_k), atol=tol)
    rgb_tol, sigma_tol = (5e-3, 2e-2) if zero_deform else (3e-2, 1.5e-1)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_f), atol=rgb_tol)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_f), atol=sigma_tol)


def _jax_vjp(params, s):
    (_, _), vjp = jax.vjp(
        lambda p, lat: jfa.fused_art_mlp_train(p, lat, jnp.asarray(s["samples"]),
                                               jnp.asarray(s["vd"]), 64), params, s["jl"])
    dp, d_lat = vjp((jnp.asarray(s["cot"][..., :3]), jnp.asarray(s["cot"][..., 3:])))
    return params_from_flax(jax.tree.map(np.asarray, dp)), _as_torch(d_lat)


def _torch_vjp(params, s):
    leaves = {k: v.requires_grad_(True) for k, v in params_from_flax(params).items()}
    lat = {k: v.requires_grad_(True) for k, v in _as_torch(s["latents"]).items()}
    rgb, sigma = tfa.fused_art_mlp_train(leaves, lat, _t(s["samples"]), _t(s["vd"]), s["consts"])
    cot = _t(s["cot"])
    ((rgb * cot[..., :3]).sum() + (sigma * cot[..., 3:]).sum()).backward()
    return {k: v.grad for k, v in leaves.items()}, {k: v.grad for k, v in lat.items()}


def test_train_vjp_matches_jax_custom_vjp_zero_deform_out(setup):
    params = _zero_deform_out(setup["params"])
    want_p, want_l = _jax_vjp(params, setup)
    got_p, got_l = _torch_vjp(params, setup)
    assert set(got_p) == set(want_p)
    max_rel, mean_rel = grad_errors(got_p, want_p)
    assert max_rel <= GRAD_MAX_REL and mean_rel <= GRAD_MEAN_REL, (max_rel, mean_rel)
    max_rel, mean_rel = grad_errors(got_l, want_l)
    assert max_rel <= GRAD_MAX_REL and mean_rel <= GRAD_MEAN_REL, (max_rel, mean_rel)


def test_train_vjp_direction_with_live_deformation(setup):
    want_p, want_l = _jax_vjp(setup["params"], setup)
    got_p, got_l = _torch_vjp(setup["params"], setup)
    assert _cos(got_p, want_p) > LIVE_COS
    assert _cos(got_l, want_l) > LIVE_COS
    deform = [k for k in want_p if k.startswith("deform")]
    assert _cos(got_p, want_p, deform) > LIVE_COS


def test_backward_from_same_activations_matches_jax(setup):
    """The hand-written backward against ``_art_bwd_from_acts`` of the JAX
    package, both fed the port's bf16 activations and the same cotangent: no
    forward difference is left, only the order of the sums."""
    s = setup
    e = tfa.fold_latents(params_from_flax(s["params"]), _as_torch(s["latents"]))
    n = s["B"] * s["S"]
    xyz = _t(s["samples"]).reshape(n, 3)
    vdir = torch.repeat_interleave(_t(s["vd"]), s["S"], dim=0)
    acts = tfa.art_forward(xyz, vdir, e, s["consts"])
    g = _t(s["cot"]).reshape(n, 4)
    got = tfa.art_bwd_from_acts(xyz, g[:, :3], g[:, 3:], acts, e, s["consts"])

    j_acts = {k: jnp.asarray(v.float().numpy(),
                             dtype=jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
              for k, v in acts.items()}
    j_acts["xp"] = jnp.pad(j_acts["xp"], ((0, 0), (0, 1)))
    ge = {k: np.zeros(shape, np.float32) for k, shape in tfa.EFF_SHAPES.items()}  # `+=` in place
    jfa._art_bwd_from_acts(
        jnp.pad(jnp.asarray(xyz.numpy()), ((0, 0), (0, 1))), jnp.asarray(g[:, :3].numpy()),
        jnp.asarray(g[:, 3:].numpy()), j_acts, {k: jnp.asarray(v.numpy()) for k, v in e.items()},
        ge, s["jconsts"])
    assert set(got) == set(ge)
    max_rel, mean_rel = grad_errors(got, _as_torch(ge))
    assert max_rel <= SAME_ACTS_REL and mean_rel <= SAME_ACTS_REL, (max_rel, mean_rel)
    # the padding comes back zero
    assert not got["wd0x"][3].any() and not got["wdo"][:, 3].any() and not got["bdo"][0, 3].any()


LEVEL_CASES = {
    # the auto-decoder's arguments; the auto-encoder's (opacity BCE against a
    # 0/1 mask, relu sigma, no padding, masked loss weights); a white background
    "autodecoder": dict(white_bkgd=False, rgb_padding=0.001, density_bias=-1.0, bce_weight=0.0,
                        sigma_act="softplus_bias"),
    "autoencoder": dict(white_bkgd=False, rgb_padding=0.0, density_bias=0.0, bce_weight=0.5,
                        sigma_act="relu"),
    "white_bkgd": dict(white_bkgd=True, rgb_padding=0.001, density_bias=-1.0, bce_weight=0.0,
                       sigma_act="softplus_bias"),
}


def _level_inputs(s, case):
    g = np.random.default_rng(7)
    B, S = s["B"], s["S"]
    t = np.sort(g.uniform(2.0, 6.0, size=(B, S)).astype(np.float32), axis=-1)
    o = (g.normal(size=(B, 3)) * 0.3).astype(np.float32)
    o[:, 2] -= 4.0
    d = (np.array([0.0, 0.0, 1.0]) + g.normal(size=(B, 3)) * 0.1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    target = g.uniform(size=(B, 3)).astype(np.float32)
    mask = (g.uniform(size=B) > 0.4).astype(np.float32)
    if case == "autoencoder":
        lw = mask / max(3.0 * mask.sum(), 1.0)
    else:
        lw = (g.uniform(0.5, 1.5, size=B) / (3.0 * B)).astype(np.float32)
    return dict(t_vals=t, rays_o=o, rays_d=d, viewdirs=d, target=target,
                loss_w=lw.astype(np.float32), mask=mask)


@pytest.mark.parametrize("case", list(LEVEL_CASES))
@pytest.mark.parametrize("zero_deform", [True, False], ids=["zero_deform_out", "live"])
def test_level_matches_pallas(setup, case, zero_deform):
    s, kw = setup, LEVEL_CASES[case]
    params = _zero_deform_out(s["params"]) if zero_deform else s["params"]
    # a denser field than a fresh init gives, so that weights and acc are not ~0
    params = dict(params, density={"kernel": params["density"]["kernel"],
                                   "bias": params["density"]["bias"] + 1.0})
    inp = _level_inputs(s, case)
    j_packed = jfa.fold_latents(params, s["jl"])
    photo_j, wgt_j, acc_j, grads_j = jax_level(
        j_packed, s["jconsts"], *(jnp.asarray(inp[k]) for k in
                                  ("t_vals", "rays_o", "rays_d", "viewdirs", "target", "loss_w",
                                   "mask")), **kw)
    packed = tfa.fold_latents(params_from_flax(params), _as_torch(s["latents"]))
    args = [_t(inp[k]) for k in ("t_vals", "rays_o", "rays_d", "viewdirs", "target", "loss_w",
                                 "mask")]
    photo, wgt, acc, grads = fused_level_train_art_grads(packed, s["consts"], *args, **kw)
    assert wgt.shape == (s["B"], s["S"]) and acc.shape == (s["B"],)
    assert float(acc.max()) > 0.05  # the rays do hit something
    np.testing.assert_allclose(wgt.numpy(), np.asarray(wgt_j), atol=5e-3)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), atol=5e-3)
    np.testing.assert_allclose(float(photo), float(photo_j), rtol=5e-3)
    want = _as_torch(grads_j)
    assert set(grads) == set(want)
    if zero_deform:
        max_rel, mean_rel = grad_errors(grads, want)
        assert max_rel <= LEVEL_GRAD_MAX_REL and mean_rel <= LEVEL_GRAD_MEAN_REL, (max_rel,
                                                                                   mean_rel)
    else:
        assert _cos(grads, want) > LIVE_COS


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_level_twin_is_the_gradient_of_its_own_loss(setup, case):
    """The hand-written compositing and head VJPs against autograd: the loss
    the level states, through ``fused_art_mlp_train`` (whose backward is the
    same MLP twin), differentiated by PyTorch."""
    import torch.nn.functional as F

    from aon_tpu_torch.core.rendering import volumetric_rendering
    from aon_tpu_torch.models.articulated import head_activations

    s, kw = setup, LEVEL_CASES[case]
    params = dict(s["params"], density={"kernel": s["params"]["density"]["kernel"],
                                        "bias": s["params"]["density"]["bias"] + 1.0})
    inp = {k: _t(v) for k, v in _level_inputs(s, case).items()}
    params_t = params_from_flax(params)
    lat = _as_torch(s["latents"])
    packed = tfa.fold_latents(params_t, lat)
    photo, wgt, acc, g_eff = fused_level_train_art_grads_plain(
        packed, s["consts"], *(inp[k] for k in ("t_vals", "rays_o", "rays_d", "viewdirs",
                                                "target", "loss_w", "mask")), **kw)
    got, got_lat = tfa.unfold_grads(g_eff, params_t, lat)

    leaves = {k: v.clone().requires_grad_(True) for k, v in params_t.items()}
    lat_leaves = {k: v.clone().requires_grad_(True) for k, v in lat.items()}
    samples = inp["rays_o"][:, None] + inp["t_vals"][..., None] * inp["rays_d"][:, None]
    raw_rgb, raw_sigma = tfa.fused_art_mlp_train(leaves, lat_leaves, samples, inp["viewdirs"],
                                                 s["consts"])
    rgb, sigma = head_activations(raw_rgb, raw_sigma, kw["sigma_act"], kw["rgb_padding"],
                                  kw["density_bias"])
    comp, acc_a, wgt_a, _ = volumetric_rendering(rgb, sigma, inp["t_vals"], inp["rays_d"],
                                                 white_bkgd=kw["white_bkgd"])
    loss = (inp["loss_w"][:, None] * (comp - inp["target"]) ** 2).sum()
    np.testing.assert_allclose(float(photo), float(loss.detach()), rtol=1e-4)
    np.testing.assert_allclose(wgt.numpy(), wgt_a.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), acc_a.detach().numpy(), atol=1e-5)
    if kw["bce_weight"]:
        loss = loss + kw["bce_weight"] * F.binary_cross_entropy_with_logits(acc_a, inp["mask"])
    loss.backward()
    want = {k: v.grad for k, v in leaves.items()}
    max_rel, mean_rel = grad_errors(got, want)
    assert max_rel <= 2e-2 and mean_rel <= 5e-3, (max_rel, mean_rel)
    max_rel, mean_rel = grad_errors(got_lat, {k: v.grad for k, v in lat_leaves.items()})
    assert max_rel <= 2e-2 and mean_rel <= 5e-3, (max_rel, mean_rel)


def test_level_wrapper_runs_the_twin_on_cpu_and_checks_its_arguments(setup):
    s = setup
    packed = tfa.fold_latents(params_from_flax(s["params"]), _as_torch(s["latents"]))
    inp = [_t(v) for v in _level_inputs(s, "autodecoder").values()]
    before = fused_level_train_art_grads.launches
    a = fused_level_train_art_grads(packed, s["consts"], *inp, False)
    b = fused_level_train_art_grads_plain(packed, s["consts"], *inp, False)
    assert fused_level_train_art_grads.launches == before  # no kernel on the CPU
    assert torch.equal(a[1], b[1]) and all(torch.equal(a[3][k], b[3][k]) for k in b[3])
    with pytest.raises(ValueError, match="sigma_act"):
        fused_level_train_art_grads(packed, s["consts"], *inp, False, sigma_act="elu")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_level_train_art_grads(packed, s["consts"], inp[0].to("meta"), *inp[1:], False)


def test_blob_layout_round_trips(setup):
    packed = tfa.fold_latents(params_from_flax(setup["params"]), _as_torch(setup["latents"]))
    wblob, bblob = tfa.art_blobs(packed)
    assert wblob.dtype == torch.bfloat16 and wblob.numel() == tfa.N_KERNEL_WEIGHTS
    assert bblob.dtype == torch.float32 and bblob.numel() == tfa.N_KERNEL_BIASES
    back = tfa.grads_from_blob(torch.cat([wblob.float(), bblob]))
    for k, shape in tfa.EFF_SHAPES.items():
        want = packed[k].to(torch.bfloat16).float() if k.startswith("w") else packed[k]
        assert tuple(back[k].shape) == shape and torch.equal(back[k], want), k
    # the vanilla kernels' blob is the head of this one (ops/csrc/art.cu relies on it)
    from aon_tpu_torch.ops import fused_mlp as tfm

    assert tfa._KERNEL_WEIGHTS[:14] == tuple("wdn" if k == "wd" else k
                                             for k in tfm._KERNEL_WEIGHTS)
    assert tfa._KERNEL_BIASES[:12] == tuple("bdn" if k == "bd" else k for k in tfm._KERNEL_BIASES)
    with pytest.raises(ValueError, match="the kernel takes"):
        tfa.art_blobs(dict(packed, wdo=packed["wdo"][:, :3]))
