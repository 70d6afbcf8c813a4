"""Port parity, training kernels: the plain twins of the two training CUDA
kernels against the JAX package's Pallas kernels run in interpret mode on the
CPU, from the same numpy inputs and the same converted weights.

On CPU tensors the port's wrappers run these twins; the CUDA kernels are held
against the twins on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, and why.  Both sides round every product's operands to bf16 and
store activations as bf16, but XLA's sums run in another order than
PyTorch's, so single activations land on the other side of a bf16 rounding
boundary (2^-9 relative) or of a relu, and the step carries on:
  * the level's compositing weights 2e-3 absolute and its squared-error sum
    2e-3 relative (the raw outputs agree to ~1e-3, test_torch_kernels.py);
  * the backward alone, from the same bf16 activations and the same
    cotangent on both sides: 2e-3 of each tensor's largest and mean magnitude
    (seen: 8e-4): this is the check that the hand-written backward has the
    kernel's formulas and roundings;
  * forward activations: at most 1% of the entries differ (seen: 0.13% at the
    last trunk layer), each by about one bf16 step (2^-7 relative) or, where
    a sum cancels to a small value, by its inputs' steps (5e-3, as raw outputs);
  * gradients of the MLP backward from raw xyz, per tensor (``grad_errors``):
    the largest error within 5e-2 of the tensor's largest magnitude and the
    mean error within 2e-2 of its mean magnitude.  The few activations that
    differ by a bf16 step re-round everything downstream of them;
  * gradients of the whole level: 1.5e-1 and 6e-2 (seen: 7e-2 and 2.7e-2 at
    these 204 rows).  Here the cotangent itself differs between the two sides
    by ~1%: it is made from raw outputs that differ by ~1e-3, through relu'
    of sigma near 0 and the cancelling suffix sum, and a bf16 chain re-rounds
    every value once its input moves by more than a bf16 step.  For scale:
    either side is 1.2e-1 (mean) from the float32 gradient of the same loss
    (``test_level_twin_is_the_gradient_of_its_own_loss``);
  * the forward of ``fused_mlp_train_xyz``: 5e-3 absolute on raw outputs.  In
    interpret mode the JAX forward keeps its float32-packed weights in
    float32 (the TPU's matrix unit would round them to bf16), while the port
    rounds them to bf16 for the launch as the card does: this is the bf16
    tolerance of test_torch_kernels.py;
  * packing and unpacking are bit-identical.
"""

import importlib
import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.models.mlp import NeRFMLP as FlaxMLP  # noqa: E402
from aon_tpu.ops import fused_mlp as jfm  # noqa: E402
from aon_tpu.ops.train_fused_level import fused_level_train_grads as jax_level  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax, tree_to_flax  # noqa: E402
from aon_tpu_torch.ops import fused_mlp as tfm  # noqa: E402
from aon_tpu_torch.ops import fused_mlp_train as tfmt  # noqa: E402
from aon_tpu_torch.ops.train_fused_level import (  # noqa: E402
    fused_level_train_grads,
    fused_level_train_grads_plain,
)

# the module: aon_tpu.ops re-exports a function of the same name over it
jfmt = importlib.import_module("aon_tpu.ops.fused_mlp_train")

GRAD_MAX_REL, GRAD_MEAN_REL = 5e-2, 2e-2
LEVEL_GRAD_MAX_REL, LEVEL_GRAD_MEAN_REL = 1.5e-1, 6e-2
SAME_ACTS_REL = 2e-3
FINE_GRAD_COS, FINE_GRAD_NORM_REL = 0.995, 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _as_torch(tree):
    return {k: _t(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    g = np.random.default_rng(0)
    B, S = 12, 17  # ragged against the JAX kernel's tiles: B % rays_per_tile, S % 8 != 0
    d = g.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t_vals = np.sort(g.uniform(2.0, 6.0, size=(B, S)), axis=-1).astype(np.float32)
    target = g.uniform(size=(B, 3)).astype(np.float32)
    cot = (g.normal(size=(B, S, 4)) / (B * S)).astype(np.float32)
    enc, venc = jnp.zeros((2, 4, 63)), jnp.zeros((2, 27))
    params = jax.tree.map(np.asarray, FlaxMLP().init(jax.random.PRNGKey(0), enc, venc)["params"])
    params["density"]["bias"] = params["density"]["bias"] + 0.3  # partly opaque rays
    return dict(B=B, S=S, o=o, d=d, t=t_vals, target=target, cot=cot, params=params,
                samples=(o[:, None, :] + t_vals[..., None] * d[:, None, :]).astype(np.float32))


def test_f32_pack_and_grad_unpack_match_jax_bitwise(setup):
    params = setup["params"]
    want = jfmt.pack_vanilla_mlp_params_f32(params)
    got = tfm.pack_vanilla_mlp_params_f32(params_from_flax(params))
    assert set(got) == set(want) == set(tfm.SHAPES) == set(jfmt._SHAPES)
    for k in want:
        assert tuple(got[k].shape) == tfm.SHAPES[k] == jfmt._SHAPES[k], k
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # gradients in the packed layout go back to the parameters' own layout
    g = np.random.default_rng(1)
    packed_grads = {k: g.normal(size=s).astype(np.float32) for k, s in tfm.SHAPES.items()}
    want_tree = jfmt.unpack_vanilla_mlp_grads({k: jnp.asarray(v) for k, v in packed_grads.items()})
    got_flat = tfm.unpack_vanilla_mlp_grads(_as_torch(packed_grads))
    assert set(got_flat) == set(params_from_flax(params))
    got_tree = tree_to_flax(got_flat)
    for name, leaves in want_tree.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got_tree[name][leaf], np.asarray(v))


def test_train_blobs_and_grad_blob_share_the_kernel_layout(setup):
    packed = tfm.pack_vanilla_mlp_params_f32(params_from_flax(setup["params"]))
    wblob, bblob = tfm.train_blobs(packed)
    assert wblob.dtype == torch.bfloat16 and wblob.numel() == tfm.N_KERNEL_WEIGHTS == 594560
    assert bblob.dtype == torch.float32 and bblob.numel() == tfm.N_KERNEL_BIASES == 2436
    assert torch.equal(wblob[:64 * 256], packed["w0"].to(torch.bfloat16).reshape(-1))
    blob = torch.arange(594560 + 2436 + 1, dtype=torch.float32)
    views = tfm.grads_from_blob(blob)
    assert {k: tuple(v.shape) for k, v in views.items()} == tfm.SHAPES
    # weights at the weight blob's offsets, then the biases
    assert views["w1"][0, 0].item() == 64 * 256 and views["b0"][0, 0].item() == 594560
    assert views["brgb"][0, -1].item() == 594560 + 2436 - 1
    assert views["w0"].data_ptr() == blob.data_ptr()  # views, not copies


def _bf16_jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def test_forward_and_backward_pieces_match_jax(setup):
    """``fwd_activations`` against ``_fwd_activations``, then ``bwd_from_acts``
    against ``_bwd_from_acts`` from the same activations and cotangent."""
    jlvl = importlib.import_module("aon_tpu.ops.train_fused_level")
    s = setup
    n = s["B"] * s["S"]
    consts = tfm.make_posenc_constants(device="cpu")
    packed = tfm.pack_vanilla_mlp_params_f32(params_from_flax(s["params"]))
    packed_j = jfmt.pack_vanilla_mlp_params_f32(s["params"])
    enc, venc = tfmt.encode_rows(consts, _t(s["samples"]).reshape(n, 3), _t(s["d"]), s["S"])
    acts = tfmt.fwd_activations(enc, venc, packed)
    acts_j = jax.jit(jfmt._fwd_activations)(_bf16_jnp(enc), _bf16_jnp(venc), packed_j)
    assert set(acts) == set(acts_j)
    for k, a in acts.items():
        b = np.asarray(acts_j[k].astype(jnp.float32))
        if a.dtype == torch.bfloat16:
            assert acts_j[k].dtype == jnp.bfloat16, k
            assert (a.float().numpy() != b).mean() <= 1e-2, k
            np.testing.assert_allclose(a.float().numpy(), b, rtol=2.0**-7, atol=5e-3, err_msg=k)
        else:  # raw rgb and sigma stay float32
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-3, err_msg=k)

    def bwd_j(enc, venc, g_rgb, g_sigma, acts, w):
        out = {}

        class Ref:  # a stand-in for the kernel's accumulator refs
            def __init__(self, k):
                self.k = k

            def __getitem__(self, _):
                return out.get(self.k, jnp.zeros(jfmt._SHAPES[self.k], jnp.float32))

            def __setitem__(self, _, val):
                out[self.k] = val

        jlvl._bwd_from_acts(enc, venc, g_rgb, g_sigma, acts, w, {k: Ref(k) for k in jfmt._SHAPES})
        return out

    cot = s["cot"].reshape(n, 4)
    same = {k: (_bf16_jnp(v) if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
            for k, v in acts.items()}
    want = jax.jit(bwd_j)(_bf16_jnp(enc), _bf16_jnp(venc), jnp.asarray(cot[:, :3]),
                          jnp.asarray(cot[:, 3:]), same, packed_j)
    got = tfmt.bwd_from_acts(enc, venc, _t(cot[:, :3]), _t(cot[:, 3:]), acts, packed)
    max_rel, mean_rel = tfmt.grad_errors(got, _as_torch(want))
    assert max_rel <= SAME_ACTS_REL and mean_rel <= SAME_ACTS_REL, (max_rel, mean_rel)


@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
def test_level_plain_twin_matches_pallas_kernel(setup, white):
    s = setup
    want_sq, want_w, want_g = jax_level(
        jfmt.pack_vanilla_mlp_params_f32(s["params"]), jfm.make_posenc_constants(),
        jnp.asarray(s["t"]), jnp.asarray(s["o"]), jnp.asarray(s["d"]), jnp.asarray(s["d"]),
        jnp.asarray(s["target"]), white)
    packed = tfm.pack_vanilla_mlp_params_f32(params_from_flax(s["params"]))
    consts = tfm.make_posenc_constants(device="cpu")
    args = (packed, consts, _t(s["t"]), _t(s["o"]), _t(s["d"]), _t(s["d"]), _t(s["target"]), white)
    sq, w, grads = fused_level_train_grads(*args)  # CPU tensors: the plain twin, no launch
    assert w.shape == (s["B"], s["S"]) and sq.ndim == 0
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0, atol=2e-3)
    np.testing.assert_allclose(sq.item(), float(want_sq), rtol=2e-3)
    assert {k: tuple(v.shape) for k, v in grads.items()} == tfm.SHAPES
    max_rel, mean_rel = tfmt.grad_errors(grads, _as_torch(want_g))
    assert max_rel <= LEVEL_GRAD_MAX_REL and mean_rel <= LEVEL_GRAD_MEAN_REL, (max_rel, mean_rel)
    sq2, w2, grads2 = fused_level_train_grads_plain(*args)
    assert torch.equal(w, w2) and all(torch.equal(grads[k], grads2[k]) for k in grads)


def test_level_plain_twin_matches_pallas_kernel_at_the_fine_shape(setup):
    """The fine level's real 64 + 128 + 1 samples per ray, at 8 rays, so the
    193-sample scans and ragged tiles of both sides are held together.

    The pointwise noise does not shrink with the 1,544 rows: at this init a
    ray's last sample (dist 1e10) carries ~40% of its weight, so the gradient
    still rests on a few rows per ray, and one relu that flips there moves
    entries of w0-w3 by up to 1e-1 of the tensor's max (seen: 8e-3 to 1.3e-1
    max, 5e-3 to 5.5e-2 mean, from one seed or run to the next).  What the
    size does give is each tensor's direction and scale: cosine >= 0.995 and
    norm ratio within 2% (seen: >= 0.9995 and within 0.6%), which a gradient
    scaled wrongly by a few percent fails."""
    g = np.random.default_rng(7)
    B, S = 8, 193
    d = g.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t_union = np.sort(g.uniform(2.0, 6.0, size=(B, S)), axis=-1).astype(np.float32)
    target = g.uniform(size=(B, 3)).astype(np.float32)
    params = setup["params"]
    want_sq, want_w, want_g = jax_level(
        jfmt.pack_vanilla_mlp_params_f32(params), jfm.make_posenc_constants(),
        jnp.asarray(t_union), jnp.asarray(o), jnp.asarray(d), jnp.asarray(d),
        jnp.asarray(target), True)
    packed = tfm.pack_vanilla_mlp_params_f32(params_from_flax(params))
    consts = tfm.make_posenc_constants(device="cpu")
    sq, w, grads = fused_level_train_grads_plain(
        packed, consts, _t(t_union), _t(o), _t(d), _t(d), _t(target), True)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0, atol=2e-3)
    np.testing.assert_allclose(sq.item(), float(want_sq), rtol=2e-3)
    want = _as_torch(want_g)
    max_rel, mean_rel = tfmt.grad_errors(grads, want)
    assert max_rel <= LEVEL_GRAD_MAX_REL and mean_rel <= LEVEL_GRAD_MEAN_REL, (max_rel, mean_rel)
    for k in want:
        a, b = grads[k].reshape(-1), want[k].reshape(-1)
        cos = (a @ b / (a.norm() * b.norm())).item()
        ratio = (a.norm() / b.norm()).item()
        assert cos >= FINE_GRAD_COS and abs(ratio - 1.0) <= FINE_GRAD_NORM_REL, (k, cos, ratio)


def test_level_twin_is_the_gradient_of_its_own_loss(setup):
    # the hand-written backward against autograd through the same float32
    # forward without the bf16 roundings: the wide tolerance of the JAX
    # suite's own check of its kernel against the flax level
    s = setup
    packed = tfm.pack_vanilla_mlp_params_f32(params_from_flax(s["params"]))
    consts = tfm.make_posenc_constants(device="cpu")
    t, o, d, target = _t(s["t"]), _t(s["o"]), _t(s["d"]), _t(s["target"])
    sq, _, grads = fused_level_train_grads_plain(packed, consts, t, o, d, d, target, True)

    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    B, S = t.shape
    xyz = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3)
    enc = tfmt.encode_plain(xyz, consts["s_pos"], consts["p_pos"])
    venc = tfmt.encode_plain(torch.repeat_interleave(d, S, 0), consts["s_view"], consts["p_view"])
    rgb, sigma = tfmt._mlp_compute(enc, venc, leaves)
    from aon_tpu_torch.core.rendering import volumetric_rendering
    comp, _, _, _ = volumetric_rendering(torch.sigmoid(rgb.reshape(B, S, 3)),
                                         torch.relu(sigma.reshape(B, S, 1)), t, d, True)
    loss = ((comp - target) ** 2).mean()
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(sq.item() / (B * 3.0), loss.item(), rtol=2e-2)
    for k in want:
        a, b = want[k].reshape(-1), grads[k].reshape(-1)
        if a.norm() * b.norm() < 1e-14:
            continue
        assert (a @ b / (a.norm() * b.norm())).item() > 0.97, k
        assert 0.8 < (b.norm() / a.norm()).item() < 1.25, k
    # the scale of bf16's own noise at 204 rows (seen: 2.0e-1 max, 1.2e-1 mean)
    max_rel, mean_rel = tfmt.grad_errors(grads, want)
    assert max_rel <= 5e-1 and mean_rel <= 3e-1, (max_rel, mean_rel)


def test_mlp_bwd_plain_twin_matches_pallas_kernel(setup):
    s = setup
    want = jfmt._bwd_call_xyz(
        jfmt.pack_vanilla_mlp_params_f32(s["params"]), jfm.make_posenc_constants(),
        jnp.asarray(s["samples"]), jnp.asarray(s["d"]), jnp.asarray(s["cot"]), jfmt.TRAIN_TILE)
    packed = tfm.pack_vanilla_mlp_params_f32(params_from_flax(s["params"]))
    consts = tfm.make_posenc_constants(device="cpu")
    args = (packed, consts, _t(s["samples"]), _t(s["d"]), _t(s["cot"]))
    before = tfmt.fused_mlp_bwd_xyz.launches
    grads = tfmt.fused_mlp_bwd_xyz(*args)  # CPU tensors: the plain twin
    assert tfmt.fused_mlp_bwd_xyz.launches == before
    assert {k: tuple(v.shape) for k, v in grads.items()} == tfm.SHAPES
    max_rel, mean_rel = tfmt.grad_errors(grads, _as_torch(want))
    assert max_rel <= GRAD_MAX_REL and mean_rel <= GRAD_MEAN_REL, (max_rel, mean_rel)
    again = tfmt.fused_mlp_bwd_xyz_plain(*args)
    assert all(torch.equal(grads[k], again[k]) for k in grads)


def test_fused_mlp_train_xyz_matches_jax_vjp(setup):
    s = setup
    consts_j = jfm.make_posenc_constants()
    samples_j, d_j = jnp.asarray(s["samples"]), jnp.asarray(s["d"])
    (want_rgb, want_sigma), vjp = jax.vjp(
        lambda p: jfmt.fused_mlp_train_xyz(p, consts_j, samples_j, d_j), s["params"])
    cot = s["cot"]
    (want_grads,) = vjp((jnp.asarray(cot[..., :3]), jnp.asarray(cot[..., 3:])))

    params = {k: v.requires_grad_(True) for k, v in params_from_flax(s["params"]).items()}
    consts = tfm.make_posenc_constants(device="cpu")
    samples = _t(s["samples"]).requires_grad_(True)
    rgb, sigma = tfmt.fused_mlp_train_xyz(params, consts, samples, _t(s["d"]))
    assert rgb.shape == (s["B"], s["S"], 3) and sigma.shape == (s["B"], s["S"], 1)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(want_rgb), rtol=0, atol=5e-3)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(want_sigma), rtol=0, atol=5e-3)
    ((rgb * _t(cot[..., :3])).sum() + (sigma * _t(cot[..., 3:])).sum()).backward()
    assert samples.grad is None  # gradients flow to the weights only

    want_flat = params_from_flax(jax.tree.map(np.asarray, want_grads))
    assert set(want_flat) == set(params)
    for k, want in want_flat.items():
        got = params[k].grad
        assert got.shape == want.shape, k
        scale = want.abs().max().clamp_min(1e-30)
        assert ((got - want).abs().max() / scale).item() <= GRAD_MAX_REL, k


def test_training_wrappers_raise_on_other_devices(setup):
    packed = tfm.pack_vanilla_mlp_params_f32(params_from_flax(setup["params"]))
    consts = tfm.make_posenc_constants(device="cpu")
    meta = dict(device="meta")
    launches = (fused_level_train_grads.launches, tfmt.fused_mlp_bwd_xyz.launches)
    with pytest.raises(ValueError, match="no kernel"):
        fused_level_train_grads(packed, consts, torch.empty(2, 5, **meta),
                                *(torch.empty(2, 3, **meta) for _ in range(4)), True)
    with pytest.raises(ValueError, match="no kernel"):
        tfmt.fused_mlp_bwd_xyz(packed, consts, torch.empty(2, 5, 3, **meta),
                               torch.empty(2, 3, **meta), torch.empty(2, 5, 4, **meta))
    assert (fused_level_train_grads.launches, tfmt.fused_mlp_bwd_xyz.launches) == launches
