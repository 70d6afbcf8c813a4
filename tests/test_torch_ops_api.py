"""Port parity, the public kernel API (``aon_tpu_torch.ops``): the plain twins
of kernel table rows 5-8 against the JAX package's Pallas kernels run in
interpret mode on the CPU, from the same numpy inputs and converted weights.

Rows 5 (``fused_nerf_mlp``, and the forward of ``fused_mlp_train``), 7
(``fused_nerf_mlp_per_ray``) and 8 (``fused_nerf_mlp_xyz``) are one MLP with
three ways of taking its input; row 6 (``fused_mlp_bwd``) is the weight
backward of ``fused_mlp_train``.  On CPU tensors the port's wrappers run
these twins; the CUDA kernels are held against the twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, and why:
  * float32-packed weights: 2e-5 on raw rgb and 2e-4 on raw sigma, the JAX
    suite's float32 MLP tolerances (tests/test_pallas_kernels.py): both sides
    multiply in float32, the sums in another order;
  * bf16-packed weights: 5e-3 absolute on raw outputs, as for kernel 1
    (tests/test_torch_kernels.py): each layer rounds its activations to bf16
    and the sums run in another order, so single values land on the other
    side of a bf16 rounding boundary and carry that step on;
  * row 8 against the JAX kernel adds the in-kernel encoding's 2e-4 (the FMA
    in the range reduction, tests/test_torch_kernels.py), which bf16 rounding
    swallows and float32 carries through the MLP: 5e-4 there;
  * the forward of ``fused_mlp_train``: 5e-3 absolute.  In interpret mode the
    JAX forward keeps its float32-packed weights in float32; the port rounds
    them to bf16 for the launch as the card does (ROADMAP.md Queue 3);
  * weight gradients (``fused_mlp_train`` against ``jax.vjp``, row 6's twin
    against ``_bwd_call``), per tensor: the largest error within 5e-2 of the
    tensor's largest magnitude and the mean error within 2e-2 of its mean
    magnitude (``grad_errors``), as for row 4 (tests/test_torch_train_kernels.py):
    both sides round the same values to bf16, and an activation that lands
    on the other side of a rounding boundary re-rounds what follows it.
"""

import importlib
import os
import types

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import aon_tpu.ops as jax_ops  # noqa: E402
import aon_tpu_torch.ops as torch_ops  # noqa: E402
from aon_tpu.core.sampling import pos_enc  # noqa: E402
from aon_tpu.models.mlp import NeRFMLP as FlaxMLP  # noqa: E402
from aon_tpu.ops import fused_mlp as jfm  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.ops import fused_mlp as tfm  # noqa: E402
from aon_tpu_torch.ops import fused_mlp_train as tfmt  # noqa: E402

# the module: aon_tpu.ops re-exports a function of the same name over it
jfmt = importlib.import_module("aon_tpu.ops.fused_mlp_train")

TOL_F32 = {"rgb": 2e-5, "sigma": 2e-4}
TOL_BF16 = 5e-3
TOL_XYZ_F32 = 5e-4
GRAD_MAX_REL, GRAD_MEAN_REL = 5e-2, 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    g = np.random.default_rng(0)
    B, S = 13, 17  # ragged against the JAX tiles: 13 % 16 rays, 17 % 8 samples
    x = (g.normal(size=(B, S, 3)) * 1.5).astype(np.float32)
    d = g.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    enc = np.asarray(pos_enc(jnp.asarray(x), 0, 10))  # (B, S, 63)
    venc = np.asarray(pos_enc(jnp.asarray(d), 0, 4))  # (B, 27)
    params = jax.tree.map(np.asarray, FlaxMLP().init(
        jax.random.PRNGKey(0), jnp.asarray(enc), jnp.asarray(venc))["params"])
    params["density"]["bias"] = params["density"]["bias"] + 0.3
    cot = (g.normal(size=(B * S, 4)) / (B * S)).astype(np.float32)
    return types.SimpleNamespace(B=B, S=S, x=x, d=d, enc=enc, venc=venc, params=params, cot=cot,
                                 torch_params=params_from_flax(params))


def _packings(s, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (jfm.pack_vanilla_mlp_params(s.params, dtype=jdt),
            tfm.pack_vanilla_mlp_params(s.torch_params, dtype=tdt))


def _close(got, want, dtype, name, f32_tol=None):
    tol = (f32_tol or TOL_F32[name]) if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol, err_msg=name)


def _pad(a, width):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True], ids=["63-27", "64-32"])
def test_fused_nerf_mlp_twin_matches_pallas(setup, dtype, padded):
    s = setup
    n = s.B * s.S - 3  # ragged N
    enc = s.enc.reshape(-1, 63)[:n]
    venc = np.repeat(s.venc, s.S, axis=0)[:n]
    if padded:
        enc, venc = _pad(enc, 64), _pad(venc, 32)
    packed_j, packed = _packings(s, dtype)
    want_rgb, want_sigma = jfm.fused_nerf_mlp(packed_j, jnp.asarray(enc), jnp.asarray(venc))
    before = tfm.fused_nerf_mlp.launches
    rgb, sigma = tfm.fused_nerf_mlp(packed, _t(enc), _t(venc))  # CPU tensors: the twin
    assert tfm.fused_nerf_mlp.launches == before
    assert rgb.shape == (n, 3) and sigma.shape == (n, 1)
    assert rgb.dtype == sigma.dtype == torch.float32
    _close(rgb, want_rgb, dtype, "rgb")
    _close(sigma, want_sigma, dtype, "sigma")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_nerf_mlp_per_ray_twin_matches_pallas(setup, dtype):
    s = setup
    packed_j, packed = _packings(s, dtype)
    want_rgb, want_sigma = jfm.fused_nerf_mlp_per_ray(
        packed_j, jnp.asarray(s.enc), jnp.asarray(s.venc))
    rgb, sigma = tfm.fused_nerf_mlp_per_ray(packed, _t(s.enc), _t(s.venc))
    assert rgb.shape == (s.B, s.S, 3) and sigma.shape == (s.B, s.S, 1)
    _close(rgb, want_rgb, dtype, "rgb")
    _close(sigma, want_sigma, dtype, "sigma")
    # the per-ray view encoding is the flat one repeated: the same function
    flat = tfm.fused_nerf_mlp(packed, _t(s.enc.reshape(-1, 63)),
                              _t(np.repeat(s.venc, s.S, axis=0)))
    assert torch.equal(rgb.reshape(-1, 3), flat[0]) and torch.equal(sigma.reshape(-1, 1), flat[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_nerf_mlp_xyz_twin_matches_pallas(setup, dtype):
    s = setup
    packed_j, packed = _packings(s, dtype)
    want_rgb, want_sigma = jfm.fused_nerf_mlp_xyz(
        packed_j, jfm.make_posenc_constants(), jnp.asarray(s.x), jnp.asarray(s.d))
    consts = tfm.make_posenc_constants(device="cpu")
    before = tfm.fused_nerf_mlp_xyz.launches
    rgb, sigma = tfm.fused_nerf_mlp_xyz(packed, consts, _t(s.x), _t(s.d))
    assert tfm.fused_nerf_mlp_xyz.launches == before
    assert rgb.shape == (s.B, s.S, 3) and sigma.shape == (s.B, s.S, 1)
    _close(rgb, want_rgb, dtype, "rgb", TOL_XYZ_F32)
    _close(sigma, want_sigma, dtype, "sigma", TOL_XYZ_F32)
    # rows 1 and 8 are one function: the same twin
    again = tfmt.fused_nerf_mlp_xyz_eval(packed, consts, _t(s.x), _t(s.d))
    assert torch.equal(rgb, again[0]) and torch.equal(sigma, again[1])


def test_fused_mlp_train_matches_jax_vjp(setup):
    s = setup
    n = s.B * s.S
    enc, venc = s.enc.reshape(n, 63), np.repeat(s.venc, s.S, axis=0)
    packed_j = jfmt.pack_vanilla_mlp_params_f32(s.params)
    (want_rgb, want_sigma), vjp = jax.vjp(
        lambda p: jfmt.fused_mlp_train(p, jnp.asarray(enc), jnp.asarray(venc)), packed_j)
    (want_grads,) = vjp((jnp.asarray(s.cot[:, :3]), jnp.asarray(s.cot[:, 3:])))

    packed = {k: v.requires_grad_(True)
              for k, v in tfm.pack_vanilla_mlp_params_f32(s.torch_params).items()}
    enc_t = _t(enc).requires_grad_(True)
    rgb, sigma = tfmt.fused_mlp_train(packed, enc_t, _t(venc))
    assert rgb.shape == (n, 3) and sigma.shape == (n, 1)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(want_rgb), rtol=0, atol=TOL_BF16)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(want_sigma), rtol=0,
                               atol=TOL_BF16)
    ((rgb * _t(s.cot[:, :3])).sum() + (sigma * _t(s.cot[:, 3:])).sum()).backward()
    assert enc_t.grad is None  # gradients flow to the weights only
    got = {k: v.grad for k, v in packed.items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == tfm.SHAPES
    max_rel, mean_rel = tfmt.grad_errors(got, {k: _t(v) for k, v in want_grads.items()})
    assert max_rel <= GRAD_MAX_REL and mean_rel <= GRAD_MEAN_REL, (max_rel, mean_rel)


@pytest.mark.parametrize("padded", [False, True], ids=["63-27", "64-32"])
def test_fused_mlp_bwd_twin_matches_pallas(setup, padded):
    s = setup
    n = s.B * s.S - 5  # ragged: the JAX kernel pads with g = 0
    enc, venc = s.enc.reshape(-1, 63)[:n], np.repeat(s.venc, s.S, axis=0)[:n]
    if padded:
        enc, venc = _pad(enc, 64), _pad(venc, 32)
    cot = s.cot[:n]
    packed_j = jfmt.pack_vanilla_mlp_params_f32(s.params)
    want = jfmt._bwd_call(packed_j, *jfmt._pad_features(jnp.asarray(enc), jnp.asarray(venc)),
                          jnp.asarray(cot), jfmt.TRAIN_TILE)
    packed = tfm.pack_vanilla_mlp_params_f32(s.torch_params)
    before = tfmt.fused_mlp_bwd.launches
    got = tfmt.fused_mlp_bwd(packed, _t(enc), _t(venc), _t(cot))  # the twin
    assert tfmt.fused_mlp_bwd.launches == before
    assert {k: tuple(v.shape) for k, v in got.items()} == tfm.SHAPES
    max_rel, mean_rel = tfmt.grad_errors(got, {k: _t(v) for k, v in want.items()})
    assert max_rel <= GRAD_MAX_REL and mean_rel <= GRAD_MEAN_REL, (max_rel, mean_rel)


def test_ops_exports_the_jax_names_except_the_shadowing_function():
    want = set(jax_ops.__all__) - {"fused_mlp_train"}
    assert set(torch_ops.__all__) == want
    for name in want:
        assert callable(getattr(torch_ops, name)), name
    # the module keeps its name; the function lives inside it
    assert isinstance(torch_ops.fused_mlp_train, types.ModuleType)
    assert torch_ops.fused_mlp_train.fused_mlp_train is tfmt.fused_mlp_train
    # the JAX package's name is the function, not its module
    assert not isinstance(jax_ops.fused_mlp_train, types.ModuleType)


def test_entry_points_raise_on_other_devices(setup):
    s = setup
    packed = tfm.pack_vanilla_mlp_params(s.torch_params)
    packed32 = tfm.pack_vanilla_mlp_params_f32(s.torch_params)
    consts = tfm.make_posenc_constants(device="cpu")

    def meta(*shape):
        return torch.empty(*shape, device="meta")

    counters = (tfm.fused_nerf_mlp, tfm.fused_nerf_mlp_per_ray, tfm.fused_nerf_mlp_xyz,
                tfmt.fused_mlp_bwd)
    before = [c.launches for c in counters]
    calls = (
        lambda: tfm.fused_nerf_mlp(packed, meta(8, 64), meta(8, 32)),
        lambda: tfm.fused_nerf_mlp_per_ray(packed, meta(2, 4, 64), meta(2, 32)),
        lambda: tfm.fused_nerf_mlp_xyz(packed, consts, meta(2, 4, 3), meta(2, 3)),
        lambda: tfmt.fused_mlp_bwd(packed32, meta(8, 64), meta(8, 32), meta(8, 4)),
    )
    for call in calls:
        with pytest.raises(ValueError, match="no kernel"):
            call()
    assert [c.launches for c in counters] == before
