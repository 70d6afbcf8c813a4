"""Port parity, the auto-decoder's modules: the code library, the articulated
MLP and the two-level articulated NeRF against the flax modules with converted
params, the params / gradients / moments carry-over in both directions, and
the articulated analytic scene.

Tolerances, and why:
  * code library rows, midpoints and ``is_test`` indexing: exact (lookups and
    one float32 average);
  * ``ArticulatedNeRFMLP`` in float32 against flax: 5e-4 absolute on raw
    outputs (seen 1e-4): float32 sums in another order move the deformation
    output by ~1e-7, which the encoding's top frequency (2^9) turns into ~1e-4
    rad of phase; 2e-5 with ``deform_out`` zeroed;
  * ``ArticulatedNeRF`` deterministic forward: comp_rgb and acc 2e-3, depth
    2e-2: as above, through two levels (the coarse weights move the fine
    samples);
  * conversion round trips: bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aon_tpu.core.sampling import pos_enc as jax_pos_enc
from aon_tpu.models.articulated import ArticulatedNeRF as FlaxArtNeRF
from aon_tpu.models.articulated import ArticulatedNeRFMLP as FlaxArtMLP
from aon_tpu.models.code_library import CodeLibraryArticulated as FlaxCodeLibrary
from aon_tpu.models.code_library import interpolate_articulations as jax_interpolate
from aon_tpu_torch.core import prng
from aon_tpu_torch.core.sampling import pos_enc
from aon_tpu_torch.data.analytic import articulated_scene, render_articulated
from aon_tpu_torch.models.articulated import ArticulatedNeRF, ArticulatedNeRFMLP
from aon_tpu_torch.models.code_library import CodeLibraryArticulated, interpolate_articulations
from aon_tpu_torch.models.convert import params_from_flax, tree_to_flax


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _latents(g):
    return {"density": (g.normal(size=(1, 128)) * 0.1).astype(np.float32),
            "color": (g.normal(size=(1, 128)) * 0.1).astype(np.float32),
            "articulation": (g.normal(size=(1, 32)) * 0.1).astype(np.float32)}


@pytest.fixture(scope="module")
def library():
    flax_lib = FlaxCodeLibrary(n_max_objs=5)
    params = flax_lib.init(jax.random.PRNGKey(3), jnp.array(0), jnp.array(0))["params"]
    lib = CodeLibraryArticulated(n_max_objs=5)
    return flax_lib, params, lib, params_from_flax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("ids,is_test", [((2, 7), False), ((4, 13), True), ((0, 18), True),
                                         (([1, 3], [0, 9]), False), (([1, 3], [1, 2]), True)])
def test_code_library_rows_match_flax(library, ids, is_test):
    flax_lib, params, lib, state = library
    inst, art = ids
    want = flax_lib.apply({"params": params}, jnp.asarray(inst), jnp.asarray(art), is_test=is_test)
    got = torch.func.functional_call(lib, state, (inst, art), dict(is_test=is_test))
    assert set(got) == set(want) == {"density", "color", "articulation"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_interpolate_articulations_midpoints():
    table = np.random.default_rng(0).normal(size=(10, 32)).astype(np.float32)
    got = interpolate_articulations(_t(table))
    assert got.shape == (19, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_interpolate(jnp.asarray(table))))
    assert torch.equal(got[0::2], _t(table))
    assert torch.equal(got[5], 0.5 * (_t(table)[2] + _t(table)[3]))


def test_code_library_init_is_seeded_xavier_and_shaped():
    a = CodeLibraryArticulated(n_max_objs=8, key=prng.key(1))
    b = CodeLibraryArticulated(n_max_objs=8, key=prng.key(1))
    shapes = {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert shapes == {"embedding_instance_shape.weight": (8, 128),
                      "embedding_instance_appearance.weight": (8, 128),
                      "embedding_instance_articulation.weight": (10, 32)}
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    bound = (6.0 / (8 + 128)) ** 0.5  # xavier-uniform
    w = a.embedding_instance_shape.weight
    assert w.abs().max() <= bound and w.abs().max() > 0.8 * bound


@pytest.fixture(scope="module")
def mlp_setup():
    g = np.random.default_rng(0)
    B, S = 5, 7
    samples = (g.normal(size=(B, S, 3)) * 1.5).astype(np.float32)
    vd = g.normal(size=(B, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    latents = _latents(g)
    flax_mlp = FlaxArtMLP()
    jl = {k: jnp.asarray(v) for k, v in latents.items()}
    venc = jax_pos_enc(jnp.asarray(vd), 0, 4)
    params = flax_mlp.init(jax.random.PRNGKey(0), jnp.asarray(samples), venc, jl)["params"]
    params = {name: {"kernel": layer["kernel"],
                     "bias": jnp.asarray(g.normal(size=layer["bias"].shape).astype(np.float32)
                                         * 0.05)} for name, layer in params.items()}
    return flax_mlp, params, samples, vd, venc, latents, jl


@pytest.mark.parametrize("zero_deform", [False, True], ids=["live", "zero_deform_out"])
def test_articulated_mlp_matches_flax(mlp_setup, zero_deform):
    flax_mlp, params, samples, vd, venc, latents, jl = mlp_setup
    if zero_deform:
        params = dict(params, deform_out={k: jnp.zeros_like(v)
                                          for k, v in params["deform_out"].items()})
    want_rgb, want_sigma = flax_mlp.apply({"params": params}, jnp.asarray(samples), venc, jl)
    mlp = ArticulatedNeRFMLP()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == set(mlp.state_dict())
    assert all(tuple(v.shape) == tuple(mlp.state_dict()[k].shape) for k, v in state.items())
    rgb, sigma = torch.func.functional_call(
        mlp, state, (_t(samples), pos_enc(_t(vd), 0, 4), {k: _t(v) for k, v in latents.items()}))
    assert rgb.shape == (5, 7, 3) and sigma.shape == (5, 7, 1)
    tol = 2e-5 if zero_deform else 5e-4
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=tol)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=tol)


def test_articulated_mlp_reads_articulation_deg_when_asked(mlp_setup):
    _, params, samples, vd, _, latents, _ = mlp_setup
    state = params_from_flax(jax.tree.map(np.asarray, params))
    lat = {k: _t(v) for k, v in latents.items()}
    args = (_t(samples), pos_enc(_t(vd), 0, 4))
    want = torch.func.functional_call(ArticulatedNeRFMLP(), state, (*args, lat))
    lat_deg = {"density": lat["density"], "color": lat["color"],
               "articulation_deg": lat["articulation"]}
    got = torch.func.functional_call(ArticulatedNeRFMLP(use_deg_embedding=True), state,
                                     (*args, lat_deg))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("sigma_activation,rgb_padding,white",
                         [("softplus_bias", 0.001, False), ("relu", 0.0, True)])
def test_articulated_nerf_matches_flax(sigma_activation, rgb_padding, white):
    g = np.random.default_rng(2)
    B = 12
    d = g.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d.copy()}
    latents = _latents(g)
    kw = dict(num_coarse_samples=8, num_fine_samples=8, sigma_activation=sigma_activation,
              rgb_padding=rgb_padding)
    flax_model = FlaxArtNeRF(**kw)
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    jl = {k: jnp.asarray(v) for k, v in latents.items()}
    variables = flax_model.init(jax.random.PRNGKey(1), jrays, jl, None, False, white, 2.0, 6.0)
    # a denser field than a fresh init gives, so that acc is not ~0
    params = jax.tree.map(lambda x: x, variables["params"])
    for level in ("coarse_mlp", "fine_mlp"):
        params[level]["density"]["bias"] = params[level]["density"]["bias"] + 2.0
    want = flax_model.apply({"params": params}, jrays, jl, None, False, white, 2.0, 6.0)
    model = ArticulatedNeRF(**kw)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == set(model.state_dict())
    got = torch.func.functional_call(
        model, state, ({k: _t(v) for k, v in rays.items()},
                       {k: _t(v) for k, v in latents.items()}, white, 2.0, 6.0))
    assert len(got) == len(want) == 2
    for (rgb, acc, depth), (jrgb, jacc, jdepth) in zip(got, want):
        assert float(jacc.max()) > 0.2
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=2e-3)
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=2e-3)
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=2e-2)
    with pytest.raises(ValueError, match="sigma_activation"):
        ArticulatedNeRF(sigma_activation="elu")


def test_convert_carries_the_autodecoder_tree_both_ways(library):
    _, lib_params, _, _ = library
    g = np.random.default_rng(5)
    flax_mlp = FlaxArtMLP()
    lat = {k: jnp.asarray(v) for k, v in _latents(g).items()}
    mlp_params = flax_mlp.init(jax.random.PRNGKey(0), jnp.zeros((2, 3, 3)), jnp.zeros((2, 27)),
                               lat)["params"]
    tree = {"model": {"coarse_mlp": mlp_params, "fine_mlp": mlp_params},
            "code_library": lib_params}
    tree = jax.tree.map(np.asarray, tree)
    flat = params_from_flax(tree)
    assert flat["model.coarse_mlp.deform_0.weight"].shape == (128, 3 + 128 + 32)
    assert flat["model.fine_mlp.views_0.weight"].shape == (128, 256 + 27 + 128)
    # a flax Embed's table carries over untransposed
    assert flat["code_library.embedding_instance_articulation.weight"].shape == (10, 32)
    np.testing.assert_array_equal(
        flat["code_library.embedding_instance_shape.weight"].numpy(),
        tree["code_library"]["embedding_instance_shape"]["embedding"])
    back = tree_to_flax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_articulated_scene_follows_its_ids():
    scene = articulated_scene(n_instances=2, n_articulations=3, n_views=2, w=16, h=12, seed=1)
    assert {k: v.shape for k, v in scene.items()} == {
        k: (6, 2 * 16 * 12, 3) for k in ("rays_o", "rays_d", "viewdirs", "target")}
    assert all(v.dtype == np.float32 for v in scene.values())
    np.testing.assert_allclose(np.linalg.norm(scene["rays_d"], axis=-1), 1.0, atol=1e-5)
    again = articulated_scene(n_instances=2, n_articulations=3, n_views=2, w=16, h=12, seed=1)
    assert all(np.array_equal(scene[k], again[k]) for k in scene)
    # on black, and every pair shows its object
    lit = scene["target"].sum(-1) > 0
    assert lit.any(axis=1).all() and not lit.all(axis=1).any()
    # the same rays see another colour per instance and another silhouette per articulation
    o, rd = scene["rays_o"][0], scene["rays_d"][0]
    rgb00, a00 = render_articulated(o, rd, 0, 0, 3)
    rgb10, a10 = render_articulated(o, rd, 1, 0, 3)
    rgb02, a02 = render_articulated(o, rd, 0, 2, 3)
    both = (a00 > 0) & (a10 > 0)
    assert both.any() and not np.allclose(rgb00[both], rgb10[both])
    assert (a00 != a02).any()
