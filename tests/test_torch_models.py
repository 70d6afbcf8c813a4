"""Port parity, models: aon_tpu_torch NeRFMLP / VanillaNeRF at full width in
float32 against the flax modules, with the flax params carried over by
models/convert.py.  Tolerances are the JAX suite's own for a float32 MLP
(2e-5 rgb / 2e-4 sigma, tests/test_pallas_kernels.py).  Rendered outputs:
1e-5 at the coarse level (float32 sums in another order); at the fine level
1e-4 (comp_rgb, acc) and 1e-3 (depth), since the fine samples inherit
sample_pdf's tolerance (test_torch_core.py, test_torch_render.py)."""

import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.core.sampling import pos_enc  # noqa: E402
from aon_tpu.models.mlp import NeRFMLP as FlaxMLP  # noqa: E402
from aon_tpu.models.nerf import VanillaNeRF as FlaxNeRF  # noqa: E402
from aon_tpu_torch.core import prng  # noqa: E402
from aon_tpu_torch.core.sampling import pos_enc as tpos_enc  # noqa: E402
from aon_tpu_torch.models.convert import load_npz, params_from_flax  # noqa: E402
from aon_tpu_torch.models.mlp import NeRFMLP  # noqa: E402
from aon_tpu_torch.models.nerf import VanillaNeRF  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def flax_mlp():
    g = np.random.default_rng(0)
    x = g.uniform(-3, 3, (8, 33, 3)).astype(np.float32)
    vd = g.normal(size=(8, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    enc, venc = pos_enc(jnp.asarray(x), 0, 10), pos_enc(jnp.asarray(vd), 0, 4)
    params = _np_tree(FlaxMLP().init(jax.random.PRNGKey(0), enc, venc)["params"])
    rgb, sigma = FlaxMLP().apply({"params": params}, enc, venc)
    return params, x, vd, np.asarray(rgb), np.asarray(sigma)


def test_params_from_flax_names_and_layout(flax_mlp):
    params = flax_mlp[0]
    sd = params_from_flax(params)
    model = NeRFMLP()
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    np.testing.assert_array_equal(sd["pts_5.weight"].numpy(), params["pts_5"]["kernel"].T)
    assert sd["pts_5.weight"].shape == (256, 256 + 63)  # skip concat after pts_4


def test_nerf_mlp_matches_flax(flax_mlp):
    params, x, vd, rgb_ref, sigma_ref = flax_mlp
    model = NeRFMLP()
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        rgb, sigma = model(tpos_enc(torch.from_numpy(x), 0, 10),
                           tpos_enc(torch.from_numpy(vd), 0, 4))
    np.testing.assert_allclose(rgb.numpy(), rgb_ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(sigma.numpy(), sigma_ref, rtol=0, atol=2e-4)


def test_init_is_xavier_uniform_zero_bias_and_seeded():
    a = NeRFMLP(key=prng.key(3)).state_dict()
    b = NeRFMLP(key=prng.key(3)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = a["pts_1.weight"]
    limit = np.sqrt(6.0 / (256 + 256))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
    assert all(float(a[k].abs().max()) == 0.0 for k in a if k.endswith("bias"))


def test_vanilla_nerf_matches_flax_both_levels(rng, tmp_path):
    B = 24
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.uniform(-0.3, 0.3, (B, 3)) - 4.0 * d).astype(np.float32)
    rays = {"rays_o": o, "rays_d": d, "viewdirs": d}
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    model = FlaxNeRF(num_coarse_samples=32, num_fine_samples=64)
    params = model.init(jax.random.PRNGKey(1), jrays, None, False, True, 2.0, 6.0)["params"]
    params = _np_tree(params)
    want = model.apply({"params": params}, jrays, None, False, True, 2.0, 6.0)

    # carried over through the flat npz form a converted checkpoint takes
    flat = {f"{lvl}/{layer}/{leaf}": v for lvl, layers in params.items()
            for layer, leaves in layers.items() for leaf, v in leaves.items()}
    np.savez(tmp_path / "params.npz", **flat)
    net = VanillaNeRF(num_coarse_samples=32, num_fine_samples=64)
    net.load_state_dict(load_npz(str(tmp_path / "params.npz")))
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in rays.items()}, True, 2.0, 6.0)
    for lvl, atols in ((0, (1e-5, 1e-5, 1e-5)), (1, (1e-4, 1e-4, 1e-3))):
        for w, g, atol in zip(want[lvl], got[lvl], atols):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
