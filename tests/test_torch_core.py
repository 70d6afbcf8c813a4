"""Port parity, core layer: aon_tpu_torch.core / eval.metrics / utils.config
against the JAX package on the same numpy inputs (CPU, float32).

Tolerances, and why:
  * rays, the coarse t-values at near/far 2/6, the eval quantiles and the
    config surface are bit-identical (atol=0);
  * sample coordinates o + t*d and lindisp t-values: one float32 ulp, since
    XLA on the CPU may contract a product and a sum into one FMA (it does so
    in some compilations and not in others; see test_torch_kernels.py);
  * pos_enc 1e-6, against JAX and against the exact sine of the same float32
    arguments: the port's sine is taken in float64 and rounded once (torch's
    float32 CPU sin gave one thread's chunk 1.5e-4 off on a process's first
    call), XLA's lies within an ulp;
  * sample_pdf 1e-4: the CDF's sums run in another order in XLA and PyTorch
    (a few ulp of the CDF), and a fine sample moves by that over its bin's
    density;
  * volumetric_rendering 1e-5 and SSIM 1e-5: float32 reductions in another
    order.
"""

import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.core import rays as jrays  # noqa: E402
from aon_tpu.core import rendering as jrender  # noqa: E402
from aon_tpu.core import sampling as jsamp  # noqa: E402
from aon_tpu.eval import metrics as jmetrics  # noqa: E402
from aon_tpu.utils import config as jconfig  # noqa: E402
from aon_tpu_torch.core import prng  # noqa: E402
from aon_tpu_torch.core import rays as trays  # noqa: E402
from aon_tpu_torch.core import rendering as trender  # noqa: E402
from aon_tpu_torch.core import sampling as tsamp  # noqa: E402
from aon_tpu_torch.eval import metrics as tmetrics  # noqa: E402
from aon_tpu_torch.utils import config as tconfig  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rays(rng, B):
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.uniform(-0.5, 0.5, (B, 3)) - 4.0 * d).astype(np.float32)
    return o, d


def test_rays_bit_identical(rng):
    dirs_j = jrays.get_ray_directions(48, 64, 70.0)
    dirs_t = trays.get_ray_directions(48, 64, 70.0)
    np.testing.assert_array_equal(dirs_j, dirs_t)
    poses_j, poses_t = jrays.create_spheric_poses(), trays.create_spheric_poses()
    np.testing.assert_array_equal(poses_j, poses_t)
    for kw in ({}, {"output_view_dirs": True}, {"output_view_dirs": True, "output_radii": True}):
        for a, b in zip(jrays.get_rays(dirs_j, poses_j[3][:3], **kw),
                        trays.get_rays(dirs_t, poses_t[3][:3], **kw)):
            np.testing.assert_array_equal(a, b)
    o, d = _rays(rng, 200)
    bounds = np.array([[-0.5, -0.4, -0.3], [0.5, 0.4, 0.3]], np.float32)
    for a, b in zip(jrays.ray_box_intersection(bounds, o, d),
                    trays.ray_box_intersection(bounds, o, d)):
        np.testing.assert_array_equal(a, b)
    batch = {"t_near": np.full(4, 3.0), "t_far": np.full(4, 4.0), "interval_ramp": 0.25}
    for a, b in zip(jrays.effective_intervals(batch, 2.0, 6.0),
                    trays.effective_intervals(batch, 2.0, 6.0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num", [1, 65, 128, 129, 193])
def test_unit_linspace_matches_jax_bitwise(num):
    want = np.asarray(jnp.linspace(0.0, 1.0, num, dtype=jnp.float32))
    np.testing.assert_array_equal(tsamp.unit_linspace(num).numpy(), want)


def test_eval_quantiles_match_jax_and_torch_linspace_does_not():
    want = np.asarray(jnp.linspace(0.0, 1.0 - 2.0**-32, 128, dtype=jnp.float32))
    np.testing.assert_array_equal(tsamp.eval_quantiles(128).numpy(), want)
    assert want[-1] == 1.0  # 1 - 2**-32 rounds to 1.0 in float32
    # the reason for unit_linspace(): torch's own rounds a few entries 1 ulp away
    assert (torch.linspace(0.0, 1.0 - 2.0**-32, 128).numpy() != want).sum() > 0


@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_along_rays(rng, lindisp):
    o, d = _rays(rng, 64)
    jt, jc = jsamp.sample_along_rays(None, jnp.asarray(o), jnp.asarray(d), 64, 2.0, 6.0,
                                     randomized=False, lindisp=lindisp)
    tt, tc = tsamp.sample_along_rays(_t(o), _t(d), 64, 2.0, 6.0, lindisp=lindisp)
    if lindisp:
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2.4e-7, atol=0)
    else:  # every product of the 2/6 ladder is exact: bit-identical however XLA fuses
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def test_randomized_sampling_not_ported_yet(rng):
    # ported since (tests/test_torch_train_sampling.py holds it against JAX);
    # what still raises is a randomized call with nothing to draw from, as the
    # JAX function raises without a key
    o, d = _rays(rng, 4)
    with pytest.raises(ValueError, match="PRNG key"):
        tsamp.sample_along_rays(_t(o), _t(d), 8, 2.0, 6.0, randomized=True)
    with pytest.raises(ValueError, match="PRNG key"):
        jsamp.sample_along_rays(None, jnp.asarray(o), jnp.asarray(d), 8, 2.0, 6.0, randomized=True)
    t, _ = tsamp.sample_along_rays(_t(o), _t(d), 8, 2.0, 6.0, randomized=True,
                                   key=prng.key(0))
    assert t.shape == (4, 9) and bool((t[:, 1:] >= t[:, :-1]).all())


@pytest.mark.parametrize("deg", [4, 10])
def test_pos_enc(rng, deg):
    x = rng.uniform(-6, 6, (16, 20, 3)).astype(np.float32)
    want = np.asarray(jsamp.pos_enc(jnp.asarray(x), 0, deg))
    got = tsamp.pos_enc(_t(x), 0, deg).numpy()
    assert got.shape == want.shape == (16, 20, (2 * deg + 1) * 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the port against the exact sine of the same float32 arguments
    xb = (x[..., None, :] * np.float32(2.0) ** np.arange(deg, dtype=np.float32)[:, None])
    xb = xb.reshape(16, 20, -1)
    args = np.concatenate([xb, xb + np.float32(0.5 * np.pi)], -1).astype(np.float64)
    np.testing.assert_allclose(got[..., 3:], np.sin(args), rtol=0, atol=1e-6)


def test_sample_pdf(rng):
    B = 48
    t_vals = np.sort(rng.uniform(2.0, 6.0, (B, 65)), axis=-1).astype(np.float32)
    bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (B, 63)).astype(np.float32)
    weights[:2] *= 1e-9  # ~zero mass: the eps padding path
    weights[2, 10:40] = 0.0  # empty bins: zero CDF steps
    o, d = _rays(rng, B)
    jt, jc = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(o),
                              jnp.asarray(d), jnp.asarray(t_vals), 128, randomized=False)
    tt, tc = tsamp.sample_pdf(_t(bins), _t(weights), _t(o), _t(d), _t(t_vals), 128)
    assert tt.shape == (B, 193)
    assert bool((tt[:, 1:] >= tt[:, :-1]).all())
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volumetric_rendering(rng, white_bkgd):
    B, S = 32, 65
    rgb = rng.uniform(0, 1, (B, S, 3)).astype(np.float32)
    sigma = rng.uniform(0, 5, (B, S, 1)).astype(np.float32)
    sigma[:4] = 0.0  # empty rays: acc 0, background only
    sigma[4, 10] = 1e6  # an opaque sample: the eps floor of the cumprod
    t_vals = np.sort(rng.uniform(2, 6, (B, S)), axis=-1).astype(np.float32)
    dirs = (rng.normal(size=(B, 3)) * 1.3).astype(np.float32)  # non-unit: dists scale
    want = jrender.volumetric_rendering(jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(t_vals),
                                        jnp.asarray(dirs), white_bkgd)
    got = trender.volumetric_rendering(_t(rgb), _t(sigma), _t(t_vals), _t(dirs), white_bkgd)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    mse = trender.img2mse(got[0], _t(rgb[:, 0]))
    np.testing.assert_allclose(float(trender.mse2psnr(mse)),
                               float(jrender.mse2psnr(jrender.img2mse(want[0], rgb[:, 0]))),
                               rtol=1e-6)


def test_metrics(rng):
    pred = rng.uniform(-0.1, 1.1, (40, 56, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(scale=0.05, size=pred.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(40, 56)) < 0.3
    assert tmetrics.psnr(pred, gt) == jmetrics.psnr(pred, gt)
    assert tmetrics.psnr_masked(pred, gt, mask) == jmetrics.psnr_masked(pred, gt, mask)
    np.testing.assert_allclose(tmetrics.ssim(pred, gt), jmetrics.ssim(pred, gt), atol=1e-5)
    vals = [30.0, float("nan"), None, 31.0]
    assert tmetrics.summarize("psnr", vals) == jmetrics.summarize("psnr", vals)


def test_config_surface_matches(tmp_path):
    import dataclasses
    import json

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"exp_type": "vanilla", "N_samples": 32, "white_back": True,
                                "chunk": 61440, "compute_dtype": "float32"}))
    argv = ["--config", str(path), "--N_importance", "64", "--use_pallas"]
    want = dataclasses.asdict(jconfig.get_config(argv))
    got = dataclasses.asdict(tconfig.get_config(argv))
    assert got == want
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == \
        [f.name for f in dataclasses.fields(jconfig.Config)]
