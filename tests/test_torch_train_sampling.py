"""Port parity, training inputs: the randomized sampling branches, the sorted
order-statistics quantiles and the learning-rate schedule of aon_tpu_torch
against the JAX package (CPU, float32).

torch and JAX random streams differ, so every exact test draws the uniforms
once, with the jax.random call the JAX function makes, and injects them into
the port (``t_rand=``, ``u=``).

Tolerances, and why:
  * stratified t-values from the same uniforms: 1 float32 ulp at t ~ 6
    (rtol 2.4e-7): XLA on the CPU may contract lower + (upper - lower) * r
    into an FMA;
  * sorted_uniform 1e-6: a cumsum of 129 exponentials in another order, and
    log1p by another libm;
  * randomized fine samples from the same quantiles: 1e-4, as the
    deterministic ones in test_torch_core.py (the CDF's sums run in another
    order);
  * the schedule: the port computes it in numpy float32 step by step; XLA's
    sin and exp differ from numpy's by an ulp, so rtol 3e-7.
"""

import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.core import sampling as jsamp  # noqa: E402
from aon_tpu.ops import resample_pallas as jres  # noqa: E402
from aon_tpu.train.schedule import nerf_lr_schedule as jax_schedule  # noqa: E402
from aon_tpu_torch.core import sampling as tsamp  # noqa: E402
from aon_tpu_torch.ops import resample as tres  # noqa: E402
from aon_tpu_torch.train.schedule import nerf_lr_schedule  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _rays(rng, B):
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (-4.0 * d + rng.uniform(-0.3, 0.3, (B, 3))).astype(np.float32), d


@pytest.mark.parametrize("lindisp", [False, True])
def test_randomized_sample_along_rays_matches_jax(rng, lindisp):
    B, n = 32, 64
    o, d = _rays(rng, B)
    key = jax.random.PRNGKey(3)
    jt, jc = jsamp.sample_along_rays(key, jnp.asarray(o), jnp.asarray(d), n, 2.0, 6.0,
                                     randomized=True, lindisp=lindisp)
    t_rand = np.asarray(jax.random.uniform(key, (B, n + 1), dtype=jnp.float32))  # the JAX draw
    tt, tc = tsamp.sample_along_rays(_t(o), _t(d), n, 2.0, 6.0, randomized=True, lindisp=lindisp,
                                     t_rand=_t(t_rand))
    assert tt.shape == (B, n + 1) and tc.shape == (B, n + 1, 3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    assert bool((tt[:, 1:] >= tt[:, :-1]).all())  # jitter stays inside each bin


def test_randomized_sample_along_rays_per_ray_intervals(rng):
    B, n = 16, 8
    o, d = _rays(rng, B)
    near = rng.uniform(2.0, 3.0, B).astype(np.float32)
    far = rng.uniform(4.0, 6.0, B).astype(np.float32)
    t_rand = rng.uniform(0, 1, (B, n + 1)).astype(np.float32)
    tt, _ = tsamp.sample_along_rays(_t(o), _t(d), n, _t(near), _t(far), randomized=True,
                                    t_rand=_t(t_rand))
    assert bool((tt >= _t(near)[:, None]).all() and (tt <= _t(far)[:, None]).all())


def test_sorted_uniform_matches_jax():
    key = jax.random.PRNGKey(5)
    want = np.asarray(jres.sorted_uniform(key, (24, 128)))
    raw = np.asarray(jax.random.uniform(key, (24, 129), dtype=jnp.float32))  # the JAX draw
    got = tres.sorted_uniform(_t(raw))
    assert got.shape == (24, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert bool((got[:, 1:] >= got[:, :-1]).all() and (got >= 0).all() and (got < 1).all())


def test_sorted_uniform_has_the_order_statistics_mean():
    g = torch.Generator().manual_seed(0)
    u = tres.sorted_uniform(torch.rand(4000, 9, generator=g))  # E[u_(k)] = k / (n + 1), n = 8
    np.testing.assert_allclose(u.mean(0).numpy(), np.arange(1, 9) / 9.0, atol=1e-2)


def _pdf_inputs(rng, B):
    t_vals = np.sort(rng.uniform(2.0, 6.0, (B, 65)), axis=-1).astype(np.float32)
    bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (B, 63)).astype(np.float32)
    weights[0] = 0.0
    return t_vals, bins, weights


def test_randomized_sample_pdf_fused_matches_jax(rng):
    B = 40
    t_vals, bins, weights = _pdf_inputs(rng, B)
    o, d = _rays(rng, B)
    key = jax.random.PRNGKey(7)
    jt, jc = jres.sample_pdf_fused(key, jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(o),
                                   jnp.asarray(d), jnp.asarray(t_vals), 128, randomized=True)
    u = np.array(jres.sorted_uniform(key, (B, 128)))  # the quantiles the JAX call used
    tt, tc = tres.sample_pdf_fused(_t(bins), _t(weights), _t(o), _t(d), _t(t_vals), 128,
                                   randomized=True, u=_t(u))
    assert tt.shape == (B, 193) and bool((tt[:, 1:] >= tt[:, :-1]).all())
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)


def test_randomized_sample_pdf_matches_jax(rng):
    B = 40
    t_vals, bins, weights = _pdf_inputs(rng, B)
    o, d = _rays(rng, B)
    key = jax.random.PRNGKey(9)
    jt, _ = jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(o),
                             jnp.asarray(d), jnp.asarray(t_vals), 128, randomized=True)
    u = np.asarray(jax.random.uniform(key, (B, 128), dtype=jnp.float32))  # iid, unsorted
    tt, _ = tsamp.sample_pdf(_t(bins), _t(weights), _t(o), _t(d), _t(t_vals), 128,
                             randomized=True, u=_t(u))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)


def test_fused_and_plain_resampling_agree_on_sorted_quantiles(rng):
    # the fused route feeds sorted u to a merge, the plain one sorts the union:
    # the same quantiles give the same sample set
    B = 12
    t_vals, bins, weights = _pdf_inputs(rng, B)
    o, d = _rays(rng, B)
    u = tres.sorted_uniform(_t(rng.uniform(0, 1, (B, 129)).astype(np.float32)))
    args = (_t(bins), _t(weights), _t(o), _t(d), _t(t_vals), 128)
    a, _ = tres.sample_pdf_fused(*args, randomized=True, u=u)
    b, _ = tsamp.sample_pdf(*args, randomized=True, u=u)
    assert torch.equal(a, b)


def test_generator_draws_are_seeded_and_needed(rng):
    o, d = _rays(rng, 8)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tsamp.sample_along_rays(_t(o), _t(d), 8, 2.0, 6.0, randomized=True, generator=g)[0]

    assert torch.equal(draw(1), draw(1)) and not torch.equal(draw(1), draw(2))
    t_vals, bins, weights = _pdf_inputs(rng, 8)
    with pytest.raises(ValueError, match="Generator"):
        tres.sample_pdf_fused(_t(bins), _t(weights), _t(o), _t(d), _t(t_vals), 16, randomized=True)
    with pytest.raises(ValueError, match="Generator"):
        tsamp.sample_pdf(_t(bins), _t(weights), _t(o), _t(d), _t(t_vals), 16, randomized=True)


def test_per_ray_uniform_depends_on_the_ray_alone():
    ids = torch.arange(64)
    state = torch.Generator().manual_seed(4).get_state()

    def rows(ray_ids, n=65):
        g = torch.Generator()
        g.set_state(state)
        return tsamp.per_ray_uniform(g, ray_ids, n)

    whole = rows(ids)
    assert whole.shape == (64, 65) and bool((whole >= 0).all() and (whole < 1).all())
    # any sub-batch, in any order, sees the same rows: independent of the layout
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))[:20]
    assert torch.equal(rows(perm), whole[perm])
    # rays and columns are decorrelated, and another generator state gives other rows
    assert len(torch.unique(whole)) > 0.99 * whole.numel()
    assert abs(whole.mean().item() - 0.5) < 0.02
    assert not torch.equal(tsamp.per_ray_uniform(torch.Generator().manual_seed(5), ids, 65), whole)
    # the sorted per-ray quantiles inherit it
    g = torch.Generator()
    g.set_state(state)
    u = tres.sorted_per_ray_uniform(g, ids, 16)
    g.set_state(state)
    assert torch.equal(tres.sorted_per_ray_uniform(g, ids[10:20], 16), u[10:20])
    assert bool((u[:, 1:] >= u[:, :-1]).all())


SCHEDULE_STEPS = [0, 1, 1250, 2500, 50000, 100000, 200000]


@pytest.mark.parametrize("step", SCHEDULE_STEPS)
def test_nerf_lr_schedule_matches_jax_value_for_value(step):
    want = float(jax_schedule()(step))
    got = nerf_lr_schedule()(step)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


@pytest.mark.parametrize("kw", [dict(lr_delay_steps=0), dict(lr_init=1e-3, lr_final=1e-5,
                                                             lr_delay_steps=100, lr_delay_mult=0.1,
                                                             max_steps=24000)])
def test_nerf_lr_schedule_other_settings(kw):
    for step in (0, 50, 100, 12000, 24000, 30000):
        np.testing.assert_allclose(nerf_lr_schedule(**kw)(step), float(jax_schedule(**kw)(step)),
                                   rtol=3e-7, atol=0)
    # past the horizon the schedule floors at lr_final
    assert nerf_lr_schedule(**kw)(10**7) == pytest.approx(kw.get("lr_final", 5e-6), rel=1e-6)
