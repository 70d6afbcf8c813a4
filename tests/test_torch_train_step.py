"""Port parity, the training slice as a whole: one ``train_step`` of
aon_tpu_torch's ``VanillaSystem`` against the JAX system from the same
converted state, the same batch and the same injected draws; the fused step
functions against the JAX ones run in interpret mode; microbatched
accumulation; Adam against optax; and short CPU training runs.

Tolerances, and why:
  * the plain float32 route against ``VanillaSystem.train_step`` with
    ``use_pallas=False``, whose gradients are read back from its first Adam
    moment (mu = 0.1 * g): loss 1e-5 relative; coarse gradients 1e-2 of each
    tensor's largest and 2e-3 of its mean magnitude (float32 sums in another
    order; seen 2.8e-3 and 5e-4); fine gradients 3e-1 and 4e-2 (seen 1.4e-1
    and 1.8e-2): the fine samples move by ~1e-5 with
    the coarse weights' last bits, which is 5e-3 rad at the top encoding
    frequency, so the two sides differentiate the fine MLP at slightly
    different inputs and a relu flips here and there (the jitted and the
    unjitted JAX gradients differ from each other by as much);
  * the parameters after the Adam update: the first Adam step moves every
    entry by lr * g / (|g| + 1e-8), about lr = 5e-6 whatever its size, so an
    entry whose gradient is within ten times the gradient tolerance of zero
    may change sign and is compared only to within two such steps (2 * lr);
    the others to 2% of one;
  * Adam on the same gradients against optax: 1e-6 relative;
  * the fused v3 and v2 steps against the JAX ones in interpret mode: loss
    2e-3 (v3) and 5e-3 (v2) relative; coarse gradients 3e-1 of each tensor's
    largest and 6e-2 of its mean magnitude, the level's measures of
    test_torch_train_kernels.py (one relu that flips on a heavy sample moves
    single entries by ~2e-1 at 16 rays).  Fine gradients are compared by
    direction and size only (cosine >= 0.6, norm ratio within 0.6..1.6; seen
    0.89 and 0.71, 0.80..1.18): the coarse weights differ by ~2e-4 between the
    two sides (bf16 rounding), so their CDFs and with them the fine samples
    differ by ~5e-4, 0.25 rad at the top encoding frequency.  The two sides
    run the fine level on different inputs; moving the port's own quantiles
    by 1e-3 changes its fine gradients by 26% (mean) at this size.  With the
    same inputs the level agrees as test_torch_train_kernels.py holds it;
  * flat against stacked microbatches: 1e-6 loss, 1e-5 gradients (the same
    float32 work, summed per microbatch).
"""

import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.ops.resample_pallas import sorted_uniform as jax_sorted_uniform  # noqa: E402
from aon_tpu.ops.train_fused_level import make_fused_step_fn as jax_fused_step_fn  # noqa: E402
from aon_tpu.ops.train_pallas import make_fused_loss_fn as jax_fused_loss_fn  # noqa: E402
from aon_tpu.train.schedule import nerf_lr_schedule as jax_schedule  # noqa: E402
from aon_tpu.train.systems import VanillaSystem as JaxVanillaSystem  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.core import prng  # noqa: E402
from aon_tpu_torch.data.analytic import analytic_scene  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax, tree_to_flax  # noqa: E402
from aon_tpu_torch.ops.train_fused_level import make_fused_step_fn  # noqa: E402
from aon_tpu_torch.ops.train_pallas import make_fused_loss_fn  # noqa: E402
from aon_tpu_torch.train.microbatch import accumulated_grads  # noqa: E402
from aon_tpu_torch.train.optim import Adam, default_nerf_optimizer, make_optimizer  # noqa: E402
from aon_tpu_torch.train.systems import build_system  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402

SMALL = dict(N_samples=8, N_importance=8, batch_size=32, use_pallas=False,
             compute_dtype="float32")
N_C, N_F = 8, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(rng, B):
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d.copy(),
            "target": rng.uniform(size=(B, 3)).astype(np.float32)}


def _flat_grad_errors(got, want, prefix=""):
    names = [k for k in want if k.startswith(prefix)]
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
                  for k in names)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(1e-30)).item()
                   for k in names)
    return max_rel, mean_rel


def _assert_fused_grads_close(got, want):
    assert set(got) == set(want)
    max_rel, mean_rel = _flat_grad_errors(got, want, "coarse_mlp.")
    assert max_rel <= 3e-1 and mean_rel <= 6e-2, (max_rel, mean_rel)
    for k in want:
        if k.startswith("fine_mlp."):
            a, b = got[k].reshape(-1), want[k].reshape(-1)
            assert (a @ b / (a.norm() * b.norm())).item() >= 0.6, k
            assert 0.6 <= (a.norm() / b.norm()).item() <= 1.6, k


@pytest.fixture(scope="module")
def jax_system():
    system = JaxVanillaSystem(JaxConfig(**SMALL), 2.0, 6.0, True)
    state = system.init_state(jax.random.PRNGKey(0))
    return system, jax.tree.map(np.asarray, state.params)


def test_train_step_matches_jax_vanilla_system(rng, jax_system):
    jsys, params_np = jax_system
    B = 32
    batch = _batch(rng, B)
    key = jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    jstate = jsys.init_state(jax.random.PRNGKey(0))
    jstate, jmetrics = jsys.train_step(jstate, jbatch, key)
    # after the first step mu = (1 - b1) * g: the step's own gradients
    want_flat = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state[0].mu)).items()}

    # the port's own init and draws from the same keys: JAX's, nothing injected
    system = build_system(Config(**SMALL), 2.0, 6.0, True, device="cpu")
    state = system.init_state(prng.key(0))
    for k, w in params_from_flax(params_np).items():
        assert torch.equal(state.params[k], w), k
    loss, aux, grads = accumulated_grads(system.loss_fn, state.params,
                                         {k: _t(v) for k, v in batch.items()}, prng.key(11))
    np.testing.assert_allclose(loss.item(), float(jmetrics["train/loss"]), rtol=1e-5)
    assert set(want_flat) == set(grads)
    errs = {p: _flat_grad_errors(grads, want_flat, p) for p in ("coarse_mlp.", "fine_mlp.")}
    assert errs["coarse_mlp."][0] <= 1e-2 and errs["coarse_mlp."][1] <= 2e-3, errs
    assert errs["fine_mlp."][0] <= 3e-1 and errs["fine_mlp."][1] <= 4e-2, errs

    new_state, metrics = system.train_step(state, batch, prng.key(11))
    assert new_state.step == 1 and int(jstate.step) == 1 and state.step == 0
    assert set(metrics) == set(jmetrics) == {"train/loss", "train/psnr0", "train/psnr1"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    lr = system.lr_schedule(0)
    np.testing.assert_allclose(lr, float(jax_schedule()(0)), rtol=3e-7)
    want_params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for k, want in want_params.items():
        moved = (new_state.params[k] - state.params[k]).abs().max().item()
        assert 0 < moved <= lr * 1.01, (k, moved)  # one float32 step of the parameter aside
        diff = (new_state.params[k] - want).abs()
        # entries whose gradient is well clear of its tolerance keep their sign
        tol = 1e-2 if k.startswith("coarse_mlp.") else 5e-2
        big = want_flat[k].abs() > 10 * tol * want_flat[k].abs().max()
        assert diff[big].max().item() <= 0.02 * lr, k
        assert diff.max().item() <= 2 * lr, k
    # the second moments carry over in the same layout: nu = (1 - b2) * g^2
    want_nu = params_from_flax(jax.tree.map(np.asarray, jstate.opt_state[0].nu))
    k = "coarse_mlp.views_0.weight"
    assert new_state.nu[k].shape == want_nu[k].shape == (128, 256 + 27)
    np.testing.assert_allclose(new_state.nu[k].numpy(), want_nu[k].numpy(), rtol=0,
                               atol=1e-2 * want_nu[k].max().item())


def test_adam_matches_optax_on_the_same_gradients(rng):
    schedule_kw = dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=4, lr_delay_mult=0.1,
                       max_steps=10)
    params = {"a.weight": rng.normal(size=(5, 7)).astype(np.float32),
              "a.bias": rng.normal(size=(5,)).astype(np.float32)}
    tx = optax.adam(jax_schedule(**schedule_kw), b1=0.9, b2=0.999)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    from aon_tpu_torch.train.schedule import nerf_lr_schedule

    adam = Adam(nerf_lr_schedule(**schedule_kw))
    tparams = {k: _t(v) for k, v in params.items()}
    mu, nu = adam.init(tparams)
    for step in range(4):
        grads = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, opt_state)
        jparams = optax.apply_updates(jparams, updates)
        tparams, mu, nu = adam.update(tparams, {k: _t(v) for k, v in grads.items()}, mu, nu, step)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{k} step {step}")
            np.testing.assert_allclose(nu[k].numpy(), np.asarray(opt_state[0].nu[k]), rtol=1e-6)


def test_make_optimizer_default_pair_and_the_rest():
    tx, schedule = make_optimizer(Config())
    assert isinstance(tx, Adam) and (tx.b1, tx.b2, tx.eps) == (0.9, 0.999, 1e-8)
    assert schedule(0) == default_nerf_optimizer(Config()).schedule(0)
    # lr_max_steps pins the decay horizon apart from run_max_steps
    assert make_optimizer(Config(lr_max_steps=24000))[1](24000) == pytest.approx(5e-6, rel=1e-5)
    # the rest go through the factories (tests/test_torch_optim.py); ranger
    # raises as the JAX package's make_optimizer does
    assert type(make_optimizer(Config(optimizer="sgd"))[0]).__name__ == "SGD"
    tx, schedule = make_optimizer(Config(lr_scheduler="cosine"))
    assert isinstance(tx, Adam) and schedule(Config().run_max_steps) == 0.0
    with pytest.raises(ValueError, match="LookaheadParams"):
        make_optimizer(Config(optimizer="ranger"))


@pytest.mark.parametrize("k", [1, 4])
def test_accumulated_grads_flat_against_stacked(rng, k):
    B = 32
    system = build_system(Config(**SMALL), 2.0, 6.0, True, device="cpu")
    params = system.init_params(prng.key(1))
    batch = {n: _t(v) for n, v in _batch(rng, B).items()}
    draws = {"t_rand": torch.rand(B, N_C + 1, generator=torch.Generator().manual_seed(2)),
             "u": torch.rand(B, N_F, generator=torch.Generator().manual_seed(3))}
    loss, aux, grads = accumulated_grads(system.loss_fn, params, batch, None, draws)

    def stack(tree):
        return {n: v.reshape(k, B // k, *v.shape[1:]) for n, v in tree.items()}

    loss_k, aux_k, grads_k = accumulated_grads(system.loss_fn, params, stack(batch), None,
                                               stack(draws))
    np.testing.assert_allclose(loss_k.item(), loss.item(), rtol=1e-6)
    for n in aux:
        np.testing.assert_allclose(aux_k[n].item(), aux[n].item(), rtol=1e-6)
    assert _flat_grad_errors(grads_k, grads)[0] <= 1e-5


def test_accumulated_grads_per_ray_streams_ignore_the_microbatching(rng):
    B = 32
    system = build_system(Config(**SMALL), 2.0, 6.0, True, device="cpu")
    params = system.init_params(prng.key(1))
    batch = {n: _t(v) for n, v in _batch(rng, B).items()}
    batch["ray_ids"] = torch.arange(B)
    fn = make_fused_step_fn(2.0, 6.0, True, N_C, N_F)  # CPU tensors: the twins
    results = []
    for k in (1, 2, 4):
        stacked = {n: v.reshape(k, B // k, *v.shape[1:]) for n, v in batch.items()}
        results.append(accumulated_grads(fn, params, stacked, prng.key(5)))
    for loss, aux, grads in results[1:]:
        np.testing.assert_allclose(loss.item(), results[0][0].item(), rtol=1e-6)
        assert _flat_grad_errors(grads, results[0][2])[0] <= 1e-5
    # without ray ids microbatch i draws from split(key, k)[i], as in JAX
    del batch["ray_ids"]
    stacked = {n: v.reshape(2, B // 2, *v.shape[1:]) for n, v in batch.items()}
    a = accumulated_grads(fn, params, stacked, prng.key(5))
    assert abs(a[0].item() - results[0][0].item()) > 1e-7
    halves = [fn(params, {n: v[i] for n, v in stacked.items()}, k)[0]
              for i, k in enumerate(prng.split(prng.key(5), 2))]
    np.testing.assert_allclose(a[0].item(), (halves[0] + halves[1]).item() / 2, rtol=1e-6)


def _fused_setup(rng, jax_system, B=16):
    _, params_np = jax_system
    batch = _batch(rng, B)
    return params_np, batch, {k: jnp.asarray(v) for k, v in batch.items()}


def test_fused_v3_step_matches_jax_in_interpret_mode(rng, jax_system):
    params_np, batch, jbatch = _fused_setup(rng, jax_system)
    B = len(batch["rays_o"])
    key = jax.random.PRNGKey(13)
    want_loss, want_aux, want_grads = jax_fused_step_fn(2.0, 6.0, True, N_C, N_F)(
        jax.tree.map(jnp.asarray, params_np), jbatch, key)
    k0, k2 = jax.random.split(key)  # the step's own split
    draws = {"t_rand": _t(jax.random.uniform(k0, (B, N_C + 1), dtype=jnp.float32)),
             "u": _t(jax_sorted_uniform(k2, (B, N_F)))}
    fn = make_fused_step_fn(2.0, 6.0, True, N_C, N_F)
    assert fn.returns_grads
    loss, aux, grads = fn(params_from_flax(params_np), {k: _t(v) for k, v in batch.items()},
                          None, draws)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-3)
    for k in ("loss0", "loss1"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=2e-3)
    _assert_fused_grads_close(grads, params_from_flax(jax.tree.map(np.asarray, want_grads)))


def test_fused_v2_loss_matches_jax_in_interpret_mode(rng, jax_system):
    params_np, batch, jbatch = _fused_setup(rng, jax_system)
    B = len(batch["rays_o"])
    key = jax.random.PRNGKey(17)
    jloss_fn = jax_fused_loss_fn(2.0, 6.0, True, N_C, N_F)
    (want_loss, want_aux), want_grads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jbatch, key)
    k0, _, k2, _ = jax.random.split(key, 4)
    draws = {"t_rand": _t(jax.random.uniform(k0, (B, N_C + 1), dtype=jnp.float32)),
             "u": _t(jax_sorted_uniform(k2, (B, N_F)))}
    loss_fn = make_fused_loss_fn(2.0, 6.0, True, N_C, N_F)
    assert not getattr(loss_fn, "returns_grads", False)
    loss, aux, grads = accumulated_grads(loss_fn, params_from_flax(params_np),
                                         {k: _t(v) for k, v in batch.items()}, None, draws)
    # 5e-3: in interpret mode the JAX forward keeps float32 weights in float32,
    # the port rounds them to bf16 as the card does (test_torch_train_kernels.py)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=5e-3)
    np.testing.assert_allclose(aux["loss1"].item(), float(want_aux["loss1"]), rtol=5e-3)
    _assert_fused_grads_close(grads, params_from_flax(jax.tree.map(np.asarray, want_grads)))


def test_fused_routes_agree_with_each_other_and_deterministic_switch(rng, jax_system):
    params_np, batch, _ = _fused_setup(rng, jax_system)
    B = len(batch["rays_o"])
    params = params_from_flax(params_np)
    tbatch = {k: _t(v) for k, v in batch.items()}
    g = torch.Generator().manual_seed(0)
    draws = {"t_rand": torch.rand(B, N_C + 1, generator=g),
             "u": torch.sort(torch.rand(B, N_F, generator=g), dim=-1).values}
    v3 = accumulated_grads(make_fused_step_fn(2.0, 6.0, True, N_C, N_F), params, tbatch, None, draws)
    v2 = accumulated_grads(make_fused_loss_fn(2.0, 6.0, True, N_C, N_F), params, tbatch, None, draws)
    np.testing.assert_allclose(v3[0].item(), v2[0].item(), rtol=1e-5)
    assert _flat_grad_errors(v3[2], v2[2])[0] <= 1e-2
    # randomized=False needs neither a key nor draws, and repeats itself
    fixed = make_fused_loss_fn(2.0, 6.0, True, N_C, N_F, randomized=False)
    a, b = fixed(params, tbatch)[0], fixed(params, tbatch)[0]
    assert a.item() == b.item()
    noisy = make_fused_loss_fn(2.0, 6.0, True, N_C, N_F, noise_std=1.0)
    with pytest.raises(ValueError, match="PRNG key"):
        noisy(params, tbatch, None, draws)  # the sigma noise still needs a key
    assert torch.isfinite(noisy(params, tbatch, prng.key(0), draws)[0])


def test_fine_gradients_are_sensitive_to_the_quantiles(rng):
    # why the fused steps' fine gradients are compared with JAX by direction
    # only: a shift of the fine quantiles by 1e-3 (what a 2e-4 difference in the
    # coarse weights does to the CDF) leaves the loss and the coarse level
    # alone and changes the fine gradients by tens of percent at 16 rays
    # (seen: 26% of the mean magnitude, cosine 0.97)
    B = 16
    system = build_system(Config(**SMALL), 2.0, 6.0, True, device="cpu")
    params = system.init_params(prng.key(0))
    batch = {k: _t(v) for k, v in _batch(rng, B).items()}
    g = torch.Generator().manual_seed(1)
    draws = {"t_rand": torch.rand(B, N_C + 1, generator=g),
             "u": torch.sort(torch.rand(B, N_F, generator=g), dim=-1).values}
    fn = make_fused_step_fn(2.0, 6.0, True, N_C, N_F)
    loss_a, _, grads_a = fn(params, batch, None, draws)
    loss_b, _, grads_b = fn(params, batch, None,
                            dict(draws, u=(draws["u"] + 1e-3).clamp(max=1 - 1e-6)))
    assert abs(loss_a.item() - loss_b.item()) <= 1e-2 * loss_a.item()
    assert _flat_grad_errors(grads_a, grads_b, "coarse_mlp.")[0] == 0.0
    assert _flat_grad_errors(grads_a, grads_b, "fine_mlp.")[1] >= 5e-2


def _scene_batches(steps, B, seed=0):
    scene = analytic_scene(n_views=3, w=32, h=24, seed=seed)
    g = np.random.default_rng(seed)
    for _ in range(steps):
        idx = g.integers(0, len(scene["rays_o"]), B)
        yield {k: v[idx] for k, v in scene.items()}


def test_thirty_cpu_steps_on_the_analytic_scene_lower_the_loss():
    cfg = Config(**{**SMALL, "batch_size": 64}, lr_delay_steps=0)
    system = build_system(cfg, 2.0, 6.0, True, device="cpu")
    state = system.init_state(prng.key(0))
    losses = []
    for i, batch in enumerate(_scene_batches(30, 64)):
        state, metrics = system.train_step(state, batch, prng.fold_in(prng.key(1), i))
        losses.append(metrics["train/loss"].item())
    assert state.step == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.6 * np.mean(losses[:5]), losses


def test_fused_v3_twin_trains_on_the_analytic_scene():
    # the kernel route's step function on CPU tensors (its plain twins) under the port's Adam
    cfg = Config(**SMALL, lr_delay_steps=0)
    tx = default_nerf_optimizer(cfg)
    system = build_system(cfg, 2.0, 6.0, True, device="cpu")
    state = system.init_state(prng.key(0))
    fn = make_fused_step_fn(2.0, 6.0, True, N_C, N_F)
    losses = []
    for i, batch in enumerate(_scene_batches(12, 32, seed=1)):
        loss, _, grads = accumulated_grads(fn, state.params, {k: _t(v) for k, v in batch.items()},
                                           prng.fold_in(prng.key(1), i))
        state = state.apply_gradients(grads)
        losses.append(loss.item())
    assert state.tx.eps == tx.eps and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_train_many_is_a_loop_of_train_steps(rng):
    T, k, m = 3, 2, 8
    system = build_system(Config(**SMALL), 2.0, 6.0, True, device="cpu")
    state0 = system.init_state(prng.key(0))
    flat = _batch(rng, T * k * m)
    superbatch = {n: _t(v).reshape(T, k, m, 3) for n, v in flat.items()}
    state, metrics = system.train_many(state0, superbatch, prng.key(1))
    assert state.step == T and state0.step == 0
    assert set(metrics) == {"train/loss", "train/psnr0", "train/psnr1", "train/loss_last"}

    # step t takes fold_in(key, t) (aon_tpu/train/microbatch.py:199)
    ref, losses = state0, []
    ids = torch.arange(k * m).reshape(k, m)
    for t in range(T):
        batch = {n: v[t] for n, v in superbatch.items()}
        ref, mt = system.train_step(ref, dict(batch, ray_ids=ids), prng.fold_in(prng.key(1), t))
        losses.append(mt["train/loss"].item())
    np.testing.assert_allclose(metrics["train/loss"].item(), np.mean(losses), rtol=1e-6)
    np.testing.assert_allclose(metrics["train/loss_last"].item(), losses[-1], rtol=1e-6)
    for n in ref.params:
        assert torch.equal(ref.params[n], state.params[n]), n


def test_state_trees_round_trip_through_the_flax_layout(jax_system):
    _, params_np = jax_system
    flat = params_from_flax(params_np)
    assert flat["coarse_mlp.pts_5.weight"].shape == (256, 256 + 63)
    back = tree_to_flax(flat)
    for level, layers in params_np.items():
        for layer, leaves in layers.items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(back[level][layer][leaf], v)


def test_route_choice_follows_the_device_and_the_config():
    # kernels only on CUDA: a CPU system takes the plain module whatever the config says
    for kw in (dict(use_pallas=True), dict(use_pallas=True, fused_train="v2"),
               dict(use_pallas=False), dict(use_pallas=True, noise_std=1.0)):
        system = build_system(Config(N_samples=8, N_importance=8, **kw), 2.0, 6.0, True,
                              device="cpu")
        assert system.loss_fn == system._plain_loss_fn and system._fused is None
        assert system.model.noise_std == kw.get("noise_std", 0.0)
