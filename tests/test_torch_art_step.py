"""Port parity, the auto-decoder slice as a whole: one ``train_step`` of
aon_tpu_torch's ``AutoDecoderSystem`` against the JAX system from the same
converted state, batch and injected draws; the fused v3 and v2 steps against
the JAX ones run in interpret mode; ``render_chunk`` against the JAX
``render_chunk``; the articulation-smoothness term in both conventions;
microbatches that carry the per-step ids; and ``build_system``.

Tolerances, and why:
  * the plain float32 route against the JAX ``AutoDecoderSystem.train_step``
    with ``use_pallas=False``, whose gradients are read back from its first
    Adam moment (mu = 0.1 * g): loss 1e-4 relative, ``reg`` 1e-6; coarse
    gradients 5e-2 of each tensor's largest and 1e-2 of its mean magnitude
    (float32 sums in another order move the deformation output by ~1e-7,
    2^9 times that in phase at the top frequency); fine gradients and the code
    rows' gradients, which also sum the fine level's share, 3e-1 and 5e-2 (the
    fine samples move with the coarse weights' last bits, as
    tests/test_torch_train_step.py explains for the vanilla system);
  * code-table rows no step indexed: zero gradient and bit-identical after
    the Adam update;
  * the fused v3 and v2 steps against the JAX ones in interpret mode: loss
    5e-3 relative; coarse gradients by direction (cosine >= 0.9 over the
    level's tensors; seen 0.99): with a live deformation two bf16
    implementations agree per entry only up to the phase noise that
    tests/test_torch_art_kernels.py describes; fine gradients by direction
    and size only (cosine >= 0.6, norm ratio 0.6..1.6), as for the vanilla
    system; code rows' gradients by direction (cosine >= 0.8);
  * v3 against v2 in the port, same draws: loss 1e-5, gradients 5e-2 of each
    tensor's largest magnitude (seen 2e-2): the same MLP twin on both sides,
    but the compositing backward is written out on one and autograd's on the
    other, and a cotangent that moves in its last bits re-rounds to bf16;
  * ``render_chunk`` in float32 against the JAX one: comp_rgb and acc 2e-3,
    depth 2e-2 (tests/test_torch_art_models.py); the fused route on the CPU
    (the kernels' twins) against the float32 route: 3e-2 / 3e-2 / 2.5e-1, the
    limits chip_smoke.py holds the vanilla path to;
  * flat against stacked microbatches: 1e-6 loss, 2e-4 gradients (seen 6e-5:
    the same float32 work summed per microbatch, with the deformation's
    phase amplification on top).
"""

import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.models.code_library import CodeLibraryArticulated as FlaxCodeLibrary  # noqa: E402
from aon_tpu.ops.resample_pallas import sorted_uniform as jax_sorted_uniform  # noqa: E402
from aon_tpu.ops.train_art_pallas import (  # noqa: E402
    make_fused_autodecoder_loss_fn as jax_v2_loss_fn,
)
from aon_tpu.ops.train_fused_level_art import (  # noqa: E402
    make_fused_autodecoder_step_fn as jax_v3_step_fn,
)
from aon_tpu.train.systems import AutoDecoderSystem as JaxAutoDecoderSystem  # noqa: E402
from aon_tpu.train.systems import _with_art_smoothness as jax_with_smoothness  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.models.init import seeded_params  # noqa: E402
from aon_tpu_torch.core import prng  # noqa: E402
from aon_tpu_torch.eval.render import render_frame  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.ops.train_art_pallas import (  # noqa: E402
    make_fused_art_render_fn,
    make_fused_autodecoder_loss_fn,
)
from aon_tpu_torch.ops.train_fused_level_art import make_fused_autodecoder_step_fn  # noqa: E402
from aon_tpu_torch.train.microbatch import accumulated_grads  # noqa: E402
from aon_tpu_torch.train.systems import (  # noqa: E402
    ART_TABLE,
    AutoDecoderSystem,
    _with_art_smoothness,
    build_system,
)
from aon_tpu_torch.utils.config import Config  # noqa: E402

SMALL = dict(exp_type="vanilla_autodecoder", N_samples=8, N_importance=8, N_max_objs=4,
             white_back=False, use_pallas=False, compute_dtype="float32")
N_C, N_F = 8, 8
INSTANCE, ARTICULATION = 2, 5
TABLES = {"code_library.embedding_instance_shape.weight": INSTANCE,
          "code_library.embedding_instance_appearance.weight": INSTANCE,
          ART_TABLE: ARTICULATION}


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(rng, B, loss_w=False):
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d.copy(),
             "target": rng.uniform(size=(B, 3)).astype(np.float32),
             "instance_id": np.int32(INSTANCE), "articulation_id": np.int32(ARTICULATION)}
    if loss_w:
        w = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
        batch["loss_w"] = w / w.mean()
    return batch


def _errors(got, want, names):
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
                  for k in names)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(1e-30)).item()
                   for k in names)
    return max_rel, mean_rel


def _cos(got, want, names):
    a = torch.cat([got[k].reshape(-1) for k in names])
    b = torch.cat([want[k].reshape(-1) for k in names])
    return (a @ b / (a.norm() * b.norm())).item(), (a.norm() / b.norm()).item()


def _names(tree, prefix):
    return [k for k in tree if k.startswith(prefix)]


def _assert_unindexed_rows_zero(grads):
    for name, row in TABLES.items():
        rows = grads[name].abs().sum(dim=1)
        assert rows[row] > 0, name
        assert not rows[torch.arange(len(rows)) != row].any(), name


@pytest.fixture(scope="module")
def jax_system():
    system = JaxAutoDecoderSystem(JaxConfig(**SMALL), 2.0, 6.0, False)
    state = system.init_state(jax.random.PRNGKey(0))
    return system, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("loss_w", [False, True], ids=["uniform", "loss_w"])
def test_train_step_matches_jax_autodecoder_system(rng, jax_system, loss_w):
    jsys, params_np = jax_system
    B = 32
    batch = _batch(rng, B, loss_w)
    key = jax.random.PRNGKey(11)

    jstate = jsys.init_state(jax.random.PRNGKey(0))
    jstate, jmetrics = jsys.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    # after the first step mu = (1 - b1) * g: the step's own gradients
    want = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state[0].mu)).items()}

    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    assert isinstance(system, AutoDecoderSystem)
    # the port's own init and draws from the same keys: JAX's, nothing injected
    state = system.init_state(prng.key(0))
    params = params_from_flax(params_np)
    assert set(params) == set(state.params)
    assert all(torch.equal(params[k], state.params[k]) for k in params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss, aux, grads = accumulated_grads(system.loss_fn, state.params, tbatch, prng.key(11))
    np.testing.assert_allclose(loss.item(), float(jmetrics["train/loss"]), rtol=1e-4)
    np.testing.assert_allclose(aux["reg"].item(), float(jmetrics["train/loss/reg"]), rtol=1e-6)
    assert set(want) == set(grads)
    coarse = _errors(grads, want, _names(want, "model.coarse_mlp."))
    fine = _errors(grads, want, _names(want, "model.fine_mlp."))
    codes = _errors(grads, want, list(TABLES))
    assert coarse[0] <= 5e-2 and coarse[1] <= 1e-2, coarse
    assert fine[0] <= 3e-1 and fine[1] <= 5e-2, fine
    assert codes[0] <= 3e-1 and codes[1] <= 5e-2, codes
    _assert_unindexed_rows_zero(grads)

    new_state, metrics = system.train_step(state, batch, prng.key(11))
    assert new_state.step == 1 and state.step == 0
    assert set(metrics) == set(jmetrics) == {"train/loss", "train/loss/reg", "train/psnr0",
                                             "train/psnr1"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    # the first Adam step is lr * sign(g); rows the step did not index stay
    lr = system.lr_schedule(0)
    want_params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, row in TABLES.items():
        delta = new_state.params[name] - state.params[name]
        others = torch.arange(len(delta)) != row
        assert torch.equal(new_state.params[name][others], state.params[name][others]), name
        assert 0 < delta[row].abs().max().item() <= lr * 1.01, name
        np.testing.assert_array_equal(new_state.params[name][others].numpy(),
                                      want_params[name][others].numpy())
        big = want[name][row].abs() > 0.5 * want[name][row].abs().max()
        np.testing.assert_allclose(new_state.params[name][row][big].numpy(),
                                   want_params[name][row][big].numpy(), atol=0.02 * lr)


def _fused_draws(key, B):
    k0, k2 = jax.random.split(key)  # the fused steps' own split
    return {"t_rand": _t(jax.random.uniform(k0, (B, N_C + 1), dtype=jnp.float32)),
            "u": _t(jax_sorted_uniform(k2, (B, N_F)))}


def _assert_fused_step_close(loss, aux, grads, want_loss, want_aux, want_grads):
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=5e-3)
    for k in ("loss0", "loss1"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=5e-3)
    np.testing.assert_allclose(aux["reg"].item(), float(want_aux["reg"]), rtol=1e-6)
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    cos, _ = _cos(grads, want, _names(want, "model.coarse_mlp."))
    assert cos >= 0.9, cos
    cos, ratio = _cos(grads, want, _names(want, "model.fine_mlp."))
    assert cos >= 0.6 and 0.6 <= ratio <= 1.6, (cos, ratio)
    cos, _ = _cos(grads, want, list(TABLES))
    assert cos >= 0.8, cos
    _assert_unindexed_rows_zero(grads)


@pytest.mark.parametrize("loss_w", [False, True], ids=["uniform", "loss_w"])
def test_fused_v3_step_matches_jax_in_interpret_mode(rng, jax_system, loss_w):
    _, params_np = jax_system
    B = 16
    batch = _batch(rng, B, loss_w)
    key = jax.random.PRNGKey(13)
    jlib = FlaxCodeLibrary(n_max_objs=SMALL["N_max_objs"])
    want = jax_v3_step_fn(jlib.apply, 2.0, 6.0, False, N_C, N_F)(
        jax.tree.map(jnp.asarray, params_np), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    fn = make_fused_autodecoder_step_fn(system.code_library, 2.0, 6.0, False, N_C, N_F)
    assert fn.returns_grads
    got = fn(params_from_flax(params_np), {k: _t(v) for k, v in batch.items()}, None,
             _fused_draws(key, B))
    _assert_fused_step_close(*got, *want)


def test_fused_v2_loss_matches_jax_in_interpret_mode(rng, jax_system):
    _, params_np = jax_system
    B = 16
    batch = _batch(rng, B, loss_w=True)
    key = jax.random.PRNGKey(17)
    jlib = FlaxCodeLibrary(n_max_objs=SMALL["N_max_objs"])
    jloss_fn = jax_v2_loss_fn(jlib.apply, 2.0, 6.0, False, N_C, N_F, tile=64)
    (want_loss, want_aux), want_grads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    loss_fn = make_fused_autodecoder_loss_fn(system.code_library, 2.0, 6.0, False, N_C, N_F)
    assert not getattr(loss_fn, "returns_grads", False)
    got = accumulated_grads(loss_fn, params_from_flax(params_np),
                            {k: _t(v) for k, v in batch.items()}, None, _fused_draws(key, B))
    _assert_fused_step_close(*got, want_loss, want_aux, want_grads)


def test_fused_routes_agree_with_each_other(rng, jax_system):
    _, params_np = jax_system
    B = 16
    params = params_from_flax(params_np)
    tbatch = {k: _t(v) for k, v in _batch(rng, B, loss_w=True).items()}
    g = torch.Generator().manual_seed(0)
    draws = {"t_rand": torch.rand(B, N_C + 1, generator=g),
             "u": torch.sort(torch.rand(B, N_F, generator=g), dim=-1).values}
    lib = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu").code_library
    v3 = accumulated_grads(make_fused_autodecoder_step_fn(lib, 2.0, 6.0, False, N_C, N_F),
                           params, tbatch, None, draws)
    v2 = accumulated_grads(make_fused_autodecoder_loss_fn(lib, 2.0, 6.0, False, N_C, N_F),
                           params, tbatch, None, draws)
    np.testing.assert_allclose(v3[0].item(), v2[0].item(), rtol=1e-5)
    assert _errors(v3[2], v2[2], list(v2[2]))[0] <= 5e-2


@pytest.mark.parametrize("returns_grads", [False, True], ids=["plain", "returns_grads"])
def test_art_smoothness_in_both_conventions(rng, jax_system, returns_grads):
    """The wrapped loss against the JAX wrapper around a stub of the same
    convention: value, ``reg`` and the term's gradient on the table."""
    _, params_np = jax_system
    weight = 0.05
    params = params_from_flax(params_np)
    table = jnp.asarray(params_np["code_library"]["embedding_instance_articulation"]["embedding"])
    zero = {k: torch.zeros_like(v) for k, v in params.items()}

    if returns_grads:
        def jstub(p, batch, key):
            return jnp.float32(1.0), {"reg": jnp.float32(0.25)}, jax.tree.map(jnp.zeros_like, p)

        def stub(p, batch, key=None, draws=None):
            return torch.tensor(1.0), {"reg": torch.tensor(0.25)}, dict(zero)

        jstub.returns_grads = stub.returns_grads = True
        jloss, jaux, jgrads = jax_with_smoothness(jstub, weight)(
            jax.tree.map(jnp.asarray, params_np), None, None)
        loss, aux, grads = _with_art_smoothness(stub, weight)(params, None)
        want_grad = np.asarray(jgrads["code_library"]["embedding_instance_articulation"]
                               ["embedding"])
        np.testing.assert_allclose(grads[ART_TABLE].numpy(), want_grad, rtol=1e-5, atol=1e-7)
        assert all(not grads[k].any() for k in grads if k != ART_TABLE)
    else:
        def jstub(p, batch, key):
            return jnp.float32(1.0), {"reg": jnp.float32(0.25)}

        def stub(p, batch, key=None, draws=None):
            return 1.0 + 0.0 * sum(v.sum() for v in p.values()), {"reg": torch.tensor(0.25)}

        jloss, jaux = jax_with_smoothness(jstub, weight)(
            jax.tree.map(jnp.asarray, params_np), None, None)
        wrapped = _with_art_smoothness(stub, weight)
        assert not getattr(wrapped, "returns_grads", False)
        loss, aux, grads = accumulated_grads(
            wrapped, params, {"rays_o": torch.zeros(2, 3)}, None, None)
        d = table[1:] - table[:-1]
        want_grad = np.asarray(jax.grad(lambda t: weight * jnp.sum((t[1:] - t[:-1]) ** 2))(table))
        np.testing.assert_allclose(grads[ART_TABLE].numpy(), want_grad, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(loss), 1.0 + weight * float(jnp.sum(d * d)), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(aux["reg"]), float(jaux["reg"]), rtol=1e-6)


def test_system_with_smoothness_trains_every_articulation_row(rng):
    system = build_system(Config(**SMALL, art_code_smoothness=0.01), 2.0, 6.0, False,
                          device="cpu")
    state = system.init_state(prng.key(0))
    new_state, metrics = system.train_step(state, _batch(rng, 16), prng.key(1))
    moved = (new_state.params[ART_TABLE] - state.params[ART_TABLE]).abs().sum(dim=1)
    assert (moved > 0).all()  # the term couples neighbouring codes
    assert metrics["train/loss/reg"].item() > 1e-3  # the latent norms alone give ~4e-5


@pytest.mark.parametrize("route", ["plain", "v3"])
@pytest.mark.parametrize("k", [1, 2])
def test_stacked_microbatches_carry_the_ids(rng, route, k):
    B = 16
    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    # seeded weights (models/init.py::seeded_params): the v3 twin rounds to bf16, and
    # where a pre-activation lies within float32 summation noise of a bf16 step,
    # k microbatches and one part by a percent; these weights have none
    params = seeded_params(system, torch.Generator().manual_seed(1))
    fn = (system.loss_fn if route == "plain" else
          make_fused_autodecoder_step_fn(system.code_library, 2.0, 6.0, False, N_C, N_F))
    batch = {n: _t(v) for n, v in _batch(rng, B, loss_w=True).items()}
    g = torch.Generator().manual_seed(2)
    draws = {"t_rand": torch.rand(B, N_C + 1, generator=g),
             "u": torch.sort(torch.rand(B, N_F, generator=g), dim=-1).values}
    loss, aux, grads = accumulated_grads(fn, params, batch, None, draws)

    def stack(tree):  # ray entries (k, m, ...); the ids stay one per step
        return {n: (v.reshape(k, B // k, *v.shape[1:]) if v.ndim else v) for n, v in tree.items()}

    loss_k, aux_k, grads_k = accumulated_grads(fn, params, stack(batch), None, stack(draws))
    # loss_w is mean 1 over the whole batch, not per microbatch: the mean of
    # the microbatch means is still the whole-batch weighted mean
    np.testing.assert_allclose(loss_k.item(), loss.item(), rtol=1e-6)
    np.testing.assert_allclose(aux_k["reg"].item(), aux["reg"].item(), rtol=1e-6)
    assert _errors(grads_k, grads, list(grads))[0] <= 2e-4
    _assert_unindexed_rows_zero(grads_k)


def test_train_many_cycles_the_ids_per_step(rng):
    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    state0 = system.init_state(prng.key(0))
    T, k, m = 2, 2, 8
    batches = [_batch(rng, k * m) for _ in range(T)]
    superbatch = {n: _t(np.stack([b[n] for b in batches])) for n in batches[0]}
    superbatch = {n: (v.reshape(T, k, m, *v.shape[2:]) if v.ndim > 1 else v)
                  for n, v in superbatch.items()}
    superbatch["instance_id"] = torch.tensor([0, 3])
    superbatch["articulation_id"] = torch.tensor([1, 7])
    state, metrics = system.train_many(state0, superbatch, prng.key(5))
    assert state.step == T and torch.isfinite(metrics["train/loss_last"])
    assert set(metrics) == {"train/loss", "train/loss/reg", "train/psnr0", "train/psnr1",
                            "train/loss_last"}
    moved = {n: ((state.params[n] - state0.params[n]).abs().sum(dim=1) > 0).nonzero().flatten()
             for n in TABLES}
    assert moved["code_library.embedding_instance_shape.weight"].tolist() == [0, 3]
    assert moved[ART_TABLE].tolist() == [1, 7]


@pytest.mark.parametrize("is_test,art_id", [(False, 5), (True, 11)])
def test_render_chunk_matches_jax(rng, jax_system, is_test, art_id):
    jsys, params_np = jax_system
    rays = {k: v for k, v in _batch(rng, 24).items() if k in ("rays_o", "rays_d", "viewdirs")}
    # a denser field than a fresh init gives, so that acc is not ~0
    params_np = jax.tree.map(lambda x: x, params_np)
    for level in ("coarse_mlp", "fine_mlp"):
        params_np["model"][level]["density"]["bias"] = (
            params_np["model"][level]["density"]["bias"] + 2.0)
    want = jsys.render_chunk(jax.tree.map(jnp.asarray, params_np),
                             {k: jnp.asarray(v) for k, v in rays.items()},
                             jnp.asarray(INSTANCE), jnp.asarray(art_id), is_test=is_test)
    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    params = params_from_flax(params_np)
    got = system.render_chunk(params, rays, INSTANCE, art_id, is_test=is_test)
    assert set(got) == set(want) == {"comp_rgb", "acc", "depth"}
    assert float(want["acc"].max()) > 0.2
    for k, tol in (("comp_rgb", 2e-3), ("acc", 2e-3), ("depth", 2e-2)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, err_msg=k)

    # the fused renderer on the CPU runs the kernels' twins
    fused = make_fused_art_render_fn(system.code_library, 2.0, 6.0, False, N_C, N_F)
    out = fused(params, {k: _t(v) for k, v in rays.items()}, INSTANCE, art_id, is_test=is_test)
    for k, tol in (("comp_rgb", 3e-2), ("acc", 3e-2), ("depth", 2.5e-1)):
        np.testing.assert_allclose(out[k].numpy(), got[k].numpy(), atol=tol, err_msg=k)

    # render_frame hands the ids and is_test through to every chunk
    frame = render_frame(lambda r, **ex: system.render_chunk(params, r, **ex), rays, chunk=16,
                         device="cpu", instance_id=INSTANCE, articulation_id=art_id,
                         is_test=is_test)
    np.testing.assert_allclose(frame["comp_rgb"], got["comp_rgb"].numpy(), atol=1e-6)


def test_build_system_routes_and_devices():
    cfg = Config(**SMALL)
    assert isinstance(build_system(cfg, 2.0, 6.0, False, device="cpu"), AutoDecoderSystem)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the default device is the card
            build_system(cfg, 2.0, 6.0, False)
    ae = build_system(Config(exp_type="vanilla_ae_art"), 2.0, 6.0, False, device="cpu")
    assert type(ae).__name__ == "AutoEncoderSystem" and ae.loss_fn == ae._loss_fn
    # off the card the system takes the plain route whatever use_pallas says
    system = build_system(Config(**dict(SMALL, use_pallas=True)), 2.0, 6.0, False, device="cpu")
    assert system._fused is None and system.loss_fn == system._plain_loss_fn
    # the widths of the published configuration
    full = build_system(Config(exp_type="vanilla_autodecoder", N_max_objs=8), 2.0, 6.0, False,
                        device="cpu")
    shapes = {k: tuple(v.shape) for k, v in full.init_params(prng.key(0))
              .items()}
    assert shapes["code_library.embedding_instance_shape.weight"] == (8, 128)
    assert shapes["model.coarse_mlp.deform_0.weight"] == (128, 163)
    assert shapes["model.fine_mlp.pts_5.weight"] == (256, 256 + 63 + 128)
    assert shapes["model.fine_mlp.views_3.weight"] == (128, 128)
