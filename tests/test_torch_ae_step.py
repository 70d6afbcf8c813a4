"""Port parity, the auto-encoder's training step: the plain loss of
aon_tpu_torch's ``AutoEncoderSystem`` against one ``train_step`` of the JAX
system from the same converted state, batch and injected draws; the fused v3
step (``make_fused_ae_step_fn``) on the CPU (the level kernel's twin) against
the JAX one in interpret mode; the v2 route against the v3 one; the
whole-batch denominators under k = 2 microbatches with unequal mask counts;
and ``render_chunk``'s fused route against its plain one.  The plain step
with the reference's relu sigma and the background MSE on
(``bg_loss_lambda``) at a ``bg_scale`` ramp; the fused step with the
quality config's ``softplus_bias`` (the plain one's is held against the
JAX trainer's step in tests/test_torch_trainer_ae.py; the level kernel's
twin with relu sigma against the Pallas kernel in
tests/test_torch_art_kernels.py); v3 against v2 with both.

Tolerances, and why (tests/test_torch_art_step.py explains the articulated
MLP's):
  * the plain float32 route against the JAX ``train_step`` with
    ``use_pallas=False``, gradients read back from its first Adam moment
    (mu = 0.1 g): loss and the opacity term 1e-4 relative, ``loss_state``
    1e-5, the PSNRs 1e-2 dB.  The two encoders' float32 latents differ by ~2e-5 of their scale
    (convolutions summed in another order), and the shape and degree codes
    feed the deformation field, whose output the encoding's top frequency
    (2^9) turns into phase: the gradients of the deformation and of the
    trunk behind it agree by direction, those of the heads (density, rgb,
    bottleneck, view branch) per entry.  Coarse heads 1e-2 of each tensor's
    largest and 5e-3 of its mean magnitude (seen 3.0e-3, 1.5e-3); each
    level's gradients cosine >= 0.99 and norm ratio 0.95..1.05 (seen 0.9956,
    0.975..1.018); the encoder's and the degree table's cosine >= 0.99 (seen
    0.9986); the joint-state head's 1e-4 per entry (seen 2e-5);
  * the fused v3 step against the JAX one in interpret mode, on a field
    made denser (density bias + 2: at a fresh init the relu field sits on
    its kink, and the two bf16 routes then lie as far from each other as
    each from float32): loss and its terms 5e-3 relative (seen 2.1e-3); the
    trunk and heads of each level by direction and size (cosine >= 0.98,
    norm ratio 0.9..1.1; seen 0.9947, 0.979..1.014); the deformation's, which
    carry the bf16 phase noise tests/test_torch_art_kernels.py describes, by
    direction only (cosine >= 0.4; seen 0.55..0.998), and so the degree
    table's, which reaches the NeRF through the deformation alone (cosine >=
    0.4; seen 0.68..0.997 over seeds and thread counts); the encoder's
    cosine >= 0.999 (seen 0.9997), the joint-state head's 0.9999;
  * v3 against v2 in the port on the same draws: loss and its terms 1e-5
    relative; the coarse level's gradients 1e-3 of each tensor's largest
    magnitude (the same MLP twin on both sides; the compositing backward is
    written out on one and autograd's on the other); the fine level's by
    direction (cosine >= 0.99; seen 0.998), since its samples come from the
    coarse weights of each route and move in their last bits; the encoder
    side's cosine >= 0.999 (seen 0.9999);
  * k = 2 against k = 1: loss 1e-6 relative, gradients 2e-4 of each tensor's
    largest magnitude (the same float32 work summed per microbatch); the
    whole-batch denominators themselves: exact;
  * ``render_chunk``'s fused route on the CPU (the kernels' twins) against
    its float32 route: 3e-2 / 3e-2 / 2.5e-1 for comp_rgb / acc / depth, the
    limits chip_smoke.py holds the vanilla path to; pred_state the same
    (against JAX: tests/test_torch_trainer_ae.py).
"""

import importlib
import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax.training.train_state import TrainState as FlaxTrainState  # noqa: E402

from aon_tpu.ops.resample_pallas import sorted_uniform as jax_sorted_uniform  # noqa: E402
from aon_tpu.train.system_ae import AutoEncoderSystem as JaxAutoEncoderSystem  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.models.init import seeded_params  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax, tree_to_flax  # noqa: E402
from aon_tpu_torch.ops.train_fused_level_art import (  # noqa: E402
    ae_prepare_shared,
    make_fused_ae_step_fn,
)
from aon_tpu_torch.train.microbatch import accumulated_grads  # noqa: E402
from aon_tpu_torch.train.system_ae import OPACITY_LAMBDA, AutoEncoderSystem  # noqa: E402
from aon_tpu_torch.train.systems import TrainState, build_system  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402

jax_fused_art = importlib.import_module("aon_tpu.ops.train_fused_level_art")
WH = (64, 48)
N_C, N_F = 8, 8
SMALL = dict(exp_type="vanilla_ae_art", N_samples=N_C, N_importance=N_F, img_wh=list(WH),
             white_back=False, compute_dtype="float32", use_pallas=False)
# the reference's sigma with the background MSE on, and the quality config's
MODES = {"relu_bg": dict(ae_sigma_activation="relu", bg_loss_lambda=0.5),
         "softplus": dict(ae_sigma_activation="softplus_bias")}
BG_SCALE = 0.25
ENC = ("encoder.", "joint_state.", "deg_embedding.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the suite runs these files beside
    others in parallel workers, where OpenMP threads of every worker
    oversubscribe the cores, and these small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def params():
    """Seeded params (``models/init.py::seeded_params``, a generator of seed
    0) and their flax tree: one converted state for both packages."""
    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    p = seeded_params(system, torch.Generator().manual_seed(0))
    return p, tree_to_flax(p)


_SYSTEMS = {}


def _mode(name):
    """(name, the port's CPU system, the JAX system) of a ``MODES`` entry,
    built once."""
    if name not in _SYSTEMS:
        system = build_system(Config(**SMALL, **MODES[name]), 2.0, 6.0, False, device="cpu")
        assert isinstance(system, AutoEncoderSystem) and system.loss_fn == system._loss_fn
        _SYSTEMS[name] = (name, system,
                          JaxAutoEncoderSystem(JaxConfig(**SMALL, **MODES[name]), 2.0, 6.0, False))
    return _SYSTEMS[name]


def _batch(rng, B, mask=None, flat_mask=False):
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if mask is None:
        mask = (rng.uniform(size=B) > 0.5).astype(np.float32)
    return {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d.copy(),
            "target": rng.uniform(size=(B, 3)).astype(np.float32),
            "instance_mask": mask if flat_mask else mask[:, None],
            "src_imgs": rng.normal(size=(3, WH[1], WH[0])).astype(np.float32),
            "deg": np.float32(np.deg2rad(40.0)), "bg_scale": np.float32(BG_SCALE)}


def _errors(got, want, names):
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
                  for k in names)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(1e-30)).item()
                   for k in names)
    return max_rel, mean_rel


def _cos(got, want, names):
    a = torch.cat([got[k].reshape(-1).double() for k in names])
    b = torch.cat([want[k].reshape(-1).double() for k in names])
    return (a @ b / (a.norm() * b.norm())).item(), (a.norm() / b.norm()).item()


def _names(tree, prefix):
    return [k for k in tree if k.startswith(prefix)]


def test_train_step_matches_jax_ae_system(rng, params):
    name, system, jsys = _mode("relu_bg")
    p, tree = params
    B = 32
    batch = _batch(rng, B)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 4)  # ArticulatedNeRF.__call__: one key per level and purpose
    draws = {"t_rand": _t(jax.random.uniform(keys[0], (B, N_C + 1), dtype=jnp.float32)),
             "u": _t(jax.random.uniform(keys[2], (B, N_F), dtype=jnp.float32))}

    jstate = FlaxTrainState.create(apply_fn=jsys.model.apply,
                                   params=jax.tree.map(jnp.asarray, tree), tx=jsys.tx)
    jstate, jmetrics = jsys.train_step(jstate.replace(step=jnp.asarray(0, jnp.int32)),
                                       {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state[0].mu)).items()}

    tbatch = {k: _t(v) for k, v in batch.items()}
    loss, aux, grads = accumulated_grads(system.loss_fn, p, tbatch, None, draws)
    np.testing.assert_allclose(loss.item(), float(jmetrics["train/loss"]), rtol=1e-4)
    np.testing.assert_allclose(aux["loss_state"].item(), float(jmetrics["train/loss_state"]),
                               rtol=1e-5)
    np.testing.assert_allclose(aux["opacity_loss"].item(),
                               float(jmetrics["train/opacity_loss"]), rtol=1e-4)
    assert set(want) == set(grads) == set(p)
    heads = [k for k in _names(want, "model.coarse_mlp.")
             if k.split(".")[2].split("_")[0] in ("density", "rgb", "bottleneck", "views")]
    err = _errors(grads, want, heads)
    assert err[0] <= 1e-2 and err[1] <= 5e-3, err
    for prefix in ("model.coarse_mlp.", "model.fine_mlp."):
        cos, ratio = _cos(grads, want, _names(want, prefix))
        assert cos >= 0.99 and 0.95 <= ratio <= 1.05, (prefix, cos, ratio)
    for prefix in ("encoder.", "deg_embedding."):
        assert _cos(grads, want, _names(want, prefix))[0] >= 0.99, prefix
    err = _errors(grads, want, _names(want, "joint_state."))
    assert err[0] <= 1e-4, err
    # the degree table: only the batch's row (40 degrees) has a gradient
    rows = grads["deg_embedding.deg_embedding.weight"].abs().sum(dim=1)
    assert rows.nonzero().flatten().tolist() == [40]

    mu, nu = system.tx.init(p)
    _, metrics = system.train_step(TrainState(step=0, params=p, mu=mu, nu=nu, tx=system.tx),
                                   batch, None, draws)
    assert set(metrics) == set(jmetrics) == {"train/loss", "train/loss_state",
                                             "train/opacity_loss", "train/psnr0", "train/psnr1"}
    for k in metrics:  # the PSNRs in dB: the masked MSEs agree to ~2e-4 relative
        tol = dict(atol=1e-2) if "psnr" in k else dict(rtol=1e-4)
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), err_msg=k, **tol)
    if MODES[name].get("bg_loss_lambda"):  # the background term is live, scaled by bg_scale
        off = accumulated_grads(system.loss_fn, p, dict(tbatch, bg_scale=torch.tensor(0.0)),
                                None, draws)[1]
        assert off["loss0"].item() < aux["loss0"].item() - 1e-4


def _fused_draws(key, B):
    k0, k2 = jax.random.split(key)  # the fused steps' own split
    return {"t_rand": _t(jax.random.uniform(k0, (B, N_C + 1), dtype=jnp.float32)),
            "u": _t(jax_sorted_uniform(k2, (B, N_F)))}


def _fused_fns(system, jsys):
    kw = dict(num_coarse=N_C, num_fine=N_F, bg_lambda=float(system.cfg.bg_loss_lambda),
              sigma_act=system.sigma_act, density_bias=system.density_bias)
    return (make_fused_ae_step_fn(system._encode, 2.0, 6.0, False, **kw),
            jax_fused_art.make_fused_ae_step_fn(jsys._encode, 2.0, 6.0, False, **kw))


def _denser(p):
    """``p`` with each level's density bias raised by 2, so that acc is not
    ~0 and relu sigma is off its kink."""
    out = dict(p)
    for level in ("coarse_mlp", "fine_mlp"):
        out[f"model.{level}.density.bias"] = p[f"model.{level}.density.bias"] + 2.0
    return out


def test_fused_v3_step_matches_jax_in_interpret_mode(rng, params):
    _, system, jsys = _mode("softplus")
    p = _denser(params[0])
    tree = tree_to_flax(p)
    B = 16
    batch = _batch(rng, B, flat_mask=True)
    key = jax.random.PRNGKey(13)
    fn, jfn = _fused_fns(system, jsys)
    assert fn.returns_grads and fn.prepare_shared is ae_prepare_shared
    want_loss, want_aux, want_grads = jax.jit(jfn)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    loss, aux, grads = fn(p, {k: _t(v) for k, v in batch.items()}, None, _fused_draws(key, B))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=5e-3)
    for k in ("loss0", "loss1", "opacity_loss"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=5e-3, err_msg=k)
    np.testing.assert_allclose(aux["loss_state"].item(), float(want_aux["loss_state"]),
                               rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want) == set(p)
    for prefix in ("model.coarse_mlp.", "model.fine_mlp."):
        names = _names(want, prefix)
        cos, ratio = _cos(grads, want, [k for k in names if ".deform_" not in k])
        assert cos >= 0.98 and 0.9 <= ratio <= 1.1, (prefix, cos, ratio)
        cos, _ = _cos(grads, want, [k for k in names if ".deform_" in k])
        assert cos >= 0.4, (prefix, cos)
    # the degree table reaches the NeRF through deform_0's bias alone: the
    # deformation's bound
    for prefix, limit in (("encoder.", 0.999), ("joint_state.", 0.9999), ("deg_embedding.", 0.4)):
        cos, _ = _cos(grads, want, _names(want, prefix))
        assert cos >= limit, (prefix, cos)
    assert aux["opacity_loss"].item() > 0


def test_bf16_config_runs_the_encoder_in_float32_and_matches_jax(rng, params):
    """With ``compute_dtype="bfloat16"`` the encoder still runs in float32
    (the port's bf16 cuDNN encoder held the opacity BCE on its plateau ~4,000
    steps longer than JAX's on a TPU; ROADMAP.md).  Its fused step is held
    against the JAX system's float32-encoder step at the tolerances of
    ``test_fused_v3_step_matches_jax_in_interpret_mode``."""
    _, f32_system, jsys = _mode("softplus")
    system = build_system(Config(**dict(SMALL, compute_dtype="bfloat16"), **MODES["softplus"]),
                          2.0, 6.0, False, device="cpu")
    assert system.model.coarse_mlp.dtype == torch.bfloat16
    assert system.encoder.dtype == torch.float32
    p = _denser(params[0])
    src = _t(_batch(rng, 1)["src_imgs"])[None]
    lat, pred = system._encode(p, src, 0.5)
    want_lat, want_pred = f32_system._encode(p, src, 0.5)
    assert all(v.dtype == torch.float32 for v in lat.values())
    for k in want_lat:
        assert torch.equal(lat[k], want_lat[k]), k
    B = 16
    batch = _batch(rng, B, flat_mask=True)
    key = jax.random.PRNGKey(13)
    fn, jfn = _fused_fns(system, jsys)
    want_loss, want_aux, want_grads = jax.jit(jfn)(
        jax.tree.map(jnp.asarray, tree_to_flax(p)), {k: jnp.asarray(v) for k, v in batch.items()},
        key)
    loss, aux, grads = fn(p, {k: _t(v) for k, v in batch.items()}, None, _fused_draws(key, B))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=5e-3)
    for k in ("loss0", "loss1", "opacity_loss"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=5e-3, err_msg=k)
    np.testing.assert_allclose(aux["loss_state"].item(), float(want_aux["loss_state"]),
                               rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))
    for prefix in ("model.coarse_mlp.", "model.fine_mlp."):
        names = _names(want, prefix)
        cos, ratio = _cos(grads, want, [k for k in names if ".deform_" not in k])
        assert cos >= 0.98 and 0.9 <= ratio <= 1.1, (prefix, cos, ratio)
        assert _cos(grads, want, [k for k in names if ".deform_" in k])[0] >= 0.4, prefix
    for prefix, limit in (("encoder.", 0.999), ("joint_state.", 0.9999), ("deg_embedding.", 0.4)):
        cos, _ = _cos(grads, want, _names(want, prefix))
        assert cos >= limit, (prefix, cos)


@pytest.mark.parametrize("name", list(MODES))
def test_fused_routes_agree_with_each_other(rng, params, name):
    _, system, _ = _mode(name)
    p, _ = params
    B = 16
    tbatch = {k: _t(v) for k, v in _batch(rng, B).items()}
    g = torch.Generator().manual_seed(0)
    draws = {"t_rand": torch.rand(B, N_C + 1, generator=g),
             "u": torch.sort(torch.rand(B, N_F, generator=g), dim=-1).values}
    v3 = accumulated_grads(_fused_fns(system, system)[0], p, tbatch, None, draws)
    system._fused = True  # the v2 route: the two MLP kernels' twins under autograd
    try:
        v2 = accumulated_grads(system.loss_fn, p, tbatch, None, draws)
    finally:
        system._fused = False
    np.testing.assert_allclose(v3[0].item(), v2[0].item(), rtol=1e-5)
    for k in v3[1]:
        np.testing.assert_allclose(v3[1][k].item(), v2[1][k].item(), rtol=1e-5, err_msg=k)
    assert _errors(v3[2], v2[2], _names(v2[2], "model.coarse_mlp."))[0] <= 1e-3
    assert _cos(v3[2], v2[2], _names(v2[2], "model.fine_mlp."))[0] >= 0.99
    for prefix in ENC:
        assert _cos(v3[2], v2[2], _names(v2[2], prefix))[0] >= 0.999, prefix


@pytest.mark.parametrize("route", ["plain", "v3"])
def test_k2_matches_k1_with_unequal_mask_counts(rng, params, route):
    """12 of the first microbatch's 16 rays are object rays, 2 of the
    second's: the whole-batch denominators make k = 2 the k = 1 objective,
    per-microbatch ones would not."""
    p, _ = params
    system = _mode("relu_bg")[1]
    fn = system.loss_fn if route == "plain" else _fused_fns(system, system)[0]
    B = 32
    mask = np.zeros(B, np.float32)
    mask[:12] = 1.0
    mask[16:18] = 1.0
    batch = {k: _t(v) for k, v in _batch(rng, B, mask=mask).items()}
    # dark targets in the first microbatch, bright ones in the second: the
    # per-microbatch means then weigh the second's two object rays as much
    # as the first's twelve
    batch["target"] = torch.cat([torch.full((B // 2, 3), 0.05), torch.full((B // 2, 3), 0.95)])
    g = torch.Generator().manual_seed(2)
    draws = {"t_rand": torch.rand(B, N_C + 1, generator=g),
             "u": torch.sort(torch.rand(B, N_F, generator=g), dim=-1).values}
    loss, aux, grads = accumulated_grads(fn, p, batch, None, draws)

    def stack(tree):  # ray entries (2, 16, ...); the shared ones stay
        return {n: (v.reshape(2, B // 2, *v.shape[1:]) if v.ndim and v.shape[0] == B else v)
                for n, v in tree.items()}

    sb, sd = stack(batch), stack(draws)
    loss_k, aux_k, grads_k = accumulated_grads(fn, p, sb, None, sd)
    np.testing.assert_allclose(loss_k.item(), loss.item(), rtol=1e-6)
    for k in aux:
        np.testing.assert_allclose(aux_k[k].item(), aux[k].item(), rtol=1e-6, err_msg=k)
    assert _errors(grads_k, grads, list(grads))[0] <= 2e-4

    # the JAX hook's denominators, bit for bit
    jprep = jax_fused_art.make_fused_ae_step_fn(None, 2.0, 6.0, False).prepare_shared
    want = jprep({k: jnp.asarray(v.numpy()) for k, v in sb.items() if k != "src_imgs"})
    got = ae_prepare_shared(sb)
    assert set(got) == set(want) == {"photo_denom", "photo_denom_bg"}
    for k in got:
        assert got[k].item() == float(want[k]), k

    # without the hook each microbatch normalises by its own mask counts, and
    # k = 2 leaves the k = 1 objective by a thousand times the tolerance above
    def per_microbatch(*a):
        return fn(*a)

    per_microbatch.returns_grads = getattr(fn, "returns_grads", False)
    aux_own = accumulated_grads(per_microbatch, p, sb, None, sd)[1]
    for k in ("loss0", "loss1"):  # seen 2.4% to 12.5% apart
        assert abs(aux_own[k].item() - aux[k].item()) > 1e-3 * aux[k].item(), k


def test_render_chunk_routes_agree(rng, params):
    p, _ = params
    system = _mode("softplus")[1]
    batch = _batch(rng, 24)
    rays = {k: batch[k] for k in ("rays_o", "rays_d", "viewdirs")}
    dense = _denser(p)
    src = batch["src_imgs"][None]
    got = system.render_chunk(dense, rays, src, batch["deg"])
    assert set(got) == {"comp_rgb", "acc", "depth", "pred_state"}
    assert float(got["acc"].max()) > 0.2
    assert got["pred_state"].shape == (24,) and torch.unique(got["pred_state"]).numel() == 1
    _, pred_state = system._encode(dense, src, batch["deg"])
    assert got["pred_state"][0].item() == pred_state.item()

    # the fused route on the CPU runs the kernels' twins
    system._fused = True
    try:
        out = system.render_chunk(dense, rays, src, batch["deg"])
    finally:
        system._fused = False
    for k, tol in (("comp_rgb", 3e-2), ("acc", 3e-2), ("depth", 2.5e-1)):
        np.testing.assert_allclose(out[k].numpy(), got[k].numpy(), atol=tol, err_msg=k)
    np.testing.assert_array_equal(out["pred_state"].numpy(), got["pred_state"].numpy())
    assert OPACITY_LAMBDA == 0.5
