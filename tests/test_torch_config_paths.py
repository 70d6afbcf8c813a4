"""Port parity, what only the scissors, laptop4 and raw / AABB vanilla
quality configs use, against the JAX package on its own fixtures (CPU,
float32 plain routes on both sides):

  (a) ``obj_ray_oversample`` 0.5 on a fixture copy where one frame's seg mask
      is all zero: the loader's degrade-to-uniform branch
      (``aon_tpu/data/sapien_multi.py:307``), which thin blades could reach
      (the real scissors split never does: 265-2,883 object pixels a train
      frame).  The train items at atol 0, ``loss_w`` present or absent by
      item; one fit step over the degraded item; a dispatch of two fit steps
      over items with and without ``loss_w`` (the stack takes the first
      item's entries, in both packages), and the other order, which neither
      package can stack;
  (b) one fit step with ``art_code_smoothness`` 0.001 and
      ``obj_ray_oversample`` 0.5 on raw intervals, 8 + 16 samples (the 64 +
      128 configs' shape at a small size);
  (c) every config these runs use resolves to the same fields in both
      packages' loaders;
  (d) ``quality_laptop_ae.json``: both Trainers stop it at the same step,
      24,000 = min(16 x 1,500, 100,000), under one lr schedule on its
      100,000-step horizon (the port's lr at 24,000 is JAX's logged one);
      one auto-encoder fit step with its settings at narrow widths (relu
      sigma, raw intervals, 8 + 16 samples: its 1 : 2 ratio), held at
      ``tests/test_torch_trainer_ae.py::test_fit_one_step_matches_jax``'s
      tolerances, then one validation from the converted state at that
      file's validate tolerances;
  (e) one vanilla fit step at the occ8 config's 8 + 16 samples on occupancy
      intervals, held at ``tests/test_torch_trainer.py::
      test_fit_one_step_matches_jax``'s tolerances;
  (f) ``quality_run``'s curves of the object PSNR and the joint-state error.

The fit steps start from one init (the port's Trainer draws the JAX
trainer's init, checked bit for bit) with the JAX trainer's draws, and are
held at ``tests/test_torch_trainer_multi.py::test_fit_one_step_matches_jax``'s
tolerances: the loss, PSNRs and lr at 1e-4 relative; the gradients, read back
from the first Adam moment (mu = 0.1 g after a step), coarse 5e-2 of each
tensor's largest and 1e-2 of its mean magnitude, fine and code rows 3e-1 and
5e-2 (the fine samples follow the coarse weights' last bits).  Where a
gradient goes through the live deformation's phase noise the port's tests
hold it by direction (``fused_art.DEFORM_COS`` / ``DEFORM_NORM``; cosine
over all tensors after two steps): the degraded step's fine deformation and
the two-step dispatch say why in their docstrings.  No validation runs
(``check_val_every_n_epoch`` past the run): the val path is held in
tests/test_torch_trainer_multi.py.
"""

import dataclasses
import json
import os
import shutil
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax.training.train_state import TrainState as FlaxTrainState  # noqa: E402
from PIL import Image  # noqa: E402

from aon_tpu.data import sapien_multi as jmulti  # noqa: E402
from aon_tpu.parallel import stack_step_batches as jax_stack  # noqa: E402
from aon_tpu.train import system_ae as jsystem_ae  # noqa: E402
from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu.utils.config import get_config as jax_get_config  # noqa: E402
from aon_tpu_torch.data import sapien_multi as tmulti  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax, tree_to_flax  # noqa: E402
from aon_tpu_torch.models.init import seeded_params  # noqa: E402
from aon_tpu_torch.ops import fused_art  # noqa: E402
from aon_tpu_torch.parallel.mesh import RAY_KEYS, stack_step_batches  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.scripts import quality_run  # noqa: E402
from aon_tpu_torch.train import trainer as ttrainer  # noqa: E402
from aon_tpu_torch.train.systems import ART_TABLE, TrainState  # noqa: E402
from aon_tpu_torch.utils.config import Config, get_config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WH = (64, 48)
B = 64
N_FRAMES = 3  # per degree directory
SMALL = dict(dataset_name="sapien_multi", exp_type="vanilla_autodecoder", img_wh=list(WH),
             white_back=False, use_aabb=False, N_samples=4, N_importance=4, N_max_objs=4,
             ray_batch_size=B, microbatch_rays=B, compute_dtype="float32", use_pallas=False,
             chunk=1024, num_epochs=1, steps_per_dispatch=1, log_every_n_steps=1,
             check_val_every_n_epoch=1000, save_top_k=1, exp_name="paths",
             obj_ray_oversample=0.5)
TABLES = ("code_library.embedding_instance_shape.weight",
          "code_library.embedding_instance_appearance.weight", ART_TABLE)
CONFIGS = ("quality_scissors_autodec", "quality_scissors_autodec_objover",
           "quality_scissors_autodec_640eval", "quality_laptop4_autodec",
           "quality_laptop_vanilla_refsched", "quality_laptop_vanilla_refsched_aabb24",
           "quality_scissors_vanilla", "quality_laptop_ae",
           "quality_laptop_vanilla_refsched_aabb", "quality_laptop_vanilla_refsched_aabb16",
           "quality_laptop_vanilla_refsched_occ8")

torch.set_num_threads(1)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_resolves_to_the_jax_fields(name):
    argv = ["--config", str(REPO / "configs" / f"{name}.json")]
    want = dataclasses.asdict(jax_get_config(argv))
    got = dataclasses.asdict(get_config(argv))
    assert got == want


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The port script's ``--multi`` fixture, 2 instances x 10 degrees x 3
    frames at 64x48, and a copy of it in which the frame that the stream of
    seed 0 draws first has an all-zero seg mask."""
    base = tmp_path_factory.mktemp("config_paths")
    root = base / "data"
    tfixture.main([str(root), "--multi", "--n", str(N_FRAMES), "--wh", str(WH[0]), str(WH[1]),
                   "--seed", "4"])
    empty = base / "empty_seg"
    shutil.copytree(root, empty)
    g = np.random.default_rng(0)  # the loaders' first draws: instance, degree, image
    inst = ("obj_a", "obj_b")[int(g.integers(0, 2))]
    deg = int(g.integers(0, 10))
    image_id = int(g.integers(0, 59))
    seg_dir = empty / inst / "train" / f"{10 * deg}_degree" / "seg"
    files = sorted(os.listdir(seg_dir), key=lambda f: int(f.split("_")[1].split(".")[0]))
    seg_path = seg_dir / files[image_id % len(files)]
    seg = np.asarray(Image.open(seg_path))
    assert seg.any()
    Image.fromarray(np.zeros_like(seg)).save(seg_path)
    return root, empty


def _copies(src: Path, base: Path):
    """Each package reads its own copy: both cache under the same names."""
    out = []
    for side in ("jax", "port"):
        shutil.copytree(src, base / side / "data")
        out.append(base / side)
    return out


def test_degraded_frame_items_match_jax(fixture_root, tmp_path):
    _, empty = fixture_root
    jdir, tdir = _copies(empty, tmp_path)
    kw = dict(img_wh=WH, ray_batch_size=B, obj_ray_oversample=0.5, need_src_imgs=False)
    jds = jmulti.SapienDatasetMulti(str(jdir / "data"), "train", **kw)
    tds = tmulti.SapienDatasetMulti(str(tdir / "data"), "train", **kw)
    jit, tit = jds.train_batches(seed=0), tds.train_batches(seed=0)
    with_w = []
    for i in range(8):
        jb, tb = next(jit), next(tit)
        assert set(tb) == set(jb), i
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"item {i} {k}")
        with_w.append("loss_w" in tb)
        if "loss_w" in tb:
            assert tb["loss_w"].dtype == np.float32
            np.testing.assert_allclose(tb["loss_w"].mean(), 1.0, rtol=0.2)
    # the first item's frame has no object pixel: uniform, no weights (the
    # stream draws that frame again at item 5); the others oversample the object
    assert with_w == [False, True, True, True, True, False, True, True], with_w


def _trainers(src: Path, base: Path, **overrides):
    jdir, tdir = _copies(src, base)
    jcfg = JaxConfig(**dict(SMALL, root_dir=str(jdir / "data"),
                            output_path=str(jdir / "results"), **overrides))
    tcfg = Config(**dict(SMALL, root_dir=str(tdir / "data"), output_path=str(tdir / "results"),
                         **overrides))
    jt = jtrainer.Trainer(jcfg)
    tt = ttrainer.Trainer(tcfg, device="cpu")
    want = params_from_flax(jax.tree.map(np.asarray, jt.state.params))
    assert set(tt.state.params) == set(want)
    for k, v in want.items():  # one init, bit for bit
        assert torch.equal(tt.state.params[k], v), k
    return jt, tt


def _records(cfg):
    path = Path(cfg.output_path) / cfg.exp_name / "metrics.jsonl"
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _errors(got, want, names):
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
                  for k in names)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(1e-30)).item()
                   for k in names)
    return max_rel, mean_rel


def _fit_losses_match(jt, tt, n_steps):
    """Both trainers fit ``n_steps``; their logged records agree (the loss,
    the last step's loss, the regulariser, the PSNRs and the lr at 1e-4
    relative).  Returns the port's records."""
    jt.fit()
    tt.fit()
    assert jt.global_step == tt.global_step == tt.state.step == n_steps
    jrec, trec = _records(jt.cfg), _records(tt.cfg)
    assert [(r["step"], sorted(r)) for r in trec] == [(r["step"], sorted(r)) for r in jrec]
    train = [(t, j) for t, j in zip(trec, jrec) if "train/loss" in j]
    assert train
    for t, j in train:
        for k in ("train/loss", "train/loss_last", "train/loss/reg", "train/psnr0",
                  "train/psnr1", "train/lr"):
            if k in j:  # loss_last: a dispatch's last step, logged for several
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    return trec


def _moments(jt, tt):
    """The first Adam moments of both states, times 10 (mu = 0.1 g after one
    step): (port, JAX)."""
    want = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jt.state.opt_state[0].mu)).items()}
    return {k: 10.0 * v for k, v in tt.state.mu.items()}, want


def _fit_step_matches_jax(jt, tt, deform_by_direction=False):
    """One fit step: the records, and the gradients at
    test_fit_one_step_matches_jax's tolerances; with ``deform_by_direction``
    the deformation layers' by direction instead (cosine >= 0.9, norm within
    25%: ``fused_art.DEFORM_COS`` / ``DEFORM_NORM``), as the port holds a live
    deformation wherever it compares gradients per tensor."""
    trec = _fit_losses_match(jt, tt, 1)
    got, want = _moments(jt, tt)
    deform = [k for k in want if ".deform_" in k] if deform_by_direction else []
    names = [k for k in want if k not in deform]
    coarse = _errors(got, want, [k for k in names if k.startswith("model.coarse_mlp.")])
    fine = _errors(got, want, [k for k in names if k.startswith("model.fine_mlp.")])
    codes = _errors(got, want, list(TABLES))
    assert coarse[0] <= 5e-2 and coarse[1] <= 1e-2, coarse
    assert fine[0] <= 3e-1 and fine[1] <= 5e-2, fine
    assert codes[0] <= 3e-1 and codes[1] <= 5e-2, codes
    for k in deform:
        g, w = got[k].reshape(-1), want[k].reshape(-1)
        cos = (g @ w / (g.norm() * w.norm())).item()
        ratio = (g.norm() / w.norm()).item()
        assert cos >= fused_art.DEFORM_COS and abs(ratio - 1.0) <= fused_art.DEFORM_NORM, (
            k, cos, ratio)
    return trec


def test_fit_step_over_the_degraded_item_matches_jax(fixture_root, tmp_path):
    """Seed 0's first item is the zeroed frame's: uniform rays, no ``loss_w``,
    an all-background target.  There the fine deformation's gradients part by
    phase noise (``deform_out.bias`` 5.2e-2 of its mean magnitude, over the
    one-step 5e-2), so they are held by direction."""
    _, empty = fixture_root
    jt, tt = _trainers(empty, tmp_path, samples_per_epoch=1, run_max_steps=1)
    assert "loss_w" not in next(tt._train_iterator())
    _fit_step_matches_jax(jt, tt, deform_by_direction=True)


def test_fit_dispatch_over_items_with_and_without_loss_w_matches_jax(fixture_root, tmp_path):
    """A dispatch of two steps over seed 0's first items, the zeroed frame's
    (no ``loss_w``) and a weighted one: the stack takes the first item's
    entries, so neither step weights its rays, in both packages; in the other
    order the stack finds no ``loss_w`` in the second item, in both packages.

    After two steps the first moments are not held per tensor at the one-step
    tolerances: the first step moves the code rows, whose float32 differences
    the deformation's encoding (2^9 at its top frequency) turns into phase
    noise in the second step's gradients (seen on this fixture, with or
    without ``loss_w``: coarse 6.0e-2 / 2.7e-2, fine 8.3e-2 / 8.3e-2, the
    deformation layers worst).  They are held by direction, as
    tests/test_torch_art_kernels.py holds a live deformation: cosine > 0.98
    over all tensors."""
    _, empty = fixture_root
    jt, tt = _trainers(empty, tmp_path, samples_per_epoch=2, run_max_steps=2,
                       steps_per_dispatch=2)
    it = tt._train_iterator()
    items = [next(it), next(it)]
    assert "loss_w" not in items[0] and "loss_w" in items[1]
    assert "loss_w" not in stack_step_batches(items, B, device="cpu")
    with pytest.raises(KeyError, match="loss_w"):
        stack_step_batches(items[::-1], B, device="cpu")
    with pytest.raises(KeyError, match="loss_w"):
        jax_stack(items[::-1], jt.mesh, microbatch=B)
    _fit_losses_match(jt, tt, 2)
    got, want = _moments(jt, tt)
    g = torch.cat([got[k].reshape(-1) for k in want])
    w = torch.cat([want[k].reshape(-1) for k in want])
    cos = (g @ w / (g.norm() * w.norm())).item()
    assert cos > 0.98, cos


def test_fit_step_with_code_smoothness_and_oversampling_matches_jax(fixture_root, tmp_path):
    root, _ = fixture_root
    jt, tt = _trainers(root, tmp_path, N_samples=8, N_importance=16, samples_per_epoch=1,
                       run_max_steps=1, art_code_smoothness=0.001)
    assert jt.cfg.art_code_smoothness == tt.cfg.art_code_smoothness == 0.001
    batch = next(tt._train_iterator())
    assert "loss_w" in batch and "t_near" not in batch  # oversampled, raw intervals
    start = {k: v.clone() for k, v in tt.state.params.items()}
    trec = _fit_step_matches_jax(jt, tt)
    assert trec[0]["train/loss/reg"] > 0
    # the smoothness term moves every row of the articulation table (each
    # differs from its neighbours at init); the other tables only the step's row
    moved = (tt.state.params[ART_TABLE] - start[ART_TABLE]).abs().sum(dim=1) > 0
    assert bool(moved.all()), moved
    for name in TABLES[:2]:
        moved = (tt.state.params[name] - start[name]).abs().sum(dim=1) > 0
        assert moved.nonzero().flatten().tolist() == [int(batch["instance_id"])], name


# ------------------------------------------------- quality_laptop_ae.json

AE_CONFIG = REPO / "configs" / "quality_laptop_ae.json"
# JAX's logged lr at the run's last step (results/laptop_ae/metrics.jsonl)
JAX_LR_24000 = 1.6556555056013167e-4
AE_PSNR_TOL = 2e-2  # tests/test_torch_trainer_ae.py's PSNR_TOL


def _ae_settings():
    """quality_laptop_ae.json's fields that set its run and its level at
    narrow widths: its step budget and lr horizon, raw intervals, relu sigma
    (the config's default), 8 + 16 samples (its 64 : 128), on 64x48 frames
    of ``B`` rays in float32 on the plain routes."""
    c = json.loads(AE_CONFIG.read_text())
    assert "ae_sigma_activation" not in c and "use_aabb" not in c  # the defaults
    n_c, n_f = 8, 16
    assert c["N_importance"] * n_c == c["N_samples"] * n_f
    return dict(dataset_name="sapien_multi", exp_type="vanilla_ae_art", img_wh=list(WH),
                white_back=c["white_back"], N_samples=n_c, N_importance=n_f,
                samples_per_epoch=c["samples_per_epoch"], num_epochs=c["num_epochs"],
                run_max_steps=c["run_max_steps"], ray_batch_size=B, microbatch_rays=B,
                compute_dtype="float32", use_pallas=False, chunk=1024, steps_per_dispatch=1,
                log_every_n_steps=1, limit_val_batches=2, save_top_k=1, exp_name="ae_raw",
                check_val_every_n_epoch=1000)


@pytest.fixture(scope="module")
def ae_trainers(fixture_root, tmp_path_factory):
    """A JAX and a port Trainer with quality_laptop_ae.json's settings from
    one state: the port's seeded params, carried over as the JAX trainer's
    init (its flax ResNet-34 init takes tens of seconds on the CPU), as
    tests/test_torch_trainer_ae.py does."""
    root, _ = fixture_root
    jdir, tdir = _copies(root, tmp_path_factory.mktemp("ae_raw"))
    kw = _ae_settings()
    tt = ttrainer.Trainer(Config(**kw, root_dir=str(tdir / "data"),
                                 output_path=str(tdir / "results")), device="cpu")
    tt.state = dataclasses.replace(tt.state, params=seeded_params(
        tt.system, torch.Generator().manual_seed(tt.cfg.seed)))
    tree = tree_to_flax(tt.state.params)

    def init_state(self, key):
        state = FlaxTrainState.create(apply_fn=self.model.apply,
                                      params=jax.tree.map(jnp.asarray, tree), tx=self.tx)
        return state.replace(step=jnp.asarray(0, jnp.int32))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsystem_ae.AutoEncoderSystem, "init_state", init_state)
        jt = jtrainer.Trainer(JaxConfig(**kw, root_dir=str(jdir / "data"),
                                        output_path=str(jdir / "results")))
    return jt, tt


def test_ae_config_stops_at_24000_on_the_100000_step_lr_horizon(ae_trainers):
    jt, tt = ae_trainers
    assert jt.cfg.ae_sigma_activation == tt.cfg.ae_sigma_activation == "relu"
    assert not jt.cfg.use_aabb and not tt.cfg.use_aabb
    # the fit loops' bound: num_epochs epochs of _steps_per_epoch() steps,
    # cut at run_max_steps
    plans = [min(t.cfg.num_epochs * t._steps_per_epoch(), t.cfg.run_max_steps)
             for t in (jt, tt)]
    assert plans == [24000, 24000] == [min(16 * 1500, 100000)] * 2
    # quality_run pins lr_max_steps at the config's run_max_steps: the same
    # horizon as the config's own, which sets none
    assert tt.cfg.lr_max_steps == jt.cfg.lr_max_steps == 0
    assert tt.cfg.run_max_steps == jt.cfg.run_max_steps == 100000
    for step in (0, 2500, 24000):
        got, want = float(tt.system.lr_schedule(step)), float(jt.system.lr_schedule(step))
        assert abs(got - want) <= 3e-7, (step, got, want)
    got = float(tt.system.lr_schedule(24000))
    assert abs(got - JAX_LR_24000) <= 1e-6 * JAX_LR_24000, got


def _ae_converted(tstate, jstate):
    params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    mu, nu = tstate.tx.init(params)
    return TrainState(step=int(jstate.step), params=params, mu=mu, nu=nu, tx=tstate.tx)


def _cos(got, want, names):
    a = torch.cat([got[k].reshape(-1).double() for k in names])
    b = torch.cat([want[k].reshape(-1).double() for k in names])
    return (a @ b / (a.norm() * b.norm())).item(), (a.norm() / b.norm()).item()


def _jax_latents(jt, batch):
    """The JAX encoder's latents and joint state of ``batch``'s source image,
    as torch tensors."""
    src = np.asarray(batch["src_imgs"])
    lat, pred = jt.system._encode(jt.state.params, jnp.asarray(src[None] if src.ndim == 3
                                                               else src),
                                  jnp.asarray(batch["deg"]))
    return ({k: torch.from_numpy(np.array(v)) for k, v in lat.items()},
            torch.from_numpy(np.array(pred)))


def _step_on(tt, params, batch, latents=None):
    """The Trainer's first step on ``batch`` (one microbatch, the whole-batch
    denominators, step 0's key), on the port's latents or on ``latents``:
    its loss terms and the NeRF's gradients."""
    fn, encode = tt.system.loss_fn, tt.system._encode
    batch = dict(batch, **fn.prepare_shared(batch, None))
    flat = {k: v[0] if k in RAY_KEYS else v for k, v in batch.items()}
    p = {k: v.detach().clone().requires_grad_(k.startswith(("model.", "deg_embedding.")))
         for k, v in params.items()}

    def substituted(q, src, deg):  # the degree table's row is a lookup: the port's own
        own, pred = encode(q, src, deg)
        return {k: v if k == "articulation_deg" else latents[k].reshape(v.shape)
                for k, v in own.items()}, pred

    with pytest.MonkeyPatch.context() as mp:
        if latents is not None:
            mp.setattr(tt.system, "_encode", substituted)
        loss, aux = fn(p, flat, tt.step_key(0))
    loss.backward()
    return aux, {k: v.grad for k, v in p.items() if v.grad is not None}


def test_ae_config_fit_step_and_validation_match_jax(ae_trainers, monkeypatch):
    """One fit step at the config's horizon (the Trainers' run cut to one
    step after they were built), then one validation of both from the JAX
    state converted.

    What moves with the encoders' latents is held on JAX's latents.  With
    relu sigma on raw intervals, at a fresh init, the NeRF's opacity and
    its fine samples move with the latents' last bits: the two encoders'
    float32 latents differ by ~2e-5 of their scale
    (tests/test_torch_ae_step.py), the deformation's top frequency (2^9)
    turns that into phase, rays with a little opacity carry it into the acc
    the BCE reads, and the fine samples follow the coarse weights.  Scaling
    the port's own encoder weights by 1 + 1e-7 noise moves its opacity term
    on this batch by 1.0e-4 of itself (1e-6: 1.4e-4), where with softplus
    sigma on AABB intervals it moves by 6.6e-8; the step's opacity term lies
    1.45e-4 from JAX's and its fine gradients at a cosine of 0.65.  So the
    port's step is also taken on the JAX encoder's latents (the same batch,
    key and NeRF weights): its loss terms at the fit step's 1e-4 of JAX's
    logged ones, each level's NeRF gradients by direction at the fit step's
    cosine 0.99 (seen 0.99998 coarse, 0.9985 fine), the coarse norm within
    5% and the fine within 10% (seen 1.064: its samples follow the coarse
    weights' last bits, as this file's other fine tolerances say).  The
    encoder itself is held against flax in tests/test_torch_ae_models.py;
    the fit's encoder, degree-table and coarse gradients and its joint-state
    head at the fit step's tolerances."""
    jt, tt = ae_trainers
    # the AE's state with its Adam moments is ~0.3 GB a save: the
    # checkpoints are the trainers' unchanged path, held elsewhere
    for manager in (jtrainer.CheckpointManager, ttrainer.CheckpointManager):
        monkeypatch.setattr(manager, "save_last", lambda self, state, epoch: None)
        monkeypatch.setattr(manager, "save_ranked", lambda self, state, epoch, psnr: None)
    item = next(tt._train_iterator())
    assert "t_near" not in item  # raw intervals
    ttrainer.inject_ramps(tt.cfg, item, 0)
    batch0 = {k: v[0] for k, v in stack_step_batches([item], B, device="cpu").items()}
    params0 = tt.state.params
    jlat, _ = _jax_latents(jt, item)
    jt.cfg.run_max_steps = tt.cfg.run_max_steps = 1
    jt.fit()
    tt.fit()
    assert jt.global_step == tt.global_step == tt.state.step == 1
    jrec, trec = _records(jt.cfg), _records(tt.cfg)
    assert [(r["step"], sorted(r)) for r in trec] == [(r["step"], sorted(r)) for r in jrec]
    for k in ("train/loss", "train/loss_state", "train/lr"):
        np.testing.assert_allclose(trec[0][k], jrec[0][k], rtol=1e-4, err_msg=k)
    for k in ("train/psnr0", "train/psnr1"):
        np.testing.assert_allclose(trec[0][k], jrec[0][k], atol=1e-2, err_msg=k)
    got, want = _moments(jt, tt)
    assert set(got) == set(want)
    for prefix in ("model.coarse_mlp.", "encoder."):
        cos, ratio = _cos(got, want, [k for k in want if k.startswith(prefix)])
        assert cos >= 0.99 and 0.95 <= ratio <= 1.05, (prefix, cos, ratio)
    for k in (k for k in want if k.startswith("joint_state.")):
        err = (got[k] - want[k]).abs().max() / want[k].abs().max()
        assert err <= 1e-4, (k, err.item())

    # the step on the port's own latents is the fit's; on JAX's, JAX's
    own, own_grads = _step_on(tt, params0, batch0)
    np.testing.assert_allclose(own["opacity_loss"].item(), trec[0]["train/opacity_loss"],
                               rtol=1e-6)
    assert _cos(own_grads, got, list(own_grads))[0] >= 0.999999
    on_jax, grads = _step_on(tt, params0, batch0, jlat)
    np.testing.assert_allclose(on_jax["opacity_loss"].item(), jrec[0]["train/opacity_loss"],
                               rtol=1e-4)
    nerf_terms = sum(on_jax[k].item() for k in ("loss0", "loss1", "opacity_loss"))
    np.testing.assert_allclose(nerf_terms + jrec[0]["train/loss_state"], jrec[0]["train/loss"],
                               rtol=1e-4)
    for prefix, norm in (("model.coarse_mlp.", 0.05), ("model.fine_mlp.", 0.1),
                         ("deg_embedding.", 0.1)):
        cos, ratio = _cos(grads, want, [k for k in want if k.startswith(prefix)])
        assert cos >= 0.99 and abs(ratio - 1.0) <= norm, (prefix, cos, ratio)

    tt.state = _ae_converted(tt.state, jt.state)
    jv, tv = jt.validate(0), tt.validate(0)
    assert abs(tv - jv) <= AE_PSNR_TOL and np.isfinite(tv)
    jlast, tlast = _records(jt.cfg)[-1], _records(tt.cfg)[-1]
    assert sorted(tlast) == sorted(jlast)
    np.testing.assert_allclose(tlast["val/state_error_rad"], jlast["val/state_error_rad"],
                               rtol=1e-4)
    assert tlast["val/abs_state_error_deg"] == jlast["val/abs_state_error_deg"]
    assert abs(tlast["val/psnr_obj"] - jlast["val/psnr_obj"]) <= AE_PSNR_TOL


# ------------------------------------------------ the occ8 vanilla config

def test_occ8_vanilla_fit_step_matches_jax(tmp_path):
    """quality_laptop_vanilla_refsched_occ8.json's level at 8 + 16 samples on
    occupancy intervals (white background), one fit step from the JAX
    trainer's init and draws: the records at 1e-5 relative, every parameter
    within 2 lr of JAX's and within 0.02 lr where its gradient is over a
    tenth of its tensor's largest (tests/test_torch_trainer.py)."""
    c = json.loads((REPO / "configs" / "quality_laptop_vanilla_refsched_occ8.json").read_text())
    src = tmp_path / "fixture"
    tfixture.main([str(src), "--n", "3", "--wh", str(WH[0]), str(WH[1]), "--seed", "1"])
    jdir, tdir = _copies(src, tmp_path)
    kw = dict(dataset_name="sapien", exp_type="vanilla", img_wh=list(WH),
              **{k: c[k] for k in ("white_back", "use_aabb", "use_occgrid", "N_samples",
                                   "N_importance")},
              batch_size=64, compute_dtype="float32", chunk=512, num_epochs=1,
              run_max_steps=1, steps_per_dispatch=1, log_every_n_steps=1, limit_val_batches=1,
              save_top_k=1, exp_name="occ8")
    assert (kw["N_samples"], kw["N_importance"], kw["use_occgrid"]) == (8, 16, True)
    jt = jtrainer.Trainer(JaxConfig(**kw, root_dir=str(jdir / "data"),
                                    output_path=str(jdir / "results")))
    tt = ttrainer.Trainer(Config(**kw, root_dir=str(tdir / "data"),
                                 output_path=str(tdir / "results")), device="cpu")
    start = params_from_flax(jax.tree.map(np.asarray, jt.state.params))
    for k, v in start.items():  # one init, bit for bit
        assert torch.equal(tt.state.params[k], v), k
    batch = next(tt._train_iterator())
    assert "t_near" in batch and float(np.mean(batch["t_far"] - batch["t_near"])) < 1.0
    jt.fit()
    tt.fit()
    assert jt.global_step == tt.global_step == tt.state.step == 1
    jrec, trec = _records(jt.cfg), _records(tt.cfg)
    assert [(r["step"], sorted(r)) for r in trec] == [(r["step"], sorted(r)) for r in jrec]
    for jr, tr in zip(jrec, trec):
        for k in ("train/loss", "train/psnr0", "train/psnr1", "train/lr"):
            if k in jr:
                np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, err_msg=k)
    lr = float(tt.system.lr_schedule(0))
    want = params_from_flax(jax.tree.map(np.asarray, jt.state.params))
    grads = params_from_flax(jax.tree.map(lambda m: 10.0 * np.asarray(m),
                                          jt.state.opt_state[0].mu))
    for k, w in want.items():
        assert (tt.state.params[k] - start[k]).abs().max().item() > 0, k
        diff = (tt.state.params[k] - w).abs()
        big = grads[k].abs() > 0.1 * grads[k].abs().max()
        assert diff.max().item() <= 2 * lr, k
        assert diff[big].max().item() <= 0.02 * lr, k


# ------------------------------------------------------------ quality_run

def test_quality_run_curves_read_object_psnr_and_state_error():
    """The committed JAX auto-encoder curve against itself: every gap 0 at
    JAX's 16 vals, for the PSNR, the object PSNR and the joint-state error."""
    jax_ae = REPO / "results" / "laptop_ae" / "metrics.jsonl"
    out = quality_run.curves(jax_ae, jax_ae)
    assert list(out) == list(quality_run.CURVE_KEYS)
    steps = [1500 * (i + 1) for i in range(16)]
    for key, rows in out.items():
        assert [r[0] for r in rows] == steps, key
        assert all(r[1] == r[2] and r[3] == 0.0 for r in rows), key
    assert out["val/psnr"] == quality_run.compare(jax_ae, jax_ae)
    gaps = quality_run.main([str(jax_ae), "--reference", str(jax_ae), "--gaps"])
    assert gaps["val/psnr_obj"]["last_reference"] == pytest.approx(19.6437, abs=1e-4)
    assert gaps["val/state_error_rad"]["last_port"] == pytest.approx(0.005456, abs=1e-6)
    assert all(g["mean_gap"] == g["mean_gap_last5"] == g["last_gap"] == 0.0
               and g["steps"] == 16 and g["last_step"] == 24000 for g in gaps.values())


# ------------------------------------ the auto-encoder's init field by seed

@pytest.mark.slow
def test_ae_config_init_fields_by_seed_study(tmp_path, capsys):
    """A study on the generated ``data/laptop_multi`` (skipped without it;
    ~2 min, ``-m slow -s``): the relu field ``quality_laptop_ae.json`` draws
    at seeds 0-3, at the config's widths, on the first 512 rays of the first
    batch at step 0's key, float32 plain routes.  At seed 1 both packages'
    inits are opaque on every ray, coarse and fine, and agree to float32
    rounding; the other seeds' are not.  It prints each seed's mean acc and
    the share of coarse rays over 0.99."""
    data = REPO / "data" / "laptop_multi"
    if not data.is_dir():
        pytest.skip("data/laptop_multi is generated by datagen/data_gen.py")
    from aon_tpu_torch.core.rays import effective_intervals
    from aon_tpu_torch.ops.render_fused import mlp_params

    argv = ["--config", str(AE_CONFIG)]
    n = 512

    def first_rays(side, seed, cls_get_config, trainer_cls, **kw):
        root = tmp_path / f"{side}{seed}"
        shutil.copytree(data, root / "data")  # each package caches in its own copy
        cfg = cls_get_config(argv)
        cfg.root_dir, cfg.output_path = str(root / "data"), str(root / "results")
        cfg.seed, cfg.compute_dtype, cfg.use_pallas = seed, "float32", False
        return trainer_cls(cfg, **kw)

    rows = {}
    for seed in range(4):
        tt = first_rays("port", seed, get_config, ttrainer.Trainer, device="cpu")
        item = next(tt._train_iterator())
        ttrainer.inject_ramps(tt.cfg, item, 0)
        b = {k: v[0] for k, v in stack_step_batches([item], tt.cfg.microbatch_rays,
                                                   device="cpu").items()}
        flat = {k: (v[0][:n] if k in RAY_KEYS else v) for k, v in b.items()}
        rays = {k: flat[k] for k in ("rays_o", "rays_d", "viewdirs")}
        near, far = effective_intervals(flat, tt.system.near, tt.system.far)
        src = flat["src_imgs"][None] if flat["src_imgs"].ndim == 3 else flat["src_imgs"]
        with torch.no_grad():
            lat, _ = tt.system._encode(tt.state.params, src, flat["deg"])
            out = torch.func.functional_call(
                tt.system.model, mlp_params(tt.state.params, "model"),
                (rays, lat, tt.system.white_bkgd, near, far),
                dict(randomized=True, key=tt.step_key(0)))
        accs = {"port": [out[0][1].numpy(), out[1][1].numpy()]}
        if seed == 1:
            jt = first_rays("jax", seed, jax_get_config, jtrainer.Trainer)
            jo = jt.system.model.apply(
                {"params": jt.state.params["model"]},
                {k: jnp.asarray(v.numpy()) for k, v in rays.items()},
                jt.system._encode(jt.state.params, jnp.asarray(src.numpy()),
                                  jnp.asarray(flat["deg"].numpy()))[0],
                jax.random.fold_in(jt.base_key, 0), True, jt.system.white_bkgd,
                float(near), float(far))
            accs["jax"] = [np.asarray(jo[0][1]), np.asarray(jo[1][1])]
            for lvl in range(2):
                np.testing.assert_allclose(accs["port"][lvl], accs["jax"][lvl], atol=1e-5)
        rows[seed] = {side: {"coarse_mean": float(a[0].mean()), "fine_mean": float(a[1].mean()),
                             "coarse_share_over_0.99": float((a[0] > 0.99).mean())}
                      for side, a in accs.items()}
    with capsys.disabled():
        print(json.dumps(rows))
    assert rows[1]["port"]["coarse_share_over_0.99"] == rows[1]["jax"]["coarse_share_over_0.99"] == 1.0
    assert all(rows[s]["port"]["coarse_share_over_0.99"] < 1.0 for s in (0, 2, 3))
