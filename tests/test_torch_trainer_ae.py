"""Port parity, the auto-encoder as a whole: the port's ``Trainer`` with
exp_type="vanilla_ae_art" on a ``sapien_multi`` dataset against the JAX
``Trainer`` on the same ``--multi`` fixture, from one converted state (CPU,
float32 plain routes on both sides, the quality config's ``softplus_bias``
sigma); the ``obj_ray_oversample`` guard; the extraction's auto-encoder grid
against the JAX script's; and the bench's auto-encoder row at a small size.

The JAX trainer's ``init_state`` is replaced by the port's init params
carried over (``tree_to_flax``): both trainers then start from one state,
and the JAX encoder's op-by-op init (tens of seconds on the CPU) is not paid.

Tolerances, and why (tests/test_torch_ae_step.py states them for the step
and ``render_chunk``):
  * the ray stream with ``src_imgs`` and ``deg``, the val frames' inputs and
    the output files' layout: exact;
  * one ``fit`` step with the JAX trainer's draws injected: the step's loss,
    joint-state and opacity terms 1e-4 relative, the PSNRs 1e-2 dB; its
    gradients, read back from the first Adam moment on both sides (mu = 0.1
    g), by level and by the encoder side as tests/test_torch_ae_step.py holds
    them (cosine >= 0.99, norm ratio 0.95..1.05; the joint-state head 1e-4
    per entry);
  * ``validate`` and ``test`` from one converted state: ``render_chunk``'s
    comp_rgb 2e-3 per pixel, so a frame's PSNR moves by at most
    20 log10(1 + 2e-3 / rmse) dB; held at 2e-2 dB, SSIM at 1e-3;
    ``pred_state`` and ``val/state_error_rad`` 1e-4 relative (the float32
    encoders' pred_state agree to ~1e-5; seen 1.3e-5 and 1.6e-5);
    ``val/abs_state_error_deg``: exact (whole degrees);
  * the extraction's grid: the fine MLP in float32 on the port's encoding
    against the JAX script's flax float32 grid, 5e-3 of the grid's largest
    sigma at any voxel and 1e-3 on average (seen 1.3e-3, 2.8e-4: the two
    encoders' float32 latents); the script's grid, from the articulated eval
    kernel's bf16 twin, against the JAX one 0.15 and 2.5e-2 (seen 0.105,
    0.015): the encoder's latents reach |3.4| where the auto-decoder's codes
    stay near 0.1, so folding them into the bf16 biases rounds more than
    tests/test_torch_geometry.py's 8e-2 and 1e-2 allow for those codes.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import sys
import types
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax.training.train_state import TrainState as FlaxTrainState  # noqa: E402

from aon_tpu.data import sapien_multi as jmulti  # noqa: E402
from aon_tpu.train import system_ae as jsystem_ae  # noqa: E402
from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.models.init import seeded_params  # noqa: E402
from aon_tpu_torch.core import sampling as tsampling  # noqa: E402
from aon_tpu_torch.data import sapien_multi as tmulti  # noqa: E402
from aon_tpu_torch.core.sampling import pos_enc  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax, tree_to_flax  # noqa: E402
from aon_tpu_torch.ops import fused_art  # noqa: E402
from aon_tpu_torch.ops.render_fused import mlp_params  # noqa: E402
from aon_tpu_torch.scripts import bench as port_bench  # noqa: E402
from aon_tpu_torch.scripts import extract_geometry as geo  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.train import trainer as ttrainer  # noqa: E402
from aon_tpu_torch.train.systems import TrainState, build_system  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WH = (64, 48)  # the smallest frame whose layer4 maps are wider than one pixel
B = 64
SMALL = dict(dataset_name="sapien_multi", exp_type="vanilla_ae_art", img_wh=list(WH),
             white_back=False, use_aabb=True, N_samples=4, N_importance=4,
             ae_sigma_activation="softplus_bias", aabb_warmup_steps=8000,
             ray_batch_size=B, microbatch_rays=B, samples_per_epoch=1, compute_dtype="float32",
             use_pallas=False, chunk=1024, num_epochs=1, run_max_steps=1, steps_per_dispatch=1,
             log_every_n_steps=1, limit_val_batches=5, save_top_k=1, exp_name="ae")
PSNR_TOL, SSIM_TOL, RGB_TOL = 2e-2, 1e-3, 2e-3
SMALL_DEG_VIEW = 4  # the config's N_emb_dir


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the suite runs these files beside
    others in parallel workers, where OpenMP threads of every worker
    oversubscribe the cores, and these small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_ae_fixture") / "data"
    tfixture.main([str(root), "--multi", "--n", "3", "--wh", str(WH[0]), str(WH[1]),
                   "--seed", "2"])
    return root


def _configs(fixture_root, base: Path, **overrides):
    """(JAX Config, port Config) on separate copies of the fixture."""
    out = []
    for cls, side in ((JaxConfig, "jax"), (Config, "port")):
        root = base / side / "data"
        if not root.exists():
            shutil.copytree(fixture_root, root)
        kw = dict(SMALL, root_dir=str(root), output_path=str(base / side / "results"))
        out.append(cls(**dict(kw, **overrides)))
    return out


@contextlib.contextmanager
def _jax_init_from(params):
    """The JAX ``AutoEncoderSystem.init_state`` returning ``params`` (the
    port's state dict carried over) under the system's own optimizer."""
    tree = tree_to_flax(params)

    def init_state(self, key):
        state = FlaxTrainState.create(apply_fn=self.model.apply,
                                      params=jax.tree.map(jnp.asarray, tree), tx=self.tx)
        return state.replace(step=jnp.asarray(0, jnp.int32))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsystem_ae.AutoEncoderSystem, "init_state", init_state)
        yield


def _converted(tstate, jstate):
    params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    mu, nu = tstate.tx.init(params)
    return TrainState(step=int(jstate.step), params=params, mu=mu, nu=nu, tx=tstate.tx)


@pytest.fixture(scope="module")
def trainers(fixture_root, tmp_path_factory):
    """A JAX and a port Trainer on the fixture from one state: seeded params
    (``models/init.py::seeded_params``, a generator of the config's seed; the Trainer's
    own init is flax's, held in tests/test_torch_init_keys.py)."""
    jcfg, tcfg = _configs(fixture_root, tmp_path_factory.mktemp("trainers_ae"))
    tt = ttrainer.Trainer(tcfg, device="cpu")
    tt.state = dataclasses.replace(tt.state, params=seeded_params(
        tt.system, torch.Generator().manual_seed(tcfg.seed)))
    with _jax_init_from(tt.state.params):
        jt = jtrainer.Trainer(jcfg)
    return jt, tt


def _cos(got, want, names):
    a = torch.cat([got[k].reshape(-1).double() for k in names])
    b = torch.cat([want[k].reshape(-1).double() for k in names])
    return (a @ b / (a.norm() * b.norm())).item(), (a.norm() / b.norm()).item()


@pytest.mark.parametrize("step", [0, 23])
def test_train_iterator_is_the_jax_trainers(trainers, step):
    jt, tt = trainers
    jt.global_step = tt.global_step = step
    jit, tit = jt._train_iterator(), tt._train_iterator()
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert set(tb) == set(jb) == {"rays_o", "rays_d", "viewdirs", "target", "instance_mask",
                                      "src_imgs", "t_near", "t_far", "deg", "instance_id",
                                      "articulation_id"}
        assert tb["src_imgs"].shape == (3, WH[1], WH[0])
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    jt.global_step = tt.global_step = 0


def test_fit_one_step_matches_jax(trainers, monkeypatch):
    jt, tt = trainers
    # the epoch's checkpoints are the trainers' unchanged path (held in
    # tests/test_torch_trainer*.py); the AE's state with its Adam moments is
    # ~0.3 GB a save, four a side, not worth the suite's disk and time here
    for manager in (jtrainer.CheckpointManager, ttrainer.CheckpointManager):
        monkeypatch.setattr(manager, "save_last", lambda self, state, epoch: None)
        monkeypatch.setattr(manager, "save_ranked", lambda self, state, epoch, psnr: None)
    n_c, n_f = SMALL["N_samples"], SMALL["N_importance"]
    # the JAX trainer's key of step 0 and the draws ArticulatedNeRF takes from
    # it: the port's own draws, nothing injected
    keys = jax.random.split(jax.random.fold_in(jt.base_key, 0), 4)
    draws = [np.asarray(jax.random.uniform(keys[0], (B, n_c + 1), dtype=jnp.float32)),
             np.asarray(jax.random.uniform(keys[2], (B, n_f), dtype=jnp.float32))]
    seen = []
    draw = tsampling.draw_uniform
    monkeypatch.setattr(tsampling, "draw_uniform",
                        lambda *a, **kw: seen.append(draw(*a, **kw)) or seen[-1])
    jt.fit()
    tt.fit()
    assert len(seen) == 2
    for got, want in zip(seen, draws):
        np.testing.assert_array_equal(got.numpy(), want)
    assert jt.global_step == tt.global_step == tt.state.step == 1

    jrec, trec = ([json.loads(ln) for ln in (Path(c.output_path) / c.exp_name / "metrics.jsonl")
                   .read_text().splitlines()] for c in (jt.cfg, tt.cfg))
    assert [(r["step"], sorted(r)) for r in trec] == [(r["step"], sorted(r)) for r in jrec]
    for k in ("train/loss", "train/loss_state", "train/opacity_loss", "train/lr"):
        np.testing.assert_allclose(trec[0][k], jrec[0][k], rtol=1e-4, err_msg=k)
    for k in ("train/psnr0", "train/psnr1"):
        np.testing.assert_allclose(trec[0][k], jrec[0][k], atol=1e-2, err_msg=k)
    # the epoch's validation, from the two states after the step
    assert abs(trec[-1]["val/psnr"] - jrec[-1]["val/psnr"]) <= PSNR_TOL
    assert trec[-1]["val/abs_state_error_deg"] == jrec[-1]["val/abs_state_error_deg"]

    want = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jt.state.opt_state[0].mu)).items()}
    got = {k: 10.0 * v for k, v in tt.state.mu.items()}
    assert set(got) == set(want)
    for prefix in ("model.coarse_mlp.", "model.fine_mlp.", "encoder.", "deg_embedding."):
        cos, ratio = _cos(got, want, [k for k in want if k.startswith(prefix)])
        assert cos >= 0.99 and 0.95 <= ratio <= 1.05, (prefix, cos, ratio)
    for k in (k for k in want if k.startswith("joint_state.")):
        err = (got[k] - want[k]).abs().max() / want[k].abs().max()
        assert err <= 1e-4, (k, err.item())


def test_validate_and_test_match_jax_from_one_converted_state(trainers, tmp_path, monkeypatch):
    jt, tt = trainers
    tt.state = _converted(tt.state, jt.state)
    frames = list(tt._val_frames())
    assert len(frames) == 5 and all("src_imgs" in f and "deg" in f for f in frames)
    for jf, tf in zip(jt._val_frames(), frames):
        for k in jf:
            np.testing.assert_array_equal(tf[k], np.asarray(jf[k]), err_msg=k)
    jret = jt._render_full(jt.state.params, frames[0])
    tret = tt._render_full(tt.state.params, frames[0])
    assert "pred_state" in tret and np.isnan(tret["pred_state"]).any()  # miss rays: NaN
    np.testing.assert_allclose(tret["comp_rgb"], np.asarray(jret["comp_rgb"]), atol=RGB_TOL)
    np.testing.assert_allclose(np.nanmean(tret["pred_state"]), np.nanmean(jret["pred_state"]),
                               rtol=1e-4)

    jv, tv = jt.validate(0), tt.validate(0)
    assert abs(tv - jv) <= PSNR_TOL and np.isfinite(tv)
    jrec, trec = ([json.loads(ln) for ln in (Path(c.output_path) / c.exp_name / "metrics.jsonl")
                   .read_text().splitlines()][-1] for c in (jt.cfg, tt.cfg))
    assert sorted(trec) == sorted(jrec)
    np.testing.assert_allclose(trec["val/state_error_rad"], jrec["val/state_error_rad"],
                               rtol=1e-4)
    assert trec["val/abs_state_error_deg"] == jrec["val/abs_state_error_deg"]
    assert abs(trec["val/psnr_obj"] - jrec["val/psnr_obj"]) <= PSNR_TOL

    results = {}
    for side, tr, mod in (("jax", jt, jmulti), ("port", tt, tmulti)):
        tr.test_dataset = mod.SapienDatasetMulti(
            tr.cfg.root_dir, "test_val", WH, eval_inference="render", use_aabb=True,
            ray_batch_size=B, need_src_imgs=True)
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        results[side] = tr.test(ckpt_name="absent.ckpt")  # the current params
    for k in ("test/psnr", "test/psnr_obj"):
        assert abs(results["port"][k] - results["jax"][k]) <= PSNR_TOL, k
    assert abs(results["port"]["test/ssim"] - results["jax"]["test/ssim"]) <= SSIM_TOL
    jdir, tdir = (tmp_path / s / "ckpts" for s in ("jax", "port"))
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    assert sum(p.name.startswith("image") for p in files if p.parts[-2] == "render") == 19
    jres = json.loads((jdir / "ae" / "results.json").read_text())
    tres = json.loads((tdir / "ae" / "results.json").read_text())
    assert set(tres) == set(jres) == {"PSNR", "SSIM", "PSNR_obj"}
    np.testing.assert_allclose(tres["PSNR"]["each"], jres["PSNR"]["each"], atol=PSNR_TOL)
    np.testing.assert_allclose(tres["SSIM"]["each"], jres["SSIM"]["each"], atol=SSIM_TOL)


def test_obj_ray_oversample_is_refused_as_the_jax_trainer_refuses_it(fixture_root, tmp_path):
    jcfg, tcfg = _configs(fixture_root, tmp_path, obj_ray_oversample=0.5)
    with pytest.raises(ValueError, match="obj_ray_oversample") as jerr:
        jtrainer.Trainer(jcfg)
    with pytest.raises(ValueError, match="obj_ray_oversample") as terr:
        ttrainer.Trainer(tcfg, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_extraction_of_the_ae_grid_matches_the_jax_script(fixture_root, tmp_path, monkeypatch):
    """``extract_geometry.main`` encodes train frame ``--image_id`` of
    ``--instance`` at ``--articulation`` and queries the fine MLP through the
    articulated eval kernel's twin, against the JAX script's
    ``density_color_fn`` (its CPU branch, flax in float32) on the same
    state and voxel centers."""
    sys.path.insert(0, str(REPO / "scripts"))
    import extract_geometry as jgeo

    res, chunk = 16, 1024
    _, tcfg = _configs(fixture_root, tmp_path, exp_name="geo_ae")
    config = tmp_path / "geo_ae.json"
    config.write_text(json.dumps({k: getattr(tcfg, k) for k in (*SMALL, "root_dir",
                                                                "output_path")}))
    tt = ttrainer.Trainer(tcfg, device="cpu")
    params = dict(tt.state.params)
    # partly opaque: sigma = softplus(raw - 1) around the auto threshold
    params["model.fine_mlp.density.bias"] = params["model.fine_mlp.density.bias"] + 1.5
    state = TrainState(step=5, params=params, mu=tt.state.mu, nu=tt.state.nu, tx=tt.state.tx)
    # the restore hands over this state: a saved one is a ~0.3 GB round trip
    # through the checkpoint code tests/test_torch_geometry.py already holds
    monkeypatch.setattr(geo.CheckpointManager, "restore", lambda self, st, name=None: state)
    monkeypatch.chdir(tmp_path)
    ids = ["--instance", "1", "--articulation", "3", "--image_id", "2"]
    before = fused_art.art_mlp_fwd.launches
    out = geo.main(["--config", str(config), "--resolution", str(res), "--chunk", str(chunk),
                    "--bounds", "-1.5", "-1.5", "-1.5", "1.5", "1.5", "1.5", *ids], device="cpu")
    assert fused_art.art_mlp_fwd.launches == before  # CPU tensors: the twin
    grid = np.load(tmp_path / "ckpts" / "geo_ae" / "geometry" / "density_grid.npz")
    sigma = grid["sigma"]
    assert out["queries"] == res ** 3 // chunk and out["occupied"] > 0

    jcfg = JaxConfig(**{k: getattr(tcfg, k) for k in SMALL}, root_dir=tcfg.root_dir)
    jsys = jsystem_ae.AutoEncoderSystem(jcfg, 2.0, 6.0, False)
    jds = jmulti.SapienDatasetMulti(tcfg.root_dir, "test_val", WH, eval_inference="geometry",
                                    need_src_imgs=False)
    args = types.SimpleNamespace(viewdir=(0.0, 0.0, -1.0), instance=1, articulation=3,
                                 image_id=2, interpolated=False)
    query = jgeo.density_color_fn(types.SimpleNamespace(
        cfg=jcfg, state=types.SimpleNamespace(params=tree_to_flax(params)), system=jsys,
        test_dataset=jds), args)
    pts = geo.voxel_centers(np.full(3, -1.5), 3.0 / res, res).reshape(-1, 3).astype(np.float32)
    want = np.concatenate([np.asarray(query(jnp.asarray(pts[i:i + chunk]))[0])
                           for i in range(0, len(pts), chunk)]).reshape(res, res, res)
    scale = float(np.abs(want).max())
    err = np.abs(sigma - want)
    assert err.max() <= 0.15 * scale and err.mean() <= 2.5e-2 * scale, (
        err.max() / scale, err.mean() / scale)
    # the same field in float32: the plain module on the script's encoding
    latents, _ = tt.system._encode(params, *geo.ae_source(tcfg, args))
    pos = torch.from_numpy(pts).reshape(-1, geo.POINTS_PER_RAY, 3)
    vdir = torch.tensor([[0.0, 0.0, -1.0]]).expand(pos.shape[0], 3)
    with torch.no_grad():
        _, raw = torch.func.functional_call(
            tt.system.model.fine_mlp, mlp_params(params, "model.fine_mlp"),
            (pos, pos_enc(vdir, 0, SMALL_DEG_VIEW), latents))
    f32 = torch.nn.functional.softplus(raw.reshape(res, res, res) - 1.0).numpy()
    err = np.abs(f32 - want)
    assert err.max() <= 5e-3 * scale and err.mean() <= 1e-3 * scale, (
        err.max() / scale, err.mean() / scale)


def test_bench_ae_row_at_a_small_size(monkeypatch):
    """The AE row's batch is the JAX bench's ``bench_ae`` batch bit for bit,
    and the row's timing loop trains the AE on it (here T = 2 steps a call,
    1 + 2 calls) at a small size on the CPU: every call's loss finite,
    falling from the first call."""
    sys.path.insert(0, str(REPO))
    import bench as jax_bench

    captured = {}
    monkeypatch.setattr(jax_bench, "_time_train_many",
                        lambda system, mesh, host_batch, microbatch: captured.update(host_batch)
                        or 1.0)
    args = types.SimpleNamespace(N_samples=24, N_importance=48, tight="aabb")
    jax_bench.bench_ae(args)
    want = port_bench.ae_batch(4096, "aabb")
    assert set(want) == set(captured)
    for k in want:
        np.testing.assert_array_equal(want[k], np.asarray(captured[k]), err_msg=k)

    # the row's timing loop on its system and batch, at 64 rays and 64x48
    monkeypatch.setattr(port_bench, "STEPS_PER_DISPATCH", 2)
    monkeypatch.setattr(port_bench, "WARMUP_DISPATCHES", 1)
    monkeypatch.setattr(port_bench, "TIMED_DISPATCHES", 2)
    system = build_system(Config(exp_type="vanilla_ae_art", ray_batch_size=64, batch_size=64,
                                 img_wh=list(WH), N_samples=4, N_importance=4),
                          2.0, 6.0, False, device="cpu")
    res = port_bench._time_train_many(system, port_bench.ae_batch(64, "aabb", WH), 2048,
                                      torch.device("cpu"))
    calls = port_bench.WARMUP_DISPATCHES + port_bench.TIMED_DISPATCHES
    assert res["final_step"] == calls * port_bench.STEPS_PER_DISPATCH
    assert len(res["dispatch_losses"]) == calls and np.isfinite(res["dispatch_losses"]).all()
    assert res["dispatch_losses"][-1] < res["dispatch_losses"][0]
    assert res["rays_per_step"] == 64 and res["rays_per_s"] > 0
