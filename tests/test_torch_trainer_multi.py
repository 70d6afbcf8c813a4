"""Port parity, the multi-instance trainer slice: the port's ``Trainer`` on a
``sapien_multi`` dataset with the auto-decoder, and the port's
``render_sweep`` and ``eval_per_instance`` scripts, against the JAX package
on the same ``--multi`` fixture (CPU, float32 plain routes on both sides).

Tolerances, and why (tests/test_torch_art_step.py states them for the
auto-decoder's step and ``render_chunk``):
  * the ray stream, the steps per epoch, the val frames' inputs and the
    output files' layout: exact;
  * one ``fit`` step from the same converted init params with the JAX
    trainer's draws injected: the step's loss 1e-4 relative; its gradients,
    read back from the first Adam moment on both sides (mu = 0.1 g), the
    plain route's: coarse 5e-2 of each tensor's largest and 1e-2 of its mean
    magnitude, fine and code rows 3e-1 and 5e-2; code rows no step indexed
    untouched;
  * ``validate``, ``test``, the sweep and the per-instance scores from one
    converted state: ``render_chunk``'s comp_rgb 2e-3 per pixel, so a frame's
    PSNR moves by at most 20 log10(1 + 2e-3 / rmse) dB (about 0.02 dB at the
    fixture's rmse near 0.1); held at 2e-2 dB, with SSIM at 1e-3.
"""

import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.data import sapien_multi as jmulti  # noqa: E402
from aon_tpu.eval import artifacts as jartifacts  # noqa: E402
from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.core import sampling as tsampling  # noqa: E402
from aon_tpu_torch.data import sapien_multi as tmulti  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.scripts import eval_per_instance as tper  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.scripts import render_sweep as tsweep  # noqa: E402
from aon_tpu_torch.train import trainer as ttrainer  # noqa: E402
from aon_tpu_torch.train.systems import ART_TABLE, TrainState  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WH = (64, 48)
B = 64
SMALL = dict(dataset_name="sapien_multi", exp_type="vanilla_autodecoder", img_wh=list(WH),
             white_back=False, use_aabb=True, N_samples=4, N_importance=4, N_max_objs=4,
             ray_batch_size=B, microbatch_rays=B, samples_per_epoch=1, compute_dtype="float32",
             use_pallas=False, chunk=1024, num_epochs=1, run_max_steps=1, steps_per_dispatch=1,
             log_every_n_steps=1, limit_val_batches=5, save_top_k=1, exp_name="multi")
PSNR_TOL, SSIM_TOL, RGB_TOL = 2e-2, 1e-3, 2e-3
TABLES = ("code_library.embedding_instance_shape.weight",
          "code_library.embedding_instance_appearance.weight", ART_TABLE)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_multi_fixture") / "data"
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


def _converted(tstate, jstate):
    params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    mu, nu = tstate.tx.init(params)
    return TrainState(step=int(jstate.step), params=params, mu=mu, nu=nu, tx=tstate.tx)


@pytest.fixture(scope="module")
def trainers(fixture_root, tmp_path_factory):
    """A JAX and a port Trainer on the fixture, the port's state set to the
    JAX one's converted init params."""
    jcfg, tcfg = _configs(fixture_root, tmp_path_factory.mktemp("trainers_multi"))
    jt = jtrainer.Trainer(jcfg)
    tt = ttrainer.Trainer(tcfg, device="cpu")
    # the port's Trainer initialises from the JAX trainer's init key: the same
    # xavier-uniform draws, bit for bit
    want = _converted(tt.state, jt.state)
    assert set(tt.state.params) == set(want.params)
    for k, v in want.params.items():
        assert torch.equal(tt.state.params[k], v), k
    return jt, tt


def _recorded_draws(monkeypatch):
    """Record every uniform draw the port's samplers make: (shape, tensor)."""
    seen = []
    draw = tsampling.draw_uniform

    def recording(shape, *args, **kwargs):
        out = draw(shape, *args, **kwargs)
        seen.append(out.clone())
        return out

    monkeypatch.setattr(tsampling, "draw_uniform", recording)
    return seen


def _errors(got, want, names):
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
                  for k in names)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(1e-30)).item()
                   for k in names)
    return max_rel, mean_rel


@pytest.mark.parametrize("step", [0, 23])
def test_train_iterator_is_the_jax_trainers(trainers, step):
    jt, tt = trainers
    jt.global_step = tt.global_step = step
    jit, tit = jt._train_iterator(), tt._train_iterator()
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert set(tb) == set(jb) == {"rays_o", "rays_d", "viewdirs", "target", "instance_mask",
                                      "t_near", "t_far", "deg", "instance_id", "articulation_id"}
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tt._steps_per_epoch() == jt._steps_per_epoch() == SMALL["samples_per_epoch"]
    assert tt._rays_per_step() == B
    jt.global_step = tt.global_step = 0


def test_fit_one_step_matches_jax(trainers, monkeypatch):
    jt, tt = trainers
    n_c, n_f = SMALL["N_samples"], SMALL["N_importance"]
    # the JAX trainer's key of step 0 and the draws ArticulatedNeRF takes from it:
    # the port's own draws, nothing injected
    keys = jax.random.split(jax.random.fold_in(jt.base_key, 0), 4)
    draws = {"t_rand": torch.from_numpy(np.asarray(
                 jax.random.uniform(keys[0], (B, n_c + 1), dtype=jnp.float32)))[None],
             "u": torch.from_numpy(np.asarray(
                 jax.random.uniform(keys[2], (B, n_f), dtype=jnp.float32)))[None]}
    seen = _recorded_draws(monkeypatch)
    start = tt.state
    jt.fit()
    tt.fit()
    monkeypatch.undo()
    assert [tuple(d.shape) for d in seen[:2]] == [tuple(v.shape[1:]) for v in draws.values()]
    for got, want in zip(seen, draws.values()):
        np.testing.assert_array_equal(got.numpy(), want[0].numpy())
    assert jt.global_step == tt.global_step == tt.state.step == 1

    jrec, trec = ([json.loads(ln) for ln in (Path(c.output_path) / c.exp_name / "metrics.jsonl")
                   .read_text().splitlines()] for c in (jt.cfg, tt.cfg))
    assert [(r["step"], sorted(r)) for r in trec] == [(r["step"], sorted(r)) for r in jrec]
    for k in ("train/loss", "train/psnr0", "train/psnr1", "train/lr"):
        np.testing.assert_allclose(trec[0][k], jrec[0][k], rtol=1e-4, err_msg=k)
    # the epoch's validation, from the two states after the step (the first
    # Adam step moves each weight by about lr = 5e-8 either way)
    assert abs(trec[-1]["val/psnr"] - jrec[-1]["val/psnr"]) <= PSNR_TOL

    want = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jt.state.opt_state[0].mu)).items()}
    got = {k: 10.0 * v for k, v in tt.state.mu.items()}
    names = list(want)
    coarse = _errors(got, want, [k for k in names if k.startswith("model.coarse_mlp.")])
    fine = _errors(got, want, [k for k in names if k.startswith("model.fine_mlp.")])
    codes = _errors(got, want, list(TABLES))
    assert coarse[0] <= 5e-2 and coarse[1] <= 1e-2, coarse
    assert fine[0] <= 3e-1 and fine[1] <= 5e-2, fine
    assert codes[0] <= 3e-1 and codes[1] <= 5e-2, codes
    tt.global_step = 0
    batch = next(tt._train_iterator())  # step 0's item: its ids
    tt.global_step = 1
    for name, idx in zip(TABLES, ("instance_id", "instance_id", "articulation_id")):
        moved = (tt.state.params[name] - start.params[name]).abs().sum(dim=1) > 0
        assert moved.nonzero().flatten().tolist() == [int(batch[idx])], name


def test_validate_and_test_match_jax_from_one_converted_state(trainers, tmp_path, monkeypatch):
    jt, tt = trainers
    tt.state = _converted(tt.state, jt.state)
    frames = list(tt._val_frames())
    assert len(frames) == 5
    for jf, tf in zip(jt._val_frames(), frames):
        for k in jf:
            np.testing.assert_array_equal(tf[k], np.asarray(jf[k]), err_msg=k)
    jret = jt._render_full(jt.state.params, frames[0])
    tret = tt._render_full(tt.state.params, frames[0])
    np.testing.assert_allclose(tret["comp_rgb"], np.asarray(jret["comp_rgb"]), atol=RGB_TOL)
    jv, tv = jt.validate(0), tt.validate(0)
    assert abs(tv - jv) <= PSNR_TOL and np.isfinite(tv)

    results = {}
    for side, tr, mod in (("jax", jt, jmulti), ("port", tt, tmulti)):
        tr.test_dataset = mod.SapienDatasetMulti(
            tr.cfg.root_dir, "test_val", WH, eval_inference="render", use_aabb=True,
            ray_batch_size=B, need_src_imgs=False)
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        results[side] = tr.test(ckpt_name="absent.ckpt")  # the current params
    for k in ("test/psnr", "test/psnr_obj"):
        assert abs(results["port"][k] - results["jax"][k]) <= PSNR_TOL, k
    assert abs(results["port"]["test/ssim"] - results["jax"]["test/ssim"]) <= SSIM_TOL
    jdir, tdir = (tmp_path / s / "ckpts" for s in ("jax", "port"))
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    assert sum(p.parts[-2] == "videos" for p in files) in (1, 19)  # an mp4 or its frames
    assert sum(p.name.startswith("image") for p in files if p.parts[-2] == "render") == 19
    jres = json.loads((jdir / "multi" / "results.json").read_text())
    tres = json.loads((tdir / "multi" / "results.json").read_text())
    assert set(tres) == set(jres) == {"PSNR", "SSIM", "PSNR_obj"}
    np.testing.assert_allclose(tres["PSNR"]["each"], jres["PSNR"]["each"], atol=PSNR_TOL)
    np.testing.assert_allclose(tres["SSIM"]["each"], jres["SSIM"]["each"], atol=SSIM_TOL)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def saved(fixture_root, tmp_path_factory):
    """One state (JAX init params with a denser field, so the frames are not
    the background alone) saved by each package's CheckpointManager, and a
    config file per side."""
    base = tmp_path_factory.mktemp("scripts_multi")
    jcfg, tcfg = _configs(fixture_root, base, exp_name="scripts")
    jt = jtrainer.Trainer(jcfg)
    params = jax.tree.map(lambda x: x, jt.state.params)
    for level in ("coarse_mlp", "fine_mlp"):
        params["model"][level]["density"]["bias"] = params["model"][level]["density"]["bias"] + 2.0
    jstate = jt.state.replace(params=params)
    JaxCheckpointManager(str(Path(jcfg.output_path) / "scripts")).save_last(jstate, 0)
    tt = ttrainer.Trainer(tcfg, device="cpu")
    ttrainer.CheckpointManager(str(Path(tcfg.output_path) / "scripts")).save_last(
        _converted(tt.state, jstate), 0)
    configs = {}
    for side, cfg in (("jax", jcfg), ("port", tcfg)):
        path = base / side / "config.json"
        path.write_text(json.dumps(dict(SMALL, exp_name="scripts", root_dir=cfg.root_dir,
                                        output_path=cfg.output_path)))
        configs[side] = str(path)
    return base, configs


def test_render_sweep_renders_the_jax_scripts_frames(saved, monkeypatch):
    base, configs = saved
    captured = {}

    def capture(dirpath, rgbs, name):
        captured[name] = [np.asarray(r) for r in rgbs]
        return store_image(dirpath, rgbs, name)

    store_image = jartifacts.store_image
    monkeypatch.setattr(jartifacts, "store_image", capture)
    monkeypatch.chdir(base / "jax")
    monkeypatch.setattr(sys, "argv", ["render_sweep.py", "--config", configs["jax"],
                                      "--instance", "1", "--image_id", "2"])
    _jax_script("render_sweep").main()
    monkeypatch.chdir(base / "port")
    out = tsweep.main(["--config", configs["port"], "--instance", "1", "--image_id", "2"],
                      device="cpu")
    want = captured["sweep"]
    assert len(out["frames"]) == len(want) == 2 * 10 - 1
    for got, w in zip(out["frames"], want):
        np.testing.assert_allclose(got, w, atol=RGB_TOL)
    # the frames differ across the articulation codes
    assert np.abs(out["frames"][0] - out["frames"][-1]).max() > 1e-3
    jdir, tdir = (base / s / "ckpts" / "scripts" / "sweep" for s in ("jax", "port"))
    assert sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file()) == \
        sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    with pytest.raises(SystemExit, match="vanilla_autodecoder"):
        cfg = json.loads(Path(configs["port"]).read_text())
        vanilla = base / "vanilla.json"
        vanilla.write_text(json.dumps(dict(cfg, exp_type="vanilla")))
        tsweep.main(["--config", str(vanilla)], device="cpu")


def test_eval_per_instance_writes_the_jax_scripts_scores(saved, monkeypatch):
    base, configs = saved
    outs = {}
    for side in ("jax", "port"):
        monkeypatch.chdir(base / side)
        argv = ["--config", configs[side], "--ckpt_path", "last.ckpt"]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["eval_per_instance.py", *argv])
            _jax_script("eval_per_instance").main()
        else:
            tper.main(argv, device="cpu")
        outs[side] = json.loads((base / side / "ckpts" / "scripts" / "per_instance.json")
                                .read_text())
    got, want = outs["port"], outs["jax"]
    assert set(got) == set(want) == {"instances", "interp"}
    assert set(got["interp"]) == set(want["interp"])
    assert len(got["instances"]) == len(want["instances"]) == 2
    for g, w in zip(got["instances"], want["instances"]):
        assert set(g) == set(w) and g["instance"] == w["instance"] and g["id"] == w["id"]
        assert len(g["each"]) == 19
        np.testing.assert_allclose(g["each"], w["each"], atol=PSNR_TOL)
        for k in ("PSNR", "PSNR_obj"):
            assert abs(g[k] - w[k]) <= PSNR_TOL, k
        assert abs(g["SSIM"] - w["SSIM"]) <= SSIM_TOL
    for k in got["interp"]:
        assert abs(got["interp"][k] - want["interp"][k]) <= PSNR_TOL, k


def test_scripts_run_on_cuda_by_default(saved):
    import inspect

    for fn in (tsweep.main, tper.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA: the defaults run there")
    _, configs = saved
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.main(["--config", configs["port"]])
    with pytest.raises(RuntimeError, match="CUDA"):
        tper.main(["--config", configs["port"]])


def test_quality_run_splits_the_committed_sweeps_by_code(capsys):
    from aon_tpu_torch.scripts import quality_run

    jax_results = REPO / "ckpts/laptop_autodec_24k_aabb24/results.json"
    split = quality_run.sweep_split(jax_results)["sweep"]
    each = json.loads(jax_results.read_text())["PSNR"]["each"]
    assert len(each) == 19
    assert split["learned"] == pytest.approx(np.mean(each[::2]))
    assert split["interpolated"] == pytest.approx(np.mean(each[1::2]))
    assert split["learned"] == pytest.approx(32.784, abs=5e-4)
    port = REPO / "ckpts/torch_laptop_autodec_24k_aabb24/per_instance.json"
    per = quality_run.sweep_split(port)
    assert set(per) == {"laptop_0", "laptop_1"}
    # the run's own sweep scored laptop_1: the same frames as its per-instance row
    assert per["laptop_1"] == quality_run.sweep_split(port.with_name("results.json"))["sweep"]
    out = quality_run.main(["--sweep", str(jax_results), str(port)])
    assert json.loads(capsys.readouterr().out) == {str(jax_results): {"sweep": split},
                                                   str(port): per}
    assert out == {str(jax_results): {"sweep": split}, str(port): per}
