"""Port parity, the trainer slice: ``aon_tpu_torch.train.trainer.Trainer``,
``aon_tpu_torch.run``, the metric sinks and logger, the eval artifacts and
the val grid against the JAX package on the same fixture (CPU, float32).

Tolerances, and why:
  * the ray stream after a resume, the sinks' bytes, the val grid,
    results.json and the file layout: exact;
  * one ``fit`` step from the same converted init params with the JAX
    trainer's draws injected: the step tolerances of
    test_torch_train_step.py (loss 1e-5 relative; each parameter within two
    Adam steps of the JAX one, 2 lr, and within 2% of one where its gradient
    is well clear of zero);
  * ``validate`` and ``test`` from one converted state: PSNR 1e-3 dB (float32
    renders whose sums run in another order move a pixel by ~1e-6) and SSIM
    1e-5 (test_torch_core.py's);
  * the eval jpgs: PIL's decode of the port's file against PIL's decode of the
    JAX trainer's, PSNR >= 30 dB (two JPEG encoders, test_torch_data.py).
"""

import importlib.util
import json
import os
import shutil
import struct
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from aon_tpu.data import sapien as jsapien  # noqa: E402
from aon_tpu.eval import artifacts as jartifacts  # noqa: E402
from aon_tpu.train import logging as jlogging  # noqa: E402
from aon_tpu.train import sinks as jsinks  # noqa: E402
from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu.utils import viz as jviz  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch import run as trun  # noqa: E402
from aon_tpu_torch.core import sampling as tsampling  # noqa: E402
from aon_tpu_torch.data import sapien as tsapien  # noqa: E402
from aon_tpu_torch.eval import artifacts as tartifacts  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.train import logging as tlogging  # noqa: E402
from aon_tpu_torch.train import sinks as tsinks  # noqa: E402
from aon_tpu_torch.train import trainer as ttrainer  # noqa: E402
from aon_tpu_torch.train.systems import TrainState  # noqa: E402
from aon_tpu_torch.utils import viz as tviz  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WH = (64, 48)
SMALL = dict(dataset_name="sapien", exp_type="vanilla", img_wh=list(WH), white_back=True,
             use_aabb=True, N_samples=4, N_importance=4, batch_size=64, compute_dtype="float32",
             chunk=512, num_epochs=1, run_max_steps=1, steps_per_dispatch=1,
             log_every_n_steps=1, limit_val_batches=1, save_top_k=2, ckpt_every_n_epochs=1)
JPEG_PSNR = 30.0


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_fixture") / "data"
    tfixture.main([str(root), "--n", "3", "--wh", str(WH[0]), str(WH[1]), "--seed", "1"])
    return root


def _configs(fixture_root, base: Path, **overrides):
    """(JAX Config, port Config) on separate copies of the fixture."""
    out = []
    for cls, side in ((JaxConfig, "jax"), (Config, "port")):
        root = base / side / "data"
        if not root.exists():
            shutil.copytree(fixture_root, root)
        kw = dict(SMALL, exp_name="trainer", root_dir=str(root),
                  output_path=str(base / side / "results"))
        out.append(cls(**dict(kw, **overrides)))
    return out


@pytest.fixture(scope="module")
def trainers(fixture_root, tmp_path_factory):
    """A JAX and a port Trainer on the same fixture, the port's state set to
    the JAX one's converted init params."""
    jcfg, tcfg = _configs(fixture_root, tmp_path_factory.mktemp("trainers"))
    jt = jtrainer.Trainer(jcfg)
    tt = ttrainer.Trainer(tcfg, device="cpu")
    # the port's Trainer initialises from the JAX trainer's init key: the same
    # xavier-uniform draws, bit for bit
    want = _converted(tt.state, jt.state)
    assert set(tt.state.params) == set(want.params)
    for k, v in want.params.items():
        assert torch.equal(tt.state.params[k], v), k
    return jt, tt


def _converted(tstate, jstate):
    params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    return TrainState(step=int(jstate.step), params=params, mu=tstate.tx.init(params)[0],
                      nu=tstate.tx.init(params)[1], tx=tstate.tx)


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


def _records(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def _psnr8(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


# ---------------------------------------------------------------- trainer


@pytest.mark.parametrize("step", [0, 37])
def test_train_iterator_after_resume_matches_jax(trainers, step):
    jt, tt = trainers
    jt.global_step = tt.global_step = step
    jit, tit = jt._train_iterator(), tt._train_iterator()
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert set(tb) == set(jb) == {"rays_o", "rays_d", "viewdirs", "target", "t_near", "t_far"}
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tt._steps_per_epoch() == jt._steps_per_epoch() > 0
    jt.global_step = tt.global_step = 0


def test_step_generators_are_fixed_by_seed_and_step(trainers):
    # the dispatch at step s draws from fold_in(base_key, s), the JAX trainer's key
    jt, tt = trainers
    for s in (0, 8, 2**20):
        np.testing.assert_array_equal(np.asarray(tt.step_key(s)).astype(np.uint32),
                                      np.asarray(jax.random.fold_in(jt.base_key, s)))
    assert not torch.equal(tt.step_key(0), tt.step_key(8))


def test_fit_one_step_matches_jax(trainers, monkeypatch):
    jt, tt = trainers
    cfg = tt.cfg
    B, n_c, n_f = cfg.batch_size, cfg.N_samples, cfg.N_importance
    # the JAX trainer's key of step 0 and the draws VanillaNeRF takes from it:
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

    jrec, trec = (_records(Path(c.output_path) / c.exp_name / "metrics.jsonl")
                  for c in (jt.cfg, cfg))
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    for jr, tr in zip(jrec, trec):
        assert tr["step"] == jr["step"]
        for k in ("train/loss", "train/psnr0", "train/psnr1", "train/lr"):
            if k in jr:
                np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, err_msg=k)

    lr = float(tt.system.lr_schedule(0))
    want = params_from_flax(jax.tree.map(np.asarray, jt.state.params))
    grads = params_from_flax(jax.tree.map(lambda m: 10.0 * np.asarray(m),
                                          jt.state.opt_state[0].mu))
    for k, w in want.items():
        assert (tt.state.params[k] - start.params[k]).abs().max().item() > 0, k
        diff = (tt.state.params[k] - w).abs()
        big = grads[k].abs() > 0.1 * grads[k].abs().max()
        assert diff.max().item() <= 2 * lr, k
        assert diff[big].max().item() <= 0.02 * lr, k
    jidx, tidx = (json.loads((Path(c.output_path) / c.exp_name / "index.json").read_text())
                  for c in (jt.cfg, cfg))
    assert tidx["last"] == jidx["last"] == {"name": "last.ckpt", "epoch": 0, "step": 1}
    assert [r["name"] for r in tidx["ranked"]] == [r["name"] for r in jidx["ranked"]]


def test_validate_and_test_match_jax_from_one_converted_state(trainers, tmp_path, monkeypatch):
    jt, tt = trainers
    tt.state = _converted(tt.state, jt.state)
    jv, tv = jt.validate(0), tt.validate(0)
    assert abs(tv - jv) <= 1e-3 and np.isfinite(tv)
    results = {}
    for side, tr, mod in (("jax", jt, jsapien), ("port", tt, tsapien)):
        tr.test_dataset = mod.SapienDataset(tr.cfg.root_dir, "test_val", WH,
                                            eval_inference="render", use_aabb=True)
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        results[side] = tr.test(ckpt_name="absent.ckpt")  # the current params
    for k in ("test/psnr", "test/psnr_obj"):
        assert abs(results["port"][k] - results["jax"][k]) <= 1e-3, k
    assert abs(results["port"]["test/ssim"] - results["jax"]["test/ssim"]) <= 1e-5
    assert results["port"]["test/lpips"] is results["jax"]["test/lpips"] is None
    jdir, tdir = (tmp_path / s / "ckpts" for s in ("jax", "port"))
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".jpg":
            assert _psnr8(Image.open(tdir / rel), Image.open(jdir / rel)) >= JPEG_PSNR, rel
    jres = json.loads(next(jdir.rglob("results.json")).read_text())
    tres = json.loads(next(tdir.rglob("results.json")).read_text())
    assert set(tres) == set(jres) == {"PSNR", "SSIM", "PSNR_obj"}
    for name in tres:
        assert set(tres[name]) == set(jres[name])
        np.testing.assert_allclose(tres[name]["each"], jres[name]["each"], atol=1e-3)


def _jax_run():
    spec = importlib.util.spec_from_file_location("jax_run_py", REPO / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(base: Path):
    """The files under ``base``, with each checkpoint directory as one entry
    (the JAX package writes orbax trees, the port one torch.save file)."""
    out = set()
    for p in base.rglob("*"):
        rel = p.relative_to(base)
        ckpt = next((i for i, part in enumerate(rel.parts) if part.endswith(".ckpt")), None)
        if ckpt is not None:
            out.add(Path(*rel.parts[:ckpt + 1]))
        elif p.is_file():
            out.add(rel)
    return out


def test_cli_fit_then_eval_writes_the_jax_cli_outputs(fixture_root, tmp_path, monkeypatch):
    jcfg, tcfg = _configs(fixture_root, tmp_path, run_max_steps=4, steps_per_dispatch=2,
                          use_occgrid=True, occgrid_res=32, exp_name="cli")
    jrun = _jax_run()
    for side, cfg, main in (("jax", jcfg, jrun.main),
                            ("port", tcfg, lambda c: trun.main(c, device="cpu"))):
        cfg.exp_name, cfg.output_path = "cli", "results"
        monkeypatch.chdir(tmp_path / side)
        main(cfg)
        cfg.run_eval, cfg.render_name = True, "testren"
        main(cfg)
    jtree = _tree(tmp_path / "jax" / "results") | _tree(tmp_path / "jax" / "ckpts")
    ttree = _tree(tmp_path / "port" / "results") | _tree(tmp_path / "port" / "ckpts")
    assert ttree == jtree
    assert {Path("cli/last.ckpt"), Path("cli/results.json"), Path("cli/metrics.jsonl"),
            Path("cli/testren/image000.jpg")} <= ttree
    jrec, trec = (_records(tmp_path / s / "results" / "cli" / "metrics.jsonl")
                  for s in ("jax", "port"))
    assert [(r["step"], sorted(r)) for r in trec] == [(r["step"], sorted(r)) for r in jrec]
    res = json.loads((tmp_path / "port" / "ckpts" / "cli" / "results.json").read_text())
    assert np.isfinite(res["PSNR"]["mean"]) and np.isfinite(res["SSIM"]["mean"])


def test_unported_datasets_and_systems_raise(fixture_root, tmp_path):
    # every system is ported: the auto-encoder builds on a dataset
    cfg = Config(**dict(SMALL, exp_type="vanilla_ae_art", root_dir=str(fixture_root),
                        output_path=str(tmp_path)))
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert type(tr.system).__name__ == "AutoEncoderSystem"
    assert any(k.startswith("encoder.") for k in tr.state.params)
    # what it refuses, as the JAX trainer does: object-ray oversampling
    with pytest.raises(ValueError, match="obj_ray_oversample"):
        ttrainer.Trainer(Config(exp_type="vanilla_ae_art", dataset_name="sapien_multi",
                                obj_ray_oversample=0.5, output_path=str(tmp_path)), device="cpu")


# ------------------------------------------------------------- sentinels

SENTINEL_RUNS = {
    "collapse": ([20.0, 21.0, 21.0, 21.0, 21.0], dict(limit=3)),
    "healthy": ([20.0, 21.0, 22.0, 23.0], dict(limit=3)),
    "plateau": ([10.0, 10.1, 10.1, 10.2, 10.2], dict(epochs=2)),
    "plateau_abort": ([10.0, 10.1, 10.1, 10.2, 10.2], dict(epochs=2, abort=True)),
    "above_floor": ([30.0, 30.0, 30.0, 30.0], dict(epochs=2)),
}


def _sentinel_outcome(mod, kind, values, kw):
    sentinel = (mod.CollapseSentinel(**kw) if kind in ("collapse", "healthy")
                else mod.PlateauSentinel(**kw))
    try:
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i, v in enumerate(values):
                sentinel.update(v, 100 * i)
        return ("warned", len(caught)) if caught else ("ok", 0)
    except (mod.TrainingCollapsed, mod.TrainingPlateaued) as e:
        return (type(e).__name__, str(e).split(" at step ")[0][:40])


@pytest.mark.parametrize("kind", list(SENTINEL_RUNS))
def test_sentinels_behave_as_jax(kind):
    values, kw = SENTINEL_RUNS[kind]
    assert _sentinel_outcome(ttrainer, kind, values, kw) == \
        _sentinel_outcome(jtrainer, kind, values, kw)


# ------------------------------------------------------ sinks and logging


def test_crc32c_known_vectors():
    assert tsinks._crc32c(b"") == 0
    assert tsinks._crc32c(b"123456789") == 0xE3069283
    assert tsinks._crc32c(bytes(32)) == 0x8A9136AA
    for data in (b"", b"abc", bytes(range(256))):
        assert tsinks._masked_crc(data) == jsinks._masked_crc(data)


def test_tensorboard_records_are_the_jax_sinks_bytes(tmp_path):
    for kw in (dict(file_version="brain.Event:2"),
               dict(scalars={"train/loss": 0.5, "val/psnr": 30.25})):
        assert tsinks._pb_event(1234.5, 7, **kw) == jsinks._pb_event(1234.5, 7, **kw)
    sink = tsinks.TensorBoardSink(str(tmp_path))
    sink.log_scalars(3, {"step": 3, "time": 0.1, "x": 1.5, "note": "skip"})
    sink.close()
    data = Path(sink.path).read_bytes()
    records, pos = [], 0
    while pos < len(data):
        (n,) = struct.unpack("<Q", data[pos:pos + 8])
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == jsinks._masked_crc(data[pos:pos + 8])
        payload = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == \
            jsinks._masked_crc(payload)
        records.append(payload)
        pos += 16 + n
    assert len(records) == 2 and records[1][9:] == jsinks._pb_event(0.0, 3, scalars={"x": 1.5})[9:]


def test_tensorboard_sink_readable_by_the_real_loader(tmp_path):
    loader = pytest.importorskip("tensorboard.backend.event_processing.event_file_loader")
    logger = tlogging.MetricLogger(str(tmp_path), sinks=["jsonl", "tensorboard"])
    logger.log(10, {"train/loss": 0.5, "train/psnr1": 21.25})
    logger.close()
    events = list(loader.EventFileLoader(str(next((tmp_path / "tb").glob("events.*")))).Load())
    assert events[0].file_version == "brain.Event:2"
    v = events[1].summary.value
    got = {x.tag: (x.tensor.float_val[0] if x.tensor.float_val else x.simple_value) for x in v}
    assert got == pytest.approx({"train/loss": 0.5, "train/psnr1": 21.25})


def test_registry_and_custom_sink(tmp_path):
    seen = []

    class Capture(tsinks.Sink):
        def __init__(self, logdir):
            pass

        def log_scalars(self, step, rec):
            seen.append((step, rec.get("x")))

    tsinks.register_sink("capture", Capture)
    logger = tlogging.MetricLogger(str(tmp_path), sinks=["capture"])
    logger.log(3, {"x": 1.5})
    assert seen == [(3, 1.5)]
    with pytest.raises(ValueError, match="unknown metric sink"):
        tsinks.make_sink("nope", str(tmp_path))
    assert isinstance(tsinks.make_sink("wandb", str(tmp_path)), tsinks.WandbSink)


def test_metric_logger_writes_the_jax_loggers_records_and_image(tmp_path, rng):
    image = rng.uniform(-0.1, 1.1, (12, 16, 3)).astype(np.float32)
    paths = {}
    for side, mod in (("jax", jlogging), ("port", tlogging)):
        logger = mod.MetricLogger(str(tmp_path / side), stdout_every=5)
        logger.log(5, {"train/loss": np.float32(0.25), "epoch": 1}, force_stdout=True)
        paths[side] = logger.log_image(5, "val/GT_pred_rgb", image, str(tmp_path / side))
        logger.close()
    assert Path(paths["port"]).relative_to(tmp_path / "port") == \
        Path(paths["jax"]).relative_to(tmp_path / "jax")
    np.testing.assert_array_equal(np.asarray(Image.open(paths["port"])),
                                  np.asarray(Image.open(paths["jax"])))
    jrec, trec = (_records(tmp_path / s / "metrics.jsonl") for s in ("jax", "port"))
    assert [{k: v for k, v in r.items() if k != "time"} for r in trec] == \
        [{k: v for k, v in r.items() if k != "time"} for r in jrec]


# ------------------------------------------------------ artifacts and viz


def test_artifacts_match_the_jax_writers(tmp_path, rng):
    yy, xx = np.mgrid[:24, :32]
    rgbs = [np.stack([xx / 32, yy / 24, (xx + yy) / 56], -1) + rng.normal(0, 0.02, (24, 32, 3))
            for _ in range(2)]
    depths = [2.0 + xx / 16 + rng.uniform(0, 0.1, (24, 32)) for _ in range(2)]
    stats = ({"name": "PSNR", "mean": np.float32(30.5), "test": 30.5, "each": [30.0, 31.0]},
             None, {"name": "SSIM", "mean": 0.9, "test": 0.9, "each": [0.8, None]})
    for side, mod in (("jax", jartifacts), ("port", tartifacts)):
        mod.store_image(str(tmp_path / side), rgbs, "image")
        mod.store_depth_img(str(tmp_path / side), depths, "depth")
        mod.store_depth_raw(str(tmp_path / side / "raw"), depths, "depth")
        mod.write_stats(str(tmp_path / side / "results.json"), *stats, extra={"k": "v"})
    assert (tmp_path / "port" / "results.json").read_bytes() == \
        (tmp_path / "jax" / "results.json").read_bytes()
    for name in ("image000.jpg", "image001.jpg", "depth000.jpg", "depth001.jpg"):
        got, want = (np.asarray(Image.open(tmp_path / s / name)) for s in ("port", "jax"))
        assert got.shape == want.shape and _psnr8(got, want) >= JPEG_PSNR, name
    for name in ("depth000.npz", "depth001.npz"):
        with np.load(tmp_path / "port" / "raw" / name) as a, \
                np.load(tmp_path / "jax" / "raw" / name) as b:
            np.testing.assert_array_equal(a["arr_0"], b["arr_0"])
    np.testing.assert_array_equal(tartifacts.to8b(rgbs[0]), jartifacts.to8b(rgbs[0]))


def test_store_video_writes_what_the_jax_writer_writes(tmp_path, rng):
    frames = [rng.uniform(size=(16, 16, 3)) for _ in range(3)]
    outs = {}
    for side, mod in (("jax", jartifacts), ("port", tartifacts)):
        outs[side] = mod.store_video(str(tmp_path / side), frames)
    assert (outs["port"] is None) == (outs["jax"] is None)
    assert sorted(p.name for p in (tmp_path / "port" / "videos").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax" / "videos").iterdir())


@pytest.mark.parametrize("with_depth,with_acc", [(True, True), (True, False), (False, False)])
def test_val_grid_matches_jax(rng, with_depth, with_acc):
    pytest.importorskip("cv2")  # the JAX grid colours depth through cv2 where it imports
    n = 12 * 16
    args = [rng.uniform(size=(n, 3)), rng.uniform(-0.1, 1.1, (n, 3)),
            rng.uniform(2, 6, n) if with_depth else None,
            rng.uniform(size=n) if with_acc else None]
    got = tviz.val_grid((16, 12), *args)
    want = jviz.val_grid((16, 12), *args)
    assert got.shape == want.shape == (12, 16 * (2 + with_depth + with_acc), 3)
    np.testing.assert_array_equal(got, want)


def test_cli_and_trainer_run_on_cuda_by_default(fixture_root, tmp_path):
    import inspect

    assert inspect.signature(trun.main).parameters["device"].default == "cuda"
    assert inspect.signature(ttrainer.Trainer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA: the defaults run there")
    _, tcfg = _configs(fixture_root, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(tcfg)


def test_quality_run_compares_the_committed_curves_at_equal_steps():
    from aon_tpu_torch.scripts import quality_run

    rows = quality_run.compare(REPO / "results/torch_laptop_vanilla_refsched_occ16/metrics.jsonl",
                               REPO / "results/laptop_vanilla_refsched_occ16/metrics.jsonl")
    steps = [r[0] for r in rows]
    assert len(rows) == 67 and steps[0] == 1503 and steps[-1] == 100000
    assert all(s % 1503 == 0 for s in steps[:-1])
    by_step = {r[0]: r for r in rows}
    assert by_step[25551][2] == pytest.approx(40.21, abs=5e-3)  # the JAX curve's
    assert all(abs(r[1] - r[2] - r[3]) < 1e-12 for r in rows)


def test_quality_run_main_prints_the_comparison(capsys):
    from aon_tpu_torch.scripts import quality_run

    port = REPO / "results/torch_laptop_vanilla_refsched_occ16/metrics.jsonl"
    rows = quality_run.main([str(port), "--reference",
                             str(REPO / "results/laptop_vanilla_refsched_occ16/metrics.jsonl")])
    assert json.loads(capsys.readouterr().out) == rows
    assert rows == quality_run.compare(port, REPO / quality_run.REFERENCE)


def test_quality_run_recipe_sets_each_segment_and_the_whole_runs_horizon(tmp_path):
    """The segment recipe in quality_run's docstring: a config copy holds the
    segment's end, the whole run's LR horizon, the output path and the seed,
    and --ckpt_path, absent from the JSON, reaches the config."""
    from aon_tpu_torch.train.optim import make_optimizer
    from aon_tpu_torch.train.schedule import nerf_lr_schedule
    from aon_tpu_torch.utils.config import get_config as tget_config

    c = json.loads((REPO / "configs/quality_laptop_vanilla_refsched_occ16.json").read_text())
    c.update(run_max_steps=25551, lr_max_steps=100000, output_path=str(tmp_path), seed=1)
    path = tmp_path / "quality.json"
    path.write_text(json.dumps(c))
    cfg = tget_config(["--config", str(path), "--ckpt_path", "last.ckpt"])
    assert (cfg.run_max_steps, cfg.lr_max_steps, cfg.seed, cfg.ckpt_path) == (
        25551, 100000, 1, "last.ckpt")
    whole = nerf_lr_schedule(max_steps=100000)
    _, schedule = make_optimizer(cfg)
    assert [schedule(s) for s in (0, 1503, 25551)] == [whole(s) for s in (0, 1503, 25551)]
