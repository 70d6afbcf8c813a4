"""The port's LPIPS (``aon_tpu_torch/eval/lpips.py``, ``eval/metrics.py::lpips``,
``Trainer.test``'s ``test/lpips``) and its synthetic-weights script against
the JAX package, on the CPU in float32.

Tolerances, and why:
  * the synthetic weights of the two scripts from one seed: exact;
  * LPIPS of one pair of 64x48 images on those weights: rtol 1e-5 (float32
    convolutions whose sums run in another order; TF32 is off, and the CPU
    has none);
  * ``Trainer.test`` from one converted state (tests/test_torch_trainer.py's
    harness): ``test/lpips`` and the per-frame LPIPS of results.json
    rtol 1e-4, since the two renders already differ by ~1e-6 a pixel
    (that file's PSNR tolerance); the keys of results.json and its
    ``"lpips_weights"`` label: exact.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.data import sapien as jsapien  # noqa: E402
from aon_tpu.eval import lpips as jlpips  # noqa: E402
from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu_torch.data import sapien as tsapien  # noqa: E402
from aon_tpu_torch.eval import lpips as tlpips  # noqa: E402
from aon_tpu_torch.eval import metrics as tmetrics  # noqa: E402
from aon_tpu_torch.scripts import make_synthetic_lpips_weights as tsynth  # noqa: E402
from aon_tpu_torch.train import trainer as ttrainer  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_trainer import WH, _configs, _converted, fixture_root  # noqa: E402, F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_loaders():
    """Both packages cache their LPIPS modules; each test reads its own file."""
    jlpips.lpips_fn.cache_clear()
    tlpips._load.cache_clear()
    yield
    jlpips.lpips_fn.cache_clear()
    tlpips._load.cache_clear()


@pytest.fixture(scope="module")
def synthetic_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.synthetic.npz"
    tsynth.main(["--out", str(path)])
    return path


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_lpips_weights", REPO / "scripts" / "make_synthetic_lpips_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_weights_are_the_jax_scripts(synthetic_npz, tmp_path, monkeypatch):
    want_path = tmp_path / "jax.npz"
    monkeypatch.setattr(sys, "argv", ["make_synthetic_lpips_weights.py", "--out", str(want_path)])
    _jax_script().main()
    with np.load(synthetic_npz) as got, np.load(want_path) as want:
        assert set(got.files) == set(want.files)
        assert {"__synthetic__", "conv0_w", "conv12_b", "lin4_w"} <= set(got.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lpips_matches_jax_on_synthetic_weights(synthetic_npz, monkeypatch, rng):
    monkeypatch.setenv("AON_LPIPS_WEIGHTS", str(synthetic_npz))
    w, h = 64, 48
    pred = rng.uniform(-0.1, 1.1, size=(h, w, 3)).astype(np.float32)  # clipped to [0, 1]
    gt = np.clip(pred + rng.normal(0, 0.1, size=pred.shape), 0, 1).astype(np.float32)
    want = jlpips.lpips_fn()(pred, gt)
    fn = tlpips.lpips_fn(device="cpu")
    assert isinstance(fn, torch.nn.Module) and fn.conv0_w.shape == (64, 3, 3, 3)  # OIHW
    got = float(fn(pred, gt))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0 and float(fn(gt, gt)) == 0.0
    np.testing.assert_allclose(tmetrics.lpips(pred, gt, device="cpu"), want, rtol=1e-5)
    assert tlpips.lpips_weights_kind() == jlpips.lpips_weights_kind() == "synthetic"


def test_weights_kind_and_null_without_weights(synthetic_npz, tmp_path, monkeypatch):
    pretrained = tmp_path / "pretrained.npz"
    with np.load(synthetic_npz) as data:
        np.savez(pretrained, **{k: data[k] for k in data.files if k != "__synthetic__"})
    monkeypatch.setenv("AON_LPIPS_WEIGHTS", str(pretrained))
    assert tlpips.lpips_weights_kind() == jlpips.lpips_weights_kind() == "pretrained"
    # no file under the variable nor at the default path (weights/ is
    # gitignored: a checkout holds no weights)
    monkeypatch.setenv("AON_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(tlpips, "DEFAULT_WEIGHTS", str(tmp_path / "absent_default.npz"))
    assert tlpips.lpips_weights_kind() is None
    assert tlpips.lpips_fn(device="cpu") is None
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.warns(UserWarning, match="LPIPS reported as null"):
        assert tmetrics.lpips(img, img, device="cpu") is None


def test_trainer_test_reports_lpips_as_jax(fixture_root, synthetic_npz, tmp_path, monkeypatch):
    monkeypatch.setenv("AON_LPIPS_WEIGHTS", str(synthetic_npz))
    jcfg, tcfg = _configs(fixture_root, tmp_path / "trainers")
    jt = jtrainer.Trainer(jcfg)
    tt = ttrainer.Trainer(tcfg, device="cpu")
    tt.state = _converted(tt.state, jt.state)
    results = {}
    for side, tr, mod in (("jax", jt, jsapien), ("port", tt, tsapien)):
        tr.test_dataset = mod.SapienDataset(tr.cfg.root_dir, "test_val", WH,
                                            eval_inference="render", use_aabb=True)
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        results[side] = tr.test(ckpt_name="absent.ckpt")  # the current params
    assert results["jax"]["test/lpips"] is not None
    np.testing.assert_allclose(results["port"]["test/lpips"], results["jax"]["test/lpips"],
                               rtol=1e-4)
    jres, tres = (json.loads(next((tmp_path / s / "ckpts").rglob("results.json")).read_text())
                  for s in ("jax", "port"))
    assert set(tres) == set(jres) == {"PSNR", "SSIM", "PSNR_obj", "LPIPS", "lpips_weights"}
    assert tres["lpips_weights"] == jres["lpips_weights"] == "synthetic"
    assert set(tres["LPIPS"]) == set(jres["LPIPS"])
    np.testing.assert_allclose(tres["LPIPS"]["each"], jres["LPIPS"]["each"], rtol=1e-4)
