"""Port parity of the scripts that need no model: ``demo_sphere``,
``analyze_gt_ceiling`` and ``visualize_cameras`` of ``aon_tpu_torch/scripts``
against the JAX scripts of ``scripts/`` on the same inputs (CPU).

Tolerances, and why:
  * ``demo_sphere``: the coarse and fine composites and the coarse acc at
    24x32 with the JAX script's draws injected, 1e-5 (float32 compositing of
    the same samples in another order); the PNGs, each decoded, within one
    8-bit level (a value that rounds on either side of a level);
  * ``analyze_gt_ceiling``: every value of analysis.json, 1e-12 (the same
    float64 numpy on the same pixels; the images read without PIL);
  * ``visualize_cameras``: ``load_poses`` at atol 0 on both layouts; the
    segments against the lines that the JAX script hands matplotlib (its
    figure captured at ``savefig``), 1e-6 (float32 poses in float64 lines);
    the PNG non-blank with every camera centre's pixel drawn black.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX scripts import it)
import jax.numpy as jnp
import matplotlib
import matplotlib.colors
import matplotlib.figure
import numpy as np
import pytest
import torch
from PIL import Image

from aon_tpu_torch.scripts import analyze_gt_ceiling, demo_sphere, make_fixture_dataset
from aon_tpu_torch.scripts import visualize_cameras
from aon_tpu_torch.utils.imageio import read_png

REPO = Path(__file__).resolve().parent.parent
matplotlib.use("Agg")


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ demo_sphere


def test_demo_sphere_matches_the_jax_script_under_its_draws(tmp_path, monkeypatch, capsys):
    H, W = 24, 32
    mod = jax_script("demo_sphere")
    composites = []
    render = mod.volumetric_rendering

    def recording(*args, **kwargs):
        out = render(*args, **kwargs)
        composites.append([np.asarray(v) for v in out])
        return out

    monkeypatch.setattr(mod, "volumetric_rendering", recording)
    monkeypatch.setattr(sys, "argv", ["demo_sphere.py", "--out", str(tmp_path / "jax.png"),
                                      "--hw", str(H), str(W)])
    mod.main()
    jax_lines = capsys.readouterr().out.splitlines()

    key = jax.random.PRNGKey(0)  # the JAX script's one key, for both levels
    draws = {"t_rand": np.array(jax.random.uniform(key, (H * W, 65), dtype=jnp.float32)),
             "u": np.array(jax.random.uniform(key, (H * W, 128), dtype=jnp.float32))}
    got = demo_sphere.main(["--out", str(tmp_path / "port.png"), "--hw", str(H), str(W)],
                           device="cpu", draws={k: torch.from_numpy(v) for k, v in draws.items()})
    port_lines = capsys.readouterr().out.splitlines()

    (comp, acc, _, _), (comp2, acc2, _, _) = composites
    np.testing.assert_allclose(got["comp"], comp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["acc"], acc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["comp2"], comp2, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["acc2"], acc2, rtol=0, atol=1e-5)
    want_png = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"), np.int16)
    got_png = read_png(tmp_path / "port.png").astype(np.int16)
    assert got_png.shape == want_png.shape == (H, W, 3)
    assert np.abs(got_png - want_png).max() <= 1
    assert got_png.min() < 128  # the red disk is there
    assert [ln.split()[0] for ln in port_lines] == [ln.split()[0] for ln in jax_lines]
    assert port_lines[-1] == "probe zero-weight sample_pdf: finite+sorted OK"


def test_demo_sphere_probe_stays_finite_and_sorted(tmp_path):
    got = demo_sphere.main(["--out", str(tmp_path / "s.png"), "--hw", "12", "16"], device="cpu")
    assert np.isfinite(got["probe_t"]).all() and (np.diff(got["probe_t"], axis=-1) >= 0).all()
    assert got["probe_t"].shape == (12 * 16, 65 + 128)


def test_host_scripts_need_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: demo_sphere.main(["--out", str(tmp_path / "s.png")]),
                 lambda: visualize_cameras.main([str(tmp_path)]),
                 lambda: analyze_gt_ceiling.main(["--lo", "a", "--hi", "b", "--out", "c"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------------------------ analyze_gt_ceiling


def _write_split(root: Path, wh, seed: int, frames, seg: bool):
    g = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True)
    if seg:
        (root / "seg").mkdir(parents=True)
    for i, name in enumerate(frames):
        w, h = wh
        rgba = g.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
        Image.fromarray(rgba, "RGBA").save(root / "rgb" / name)
        if seg:
            mask = np.zeros((h, w), np.uint8)
            mask[h // 4: 3 * h // 4, w // 4 + i: 3 * w // 4] = 255
            mask[2, 3] = 7  # a lone pixel: all edge
            Image.fromarray(mask, "L").save(root / "seg" / name)


def test_analyze_gt_ceiling_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    frames = [f"r_{i}.png" for i in range(3)]
    _write_split(tmp_path / "lo", (32, 24), 0, frames, seg=True)
    _write_split(tmp_path / "hi", (64, 48), 1, frames, seg=False)
    common = ["--lo", str(tmp_path / "lo"), "--hi", str(tmp_path / "hi")]
    monkeypatch.setattr(sys, "argv", ["analyze_gt_ceiling.py", *common,
                                      "--out", str(tmp_path / "jax" / "analysis.json")])
    jax_script("analyze_gt_ceiling").main()
    jax_out = capsys.readouterr().out
    got = analyze_gt_ceiling.main([*common, "--out", str(tmp_path / "port" / "analysis.json")],
                                  device="cpu")
    port_out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax" / "analysis.json").read_text())
    assert json.loads((tmp_path / "port" / "analysis.json").read_text()) == json.loads(
        json.dumps(got))
    assert set(got) == set(want) and got["method"] == want["method"]
    for k in ("psnr_obj_ceiling_mean", "psnr_full_mean", "obj_pixels_mean", "edge_fraction_mean"):
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert len(got["frames"]) == len(want["frames"]) == 3
    for g_row, w_row in zip(got["frames"], want["frames"]):
        assert set(g_row) == set(w_row) and g_row["frame"] == w_row["frame"]
        assert g_row["obj_pixels"] == w_row["obj_pixels"]
        for k in ("psnr_obj_ceiling", "psnr_full", "edge_fraction"):
            assert abs(g_row[k] - w_row[k]) <= 1e-12, k
    assert port_out.splitlines()[-1].replace(str(tmp_path / "port"), "") == \
        jax_out.splitlines()[-1].replace(str(tmp_path / "jax"), "")


# ------------------------------------------------------- visualize_cameras


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    base = tmp_path_factory.mktemp("cams")
    make_fixture_dataset.main([str(base / "single"), "--n", "3", "--wh", "64", "48"])
    make_fixture_dataset.main([str(base / "multi"), "--multi", "--n", "3", "--wh", "64", "48"])
    return base


@pytest.mark.parametrize("layout", ["split", "instance"])
def test_visualize_cameras_matches_the_jax_script(fixtures, tmp_path, monkeypatch, layout):
    mod = jax_script("visualize_cameras")
    if layout == "split":
        root, kw = fixtures / "single", dict(split="train")
    else:
        root = fixtures / "multi"
        kw = dict(split="train", instance=sorted(p.name for p in root.iterdir())[0], degree=0)
    want = mod.load_poses(str(root), **kw)
    poses = visualize_cameras.load_poses(str(root), **kw)
    assert poses.dtype == want.dtype and np.array_equal(poses, want)

    figures = []
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, *a, **k: figures.append(self))
    mod.plot_cameras(want, str(tmp_path / "jax.png"))
    ax = figures[0].axes[0]
    starts, ends, colors, dashed = visualize_cameras.camera_segments(poses)
    assert len(ax.lines) == len(starts) == 4 * len(poses)
    for line, a, b, c, d in zip(ax.lines, starts, ends, colors, dashed):
        xyz = np.stack(line.get_data_3d(), axis=-1)
        np.testing.assert_allclose(xyz, np.stack([a, b]), rtol=0, atol=1e-6)
        assert matplotlib.colors.to_rgba(line.get_color()) == matplotlib.colors.to_rgba(c)
        assert (line.get_linestyle() == "--") == bool(d)
    lim = visualize_cameras.plot_limit(poses)
    for get in (ax.get_xlim, ax.get_ylim, ax.get_zlim):
        np.testing.assert_allclose(get(), (-lim, lim), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(ax.collections[0]._offsets3d, -1), poses[:, :3, 3],
                               rtol=0, atol=1e-6)

    out = tmp_path / "port.png"
    visualize_cameras.main([str(root), *(["--instance", kw["instance"]] if "instance" in kw
                                         else []), "--out", str(out)], device="cpu")
    img = read_png(out)
    assert img.shape == (visualize_cameras.IMAGE_SIZE, visualize_cameras.IMAGE_SIZE, 3)
    assert (img != 255).any(axis=-1).sum() > 1000
    px = np.rint(visualize_cameras.project(poses[:, :3, 3], lim)).astype(int)
    assert (img[px[:, 1], px[:, 0]] == 0).all()


def test_card_name_and_device_idle_on_the_cpu():
    from aon_tpu_torch.utils.device import card_name
    from aon_tpu_torch.utils.profiling import device_idle

    assert card_name("cpu") == "cpu"
    with device_idle("cpu") as window:
        torch.ones(8).sum()
    assert window["window_ms"] > 0
    assert window["device_busy_ms"] is None and window["device_idle_share"] is None
