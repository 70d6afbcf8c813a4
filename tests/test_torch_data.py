"""Port parity, the data slice: ``aon_tpu_torch.utils.imageio`` against PIL
and cv2, the port's fixture script against the JAX one, and
``aon_tpu_torch.data`` (``native``, ``aabb``, ``occgrid``, ``sapien``)
against the JAX package on the same fixture.

Tolerances, and why:
  * PNG decode, the LANCZOS and NEAREST resizes and the JET table: bit for
    bit (integer arithmetic, Pillow's own steps in Pillow's order);
  * JPEG: PIL's decode of the port's file against PIL's decode of PIL's own
    file, PSNR >= 30 dB on the fixture's frames (both quantise the same DCT
    with the same quality-75 tables, but subsample, transform and round
    differently); the port's decoder against PIL's on PIL's file, >= 30 dB
    (it upsamples the chroma by repetition, libjpeg by interpolation);
  * the fixture files, loaders, intervals, caches and batches: atol 0 (the
    same numpy operations in the same order).

Every loader comparison builds each package's datasets in its own copy of
the fixture: both packages cache bounds, grids and intervals in the dataset
directory under the same file names, so a shared copy would hand the second
loader the first one's results.
"""

import importlib.util
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from aon_tpu import native as jnative
from aon_tpu.data import aabb as jaabb
from aon_tpu.data import occgrid as jocc
from aon_tpu.data import sapien as jsapien
from aon_tpu_torch.core import prng
from aon_tpu_torch.data import aabb as taabb
from aon_tpu_torch.data import dataset_dict
from aon_tpu_torch.data import native as tnative
from aon_tpu_torch.data import occgrid as tocc
from aon_tpu_torch.data import sapien as tsapien
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture
from aon_tpu_torch.utils import imageio

REPO = Path(__file__).resolve().parent.parent
WH = (64, 48)
JPEG_PSNR = 30.0


def _jax_fixture_module():
    spec = importlib.util.spec_from_file_location(
        "jax_make_fixture_dataset", REPO / "scripts" / "make_fixture_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """One split written by each package's fixture script from the same seed,
    with segmentation maps: (JAX dir, port dir)."""
    root = tmp_path_factory.mktemp("fixture_split")
    jmod = _jax_fixture_module()
    jmod.write_split(root / "jax", 3, *WH, np.random.default_rng(4), deg=30.0, with_seg=True)
    tfixture.write_split(root / "port", 3, *WH, np.random.default_rng(4), deg=30.0,
                         with_seg=True)
    return root / "jax", root / "port"


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """A single-scene fixture (4 train, 2 val, 2 test frames at 64x48) written
    by the port's script."""
    root = tmp_path_factory.mktemp("fixture_single") / "data"
    tfixture.main([str(root), "--n", "4", "--wh", str(WH[0]), str(WH[1]), "--seed", "2"])
    return root


def _copy(root, dest):
    shutil.copytree(root, dest)
    return dest


def _pil(path):
    return np.asarray(Image.open(path))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


# ------------------------------------------------------------------ imageio


@pytest.mark.parametrize("kind", ["rgb", "seg", "depth"])
def test_png_decode_matches_pil_on_the_jax_fixture_files(written, kind):
    files = sorted((written[0] / kind).glob("*.png"))
    assert len(files) == 3
    for f in files:
        got, want = imageio.read_png(f), _pil(f)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb", "seg", "depth"])
def test_port_fixture_writes_the_jax_fixture_pixels(written, kind):
    jdir, tdir = written
    for f in sorted((jdir / kind).glob("*.png")):
        want, got = _pil(f), _pil(tdir / kind / f.name)  # PIL reads the port's PNGs
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (json.loads((tdir / "transforms.json").read_text())
            == json.loads((jdir / "transforms.json").read_text()))


def test_port_fixture_script_writes_the_jax_script_tree(tmp_path):
    jmod = _jax_fixture_module()
    for mod, side in ((jmod, "jax"), (tfixture, "port")):
        for split, n in (("train", 2), ("val", 2), ("test", 2)):
            mod.write_split(tmp_path / side / split, n, 32, 24, np.random.default_rng(9))
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".png":
            np.testing.assert_array_equal(_pil(tmp_path / "port" / rel),
                                          _pil(tmp_path / "jax" / rel))
        else:
            assert (json.loads((tmp_path / "port" / rel).read_text())
                    == json.loads((tmp_path / "jax" / rel).read_text()))


def test_png_encode_round_trips_through_pil(rng):
    images = [rng.integers(0, 256, (9, 13, c), dtype=np.uint8) for c in (1, 2, 3, 4)]
    images += [rng.integers(0, 256, (9, 13), dtype=np.uint8),
               rng.integers(0, 65536, (9, 13), dtype=np.uint16)]
    for img in images:
        back = np.asarray(Image.open(io.BytesIO(imageio.encode_png(img))))
        np.testing.assert_array_equal(back, img.reshape(back.shape))
        np.testing.assert_array_equal(imageio.decode_png(imageio.encode_png(img)),
                                      img.reshape(back.shape))


def _smooth_rgba(rng, w, h):
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 4) % 256, (yy * 5) % 256, ((xx + yy) * 3) % 256,
                    np.where((xx - w / 2) ** 2 + (yy - h / 2) ** 2 < w * h / 8, 255, 0)], -1)
    img = img + rng.integers(0, 12, img.shape)
    img[..., 3] = np.where(rng.uniform(size=(h, w)) < 0.2, rng.integers(0, 256, (h, w)),
                           img[..., 3])
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("size", [(32, 24), (40, 18)], ids=["half", "uneven"])
@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_lanczos_resize_matches_pil(rng, size, mode):
    img = _smooth_rgba(rng, 64, 48)
    img = {"RGBA": img, "RGB": img[..., :3].copy(), "L": img[..., 0].copy()}[mode]
    want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(imageio.resize_lanczos(img, size), want)


@pytest.mark.parametrize("size", [(32, 24), (40, 18)], ids=["half", "uneven"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
def test_nearest_resize_matches_pil(rng, size, dtype):
    img = rng.integers(0, np.iinfo(dtype).max, (48, 64)).astype(dtype)
    want = np.asarray(Image.fromarray(img).resize(size, Image.NEAREST))
    np.testing.assert_array_equal(imageio.resize_nearest(img, size), want)


def test_same_size_resizes_return_copies(rng):
    img = _smooth_rgba(rng, 16, 12)
    for fn in (imageio.resize_lanczos, imageio.resize_nearest):
        out = fn(img, (16, 12))
        np.testing.assert_array_equal(out, img)
        assert out is not img and not np.shares_memory(out, img)


def test_jpeg_writer_decodes_close_to_pils_own_file(written):
    for f in sorted((written[0] / "rgb").glob("*.png")):
        rgb = _pil(f)[..., :3].copy()
        ours = _pil(io.BytesIO(imageio.encode_jpeg(rgb)))
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG")
        theirs = _pil(io.BytesIO(buf.getvalue()))
        assert ours.shape == theirs.shape == rgb.shape
        assert _psnr(ours, theirs) >= JPEG_PSNR
        # and the port's decoder on PIL's file
        assert _psnr(imageio.decode_jpeg(buf.getvalue()), theirs) >= JPEG_PSNR


def test_jpeg_huffman_tables_cover_every_symbol():
    want = sorted([0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)])
    for counts, symbols in (imageio._AC_LUMA, imageio._AC_CHROMA):
        assert sum(counts) == len(symbols) and sorted(symbols) == want
    assert sorted(imageio.ZIGZAG) == list(range(64))


def test_jet_table_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8).reshape(256, 1), cv2.COLORMAP_JET)
    np.testing.assert_array_equal(imageio.JET_RGB, lut[:, 0, ::-1])


# ------------------------------------------------------------------- native


def test_native_numpy_paths_match_the_jax_fallbacks(rng, monkeypatch):
    monkeypatch.setattr(jnative, "_try_load", lambda: None)
    n = 64
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:4, 0] = 0.0  # zero direction components: the 1e-14 substitution
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    idx = rng.integers(0, n, 40)
    for got, want in zip(tnative.ray_batch_gather(o, d, rgb, idx),
                         jnative.ray_batch_gather(o, d, rgb, idx)):
        np.testing.assert_array_equal(got, want)
    bounds = np.array([[-1.0, -0.5, -1.2], [1.0, 0.7, 0.9]])
    for got, want in zip(tnative.aabb_intersect(bounds, o, d),
                         jnative.aabb_intersect(bounds, o, d)):
        np.testing.assert_array_equal(got, want)
    rgba = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    np.testing.assert_array_equal(tnative.rgba_blend_white(rgba), jnative.rgba_blend_white(rgba))
    c2w = rng.normal(size=(3, 4)).astype(np.float32)
    for got, want in zip(tnative.generate_rays(d, c2w), jnative.generate_rays(d, c2w)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- AABB and occupancy


def test_scene_aabb_and_intervals_match_jax(fixture_root, tmp_path, rng):
    jdir = _copy(fixture_root, tmp_path / "jax") / "train"
    tdir = _copy(fixture_root, tmp_path / "port") / "train"
    for wh in (WH, (32, 24)):
        jb = jaabb.scene_aabb([str(jdir)], wh, pad=0.05)
        tb = taabb.scene_aabb([str(tdir)], wh, pad=0.05)
        np.testing.assert_array_equal(tb, jb)
    assert json.loads((tdir / ".aabb_cache.json").read_text())["bounds"] == \
        json.loads((jdir / ".aabb_cache.json").read_text())["bounds"]
    o = (rng.normal(size=(256, 3)) * 4).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + rng.normal(size=(256, 3)) * 0.2
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    for got, want in zip(taabb.ray_intervals(tb, o, d), jaabb.ray_intervals(jb, o, d)):
        np.testing.assert_array_equal(got, want)
    assert taabb._focal_for({"camera_angle_x": 0.69}, (64, 48)) == \
        jaabb._focal_for({"camera_angle_x": 0.69}, (64, 48))
    assert taabb._focal_for({"focal": 31.5}, (64, 48)) == 31.5


@pytest.mark.parametrize("dilate", [2, 1])
def test_scene_occgrid_and_refined_intervals_match_jax(fixture_root, tmp_path, rng, dilate):
    jdir = _copy(fixture_root, tmp_path / "jax") / "train"
    tdir = _copy(fixture_root, tmp_path / "port") / "train"
    jb, jg = jocc.scene_occgrid([str(jdir)], WH, res=32, dilate=dilate)
    tb, tg = tocc.scene_occgrid([str(tdir)], WH, res=32, dilate=dilate)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tg, jg)
    assert 0 < tg.sum() < tg.size
    with np.load(tdir / ".occgrid_cache.npz") as zt, np.load(jdir / ".occgrid_cache.npz") as zj:
        assert str(zt["key"]).replace(str(tdir), "") == str(zj["key"]).replace(str(jdir), "")
        np.testing.assert_array_equal(zt["grid"], zj["grid"])
    o = (rng.normal(size=(512, 3)) * 4).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + rng.normal(size=(512, 3)) * 0.15
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    hit, tn, tf = jaabb.ray_intervals(jb, o, d)
    got = tocc.refine_intervals(tb, tg, o, d, hit, tn, tf, chunk=100, dilate=dilate)
    want = jocc.refine_intervals(jb, jg, o, d, hit, tn, tf, chunk=100, dilate=dilate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for grid in (tg, None):
        for g, w in zip(taabb.ray_intervals_with_grid(tb, grid, o, d, dilate=dilate),
                        jaabb.ray_intervals_with_grid(jb, None if grid is None else jg, o, d,
                                                      dilate=dilate)):
            np.testing.assert_array_equal(g, w)


def test_scene_bounds_without_depth_are_none(tmp_path):
    (tmp_path / "train").mkdir()
    assert taabb.scene_aabb([str(tmp_path / "train")], WH) is None
    assert tocc.scene_occgrid([str(tmp_path / "train")], WH) == (None, None)


# ------------------------------------------------------------------ loaders

LOADERS = {
    "plain": (WH, {}),
    "aabb": (WH, dict(use_aabb=True)),
    "occgrid": (WH, dict(use_occgrid=True, occgrid_res=32)),
    "occgrid_resized": ((48, 36), dict(use_occgrid=True, occgrid_res=32, aabb_pad=0.2)),
}


@pytest.mark.parametrize("kind", list(LOADERS))
def test_sapien_dataset_matches_jax(fixture_root, tmp_path, kind):
    wh, kw = LOADERS[kind]
    jroot = str(_copy(fixture_root, tmp_path / "jax"))
    troot = str(_copy(fixture_root, tmp_path / "port"))
    jtrain = jsapien.SapienDataset(jroot, "train", wh, white_back=True, **kw)
    ttrain = tsapien.SapienDataset(troot, "train", wh, white_back=True, **kw)
    assert (ttrain.near, ttrain.far, ttrain.focal) == (jtrain.near, jtrain.far, jtrain.focal)
    for name in ("all_rays_o", "all_viewdirs", "all_rgbs", "all_tnear", "all_tfar",
                 "scene_bounds", "occ_grid", "directions"):
        want = getattr(jtrain, name, None)
        if want is None:
            assert getattr(ttrain, name, None) is None, name
        else:
            np.testing.assert_array_equal(getattr(ttrain, name), np.asarray(want), err_msg=name)
    for name in ("hit_fraction", "aabb_dropped_fg_frac"):
        assert getattr(ttrain, name, None) == getattr(jtrain, name, None), name
    assert len(ttrain) == len(jtrain) > 0
    assert ttrain.steps_per_epoch(16) == jtrain.steps_per_epoch(16)
    np.testing.assert_array_equal(np.stack(ttrain.poses), np.stack(jtrain.poses))
    for seed in (0, 7):
        jit, tit = jtrain.ray_batches(16, seed=seed), ttrain.ray_batches(16, seed=seed)
        for _ in range(3):
            jb, tb = next(jit), next(tit)
            assert set(tb) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    for split in ("val", "test_val"):
        jds = jsapien.SapienDataset(jroot, split, wh, eval_inference="render", **kw)
        tds = tsapien.SapienDataset(troot, split, wh, eval_inference="render", **kw)
        assert tds.img_files == jds.img_files and len(tds) == len(jds)
        np.testing.assert_array_equal(tds.image_sizes, jds.image_sizes)
        for i in range(len(tds.img_files)):
            jf, tf = jds.full_frame(i), tds.full_frame(i)
            assert set(tf) == set(jf)
            for k in jf:
                np.testing.assert_array_equal(tf[k], np.asarray(jf[k]), err_msg=f"{split} {k}")


def test_occ_interval_cache_is_shared_with_jax(fixture_root, tmp_path, monkeypatch):
    """A dataset directory prepared by the JAX loader serves the port's: the
    port reads the JAX package's bounds, grid and interval caches, and its own
    second load reads the interval cache instead of refining again."""
    root = str(_copy(fixture_root, tmp_path / "shared"))
    kw = dict(use_occgrid=True, occgrid_res=32)
    jtrain = jsapien.SapienDataset(root, "train", WH, **kw)
    cache = Path(root) / "train" / f".occ_intervals_{WH[0]}x{WH[1]}_n4.npz"
    assert cache.is_file()

    def no_refine(*a, **k):
        raise AssertionError("the intervals were refined again instead of read from the cache")

    monkeypatch.setattr(tsapien, "ray_intervals_with_grid", no_refine)
    monkeypatch.setattr(tocc, "_MEM_CACHE", {})
    monkeypatch.setattr(taabb, "_MEM_CACHE", {})
    monkeypatch.setattr(tocc, "_splat_dir", no_refine)  # the grid comes from its cache too
    ttrain = tsapien.SapienDataset(root, "train", WH, **kw)
    for name in ("all_rays_o", "all_tnear", "all_tfar", "occ_grid"):
        np.testing.assert_array_equal(getattr(ttrain, name), getattr(jtrain, name))
    assert ttrain.hit_fraction == jtrain.hit_fraction


def test_dataset_dict_and_the_articulated_loader():
    from aon_tpu_torch.data import sapien_multi as tmulti

    assert dataset_dict["sapien"] is tsapien.SapienDataset
    assert dataset_dict["sapien_multi"] is tmulti.SapienDatasetMulti
    with pytest.raises(FileNotFoundError):  # a loader, not a stub that raises
        dataset_dict["sapien_multi"]("no_such_root", split="train")


def test_port_imports_no_imaging_package():
    """Every module of the port, and chip_smoke, imports without PIL, cv2 or
    matplotlib (the card's machine need not have them)."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import aon_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(aon_tpu_torch.__path__, 'aon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('PIL', 'cv2', 'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_extraction_takes_the_dataset_bounds(fixture_root, tmp_path, monkeypatch):
    from aon_tpu_torch.scripts import extract_geometry
    from aon_tpu_torch.train.checkpoint import CheckpointManager
    from aon_tpu_torch.train.systems import build_system
    from aon_tpu_torch.utils.config import Config

    troot = _copy(fixture_root, tmp_path / "port")
    jroot = _copy(fixture_root, tmp_path / "jax")
    cfg = dict(root_dir=str(troot), output_path=str(tmp_path / "results"), exp_name="geo",
               img_wh=list(WH), N_samples=4, N_importance=4, compute_dtype="float32")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    system = build_system(Config(**cfg), 2.0, 6.0, False, device="cpu")
    state = system.init_state(prng.key(0))
    CheckpointManager(str(tmp_path / "results" / "geo")).save_last(state, epoch=0)
    monkeypatch.chdir(tmp_path)
    out = extract_geometry.main(["--config", str(tmp_path / "cfg.json"), "--resolution", "8",
                                 "--chunk", "512"], device="cpu")
    with np.load(Path(out["out_dir"]) / "density_grid.npz") as z:
        np.testing.assert_array_equal(z["bounds"], jaabb.scene_aabb([str(jroot / "train")], WH))
