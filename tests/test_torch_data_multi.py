"""Port parity, the articulated loader: ``aon_tpu_torch.data.sapien_multi``
against ``aon_tpu.data.sapien_multi`` on the same ``--multi`` fixture, and
the port's fixture script's ``--multi`` tree against the JAX script's.

Tolerance: atol 0 throughout.  The loaders run the same numpy operations in
the same order, draw from ``np.random.default_rng`` in the same order and
shapes (instance, degree, image, then the pixels), and decode and resize
the images bit for bit as PIL does (``utils/imageio.py``).

Each package reads its own copy of the fixture: both cache bounds and grids
in the dataset directories under the same file names, so a shared copy would
hand the second loader the first one's results.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from aon_tpu.data import aabb as jaabb
from aon_tpu.data import occgrid as jocc
from aon_tpu.data import sapien_multi as jmulti
from aon_tpu_torch.data import aabb as taabb
from aon_tpu_torch.data import occgrid as tocc
from aon_tpu_torch.data import sapien_multi as tmulti
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture

REPO = Path(__file__).resolve().parent.parent
WH = (64, 48)
N_FRAMES = 3  # per degree directory
N_ITEMS = 4  # train items compared per stream


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The port script's ``--multi`` fixture: 2 instances x 10 degrees x 3
    frames at 64x48."""
    root = tmp_path_factory.mktemp("fixture_multi") / "data"
    tfixture.main([str(root), "--multi", "--n", str(N_FRAMES), "--wh", str(WH[0]), str(WH[1]),
                   "--seed", "3"])
    return root


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    """Each comparison computes bounds and grids from its own copy."""
    for mod in (jaabb, jocc, taabb, tocc):
        monkeypatch.setattr(mod, "_MEM_CACHE", {})


def _copies(fixture_root, base: Path, spheric: bool = False):
    """(JAX copy, port copy) of the fixture; with ``spheric`` each instance
    also gets a ``test_spheric`` split (a copy of its 0_degree split)."""
    out = []
    for side in ("jax", "port"):
        root = base / side
        shutil.copytree(fixture_root, root)
        if spheric:
            for inst in ("obj_a", "obj_b"):
                shutil.copytree(root / inst / "train" / "0_degree", root / inst / "test_spheric")
        out.append(str(root))
    return out


def _pair(fixture_root, base, split="train", spheric=False, **kw):
    jroot, troot = _copies(fixture_root, base, spheric)
    return (jmulti.SapienDatasetMulti(jroot, split, **kw),
            tmulti.SapienDatasetMulti(troot, split, **kw))


def _assert_items_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


LOADERS = {
    "plain": dict(img_wh=WH, ray_batch_size=256),
    "white_back": dict(img_wh=WH, ray_batch_size=256, white_back=True, need_src_imgs=False),
    "resized": dict(img_wh=(40, 30), ray_batch_size=256),
    "oversample": dict(img_wh=WH, ray_batch_size=256, obj_ray_oversample=0.25),
    "aabb": dict(img_wh=WH, ray_batch_size=256, use_aabb=True, need_src_imgs=False),
    "aabb_oversample": dict(img_wh=WH, ray_batch_size=256, use_aabb=True,
                            obj_ray_oversample=0.25, need_src_imgs=False),
    "occgrid": dict(img_wh=WH, ray_batch_size=256, use_occgrid=True, occgrid_res=32,
                    need_src_imgs=False),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_train_items_match_jax(fixture_root, tmp_path, name):
    kw = LOADERS[name]
    jds, tds = _pair(fixture_root, tmp_path, **kw)
    assert list(tds.ids) == list(jds.ids) == ["obj_a", "obj_b"]
    for attr in ("scene_bounds", "occ_grid"):
        want = getattr(jds, attr)
        assert (getattr(tds, attr) is None) == (want is None), attr
        if want is not None:
            np.testing.assert_array_equal(getattr(tds, attr), want)
    jit, tit = jds.train_batches(seed=5), tds.train_batches(seed=5)
    for i in range(N_ITEMS):
        jb, tb = next(jit), next(tit)
        _assert_items_equal(tb, jb, f"{name} item {i}")
    assert ("loss_w" in tb) == (kw.get("obj_ray_oversample", 0) > 0)
    assert ("t_near" in tb) == bool(kw.get("use_aabb") or kw.get("use_occgrid"))
    assert ("src_imgs" in tb) == kw.get("need_src_imgs", True)
    assert tb["rays_o"].shape == (kw["ray_batch_size"], 3)


def test_val_frames_match_jax(fixture_root, tmp_path):
    jds, tds = _pair(fixture_root, tmp_path, "val", img_wh=WH, use_aabb=True)
    for seed in range(3):
        _assert_items_equal(tds.val_frame(seed), jds.val_frame(seed), f"val seed {seed}")


@pytest.mark.parametrize("spheric", [False, True], ids=["0_degree", "test_spheric"])
def test_test_frames_match_jax_on_both_branches(fixture_root, tmp_path, spheric):
    jds, tds = _pair(fixture_root, tmp_path, "test_val", spheric=spheric, img_wh=WH,
                     use_aabb=True, eval_inference="render", need_src_imgs=False)
    np.testing.assert_array_equal(tds.poses_test, jds.poses_test)
    np.testing.assert_array_equal(tds.image_sizes, jds.image_sizes)
    for idx, seed, instance in ((0, 0, None), (5, 1, None), (18, 0, 1), (7, 2, 0)):
        got = tds.test_frame(idx, seed=seed, instance=instance)
        _assert_items_equal(got, jds.test_frame(idx, seed=seed, instance=instance),
                            f"test {idx} seed {seed} instance {instance}")
        assert int(got["articulation_id"]) == idx
    # the branches differ: the 0_degree fallback takes the spheric pose, the
    # test_spheric split its own frame's pose
    frame = tds.test_frame(3, seed=0, instance=0)
    c2w = tds.poses_test[3][:3, 3]
    assert np.allclose(frame["rays_o"][0], c2w) != spheric


def test_lengths_per_split(fixture_root, tmp_path):
    for split, want in (("train", 37), ("val", 1), ("test_val", 19)):
        jds, tds = _pair(fixture_root, tmp_path / split, split, img_wh=WH, samples_per_epoch=37)
        assert len(tds) == len(jds) == want


def test_frame_cache_keys_on_the_wrapped_index(fixture_root, tmp_path, monkeypatch):
    monkeypatch.setenv("AON_FRAME_CACHE", "4")
    jds, tds = _pair(fixture_root, tmp_path, img_wh=WH, use_aabb=True)
    for image_id in (1, 1 + N_FRAMES, 2 + 5 * N_FRAMES, 57):
        jkey, jframe = jds._read_frame_cached("obj_b", "30_degree", image_id)
        tkey, tframe = tds._read_frame_cached("obj_b", "30_degree", image_id)
        assert tkey == jkey == ("obj_b", "30_degree", image_id % N_FRAMES)
        for g, w in zip(tframe[:5], jframe[:5]):
            np.testing.assert_array_equal(g, w)
    assert sorted(tds._frame_cache) == sorted(jds._frame_cache)
    assert len(tds._frame_cache) == 3  # three distinct frames under a cap of 4
    # a cached frame is the same object, an uncached one is read again
    assert tds._read_frame_cached("obj_b", "30_degree", 4)[1] is tds._frame_cache[
        ("obj_b", "30_degree", 1)]
    for k in range(N_FRAMES):
        tds._read_frame_cached("obj_a", "0_degree", k)
    assert len(tds._frame_cache) == 4  # the cap holds


def test_rgba_alpha_is_dropped_not_blended(fixture_root, tmp_path):
    """The JAX loader reads rgb through PIL's ``convert("RGB")``: an RGBA file's
    colour channels stay as they are (the single-scene loader blends them to
    white)."""
    jds, tds = _pair(fixture_root, tmp_path, img_wh=WH)
    base = Path(tds.root_dir) / "obj_a" / "train" / "20_degree"
    rgb, seg = tds._load_image_and_seg(str(base / "rgb" / "r_1.png"), str(base / "seg" / "r_1.png"))
    want_rgb, want_seg = jds._load_image_and_seg(
        str(Path(jds.root_dir) / "obj_a/train/20_degree/rgb/r_1.png"),
        str(Path(jds.root_dir) / "obj_a/train/20_degree/seg/r_1.png"))
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(seg, want_seg)
    rgba = np.asarray(Image.open(base / "rgb" / "r_1.png"))
    assert rgba.shape[-1] == 4 and (rgba[..., 3] == 0).any()
    np.testing.assert_array_equal(rgb, rgba[..., :3])


def _jax_fixture_module():
    spec = importlib.util.spec_from_file_location(
        "jax_make_fixture_dataset", REPO / "scripts" / "make_fixture_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_fixture_script_writes_the_jax_multi_tree(tmp_path, monkeypatch):
    """The same files with the same pixels (PIL's decode of each PNG) and the
    same transforms.json bytes: the two scripts' PNG encoders compress
    differently, so the PNG files' bytes are not compared."""
    argv = ["--multi", "--n", "2", "--wh", "16", "12", "--seed", "7"]
    monkeypatch.setattr(sys, "argv", ["make_fixture_dataset.py", str(tmp_path / "jax"), *argv])
    _jax_fixture_module().main()
    tfixture.main([str(tmp_path / "port"), *argv])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 2 * 10 * (3 * 2 + 1)
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        got, want = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".png":
            a, b = np.asarray(Image.open(got)), np.asarray(Image.open(want))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=str(rel))
        else:
            assert got.read_bytes() == want.read_bytes(), rel
            assert json.loads(got.read_text())["frames"]
