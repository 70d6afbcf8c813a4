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
      packages' loaders.

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
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from aon_tpu.data import sapien_multi as jmulti  # noqa: E402
from aon_tpu.parallel import stack_step_batches as jax_stack  # noqa: E402
from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu.utils.config import get_config as jax_get_config  # noqa: E402
from aon_tpu_torch.data import sapien_multi as tmulti  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.ops import fused_art  # noqa: E402
from aon_tpu_torch.parallel.mesh import stack_step_batches  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.train import trainer as ttrainer  # noqa: E402
from aon_tpu_torch.train.systems import ART_TABLE  # noqa: E402
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
           "quality_scissors_vanilla")

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
