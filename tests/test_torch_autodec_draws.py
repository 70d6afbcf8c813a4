"""The auto-decoder's step under the JAX trainer's own init and draws: does
the port's step, and its code table, part from the JAX step faster than two
honest runs part from each other?  And over whole runs of paired seeds, do
the port's interpolated-code frames fall short of JAX's?

``configs/smoke_autodecoder.json`` (16 + 16 samples, float32) on the
port's ``--multi`` fixture with ``white_back`` off, as the laptop configs
have it (the fixture's background is black).  The fixture is the port's
fixture script's two spheres x 10 degrees x 3 frames at 64x48, written
with a camera angle that gives the loader's focal at 64 wide what the
fixture's camera angle gives at 320 wide: with the loader's w/320 focal
rescale the script's own frames show a sphere ~7 pixels across, where the
lid's articulation is all but invisible.  Beside it each instance gets a
``test_spheric`` sweep as datagen writes one: frame i at
``create_spheric_poses(radius=4)[i]`` with the lid at 5 i degrees, so the
even frames are the learned codes' degrees and the odd frames the
midpoints'.  Both packages run the plain float32 route.  The port's own
init from the trainer's ``init_key`` is the JAX init (held bit for bit, the
code tables included) and its step key ``fold_in(base_key, step)`` gives
the JAX draws.  The runs:

  (a) JAX, its jitted ``AutoDecoderSystem.train_step`` with the step's key;
  (b) the port on its own route: its own init, its own keys;
  (c) JAX again from an init one ulp away in one weight: the control for
      how fast two runs part that differ only in the last bit.

The tier-1 test, 8 steps of 128 rays, holds:

  * the port's init to JAX's, bit for bit;
  * step 1 of (b) against (a) to ``test_torch_trainer_multi.py::
    test_fit_one_step_matches_jax``'s tolerances: the loss 1e-4 relative;
    the gradients, read back from the first Adam moment (mu = 0.1 g),
    coarse 5e-2 of each tensor's largest and 1e-2 of its mean magnitude,
    fine and code rows 3e-1 and 5e-2; code rows the step did not index
    untouched;
  * steps 1-8: (b) parts from (a) no faster than (c) does, the growth
    ``d(8) / d(1)`` of (b)'s distance within 2x (c)'s growth, over all the
    parameters, over the articulation table alone and over its midpoints
    ``interpolate_articulations(table)[1::2]``.  For the table the growth
    is taken from the first step where (c)'s table has parted from (a)'s
    (seen: step 4): until then Adam's update of the code rows, ``lr g /
    (|g| + eps)`` with one row's gradient moved by one ulp elsewhere,
    rounds to the same float32.  (b)'s table equals (a)'s after step 1 and
    lies 4.4e-6 from it after step 2, the same first-step offset as the
    whole state's (1.8e-4 after step 1: XLA's fused multiply-adds against
    the port's op-by-op arithmetic, as ``tests/test_torch_draws.py``
    explains), and then grows more slowly than (c)'s (seen: 1.14x against
    1.54x over steps 4-8 for the table, 1.14x against 1.68x for its
    midpoints; 1.32x against 2,300x over steps 1-8 for the whole state);
  * each step's loss within 1e-4 relative of (a)'s;
  * a code row that an earlier step indexed and this step did not moves in
    both packages (its gradient is zero, its Adam moments are not), the
    port's move within 2 lr of JAX's (Adam's sign on a near-zero gradient,
    as a first step is held; seen up to 1.2 lr).

The study (``slow``; ``-m slow -k autodec_draws -s``, 1 h 43 min on eight
cores) trains three seeds of each package, the same seed in each pair, in
six processes of one thread, through each package's own ``Trainer.fit``:
256 rays a step for 3,072 steps, the config's schedule over them with the
laptop configs' LR warm-up share (2,500 of 24,000 steps).  It renders each
run's two 19-frame sweeps through each package's own ``eval_per_instance``
and splits them with ``quality_run``'s ``--sweep`` (even: learned codes;
odd: midpoints), prints each pair's odd, even and val gaps, JAX's own
spread over seeds and the articulation table's geometry at every
validation (consecutive codes' distances, the rows' norms, the midpoints'
norms against their neighbours'), and asserts the mean paired odd gap
within 2x the standard deviation of JAX's odd frames over its seeds.

Seen (seeds 0, 1, 2): the fixture plateaus near 19 dB val.  The paired
odd gaps (port - JAX) are -0.013, -0.007, -0.076 dB (mean -0.032, bound
2 x 0.161), the even gaps +0.012, +0.015, -0.160, the final val gaps
-0.246, -0.122, +0.073 (the port's val curves lie 0.12-0.17 below JAX's on
average over their 12 vals, within JAX's val spread of 0.176 over seeds).
JAX's odd frames: 18.961, 18.668, 18.696.  The tables barely leave their
xavier init in 3,072 steps (row norms 1.25-1.26 -> 1.23-1.25), and the two
packages' geometry stays within 1%: consecutive distances 1.6109 /
1.6135, 1.7336 / 1.7253, 1.8201 / 1.8206 and midpoint norm ratios 0.7624 /
0.7635, 0.7188 / 0.7180, 0.6791 / 0.6796 (JAX / port) at the end; the
final tables lie
0.19-0.22 apart (each ~3.9 in norm).  ``PERF.md`` §6 has the rest.
"""

import importlib.util
import json
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.core import prng  # noqa: E402
from aon_tpu_torch.core.rays import create_spheric_poses  # noqa: E402
from aon_tpu_torch.models.code_library import interpolate_articulations  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.train.systems import ART_TABLE, AutoDecoderSystem  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402
from aon_tpu_torch.utils.imageio import write_png  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMOKE = json.loads((REPO / "configs" / "smoke_autodecoder.json").read_text())
WH = (64, 48)
TIER1_BATCH, TIER1_STEPS = 128, 8
STUDY_SEEDS = (0, 1, 2)
STUDY_BATCH, STUDY_STEPS, STUDY_EPOCH = 256, 3072, 256
TABLES = ("code_library.embedding_instance_shape.weight",
          "code_library.embedding_instance_appearance.weight", ART_TABLE)
# the camera angle whose focal under the loader's w/320 rescale at 64 wide is
# the fixture angle's focal at 320 wide
ZOOMED_ANGLE = float(2 * np.arctan(np.tan(0.5 * tfixture.CAMERA_ANGLE_X) * WH[0] / 320.0))
SWEEP_FRAMES = 19


def write_fixture(root: Path) -> Path:
    """The fixture script's ``--multi`` tree at 64x48 under ``ZOOMED_ANGLE``,
    and a ``test_spheric`` sweep for each instance."""
    angle = tfixture.CAMERA_ANGLE_X
    tfixture.CAMERA_ANGLE_X = ZOOMED_ANGLE
    try:
        tfixture.main([str(root), "--multi", "--n", "3", "--wh", str(WH[0]), str(WH[1]),
                       "--seed", "1"])
        poses = create_spheric_poses(radius=4.0)
        for inst in ("obj_a", "obj_b"):
            base = root / inst / "test_spheric"
            for sub in ("rgb", "seg", "depth"):
                (base / sub).mkdir(parents=True, exist_ok=True)
            frames, degrees = {}, {}
            for i in range(SWEEP_FRAMES):
                c2w = poses[i].astype(np.float32)
                rgb, alpha, z = tfixture.render_analytic(c2w, WH[0], WH[1], 5.0 * i)
                rgba = np.concatenate([(rgb * 255).astype(np.uint8),
                                       (alpha[..., None] * 255).astype(np.uint8)], axis=-1)
                write_png(base / "rgb" / f"r_{i}.png", rgba)
                write_png(base / "seg" / f"r_{i}.png", (alpha * 255).astype(np.uint8))
                write_png(base / "depth" / f"r_{i}.png",
                          np.clip(z * 1000.0, 0, 65535).astype(np.uint16))
                frames[f"r_{i}"], degrees[f"r_{i}"] = c2w.tolist(), 5.0 * i
            (base / "transforms.json").write_text(json.dumps(
                {"camera_angle_x": ZOOMED_ANGLE, "frames": frames, "joint_degrees": degrees}))
    finally:
        tfixture.CAMERA_ANGLE_X = angle
    return root


def config(root: Path, out: Path, batch: int, steps: int, **overrides) -> dict:
    """The smoke config on ``root`` at ``batch`` rays a step (one microbatch)."""
    return dict(SMOKE, root_dir=str(root), output_path=str(out), white_back=False,
                ray_batch_size=batch, microbatch_rays=batch, run_max_steps=steps, **overrides)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("autodec_draws_fixture") / "data")


class Study:
    """The JAX trainer's init, key and batches on the smoke config, and the
    runs (a)-(c) from them."""

    def __init__(self, root: Path, out: Path, batch_size: int, steps: int):
        cfg = config(root, out, batch_size, steps)
        self.jt = jtrainer.Trainer(JaxConfig(**cfg))
        self.jsys = self.jt.system
        self.init = jax.tree.map(np.array, self.jt.state.params)
        it = self.jt._train_iterator()
        self.batches = [next(it) for _ in range(steps)]
        self.tsys = AutoDecoderSystem(Config(**cfg), self.jsys.near, self.jsys.far,
                                      self.jsys.white_bkgd, device="cpu")
        # the port Trainer's keys: split(key(seed)) into the draws' and the init's
        self.base_key, self.init_key = prng.split(prng.key(Config(**cfg).seed))

    def key(self, step: int):
        return jax.random.fold_in(self.jt.base_key, step)

    def one_ulp_off(self):
        """The init with one weight (the first entry of the first kernel)
        moved one ulp up."""
        flat, treedef = jax.tree_util.tree_flatten_with_path(self.init)
        leaves = [np.array(v) for _, v in flat]
        i = next(i for i, (path, _) in enumerate(flat)
                 if "kernel" in jax.tree_util.keystr(path))
        leaves[i].flat[0] = np.nextafter(leaves[i].flat[0], np.float32(np.inf))
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def _jax_state(self, init):
        params = jax.tree.map(jnp.asarray, init)
        return self.jt.state.replace(params=params, opt_state=self.jsys.tx.init(params),
                                     step=jnp.asarray(0, jnp.int32))

    def run_jax(self, init, steps: int):
        """(params after each step in the port's names, loss per step)."""
        state = self._jax_state(init)
        traj, loss = [], []
        for s in range(steps):
            batch = {k: jnp.asarray(v) for k, v in self.batches[s].items()}
            state, m = self.jsys.train_step(state, batch, self.key(s))
            traj.append(params_from_flax(jax.tree.map(np.asarray, state.params)))
            loss.append(float(m["train/loss"]))
        return traj, np.array(loss), state

    def run_port(self, steps: int):
        """(b): the port's own init and keys."""
        state = self.tsys.init_state(self.init_key)
        traj, loss = [], []
        for s in range(steps):
            state, m = self.tsys.train_step(state, self.batches[s],
                                            prng.fold_in(self.base_key, s))
            traj.append(dict(state.params))
            loss.append(m["train/loss"].item())
        return traj, np.array(loss), state


def distance(p, q, names=None) -> float:
    """The Euclidean distance between two parameter sets (over ``names``)."""
    names = list(p) if names is None else names
    return float(torch.sqrt(sum(((p[k].double() - q[k].double()) ** 2).sum() for k in names)))


def midpoint_distance(p, q) -> float:
    """The distance between two articulation tables' midpoint codes."""
    return float(torch.linalg.norm((interpolate_articulations(p[ART_TABLE])[1::2]
                                    - interpolate_articulations(q[ART_TABLE])[1::2]).double()))


def _errors(got, want, names):
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
                  for k in names)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(1e-30)).item()
                   for k in names)
    return max_rel, mean_rel


def test_port_autodec_step_parts_from_jax_no_faster_than_two_honest_runs(fixture_root, tmp_path):
    st = Study(fixture_root, tmp_path / "results", TIER1_BATCH, TIER1_STEPS)
    ta, la, _ = st.run_jax(st.init, TIER1_STEPS)
    tb, lb, port_state = st.run_port(TIER1_STEPS)
    tc, _, _ = st.run_jax(st.one_ulp_off(), TIER1_STEPS)

    # the port's own init is the JAX trainer's, bit for bit, the code tables included
    start = params_from_flax(st.init)
    own = st.tsys.init_state(st.init_key).params
    assert set(own) == set(start) and set(TABLES) <= set(own)
    assert all(torch.equal(own[k], v) for k, v in start.items())

    # step 1 against the compiled JAX step: test_fit_one_step_matches_jax's measure,
    # the gradients read back from the first Adam moment on both sides
    _, _, jstate = st.run_jax(st.init, 1)
    want = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state[0].mu)).items()}
    state = st.tsys.init_state(st.init_key)
    state, m = st.tsys.train_step(state, st.batches[0], prng.fold_in(st.base_key, 0))
    got = {k: 10.0 * v for k, v in state.mu.items()}
    coarse = _errors(got, want, [k for k in want if k.startswith("model.coarse_mlp.")])
    fine = _errors(got, want, [k for k in want if k.startswith("model.fine_mlp.")])
    codes = _errors(got, want, list(TABLES))
    assert coarse[0] <= 5e-2 and coarse[1] <= 1e-2, coarse
    assert fine[0] <= 3e-1 and fine[1] <= 5e-2, fine
    assert codes[0] <= 3e-1 and codes[1] <= 5e-2, codes
    np.testing.assert_allclose(m["train/loss"].item(), la[0], rtol=1e-4)
    for name, idx in zip(TABLES, ("instance_id", "instance_id", "articulation_id")):
        moved = (tb[0][name] - start[name]).abs().sum(dim=1) > 0
        assert moved.nonzero().flatten().tolist() == [int(st.batches[0][idx])], name

    # steps 1-8: (b) parts from (a) no faster than the one-ulp control does,
    # over every parameter, the articulation table and its midpoints
    steps = range(TIER1_STEPS)
    d_b, d_c = ([distance(t[s], ta[s]) for s in steps] for t in (tb, tc))
    assert d_c[0] > 0
    assert d_b[-1] / d_b[0] <= 2 * d_c[-1] / d_c[0], (d_b, d_c)
    t_b, t_c = ([distance(t[s], ta[s], [ART_TABLE]) for s in steps] for t in (tb, tc))
    m_b, m_c = ([midpoint_distance(t[s], ta[s]) for s in steps] for t in (tb, tc))
    # from the first step where (c)'s table has parted from (a)'s
    s0 = next(s for s in steps if t_c[s] > 0 and m_c[s] > 0)
    assert s0 < TIER1_STEPS - 1, (t_c, m_c)
    assert t_b[-1] / t_b[s0] <= 2 * t_c[-1] / t_c[s0], (t_b, t_c)
    assert m_b[-1] / m_b[s0] <= 2 * m_c[-1] / m_c[s0], (m_b, m_c)
    np.testing.assert_allclose(lb, la, rtol=1e-4)
    assert int(port_state.step) == TIER1_STEPS

    # a code row indexed by an earlier step and not by this one still moves,
    # through its Adam moments, in both packages alike
    arts = [int(b["articulation_id"]) for b in st.batches]
    stale = [(s, r) for s in range(1, TIER1_STEPS) for r in set(arts[:s]) - {arts[s]}]
    assert stale
    for s, r in stale:
        got = tb[s][ART_TABLE][r] - tb[s - 1][ART_TABLE][r]
        want = ta[s][ART_TABLE][r] - ta[s - 1][ART_TABLE][r]
        assert got.abs().max().item() > 0 and want.abs().max().item() > 0, (s, r)
        # Adam's sign on a near-zero gradient: within 2 lr, as a first step is held
        assert (got - want).abs().max().item() <= 2 * float(st.tsys.lr_schedule(s)), (s, r)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def table_geometry(table: np.ndarray) -> dict:
    """The articulation table's shape: the mean distance between consecutive
    codes, the mean row norm, and the mean ratio of a midpoint's norm to its
    two neighbours' mean norm (1 where consecutive codes are parallel, 0.71
    where they are orthogonal and of equal norm)."""
    norms = np.linalg.norm(table, axis=1)
    mids = np.linalg.norm(0.5 * (table[:-1] + table[1:]), axis=1)
    return {"consecutive": float(np.linalg.norm(np.diff(table, axis=0), axis=1).mean()),
            "row_norm": float(norms.mean()),
            "midpoint_norm_ratio": float((mids / (0.5 * (norms[:-1] + norms[1:]))).mean())}


def train_and_sweep(side: str, seed: int, root: str, out: str, batch: int, steps: int,
                    epoch: int) -> dict:
    """One run of the study in this process: ``side``'s own ``Trainer.fit``
    on ``seed``, its articulation table at every validation, then its own
    ``eval_per_instance`` split by code with ``quality_run.sweep_split``.
    Returns ``{"val": {step: psnr}, "split": {instance: {learned,
    interpolated}}, "tables": [...]}``."""
    from aon_tpu_torch.scripts import eval_per_instance as tper
    from aon_tpu_torch.scripts import quality_run
    from aon_tpu_torch.train import trainer as ttrainer

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    run_dir = Path(out) / f"{side}_seed{seed}"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg = config(Path(root), run_dir / "results", batch, steps, seed=seed,
                 samples_per_epoch=epoch, num_epochs=steps // epoch, log_every_n_steps=epoch,
                 # the laptop configs' LR warm-up, 2,500 of 24,000 steps, as a share
                 lr_delay_steps=steps * 2500 // 24000)
    if side == "jax":
        tr = jtrainer.Trainer(JaxConfig(**cfg))

        def table():
            return np.array(tr.state.params["code_library"]["embedding_instance_articulation"]
                            ["embedding"])
    else:
        tr = ttrainer.Trainer(Config(**cfg), device="cpu")

        def table():
            return tr.state.params[ART_TABLE].numpy().copy()
    tables = [table()]
    validate = tr.validate

    def recording(epoch_idx):
        tables.append(table())
        return validate(epoch_idx)

    tr.validate = recording
    tr.fit()
    cfg_path = run_dir / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    argv = ["--config", str(cfg_path), "--ckpt_path", "last.ckpt"]
    cwd = os.getcwd()
    os.chdir(run_dir)  # eval_per_instance writes ckpts/ under the working directory
    try:
        if side == "jax":
            sys.argv = ["eval_per_instance.py", *argv]
            _jax_script("eval_per_instance").main()
        else:
            tper.main(argv, device="cpu")
    finally:
        os.chdir(cwd)
    per = run_dir / "ckpts" / cfg["exp_name"] / "per_instance.json"
    metrics = Path(cfg["output_path"]) / cfg["exp_name"] / "metrics.jsonl"
    return {"val": quality_run.val_curve(metrics), "split": quality_run.sweep_split(per),
            "tables": [t.tolist() for t in tables]}


@pytest.mark.slow
def test_autodec_paired_seeds_interpolated_gap_within_jax_spread(tmp_path):
    """The study behind ROADMAP.md's Queue 3 entry (the auto-decoder's
    interpolated-code frames): six runs in six processes of one thread."""
    root = write_fixture(tmp_path / "data")
    jobs = [(side, seed) for seed in STUDY_SEEDS for side in ("jax", "port")]
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {job: ex.submit(train_and_sweep, *job, str(root), str(tmp_path / "runs"),
                                  STUDY_BATCH, STUDY_STEPS, STUDY_EPOCH) for job in jobs}
        runs = {job: f.result() for job, f in futures.items()}

    def by_code(run, kind):  # the mean over the instances' sweeps
        return float(np.mean([s[kind] for s in run["split"].values()]))

    rows = []
    for seed in STUDY_SEEDS:
        j, p = runs["jax", seed], runs["port", seed]
        last = max(j["val"])
        rows.append({
            "seed": seed,
            "jax": {"odd": by_code(j, "interpolated"), "even": by_code(j, "learned"),
                    "val": j["val"][last]},
            "port": {"odd": by_code(p, "interpolated"), "even": by_code(p, "learned"),
                     "val": p["val"][last]},
            "val_curve_gap_mean": float(np.mean([p["val"][s] - j["val"][s] for s in j["val"]])),
            "table_geometry": {side: [table_geometry(np.array(t)) for t in r["tables"]]
                               for side, r in (("jax", j), ("port", p))},
            "final_table_distance": float(np.linalg.norm(np.array(j["tables"][-1])
                                                         - np.array(p["tables"][-1]))),
        })
    gaps = {k: [r["port"][k] - r["jax"][k] for r in rows] for k in ("odd", "even", "val")}
    jax_odd = [r["jax"]["odd"] for r in rows]
    report = {
        "steps": STUDY_STEPS, "batch": STUDY_BATCH, "seeds": list(STUDY_SEEDS), "runs": rows,
        "paired_gaps": gaps,
        "mean_paired_gap": {k: float(np.mean(v)) for k, v in gaps.items()},
        "jax_spread_std": {k: float(np.std([r["jax"][k] for r in rows], ddof=1))
                           for k in ("odd", "even", "val")},
        "port_spread_std": {k: float(np.std([r["port"][k] for r in rows], ddof=1))
                            for k in ("odd", "even", "val")},
    }
    print(json.dumps(report, indent=1))
    for r in rows:
        assert all(np.isfinite(v) for side in ("jax", "port") for v in r[side].values()), r
    assert abs(np.mean(gaps["odd"])) <= 2 * np.std(jax_odd, ddof=1), report["mean_paired_gap"]
