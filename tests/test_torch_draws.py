"""The vanilla step under the JAX trainer's own draws: does the port's step
part from the JAX step faster than two honest runs part from each other?

``configs/smoke_vanilla.json`` on the 64x48 fixture, both packages on the
plain float32 route from one converted init.  Every step injects the JAX
trainer's draws, ``jax.random.split(jax.random.fold_in(base_key, step), 4)``
(``keys[0]`` the coarse ``t_rand``, ``keys[2]`` the fine ``u``), into the
port's ``train_step``; the JAX side is ``VanillaSystem.train_step`` with the
step's key.  The runs:

  (a) JAX, its jitted step;
  (b) the port with JAX's draws;
  (c) JAX again from an init one ulp away in one weight: the control for how
      fast two runs part that differ only in the last bit;
  (d) the port with its own draws (the 300-step study only);
  (e) JAX's step run op by op (``jax.disable_jit``), one step (the study
      only: its first op-by-op step compiles every primitive, ~35 s).

What two honest runs differ by.  XLA's compiled step contracts the sample
points ``o + t d`` into fused multiply-adds, so a quarter of the points move
by an ulp; the encoding's 2^9 octave turns that ulp into 2.4e-4 of the sine's
argument, the gradients move by ~1e-3 relative, and Adam's first update,
``lr g / (|g| + eps)``, takes the other sign wherever a gradient is near zero.
After one step the compiled JAX step (a) and JAX's own op-by-op step (e)
therefore lie 1.6e-4 apart in the parameters, ten thousand times further than
(c) lies from (a) (1.4e-8: one ulp of one weight).  The port evaluates JAX's
arithmetic unfused: it lies 1.7e-7 from (e) after one step.  So (c)'s distance
cannot bound (b)'s until the trajectories have decorrelated, and the test
holds, with the tolerances stated:

  * step 1 of (b) against (a): ``test_fit_one_step_matches_jax``'s tolerances
    (loss 1e-5 relative; every parameter within 2 lr, and within 2% of lr
    where its gradient is above a tenth of its tensor's largest);
  * steps 1-8: (b) parts from (a) no faster than (c) does, the growth
    ``d(8) / d(1)`` of (b)'s distance within 2x (c)'s growth;
  * each step's loss: (b)'s within 1e-5 relative of (a)'s (the one-step
    test's tolerance; seen 8.6e-7, once the parameters have parted by the
    rounding above).

The 300-step study (``slow``: ~1 s a step a package at the config's 512
rays) records the train PSNR of (a)-(d), their means over the last 100 steps
and the parameter distances (a)-(b) and (a)-(c).  It holds step 1 of (b) no
further from (a) than 2x (e)'s distance from (a) and within a tenth of that
distance (plus 1e-6) from (e) -- the port computes the JAX step's arithmetic,
and parts from the compiled step only as far as JAX's own unfused step does
(seen 8.7e-5 and 3.4e-6 at 512 rays, 1.6e-4 and 1.7e-7 at 128) -- and (b) to
parting no faster than (c) over the whole run; by its end the runs have
decorrelated, and (b)'s final parameters and largest loss gap lie no
further from (a) than 2x (c)'s (seen 2.6e-3 against 1.7e-3, 4.2e-4 against
4.0e-4).  Its numbers stand in ROADMAP.md (Queue 3)
and PERF.md.
"""

import json
import os
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.train import trainer as jtrainer  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.train.systems import TrainState, VanillaSystem  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMOKE = json.loads((REPO / "configs" / "smoke_vanilla.json").read_text())
TIER1_BATCH, TIER1_STEPS = 128, 8  # rays a step cut from the config's 512 for time
STUDY_STEPS, STUDY_TAIL = 300, 100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("draws_fixture") / "data"
    tfixture.main([str(root), "--n", "3", "--wh", "64", "48", "--seed", "1"])
    return root


class Study:
    """The JAX trainer's init, key and batches on the smoke config, and the
    runs (a)-(e) from them."""

    def __init__(self, root: Path, out: Path, batch_size: int, steps: int):
        cfg = dict(SMOKE, root_dir=str(root), output_path=str(out), batch_size=batch_size,
                   run_max_steps=steps)
        self.jt = jtrainer.Trainer(JaxConfig(**cfg))
        self.jsys = self.jt.system
        self.init = jax.tree.map(np.array, self.jt.state.params)
        it = self.jt._train_iterator()
        self.batches = [next(it) for _ in range(steps)]
        self.tsys = VanillaSystem(Config(**cfg), self.jsys.near, self.jsys.far,
                                  self.jsys.white_bkgd, device="cpu")
        self.lr0 = float(self.tsys.lr_schedule(0))

    def key(self, step: int):
        return jax.random.fold_in(self.jt.base_key, step)

    def draws(self, step: int):
        """The uniforms the JAX model takes from the step's key."""
        keys = jax.random.split(self.key(step), 4)
        b = self.batches[step]["rays_o"].shape[0]
        n_c, n_f = SMOKE["N_samples"], SMOKE["N_importance"]
        return {"t_rand": torch.from_numpy(np.array(
                    jax.random.uniform(keys[0], (b, n_c + 1), dtype=jnp.float32))),
                "u": torch.from_numpy(np.array(
                    jax.random.uniform(keys[2], (b, n_f), dtype=jnp.float32)))}

    def one_ulp_off(self):
        """The init with one weight (the first entry of the first kernel)
        moved one ulp up."""
        flat, treedef = jax.tree_util.tree_flatten_with_path(self.init)
        leaves = [np.array(v) for _, v in flat]
        i = next(i for i, (path, _) in enumerate(flat)
                 if "kernel" in jax.tree_util.keystr(path))
        leaves[i].flat[0] = np.nextafter(leaves[i].flat[0], np.float32(np.inf))
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def run_jax(self, init, steps: int, jit: bool = True):
        """(params after each step in the port's names, loss, psnr1 per step)."""
        params = jax.tree.map(jnp.asarray, init)
        state = self.jt.state.replace(params=params, opt_state=self.jsys.tx.init(params),
                                      step=jnp.asarray(0, jnp.int32))
        traj, loss, psnr = [], [], []
        for s in range(steps):
            batch = {k: jnp.asarray(v) for k, v in self.batches[s].items()}
            if jit:
                state, m = self.jsys.train_step(state, batch, self.key(s))
            else:
                with jax.disable_jit():
                    state, m = self.jsys.train_step(state, batch, self.key(s))
            traj.append(params_from_flax(jax.tree.map(np.asarray, state.params)))
            loss.append(float(m["train/loss"]))
            psnr.append(float(m["train/psnr1"]))
        return traj, np.array(loss), np.array(psnr)

    def run_port(self, steps: int, jax_draws: bool = True):
        params = params_from_flax(self.init)
        mu, nu = self.tsys.tx.init(params)
        state = TrainState(step=0, params=params, mu=mu, nu=nu, tx=self.tsys.tx)
        traj, loss, psnr = [], [], []
        for s in range(steps):
            if jax_draws:
                state, m = self.tsys.train_step(state, self.batches[s], None, self.draws(s))
            else:
                gen = torch.Generator().manual_seed(10_000 + s)
                state, m = self.tsys.train_step(state, self.batches[s], gen)
            traj.append(dict(state.params))
            loss.append(m["train/loss"].item())
            psnr.append(m["train/psnr1"].item())
        return traj, np.array(loss), np.array(psnr)

    def jax_grads_of_step0(self):
        """JAX's gradients of step 0, read back from its first Adam moment
        (mu = 0.1 g), as test_torch_trainer.py reads them."""
        params = jax.tree.map(jnp.asarray, self.init)
        state = self.jt.state.replace(params=params, opt_state=self.jsys.tx.init(params),
                                      step=jnp.asarray(0, jnp.int32))
        batch = {k: jnp.asarray(v) for k, v in self.batches[0].items()}
        state, _ = self.jsys.train_step(state, batch, self.key(0))
        return params_from_flax(jax.tree.map(lambda m: 10.0 * np.asarray(m),
                                             state.opt_state[0].mu))


def distance(p, q) -> float:
    """The Euclidean distance between two parameter sets."""
    return float(torch.sqrt(sum(((p[k].double() - q[k].double()) ** 2).sum() for k in p)))


def test_port_step_parts_from_jax_no_faster_than_two_honest_runs(fixture_root, tmp_path):
    st = Study(fixture_root, tmp_path / "results", TIER1_BATCH, TIER1_STEPS)
    ta, la, _ = st.run_jax(st.init, TIER1_STEPS)
    tb, lb, _ = st.run_port(TIER1_STEPS)
    tc, _, _ = st.run_jax(st.one_ulp_off(), TIER1_STEPS)

    # step 1 against the compiled JAX step: test_fit_one_step_matches_jax's measure
    grads = st.jax_grads_of_step0()
    start = params_from_flax(st.init)
    for k, w in ta[0].items():
        assert (tb[0][k] - start[k]).abs().max().item() > 0, k
        diff = (tb[0][k] - w).abs()
        big = grads[k].abs() > 0.1 * grads[k].abs().max()
        assert diff.max().item() <= 2 * st.lr0, k
        assert diff[big].max().item() <= 0.02 * st.lr0, k

    # steps 1-8: (b) parts from (a) no faster than the one-ulp control does
    d_b = [distance(tb[s], ta[s]) for s in range(TIER1_STEPS)]
    d_c = [distance(tc[s], ta[s]) for s in range(TIER1_STEPS)]
    assert d_c[0] > 0
    assert d_b[-1] / d_b[0] <= 2 * d_c[-1] / d_c[0], (d_b, d_c)
    np.testing.assert_allclose(lb, la, rtol=1e-5)


@pytest.mark.slow
def test_port_under_jax_draws_300_steps(fixture_root, tmp_path):
    """The study behind ROADMAP.md's Queue 3 entry: prints the curves' means
    and the distances; holds step 1 against JAX's op-by-op step (e) and (b)
    to parting no faster than (c) over the whole run."""
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    st = Study(fixture_root, tmp_path / "results", SMOKE["batch_size"], STUDY_STEPS)
    ta, la, pa = st.run_jax(st.init, STUDY_STEPS)
    tb, lb, pb = st.run_port(STUDY_STEPS)
    tc, lc, pc = st.run_jax(st.one_ulp_off(), STUDY_STEPS)
    _, _, pd = st.run_port(STUDY_STEPS, jax_draws=False)
    te, _, _ = st.run_jax(st.init, 1, jit=False)
    tail = slice(-STUDY_TAIL, None)
    d_b = [distance(tb[s], ta[s]) for s in range(STUDY_STEPS)]
    d_c = [distance(tc[s], ta[s]) for s in range(STUDY_STEPS)]
    d_ae, d_be = distance(ta[0], te[0]), distance(tb[0], te[0])
    report = {
        "steps": STUDY_STEPS, "batch_size": SMOKE["batch_size"],
        "psnr1_last100_mean": {"a_jax": pa[tail].mean(), "b_port_jax_draws": pb[tail].mean(),
                               "c_jax_one_ulp": pc[tail].mean(), "d_port_own_draws": pd[tail].mean()},
        "distance_a_b": {"step1": d_b[0], "step8": d_b[7], "final": d_b[-1]},
        "distance_a_c": {"step1": d_c[0], "step8": d_c[7], "final": d_c[-1]},
        "step1_distance_a_e": d_ae, "step1_distance_b_e": d_be,
        "loss_max_abs_gap": {"a_b": float(np.abs(lb - la).max()), "a_c": float(np.abs(lc - la).max())},
    }
    print(json.dumps(report, indent=1, default=float))
    assert np.all(np.isfinite(pb)) and np.all(np.isfinite(pd))
    # the port parts from the compiled step as JAX's unfused step does
    assert d_b[0] <= 2 * d_ae and d_be <= 0.1 * d_ae + 1e-6, (d_b[0], d_ae, d_be)
    assert d_b[-1] / d_b[0] <= 2 * d_c[-1] / d_c[0], (d_b[-1], d_b[0], d_c[-1], d_c[0])
    # decorrelated by the end: (b) no further from (a) than 2x (c)
    assert d_b[-1] <= 2 * d_c[-1], (d_b[-1], d_c[-1])
    assert np.abs(lb - la).max() <= 2 * np.abs(lc - la).max()
