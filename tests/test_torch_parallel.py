"""The port's data parallelism (``aon_tpu_torch/parallel/``, the ranks' route
of ``train/microbatch.py`` and ``eval/render.py``) and its profiling hooks
(``aon_tpu_torch/utils/profiling.py``), against the JAX package.

* ``process_ray_slice``, ``alter_gather_cat``, ``pad_to_multiple``, the
  classification of batch entries by key and each rank's block of a
  superbatch, against ``aon_tpu.parallel`` (a rank's block against the shard
  of that device of a 2-device mesh), exactly.
* Two gloo ranks (subprocesses that import torch only) against one process,
  through ``aon_tpu_torch/scripts/multihost_train_demo.py``: the vanilla and
  auto-decoder systems for 3 steps, the auto-encoder for 1 (its later steps
  diverge chaotically in either package: tests/test_multihost.py:104-117), at
  ``tests/test_multihost.py``'s tolerances (loss and parameter digest
  rtol 1e-5).
* The vanilla system's 2-rank ``make_train_many_sharded`` against the JAX
  package's on 2 of the 8 virtual devices, at ``tests/test_sharded_fused.py``'s
  size (64 rays, 8 + 8 samples, 2 steps of 2 microbatches of 32) and
  loss tolerance (rtol 1e-4).  Both run the plain float32 module on the
  real draws, per ray as the fused routes draw across ranks: step t's key
  ``fold_in(key, t)``, its ``split(key, 4)``, the coarse and fine uniforms
  ``uniform(fold_in(k, ray_id), (n,))`` of the global ray ids, the same
  bits in both packages (tests/test_torch_prng.py).  The
  parameters are held as chip_smoke.py holds train_many against train_step:
  an early Adam step moves an entry by ``lr * g / (|g| + eps)``, so an entry
  whose gradient lies within float32 noise of zero may go either way by the
  lr (seen: one bias of 256 flipped, 1.03e-5 after two steps of ~5.2e-6);
  the largest difference is held to 2 lr a step, and the mean difference
  over all entries, which a systematic fault moves, to 2e-7 (seen 1.6e-8;
  one rank's rays without the all-reduce give 3.7e-6).
* A 2-rank eval gather (``multihost_eval_demo.py``) against one process's frame.
* ``profiling.trace`` names an ``annotate`` span; ``AON_DEBUG_NANS=1`` turns
  anomaly detection on.

Every subprocess has its own timeout.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.core import rendering as jrendering  # noqa: E402
from aon_tpu.core import sampling as jsampling  # noqa: E402
from aon_tpu.models.mlp import NeRFMLP as JaxNeRFMLP  # noqa: E402
from aon_tpu.parallel import get_mesh  # noqa: E402
from aon_tpu.parallel import mesh as jax_mesh  # noqa: E402
from aon_tpu.parallel import multihost as jax_multihost  # noqa: E402
from aon_tpu.train.microbatch import make_train_many_sharded as jax_train_many_sharded  # noqa: E402
from aon_tpu.train.systems import VanillaSystem as JaxVanillaSystem  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.parallel import mesh, multihost  # noqa: E402
from aon_tpu_torch.scripts import make_fixture_dataset as tfixture  # noqa: E402
from aon_tpu_torch.train.optim import make_optimizer  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402
from aon_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300  # seconds, each subprocess


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in ("AON_DISTRIBUTED", "WORLD_SIZE", "RANK", "LOCAL_RANK", "AON_DEBUG_NANS"):
        env.pop(k, None)
    return env


def _run_ranks(cmds, envs=None, cwd=REPO):
    """Run the commands side by side (the ranks of one group), each with its
    timeout and its extra environment; raise with its stderr where one fails."""
    envs = envs or [{}] * len(cmds)
    procs = [subprocess.Popen(c, env=dict(_env(), **e), cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c, e in zip(cmds, envs)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]


def _module(name):
    return [sys.executable, "-m", f"aon_tpu_torch.scripts.{name}", "--device", "cpu"]


# ------------------------------------------------------------ the helpers


@pytest.mark.parametrize("n,p", [(769, 4), (1024, 2), (5, 1)])
def test_process_ray_slice_matches_jax(n, p):
    blocks = [multihost.process_ray_slice(n, pid, p) for pid in range(p)]
    assert blocks == [jax_multihost.process_ray_slice(n, pid, p) for pid in range(p)]
    assert blocks[-1][1] >= n and multihost.process_ray_slice(n) == (0, n)


def test_alter_gather_cat_matches_jax_in_one_process(rng):
    w, h = 8, 4
    chunks = [{"comp_rgb": rng.normal(size=(20, 3)).astype(np.float32),
               "acc": rng.normal(size=(20,)).astype(np.float32)} for _ in range(2)]
    got = multihost.alter_gather_cat(chunks, (w, h))
    want = jax_multihost.alter_gather_cat(chunks, (w, h))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n,multiple", [(10, 4), (12, 4), (7, 1)])
def test_pad_to_multiple_matches_jax(rng, n, multiple):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_array_equal(mesh.pad_to_multiple(x, multiple),
                                  jax_mesh.pad_to_multiple(x, multiple))


def test_entries_are_classified_by_key_as_jax(rng):
    entries = {"rays_o": np.zeros((8, 3)), "t_near": np.zeros(8), "loss_w": np.zeros(8),
               "instance_id": np.asarray(1), "src_imgs": np.zeros((1, 3, 4, 4)),
               "deg": np.asarray(0.5)}
    assert mesh.RAY_KEYS == jax_mesh.RAY_KEYS
    for k, v in entries.items():
        assert mesh._is_ray_entry(k, v, 4) == jax_mesh._is_ray_entry(k, v, 4), k
    for bad in (np.zeros((6, 3)), np.zeros((2, 3)), np.asarray(1.0)):
        for fn in (mesh._is_ray_entry, jax_mesh._is_ray_entry):
            with pytest.raises(ValueError, match="not shardable"):
                fn("rays_o", bad, 4)


def _batches(rng, n_steps=2, n=64):
    return [{"rays_o": rng.normal(size=(n, 3)).astype(np.float32),
             "t_near": rng.uniform(size=(n,)).astype(np.float32),
             "instance_id": np.asarray(i, np.int32)} for i in range(n_steps)]


@pytest.mark.parametrize("microbatch", [None, 16])
def test_each_rank_holds_its_devices_block(rng, monkeypatch, eight_devices, microbatch):
    """stack_step_batches and shard_ray_batch on rank r of 2 hold what the JAX
    package puts on device r of a 2-device mesh."""
    batches = _batches(rng)
    mesh2 = get_mesh(2)
    want_stack = jax_mesh.stack_step_batches(batches, mesh2, microbatch=microbatch)
    want_shard = jax_mesh.shard_ray_batch(batches[0], mesh2, microbatch=microbatch)
    for rank in range(2):
        monkeypatch.setattr(mesh, "rank_of", lambda group, r=rank: r)
        monkeypatch.setattr(mesh, "size_of", lambda group: 2)
        got_stack = mesh.stack_step_batches(batches, microbatch, "cpu", group="two ranks")
        got_shard = mesh.shard_ray_batch(batches[0], microbatch, "cpu", group="two ranks")
        for got, want in ((got_stack, want_stack), (got_shard, want_shard)):
            assert set(got) == set(want)
            for k, v in want.items():
                shard = next(s.data for s in v.addressable_shards if s.device == mesh2.devices[rank])
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard), err_msg=k)
    with pytest.raises(ValueError, match="not shardable"):
        mesh.stack_step_batches(batches, 1, "cpu", group="two ranks")


def test_a_world_above_one_never_trains_alone(monkeypatch):
    monkeypatch.delenv("AON_DISTRIBUTED", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="AON_DISTRIBUTED"):
        mesh.maybe_initialize_distributed("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert mesh.get_group(0) is None and mesh.get_group(1) is None
    with pytest.raises(ValueError, match="world size is 1"):
        mesh.get_group(2)


# ------------------------------------------------------------ two gloo ranks


@pytest.mark.parametrize("system,steps", [("vanilla", 3), ("autodecoder", 3), ("ae", 1)])
def test_two_ranks_train_to_the_single_process_result(tmp_path, system, steps):
    args = ["--system", system, "--steps", str(steps)]
    single = tmp_path / "single.npz"
    _run_ranks([_module("multihost_train_demo") + args + ["--out", str(single)]])
    port = _free_port()
    outs = [tmp_path / f"p{r}.npz" for r in range(2)]
    _run_ranks([_module("multihost_train_demo") + args + [
        "--num_processes", "2", "--process_id", str(r), "--coordinator", f"localhost:{port}",
        "--out", str(outs[r])] for r in range(2)])
    want = np.load(single)
    assert int(want["processes"]) == 1
    for out in outs:
        got = np.load(out)
        assert int(got["processes"]) == 2
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["params_digest"], want["params_digest"], rtol=1e-5)
    # the ranks apply the same update: their parameters are equal bit for bit
    np.testing.assert_array_equal(np.load(outs[0])["params"], np.load(outs[1])["params"])


def test_two_ranks_render_the_single_process_frame(tmp_path):
    single = tmp_path / "single.npz"
    _run_ranks([_module("multihost_eval_demo") + ["--out", str(single)]])
    port = _free_port()
    outs = [tmp_path / f"p{r}.npz" for r in range(2)]
    _run_ranks([_module("multihost_eval_demo") + [
        "--num_processes", "2", "--process_id", str(r), "--coordinator", f"localhost:{port}",
        "--out", str(outs[r])] for r in range(2)])
    want = np.load(single)
    assert want["comp_rgb"].shape == (24, 32, 3)
    for out in outs:
        got = np.load(out)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


_CLI = ("import sys; from aon_tpu_torch import run; from aon_tpu_torch.utils.config import "
        "get_config; run.main(get_config(sys.argv[1:]), device='cpu')")


def test_two_ranks_run_the_cli_to_the_single_process_outputs(tmp_path):
    """python -m aon_tpu_torch.run over two ranks (AON_DISTRIBUTED=1 and the
    variables torch.distributed.run sets): a fit of 3 epochs of 2 steps, each
    one dispatch of 2 with a validation after it, then --run_eval.  The
    logged losses, val and test PSNR are the one process's, and rank 0 alone
    writes: one line a record in metrics.jsonl, one results.json.  (A step
    dispatched alone draws per ray over ranks and one block in one process,
    as in the JAX package: see ``_System.train_step``.)"""
    data = tmp_path / "data"
    tfixture.main([str(data), "--n", "3", "--wh", "64", "48", "--seed", "1"])
    cfg = dict(dataset_name="sapien", root_dir=str(data), exp_name="dp", exp_type="vanilla",
               img_wh=[64, 48], white_back=True, use_aabb=True, N_samples=4, N_importance=4,
               batch_size=64, microbatch_rays=32, compute_dtype="float32", chunk=512,
               num_epochs=3, run_max_steps=6, steps_per_dispatch=2, log_every_n_steps=2,
               limit_val_batches=1)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    def rank_envs():  # the fit and the eval each meet at a port of their own
        port = str(_free_port())
        return [dict(AON_DISTRIBUTED="1", RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                     MASTER_ADDR="localhost", MASTER_PORT=port) for r in range(2)]

    for side in ("single", "ranks"):
        (tmp_path / side).mkdir()
        for extra in ([], ["--run_eval", "--render_name", "t"]):
            envs = [{}] if side == "single" else rank_envs()
            _run_ranks([[sys.executable, "-c", _CLI, "--config", str(tmp_path / "cfg.json")]
                        + extra] * len(envs), envs, cwd=tmp_path / side)
    recs = {side: [json.loads(ln) for ln in (tmp_path / side / "results" / "dp" /
                                             "metrics.jsonl").read_text().splitlines()]
            for side in ("single", "ranks")}
    assert [sorted(r) for r in recs["ranks"]] == [sorted(r) for r in recs["single"]]
    for got, want in zip(recs["ranks"], recs["single"]):
        assert got["step"] == want["step"]
        for k in ("train/loss", "train/loss_last", "val/psnr", "test/psnr"):
            if k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert any("train/loss" in r for r in recs["single"])
    assert any("test/psnr" in r for r in recs["single"])
    res = [json.loads((tmp_path / s / "ckpts" / "dp" / "results.json").read_text())
           for s in ("single", "ranks")]
    np.testing.assert_allclose(res[1]["PSNR"]["each"], res[0]["PSNR"]["each"], rtol=1e-5)


# the ranks of the JAX comparison: torch and the port only
_SHARDED_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from aon_tpu_torch.core import prng
    from aon_tpu_torch.core.rendering import img2mse
    from aon_tpu_torch.core.sampling import per_ray_uniform
    from aon_tpu_torch.parallel.mesh import stack_step_batches
    from aon_tpu_torch.train.microbatch import make_train_many_sharded
    from aon_tpu_torch.train.systems import TrainState, VanillaSystem
    from aon_tpu_torch.utils.config import Config

    rank, port, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    data = np.load(inp)
    system = VanillaSystem(Config(N_samples=8, N_importance=8, compute_dtype="float32"),
                           2.0, 6.0, True, device="cpu")

    def loss_fn(params, batch, key=None, draws=None):
        # the plain module on the per-ray draws of the step's key
        rays = {k: batch[k] for k in ("rays_o", "rays_d", "viewdirs")}
        k0, _, k2, _ = prng.split(key, 4)
        draws = {"t_rand": per_ray_uniform(k0, batch["ray_ids"], 9),
                 "u": per_ray_uniform(k2, batch["ray_ids"], 8)}
        levels = torch.func.functional_call(system.model, dict(params), (rays, True, 2.0, 6.0),
                                            dict(randomized=True, draws=draws))
        loss0, loss1 = (img2mse(lv[0], batch["target"]) for lv in levels)
        return loss0 + loss1, {"loss0": loss0, "loss1": loss1}

    many = make_train_many_sharded(loss_fn, lambda loss, aux: {"train/loss": loss},
                                   dist.group.WORLD)
    params = {k[len("params/"):]: torch.from_numpy(data[k]) for k in data.files
              if k.startswith("params/")}
    state = TrainState(0, params, *system.tx.init(params), system.tx)
    batch = {k: data[k] for k in ("rays_o", "rays_d", "viewdirs", "target")}
    superbatch = stack_step_batches([batch] * 2, 32, "cpu", dist.group.WORLD)
    state, metrics = many(state, superbatch, prng.key(1))
    np.savez(out, loss=float(metrics["train/loss"]),
             **{"params/" + k: v.numpy() for k, v in state.params.items()})
    dist.destroy_process_group()
''')


def test_two_ranks_match_jax_make_train_many_sharded(tmp_path, eight_devices):
    g = np.random.default_rng(0)
    B = 64
    d = g.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"rays_o": (-4 * d).astype(np.float32), "rays_d": d, "viewdirs": d,
             "target": g.uniform(size=(B, 3)).astype(np.float32)}
    jsys = JaxVanillaSystem(JaxConfig(N_samples=8, N_importance=8, compute_dtype="float32"),
                            2.0, 6.0, True)
    state0 = jsys.init_state(jax.random.PRNGKey(0))
    inp = tmp_path / "in.npz"
    init = params_from_flax(jax.tree.map(np.asarray, state0.params))
    np.savez(inp, **batch, **{"params/" + k: v.numpy() for k, v in init.items()})

    def jloss(params, b, key):
        # VanillaNeRF's two levels, drawing per ray as the fused losses do
        o, d, ids = b["rays_o"], b["rays_d"], b["ray_ids"]
        k0, _, k2, _ = jax.random.split(key, 4)
        venc = jsampling.pos_enc(b["viewdirs"], 0, 4)

        def level(p, t, pts):
            rgb, sigma = JaxNeRFMLP().apply({"params": p}, jsampling.pos_enc(pts, 0, 10), venc)
            return jrendering.volumetric_rendering(jax.nn.sigmoid(rgb), jax.nn.relu(sigma), t,
                                                   d, white_bkgd=True)

        t, pts = jsampling.sample_along_rays(k0, o, d, 8, 2.0, 6.0, True, ray_ids=ids)
        comp0, _, w, _ = level(params["coarse_mlp"], t, pts)
        t, pts = jsampling.sample_pdf(k2, 0.5 * (t[..., 1:] + t[..., :-1]), w[..., 1:-1], o, d,
                                      t, 8, True, ray_ids=ids)
        comp1, _, _, _ = level(params["fine_mlp"], t, pts)
        loss0, loss1 = (jax.numpy.mean((c - b["target"]) ** 2) for c in (comp0, comp1))
        return loss0 + loss1, {"loss0": loss0, "loss1": loss1}

    mesh2 = get_mesh(2)
    many = jax_train_many_sharded(jloss, lambda loss, aux: {"train/loss": loss}, mesh2)
    want_state, want_metrics = many(
        state0, jax_mesh.stack_step_batches([batch] * 2, mesh2, microbatch=32),
        jax.random.PRNGKey(1))
    want = params_from_flax(jax.tree.map(np.asarray, want_state.params))

    port = _free_port()
    outs = [tmp_path / f"p{r}.npz" for r in range(2)]
    _run_ranks([[sys.executable, "-c", _SHARDED_WORKER, str(r), str(port), str(inp),
                 str(outs[r])] for r in range(2)])
    lr_sum = sum(make_optimizer(Config())[1](i) for i in range(2))
    moved = max(float(np.abs(v.numpy() - init[k].numpy()).max()) for k, v in want.items())
    assert moved > 0.5 * lr_sum  # the parameters did move
    for out in outs:
        got = np.load(out)
        np.testing.assert_allclose(got["loss"], float(want_metrics["train/loss"]), rtol=1e-4)
        diffs = np.concatenate([np.abs(got["params/" + k] - v.numpy()).reshape(-1)
                                for k, v in want.items()])
        assert diffs.max() <= 2.0 * lr_sum, diffs.max()
        assert diffs.mean() <= 2e-7, diffs.mean()


# ------------------------------------------------------------ profiling


def test_trace_names_an_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("aon_span"):
            torch.ones(64).sum()
    text = (tmp_path / profiling.TRACE_FILE).read_text()
    assert '"aon_span"' in text


def test_debug_nans_env_turns_anomaly_detection_on(monkeypatch):
    before = torch.is_anomaly_enabled()
    try:
        monkeypatch.delenv("AON_DEBUG_NANS", raising=False)
        torch.autograd.set_detect_anomaly(False)
        assert not profiling.maybe_enable_debug_nans(False)
        monkeypatch.setenv("AON_DEBUG_NANS", "1")
        assert profiling.maybe_enable_debug_nans(False) and torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(False)
        monkeypatch.delenv("AON_DEBUG_NANS")
        assert profiling.maybe_enable_debug_nans(True)
    finally:
        torch.autograd.set_detect_anomaly(before)
