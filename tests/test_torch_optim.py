"""The port's optimizer and scheduler factories (``aon_tpu_torch/train/optim.py``)
against the JAX package's optax ones (``aon_tpu/train/optim.py`` and
``aon_tpu/train/systems.py::make_optimizer``).

Each pair of {sgd, adam, radam} x {steplr, cosine, poly, nerf_loglerp},
with and without a one-epoch warmup (multiplier 2), runs 20 updates from the
same parameters on the same seeded gradients through both packages'
``make_optimizer``; the parameters and the schedule agree at rtol 1e-6 after
every update, with an atol of one float32 ulp of the tree's largest entry
for the entries that pass near zero (where the two orders of the same
float32 operations leave an ulp of the operands: seen 8.4e-9 at 0.0048).  "ranger"
(lookahead over radam on fast / slow parameters) runs through
``get_optimizer`` the same way.  Also: ``make_optimizer`` routes as the JAX
package's and raises for ranger as it does, and a checkpoint of each
optimizer's state resumes bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aon_tpu.train.optim import get_optimizer as jax_get_optimizer
from aon_tpu.train.optim import get_scheduler as jax_get_scheduler
from aon_tpu.train.optim import wrap_lookahead_params as jax_wrap_lookahead_params
from aon_tpu.train.systems import make_optimizer as jax_make_optimizer
from aon_tpu.utils.config import Config as JaxConfig
from aon_tpu_torch.train import optim
from aon_tpu_torch.train.checkpoint import CheckpointManager
from aon_tpu_torch.train.systems import TrainState
from aon_tpu_torch.utils.config import Config

N_UPDATES = 20
# 40 steps in 4 epochs: 10 steps an epoch, so the warmup, the step decay at
# epoch 1 and most of the cosine / poly decay fall inside the 20 updates
SCHED = dict(lr_init=1e-2, run_max_steps=40, num_epochs=4, decay_step=[1], poly_exp=0.9,
             warmup_multiplier=2.0, weight_decay=1e-2, momentum=0.9, lr_delay_steps=5)
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params_and_grads(seed=0):
    g = np.random.default_rng(seed)
    params = {"w": g.normal(size=(4, 5)).astype(np.float32),
              "b": g.normal(size=(5,)).astype(np.float32)}
    grads = [{k: g.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(N_UPDATES)]
    return params, grads


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_tree_close(got, want, what):
    ulp = np.finfo(np.float32).eps * max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=RTOL,
                                   atol=ulp, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("warmup", [0, 1])
@pytest.mark.parametrize("scheduler", ["steplr", "cosine", "poly", "nerf_loglerp"])
@pytest.mark.parametrize("name", ["sgd", "adam", "radam"])
def test_each_pair_matches_optax_over_20_updates(name, scheduler, warmup):
    kw = dict(SCHED, optimizer=name, lr_scheduler=scheduler, warmup_epochs=warmup)
    jtx, jsched = jax_make_optimizer(JaxConfig(**kw))
    tx, sched = optim.make_optimizer(Config(**kw))
    params, grads = _params_and_grads()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    tparams = _torch_tree(params)
    mu, nu = tx.init(tparams)
    for step, g in enumerate(grads):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=RTOL)
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams, mu, nu = tx.update(tparams, _torch_tree(g), mu, nu, step)
        _assert_tree_close(tparams, jparams, f"{name}/{scheduler} step {step}")


def test_ranger_matches_optax_lookahead_over_20_updates():
    steps_per_epoch = 10
    jsched = jax_get_scheduler(1e-2, "cosine", 4, steps_per_epoch)
    sched = optim.get_scheduler(1e-2, "cosine", 4, steps_per_epoch)
    jtx = jax_get_optimizer("ranger", 1e-2, schedule=jsched)
    tx = optim.get_optimizer("ranger", 1e-2, schedule=sched)
    params, grads = _params_and_grads(1)
    jlp = jax_wrap_lookahead_params({k: jnp.asarray(v) for k, v in params.items()})
    jstate = jtx.init(jlp)
    lp = optim.wrap_lookahead_params(_torch_tree(params))
    mu, nu = tx.init(lp)
    for step, g in enumerate(grads):  # three synchronisations (every 6th step)
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jlp)
        jlp = optax.apply_updates(jlp, updates)
        lp, mu, nu = tx.update(lp, _torch_tree(g), mu, nu, step)
        _assert_tree_close(lp.fast, jlp.fast, f"fast, step {step}")
        _assert_tree_close(lp.slow, jlp.slow, f"slow, step {step}")
    assert not np.allclose(np.asarray(jlp.fast["w"]), np.asarray(jlp.slow["w"]))


def test_make_optimizer_routes_as_jax():
    tx, sched = optim.make_optimizer(Config())
    assert type(tx) is optim.Adam and tx.weight_decay == 0.0
    assert sched is tx.schedule
    cases = {("sgd", "poly"): optim.SGD, ("adam", "cosine"): optim.Adam,
             ("radam", "nerf_loglerp"): optim.RAdam}
    for (name, scheduler), cls in cases.items():
        cfg = Config(optimizer=name, lr_scheduler=scheduler, run_max_steps=90, num_epochs=4)
        tx, sched = optim.make_optimizer(cfg)
        jtx, jsched = jax_make_optimizer(JaxConfig(**dataclasses.asdict(cfg)))
        assert type(tx) is cls
        # steps_per_epoch = run_max_steps // num_epochs = 22: the schedules agree past it
        for step in (0, 21, 22, 45, 90):
            np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=RTOL)
    for mod, cfg_cls in ((optim, Config), (None, JaxConfig)):
        make = mod.make_optimizer if mod else jax_make_optimizer
        with pytest.raises(ValueError, match="LookaheadParams"):
            make(cfg_cls(optimizer="ranger"))
    with pytest.raises(ValueError, match="not recognized"):
        optim.make_optimizer(Config(optimizer="adagrad", lr_scheduler="poly"))
    with pytest.raises(ValueError, match="not recognized"):
        optim.make_optimizer(Config(lr_scheduler="exp"))


@pytest.mark.parametrize("name", ["sgd", "adam", "radam"])
def test_a_checkpoint_resumes_bit_for_bit(tmp_path, name):
    tx, _ = optim.make_optimizer(Config(**dict(SCHED, optimizer=name, lr_scheduler="poly")))
    params, grads = _params_and_grads()
    fresh = TrainState(step=0, params=_torch_tree(params), mu=tx.init(_torch_tree(params))[0],
                       nu=tx.init(_torch_tree(params))[1], tx=tx)
    state = fresh
    for g in grads[:5]:
        state = state.apply_gradients(_torch_tree(g))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_last(state, epoch=0)
    resumed = ckpt.restore(fresh)
    assert resumed.step == 5
    for g in grads[5:]:
        state = state.apply_gradients(_torch_tree(g))
        resumed = resumed.apply_gradients(_torch_tree(g))
    for part in ("params", "mu", "nu"):
        got, want = getattr(resumed, part), getattr(state, part)
        assert set(got) == set(want) and (part != "mu" or got)
        for k in want:
            assert torch.equal(got[k], want[k]), (part, k)
    assert (name == "sgd") == (not state.nu)  # SGD carries its trace alone
