"""Optimizers and learning-rate schedules of the training systems (port of
``aon_tpu/train/optim.py`` and of ``aon_tpu/train/systems.py::make_optimizer``).

The reference defines sgd / adam / radam / ranger and steplr / cosine / poly
with a gradual warmup (``utils/__init__.py:32-88``) but its live systems use
plain Adam with the log-lerp schedule; the JAX package makes the factories
reachable from the config, and so does this module.  The JAX package builds
them from optax; here each is written out as tensor code on ``{name:
tensor}`` trees in the order optax computes it:

* ``get_scheduler``: ``steplr`` (``piecewise_constant_schedule``, boundaries
  at ``epoch * steps_per_epoch``), ``cosine`` (``cosine_decay_schedule``),
  ``poly`` (``polynomial_schedule`` from ``lr`` to 0 at ``poly_exp``), each
  under the gradual-warmup multiplier ramp; plain functions of the step,
  computed in float32 as optax computes them.
* ``get_optimizer``: ``sgd`` (``add_decayed_weights`` then ``sgd`` with
  momentum), ``adam`` (``adamw``: the reference's "adam" is AdamW), ``radam``
  (``radam``), ``ranger`` (``lookahead`` over ``radam``, ``sync_period=6``,
  ``slow_step_size=0.5``, on ``LookaheadParams``).

Every optimizer is functional, ``init(params) -> (mu, nu)`` and
``update(params, grads, mu, nu, step) -> (params, mu, nu)``, from the state
after ``step`` updates: the schedule is read at ``step``, the bias
corrections use ``step + 1``.  ``mu`` is the first moment (SGD's momentum
trace), ``nu`` the second (empty for SGD), so ``TrainState`` and the
checkpoints carry every optimizer's own state.  The updates run as
``torch._foreach_*`` calls, a dozen launches per step for all parameter
tensors together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from aon_tpu_torch.train.schedule import nerf_lr_schedule
from aon_tpu_torch.utils.config import Config

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]
f32 = np.float32


def get_scheduler(
    lr: float,
    lr_scheduler: str = "poly",
    num_epochs: int = 80,
    steps_per_epoch: int = 1000,
    decay_step: Sequence[int] = (20,),
    decay_gamma: float = 0.1,
    poly_exp: float = 0.99,
    warmup_epochs: int = 0,
    warmup_multiplier: float = 1.0,
) -> Schedule:
    """``fn(step) -> lr``: steplr / cosine / poly over ``num_epochs`` epochs of
    ``steps_per_epoch`` steps (the reference's epoch-based schedules,
    utils/__init__.py:71-88, in steps), under a linear warmup multiplier
    from 1 to ``warmup_multiplier`` over ``warmup_epochs`` epochs
    (GradualWarmupScheduler)."""
    total_steps = max(1, num_epochs * steps_per_epoch)

    if lr_scheduler == "steplr":
        boundaries = sorted({int(e) * steps_per_epoch: decay_gamma for e in decay_step}.items())

        def base(step: int):
            v = f32(lr)
            for threshold, scale in boundaries:
                if step >= threshold:
                    v = f32(scale) * v
            return v
    elif lr_scheduler == "cosine":
        def base(step: int):
            count = f32(min(step, total_steps))
            cosine_decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(total_steps),
                                                       dtype=f32))
            return f32(lr) * cosine_decay
    elif lr_scheduler == "poly":
        def base(step: int):
            count = f32(min(max(step, 0), total_steps))
            frac = f32(1) - count / f32(total_steps)
            return f32(lr) * np.power(frac, f32(poly_exp), dtype=f32)
    else:
        raise ValueError(f"scheduler {lr_scheduler!r} not recognized")

    if warmup_epochs <= 0:
        return lambda step: float(base(step))

    warmup_steps = warmup_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        frac = np.clip(f32(step) / f32(warmup_steps), f32(0), f32(1))
        mult = f32(1) + f32(warmup_multiplier - 1.0) * frac
        return float(f32(base(step) * mult))

    return schedule


class _Optimizer:
    """``update`` = the parameters plus ``updates``: each subclass computes its
    scaled step ``-lr * ...`` in ``updates``, in optax's order of float32
    operations (its bias corrections in float32 too), so that on the CPU the
    two agree bit for bit on the same gradients."""

    schedule: Schedule

    def updates(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                mu: Mapping[str, torch.Tensor], nu: Mapping[str, torch.Tensor],
                step: int) -> Tuple[Tree, Tree, Tree]:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
               mu: Mapping[str, torch.Tensor], nu: Mapping[str, torch.Tensor],
               step: int) -> Tuple[Tree, Tree, Tree]:
        """One step from the state after ``step`` updates: new ``(params, mu, nu)``."""
        u, mu, nu = self.updates(params, grads, mu, nu, step)
        names = list(params)
        new_p = torch._foreach_add([params[k] for k in names], [u[k] for k in names])
        return dict(zip(names, new_p)), mu, nu


def _pow_f32(x: float, n: int):
    """``x**n`` in float32 by square-and-multiply, as XLA computes a float32
    to an integer power: RAdam's rectification cancels ~300-fold, so an ulp
    of ``b2**n`` moves it by a tenth of a percent."""
    base, acc = f32(x), f32(1)
    while n:
        if n & 1:
            acc = f32(acc * base)
        base = f32(base * base)
        n >>= 1
    return acc


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(f32(1) - _pow_f32(decay, count))


class Adam(_Optimizer):
    """Functional Adam over ``{name: tensor}`` trees; with ``weight_decay``
    AdamW (optax's ``adamw``: the decay is added to the scaled update)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> Tuple[Tree, Tree]:
        return ({k: torch.zeros_like(v) for k, v in params.items()},
                {k: torch.zeros_like(v) for k, v in params.items()})

    def _moments(self, names, grads, mu, nu, count):
        """The new moments and their bias-corrected values."""
        g = [grads[k] for k in names]
        m = torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1),
                               torch._foreach_mul([mu[k] for k in names], self.b1))
        v = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
                               torch._foreach_mul([nu[k] for k in names], self.b2))
        m_hat = torch._foreach_div(m, _bias_correction(self.b1, count))
        v_hat = torch._foreach_div(v, _bias_correction(self.b2, count))
        return m, v, m_hat, v_hat

    def _denom(self, v_hat):
        denom = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(denom, self.eps)
        return denom

    @torch.no_grad()
    def updates(self, params, grads, mu, nu, step):
        lr = self.schedule(step)
        names = list(params)
        m, v, m_hat, v_hat = self._moments(names, grads, mu, nu, step + 1)
        u = torch._foreach_div(m_hat, self._denom(v_hat))
        if self.weight_decay != 0.0:
            u = torch._foreach_add(u, torch._foreach_mul([params[k] for k in names],
                                                         self.weight_decay))
        u = torch._foreach_mul(u, -lr)
        return dict(zip(names, u)), dict(zip(names, m)), dict(zip(names, v))


class RAdam(Adam):
    """Functional Rectified Adam (optax's ``radam``): the Adam step scaled by
    the variance rectification ``r`` once the approximated SMA length ``ro``
    reaches ``threshold``, the bias-corrected momentum alone before."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, threshold: float = 5.0):
        super().__init__(schedule, b1, b2, eps)
        self.threshold = threshold

    @torch.no_grad()
    def updates(self, params, grads, mu, nu, step):
        lr = self.schedule(step)
        count = step + 1
        names = list(params)
        m, v, m_hat, v_hat = self._moments(names, grads, mu, nu, count)
        ro_inf = f32(2.0 / (1.0 - self.b2) - 1.0)
        b2t = _pow_f32(self.b2, count)
        ro = ro_inf - f32(2 * count) * b2t / (f32(1) - b2t)
        if ro >= self.threshold:
            r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                        / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro), dtype=f32)
            u = torch._foreach_div(torch._foreach_mul(m_hat, float(r)), self._denom(v_hat))
        else:
            u = m_hat
        u = torch._foreach_mul(u, -lr)
        return dict(zip(names, u)), dict(zip(names, m)), dict(zip(names, v))


class SGD(_Optimizer):
    """Functional SGD with momentum and weight decay added to the gradient
    (optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))``): the trace
    is ``g + wd * p + momentum * trace``, the step ``-lr * trace``."""

    def __init__(self, schedule: Schedule, momentum: float = 0.9, weight_decay: float = 0.0):
        self.schedule, self.momentum, self.weight_decay = schedule, momentum, weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> Tuple[Tree, Tree]:
        return {k: torch.zeros_like(v) for k, v in params.items()}, {}

    @torch.no_grad()
    def updates(self, params, grads, mu, nu, step):
        lr = self.schedule(step)
        names = list(params)
        g = [grads[k] for k in names]
        if self.weight_decay != 0.0:
            g = torch._foreach_add(g, torch._foreach_mul([params[k] for k in names],
                                                         self.weight_decay))
        trace = torch._foreach_add(g, torch._foreach_mul([mu[k] for k in names], self.momentum))
        return dict(zip(names, torch._foreach_mul(trace, -lr))), dict(zip(names, trace)), {}


@dataclasses.dataclass(frozen=True)
class LookaheadParams:
    """The fast and slow parameter trees of the lookahead optimizer."""

    fast: Tree
    slow: Tree


def wrap_lookahead_params(params: Mapping[str, torch.Tensor]) -> LookaheadParams:
    """Wrap a params tree for the "ranger" (lookahead) optimizer."""
    return LookaheadParams(fast=dict(params), slow={k: v.clone() for k, v in params.items()})


class Lookahead:
    """Functional lookahead (optax's ``lookahead``) over a fast optimizer, on
    ``LookaheadParams``: ``sync_period`` fast steps, then the slow weights
    move ``slow_step_size`` of the way to the fast ones and the fast weights
    restart from them.  The gradients are the fast weights'; the fast
    optimizer's ``(mu, nu)`` are the state, and the steps since the last
    synchronisation are ``step % sync_period``."""

    def __init__(self, fast: _Optimizer, sync_period: int = 6, slow_step_size: float = 0.5):
        if sync_period < 1:
            raise ValueError("Synchronization period must be >= 1.")
        self.fast, self.sync_period, self.slow_step_size = fast, sync_period, slow_step_size
        self.schedule = fast.schedule

    def init(self, params: LookaheadParams) -> Tuple[Tree, Tree]:
        return self.fast.init(params.fast)

    @torch.no_grad()
    def update(self, params: LookaheadParams, grads, mu, nu, step):
        u, mu, nu = self.fast.updates(params.fast, grads, mu, nu, step)
        names = list(u)
        fast = [params.fast[k] for k in names]
        slow = [params.slow[k] for k in names]
        up = [u[k] for k in names]
        if step % self.sync_period == self.sync_period - 1:
            # the last fast step, then the slow weights move toward it and the
            # fast weights restart from them (optax's merged update)
            diff = torch._foreach_sub(torch._foreach_add(fast, up), slow)
            slow = torch._foreach_add(slow, torch._foreach_mul(diff, self.slow_step_size))
            up = torch._foreach_sub(up, torch._foreach_mul(diff, 1.0 - self.slow_step_size))
        fast = torch._foreach_add(fast, up)
        return LookaheadParams(fast=dict(zip(names, fast)), slow=dict(zip(names, slow))), mu, nu


def get_optimizer(optimizer: str = "adam", lr: float = 1.0e-3, momentum: float = 0.9,
                  weight_decay: float = 0.0, eps: float = 1e-8,
                  schedule: Optional[Schedule] = None):
    """sgd / adam / radam / ranger (utils/__init__.py:32-52 parity) at the
    learning rate ``schedule`` (a constant ``lr`` without one).  The
    reference's "adam" is AdamW; "ranger" is lookahead over RAdam and takes
    ``LookaheadParams`` (``wrap_lookahead_params``)."""
    schedule = schedule if schedule is not None else (lambda step: lr)
    if optimizer == "sgd":
        return SGD(schedule, momentum=momentum, weight_decay=weight_decay)
    if optimizer == "adam":
        return Adam(schedule, eps=eps, weight_decay=weight_decay)
    if optimizer == "radam":
        return RAdam(schedule, eps=eps)
    if optimizer == "ranger":
        return Lookahead(RAdam(schedule, eps=eps), sync_period=6, slow_step_size=0.5)
    raise ValueError(f"optimizer {optimizer!r} not recognized")


def default_nerf_optimizer(cfg: Config) -> Adam:
    """The live training path's Adam + log-lerp/warmup schedule."""
    return Adam(
        nerf_lr_schedule(
            cfg.lr_init, cfg.lr_final, cfg.lr_delay_steps, cfg.lr_delay_mult,
            # lr_max_steps pins the decay horizon apart from run_max_steps
            # (0 = coupled); past it the schedule floors at lr_final
            cfg.lr_max_steps or cfg.run_max_steps,
        ),
        b1=0.9, b2=0.999,
    )


def make_optimizer(cfg: Config):
    """Config-routed optimizer + schedule: ``(optimizer, lr_schedule)``.

    adam + ``nerf_loglerp`` is the reference's live path (plain Adam with the
    log-lerp schedule); every other pair goes through the factories, with
    ``steps_per_epoch = run_max_steps // num_epochs``.  "ranger" raises, as
    the JAX package's does: its fast/slow parameter pairs are not what the
    systems' checkpoints and renderers carry."""
    if cfg.optimizer == "adam" and cfg.lr_scheduler == "nerf_loglerp":
        tx = default_nerf_optimizer(cfg)
        return tx, tx.schedule
    if cfg.optimizer == "ranger":
        raise ValueError(
            "optimizer='ranger' (RAdam+Lookahead) needs LookaheadParams-wrapped "
            "param trees, which the training systems' checkpoint/render paths "
            "don't carry; use train/optim.get_optimizer directly for it")
    if cfg.lr_scheduler == "nerf_loglerp":
        schedule = default_nerf_optimizer(cfg).schedule
    else:
        steps_per_epoch = max(1, cfg.run_max_steps // max(1, cfg.num_epochs))
        schedule = get_scheduler(
            cfg.lr_init, cfg.lr_scheduler, cfg.num_epochs, steps_per_epoch,
            decay_step=cfg.decay_step, decay_gamma=cfg.decay_gamma, poly_exp=cfg.poly_exp,
            warmup_epochs=cfg.warmup_epochs, warmup_multiplier=cfg.warmup_multiplier)
    tx = get_optimizer(cfg.optimizer, cfg.lr_init, momentum=cfg.momentum,
                       weight_decay=cfg.weight_decay, schedule=schedule)
    return tx, schedule
