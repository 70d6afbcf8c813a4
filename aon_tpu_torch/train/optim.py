"""The optimizer of the training systems (port of the default pair of
``aon_tpu/train/systems.py::make_optimizer``).

Only the reference's live path is ported: plain Adam(0.9, 0.999, eps 1e-8)
with the log-lerp + sin-warmup schedule.  The factory surface of
``aon_tpu/train/optim.py`` (sgd / radam / ranger, steplr / cosine / poly,
gradual warmup) is ROADMAP.md slice 6.

The update is written out as tensor code on dictionaries of tensors, in the
order ``optax.adam`` computes it: the schedule is read at the count before
the update, the bias corrections use the count after it, and the step is
``-lr * m_hat / (sqrt(v_hat) + eps)``.  It runs as ``torch._foreach_*``
calls, a dozen launches per step for all parameter tensors together.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from aon_tpu_torch.train.schedule import nerf_lr_schedule
from aon_tpu_torch.utils.config import Config

Tree = Dict[str, torch.Tensor]


class Adam:
    """Functional Adam over ``{name: tensor}`` trees."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> Tuple[Tree, Tree]:
        return ({k: torch.zeros_like(v) for k, v in params.items()},
                {k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
               mu: Mapping[str, torch.Tensor], nu: Mapping[str, torch.Tensor],
               step: int) -> Tuple[Tree, Tree, Tree]:
        """One step from the state after ``step`` updates: new ``(params, mu, nu)``."""
        lr = self.schedule(step)
        count = step + 1
        c1, c2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        names = list(params)
        p, g = [params[k] for k in names], [grads[k] for k in names]
        # one launch per operation for all tensors together, not one per tensor
        m = torch._foreach_mul([mu[k] for k in names], self.b1)
        torch._foreach_add_(m, g, alpha=1.0 - self.b1)
        v = torch._foreach_mul([nu[k] for k in names], self.b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        new_p = torch._foreach_add(p, torch._foreach_div(m, denom), alpha=-lr / c1)
        return dict(zip(names, new_p)), dict(zip(names, m)), dict(zip(names, v))


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


def make_optimizer(cfg: Config) -> Tuple[Adam, Callable[[int], float]]:
    """Config-routed optimizer + schedule: ``(optimizer, lr_schedule)``."""
    if cfg.optimizer == "adam" and cfg.lr_scheduler == "nerf_loglerp":
        tx = default_nerf_optimizer(cfg)
        return tx, tx.schedule
    raise NotImplementedError(
        f"optimizer={cfg.optimizer!r} with lr_scheduler={cfg.lr_scheduler!r} is not ported yet "
        "(ROADMAP.md slice 6, Queue 1 item 9); only adam + nerf_loglerp is"
    )
