"""Microbatched gradient accumulation and multi-step dispatch (port of
``aon_tpu/train/microbatch.py``).

Gradient accumulation has exact mean semantics: equal-size microbatch MSE
means average to the full-batch mean.  Ray entries of a stacked batch arrive
as ``(k, m, ...)``; a flat batch ``(m, ...)`` is one microbatch.  Every other
entry is shared: it reaches each microbatch as it is (the auto-decoder's
``instance_id`` and ``articulation_id``, one per step), and in a superbatch it
carries one value per step on its leading axis.

Over several ranks each rank holds its block of every microbatch
(``parallel/mesh.py::stack_step_batches``), and the ranks' ``(loss, aux,
grads)`` are all-reduced to their mean before the one update that every rank
applies.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from aon_tpu_torch.core import prng
# batch entries carrying a per-ray leading axis (everything else is shared)
from aon_tpu_torch.parallel.mesh import RAY_KEYS, all_reduce_mean, rank_of, size_of


def _loss_aux_grads(loss_fn: Callable, params: Mapping[str, torch.Tensor], batch, key, draws):
    """(loss, aux, grads) from either kind of loss function.

    A plain ``loss_fn`` returns (loss, aux) and is differentiated here by
    autograd; a gradient-producing step (``loss_fn.returns_grads`` true, the
    v3 level kernels) returns (loss, aux, grads) itself."""
    if getattr(loss_fn, "returns_grads", False):
        return loss_fn(params, batch, key, draws)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, batch, key, draws)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, dict(zip(names, grads))


def accumulated_grads(
    loss_fn: Callable,
    params: Mapping[str, torch.Tensor],
    batch: Mapping[str, torch.Tensor],
    key: Optional[torch.Tensor] = None,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
    group: Optional[dist.ProcessGroup] = None,
):
    """Mean (loss, aux, grads) over stacked microbatches.

    ``batch``: ray entries (k, m, ...) or flat (m, ...), shared entries as
    they are; ``loss_fn(params, flat_batch, key, draws)`` sees (m, ...)
    ray entries.  ``draws`` (injected uniforms) are stacked like the rays.

    The microbatches' keys are the JAX package's (``aon_tpu/train/microbatch.py:89-97``):
    with ``ray_ids`` in the batch every ray has its own stream already, so
    each microbatch takes ``key`` itself and the trajectory does not depend
    on the microbatch count k; without them microbatch i takes ``split(key,
    k)[i]``.  A flat batch, or a stack of one, takes ``key``.

    A ``loss_fn`` may expose ``prepare_shared(batch, group) -> dict`` for
    whole-batch reductions over all k microbatches, and over the ranks of
    ``group``, that each microbatch then reads as shared entries: the
    auto-encoder's masked-MSE denominators (``photo_denom``,
    ``photo_denom_bg``), which the reference takes over the whole ray batch
    (model_ae_art.py:380-387), not per microbatch.  The mean over the ranks
    is the caller's (``make_train_many_sharded``).
    """
    prep = getattr(loss_fn, "prepare_shared", None)
    if prep is not None:
        batch = dict(batch, **prep(batch, group))
    if batch["rays_o"].ndim == 2:
        # flat batch: a single microbatch.  Decided on rays_o: 1-D ray
        # entries (t_near, loss_w) are 1-D flat and 2-D stacked.
        return _loss_aux_grads(loss_fn, params, batch, key, draws)

    ray_parts = {n: v for n, v in batch.items() if n in RAY_KEYS}
    shared = {n: v for n, v in batch.items() if n not in RAY_KEYS}
    k = batch["rays_o"].shape[0]
    if k == 1 or "ray_ids" in batch:
        keys = [key] * k
    else:
        keys = prng.maybe_split(key, k)

    loss_acc, aux_acc, grads_acc = None, None, None
    for i in range(k):
        mb = dict(shared, **{n: v[i] for n, v in ray_parts.items()})
        mb_draws = None if draws is None else {n: v[i] for n, v in draws.items()}
        loss, aux, grads = _loss_aux_grads(loss_fn, params, mb, keys[i], mb_draws)
        if i == 0:
            loss_acc, aux_acc, grads_acc = loss, dict(aux), dict(grads)
        else:
            loss_acc = loss_acc + loss
            aux_acc = {n: aux_acc[n] + v for n, v in aux.items()}
            grads_acc = {n: grads_acc[n] + g for n, g in grads.items()}
    if k == 1:
        return loss_acc, aux_acc, grads_acc
    inv_k = 1.0 / k
    return (loss_acc * inv_k, {n: v * inv_k for n, v in aux_acc.items()},
            {n: g * inv_k for n, g in grads_acc.items()})


def _inject_ray_ids(superbatch: Mapping[str, torch.Tensor], m_global: int,
                    offset: int) -> Dict[str, torch.Tensor]:
    """Attach global per-ray indices (T, k, m_local) so randomized sampling
    depends neither on the microbatching nor on the ranks
    (``core.sampling.per_ray_uniform``): ray j of microbatch i on the rank
    whose block starts at ``offset`` is ray ``i * m_global + offset + j``.
    The plain modules draw one block over the whole microbatch, as the JAX
    package's flax modules do: ``draw_row0`` (T,), the rank's first row in
    it."""
    ref = superbatch["rays_o"]  # (T, k, m_local, 3)
    t_steps, k, m_local = ref.shape[:3]
    micro = torch.arange(k, device=ref.device, dtype=torch.int64)[:, None]
    row = torch.arange(m_local, device=ref.device, dtype=torch.int64)[None, :]
    ids = micro * m_global + offset + row
    return dict(superbatch, ray_ids=ids.expand(t_steps, k, m_local),
                draw_row0=torch.full((t_steps,), offset, dtype=torch.int64))


def make_train_many_sharded(loss_fn: Callable, metrics_fn: Callable,
                            group: Optional[dist.ProcessGroup]) -> Callable:
    """Multi-step dispatch: T optimizer steps from one call, over the ranks
    of ``group`` or, with None, on one process.  The JAX package has two:
    ``make_train_many`` scans the steps inside one jitted call to amortise its
    dispatch latency, ``make_train_many_sharded`` runs that scan in a
    ``shard_map`` on every chip of the mesh; eager PyTorch has no latency to
    amortise, so one plain Python loop serves both.

    Returns ``fn(state, superbatch, key) -> (state, metrics)``:
    ``superbatch`` entries carry a leading T axis over stacked ``(k, m, ...)``
    batches, of which each rank holds its block of every microbatch
    (``stack_step_batches`` with the group), with ray ids ``m_global =
    m_local * world`` and ``offset = rank * m_local``, so every ray draws
    what it draws in one process.  Step t takes the key ``fold_in(key, t)``
    (``aon_tpu/train/microbatch.py:145``, ``:199``).  Each step's ``(loss, aux, grads)`` are
    all-reduced to their mean over the ranks (one all-reduce of their
    concatenation) before ``state.apply_gradients``, which every rank
    applies to the same parameters: they stay the same on every rank.  The
    metrics are means over the T steps, the same on every rank, and
    ``train/loss_last`` is the last step's loss.
    """
    world, offset_of = size_of(group), rank_of(group)

    def train_many(state, superbatch: Mapping[str, torch.Tensor],
                   key: Optional[torch.Tensor] = None):
        m_local = superbatch["rays_o"].shape[2]
        superbatch = _inject_ray_ids(superbatch, m_local * world, offset_of * m_local)
        t_steps = superbatch["rays_o"].shape[0]
        losses, auxs = [], []
        for t in range(t_steps):
            batch = {n: v[t] for n, v in superbatch.items()}
            step_key = None if key is None else prng.fold_in(key, t)
            loss, aux, grads = accumulated_grads(loss_fn, state.params, batch, step_key,
                                                 group=group)
            names, aux_names = list(grads), list(aux)
            reduced = all_reduce_mean([loss] + [aux[n] for n in aux_names]
                                      + [grads[n] for n in names], group)
            loss, aux = reduced[0], dict(zip(aux_names, reduced[1:1 + len(aux_names)]))
            state = state.apply_gradients(dict(zip(names, reduced[1 + len(aux_names):])))
            losses.append(loss)
            auxs.append(aux)
        mean_aux = {n: torch.stack([a[n] for a in auxs]).mean() for n in auxs[0]}
        metrics = metrics_fn(torch.stack(losses).mean(), mean_aux)
        metrics["train/loss_last"] = losses[-1]
        return state, metrics

    return train_many
