"""Microbatched gradient accumulation and multi-step dispatch (port of
``aon_tpu/train/microbatch.py``, single device).

Gradient accumulation has exact mean semantics: equal-size microbatch MSE
means average to the full-batch mean.  Ray entries of a stacked batch arrive
as ``(k, m, ...)``; a flat batch ``(m, ...)`` is one microbatch.  Every other
entry is shared: it reaches each microbatch as it is (the auto-decoder's
``instance_id`` and ``articulation_id``, one per step), and in a superbatch it
carries one value per step on its leading axis.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

# batch entries carrying a per-ray leading axis (everything else is shared)
RAY_KEYS = (
    "rays_o", "rays_d", "viewdirs", "target", "instance_mask", "radii",
    "ray_ids", "t_near", "t_far", "hit", "loss_w",
)


def _loss_aux_grads(loss_fn: Callable, params: Mapping[str, torch.Tensor], batch, generator, draws):
    """(loss, aux, grads) from either kind of loss function.

    A plain ``loss_fn`` returns (loss, aux) and is differentiated here by
    autograd; a gradient-producing step (``loss_fn.returns_grads`` true, the
    v3 level kernels) returns (loss, aux, grads) itself."""
    if getattr(loss_fn, "returns_grads", False):
        return loss_fn(params, batch, generator, draws)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, batch, generator, draws)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, dict(zip(names, grads))


def accumulated_grads(
    loss_fn: Callable,
    params: Mapping[str, torch.Tensor],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
):
    """Mean (loss, aux, grads) over stacked microbatches.

    ``batch``: ray entries (k, m, ...) or flat (m, ...), shared entries as
    they are; ``loss_fn(params, flat_batch, generator, draws)`` sees (m, ...)
    ray entries.  ``draws`` (injected uniforms) are stacked like the rays.

    With ``ray_ids`` in the batch every ray has its own stream already, so
    each microbatch starts from the same generator state: the trajectory
    does not depend on the microbatch count k.  Without them the generator
    simply runs on from one microbatch to the next.
    """
    if batch["rays_o"].ndim == 2:
        # flat batch: a single microbatch.  Decided on rays_o: 1-D ray
        # entries (t_near, loss_w) are 1-D flat and 2-D stacked.
        return _loss_aux_grads(loss_fn, params, batch, generator, draws)

    ray_parts = {n: v for n, v in batch.items() if n in RAY_KEYS}
    shared = {n: v for n, v in batch.items() if n not in RAY_KEYS}
    k = batch["rays_o"].shape[0]
    same_state = generator.get_state() if "ray_ids" in batch and generator is not None else None

    loss_acc, aux_acc, grads_acc = None, None, None
    for i in range(k):
        if same_state is not None:
            generator.set_state(same_state)
        mb = dict(shared, **{n: v[i] for n, v in ray_parts.items()})
        mb_draws = None if draws is None else {n: v[i] for n, v in draws.items()}
        loss, aux, grads = _loss_aux_grads(loss_fn, params, mb, generator, mb_draws)
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


def _inject_ray_ids(superbatch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Attach global per-ray indices (T, k, m) so randomized sampling does
    not depend on the microbatching (``core.sampling.per_ray_uniform``)."""
    ref = superbatch["rays_o"]  # (T, k, m, 3)
    t_steps, k, m = ref.shape[:3]
    ids = torch.arange(k * m, device=ref.device, dtype=torch.int64).reshape(k, m)
    return dict(superbatch, ray_ids=ids.expand(t_steps, k, m))


def make_train_many(loss_fn: Callable, metrics_fn: Callable) -> Callable:
    """Multi-step dispatch: T optimizer steps from one call, a plain Python
    loop (the JAX package scans them inside one jitted call to amortise its
    dispatch latency; eager PyTorch has none to amortise).

    Returns ``fn(state, superbatch, generator) -> (state, metrics)``:
    ``superbatch`` entries carry a leading T axis over stacked ``(k, m, ...)``
    batches, each step runs the usual microbatched accumulation and
    ``state.apply_gradients``; metrics are means over the T steps and
    ``train/loss_last`` is the last step's loss.
    """

    def train_many(state, superbatch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        superbatch = _inject_ray_ids(superbatch)
        t_steps = superbatch["rays_o"].shape[0]
        losses, auxs = [], []
        for t in range(t_steps):
            batch = {n: v[t] for n, v in superbatch.items()}
            loss, aux, grads = accumulated_grads(loss_fn, state.params, batch, generator)
            state = state.apply_gradients(grads)
            losses.append(loss)
            auxs.append(aux)
        mean_aux = {n: torch.stack([a[n] for a in auxs]).mean() for n in auxs[0]}
        metrics = metrics_fn(torch.stack(losses).mean(), mean_aux)
        metrics["train/loss_last"] = losses[-1]
        return state, metrics

    return train_many
