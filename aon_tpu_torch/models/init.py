"""The JAX package's parameter init, bit for bit where flax draws uniforms.

A flax module's ``init(key, ...)`` gives each parameter its own key: the
module path of the parameter's scope and the scope's running count of
``make_rng("params")`` calls (1 for a ``Dense``'s kernel, 2 for its bias) are
hashed with SHA-1 and folded into ``key`` (``flax/core/scope.py``:
``LazyRng``, ``_fold_in_static``, ``Scope.make_rng``; flax 0.12 with
``flax_fix_rng_separator`` off, its default).  The port's module names are
the flax paths (``models/convert.py`` maps them one to one), so
``flax_init_`` redraws every ``nn.Linear``, ``nn.Conv2d`` and
``nn.Embedding`` of a module from that key with the flax initialiser of the
JAX module it ports, in the flax layout, and stores it in the PyTorch one.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from aon_tpu_torch.core import prng

# the JAX package's initialisers, as ``jax.nn.initializers.variance_scaling``
# arguments: (scale, mode, distribution, in_axis, out_axis)
INITIALISERS = {
    # ``nn.initializers.xavier_uniform()``: the NeRF MLPs' kernels and the
    # code library's tables (aon_tpu/models/mlp.py, code_library.py)
    "xavier_uniform": (1.0, "fan_avg", "uniform", -2, -1),
    # flax ``Dense`` / ``Conv``'s default kernel init (the ResNet-34 encoder
    # and the joint-state head, aon_tpu/models/resnet.py, joint_state.py)
    "lecun_normal": (1.0, "fan_in", "truncated_normal", -2, -1),
    # flax ``Embed``'s default (the auto-encoder's degree table)
    "embed_normal": (1.0, "fan_in", "normal", -2, 0),
}
# the standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _fold_bytes(x) -> bytes:
    if isinstance(x, str):
        return x.encode("utf-8")
    return int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big")


def scope_key(key, path: Sequence) -> torch.Tensor:
    """``LazyRng(key, path).as_jax_rng()``: ``fold_in(key, h)`` with ``h``
    the first four bytes (big-endian) of the SHA-1 of the path's names and
    ints, concatenated."""
    if not path:
        return torch.as_tensor(key, dtype=torch.int64)
    digest = hashlib.sha1(b"".join(_fold_bytes(x) for x in path)).digest()
    return prng.fold_in(key, int.from_bytes(digest[:4], byteorder="big"))


def param_key(key, scope: Sequence[str], count: int) -> torch.Tensor:
    """The key of the ``count``-th parameter (1-based) that the flax module at
    ``scope`` creates under ``init(key)``."""
    return scope_key(key, tuple(scope) + (count,))


def _fans(shape: Tuple[int, ...], in_axis: int, out_axis: int) -> Tuple[float, float]:
    """``jax.nn.initializers._compute_fans``."""
    in_size, out_size = shape[in_axis], shape[out_axis]
    receptive = math.prod(shape) / in_size / out_size
    return in_size * receptive, out_size * receptive


def variance_scaling(key, shape: Tuple[int, ...], kind: str) -> torch.Tensor:
    """``jax.nn.initializers.variance_scaling`` of the named kind, float32 on
    the CPU."""
    scale, mode, distribution, in_axis, out_axis = INITIALISERS[kind]
    fan_in, fan_out = _fans(shape, in_axis, out_axis)
    denominator = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    variance = torch.tensor(scale / denominator, dtype=torch.float32)
    if distribution == "uniform":
        return prng.uniform(key, shape, minval=-1.0, maxval=1.0) * torch.sqrt(3 * variance)
    if distribution == "normal":
        return prng.normal(key, shape) * torch.sqrt(variance)
    stddev = torch.sqrt(variance) / torch.tensor(_TRUNC_STD, dtype=torch.float32)
    return prng.truncated_normal(key, -2.0, 2.0, shape) * stddev


@torch.no_grad()
def flax_init_(module: nn.Module, key, kernel_init: str = "xavier_uniform") -> None:
    """Draw every weight of ``module``'s ``nn.Linear``, ``nn.Conv2d`` and
    ``nn.Embedding`` layers as ``init(key)`` of the flax module it ports
    draws it, and zero their biases.  With no key every parameter is zero:
    a module built for a system, whose ``init_state(key)`` draws it.

    ``module`` is the flax module that ``init`` was called on; the names of
    its submodules are their flax scope names.  ``kernel_init`` names the JAX module's initialiser
    (``INITIALISERS``).  Each weight is drawn in the flax layout (a dense
    kernel (in, out), a conv kernel (kh, kw, in, out), a table (rows,
    features)) and stored in PyTorch's.
    """
    if key is None:
        for p in module.parameters():
            p.zero_()
        return
    for name, m in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, nn.Linear):
            kernel = variance_scaling(param_key(key, path, 1),
                                      (m.in_features, m.out_features), kernel_init)
            m.weight.copy_(kernel.T)
        elif isinstance(m, nn.Conv2d):
            out_c, in_c, kh, kw = m.weight.shape
            kernel = variance_scaling(param_key(key, path, 1), (kh, kw, in_c, out_c),
                                      kernel_init)
            m.weight.copy_(kernel.permute(3, 2, 0, 1))
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(variance_scaling(param_key(key, path, 1), tuple(m.weight.shape),
                                            kernel_init))
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


@torch.no_grad()
def seeded_params(system, generator: torch.Generator) -> dict:
    """The flat state dict of ``system`` drawn from a ``torch.Generator``,
    not the JAX package's init (``flax_init_`` is that): the inputs of checks
    whose weights must stay fixed, as the port drew them before it took the
    JAX package's keys.  Xavier-uniform dense weights and code tables, the
    encoder's and joint-state head's ``lecun_normal`` as a normal redrawn
    outside +-2, the degree table a normal of std 1/sqrt(32), zero biases,
    drawn in module order from ``generator`` on the system's device."""
    params = system.init_params(prng.key(0))  # the names, shapes and device
    nested = any(k.startswith("model.") for k in params)
    groups = [("model", "xavier"), ("code_library", "xavier"), ("encoder", "lecun"),
              ("joint_state", "lecun"), ("deg_embedding", "normal")]
    for group, kind in groups:
        if not hasattr(system, group):
            continue
        prefix = f"{group}." if nested else ""
        for name, m in getattr(system, group).named_modules():
            w = params.get(f"{prefix}{name}.weight")
            if w is None or not isinstance(m, (nn.Linear, nn.Embedding, nn.Conv2d)):
                continue
            if kind == "xavier":
                nn.init.xavier_uniform_(w, generator=generator)
            elif kind == "normal":
                w.normal_(std=32 ** -0.5, generator=generator)
            else:
                w.normal_(generator=generator)
                while bool((w.abs() > 2.0).any()):
                    out = w.abs() > 2.0
                    w[out] = torch.randn(int(out.sum()), generator=generator, device=w.device,
                                         dtype=w.dtype)
                w.mul_(math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD)
    return params
