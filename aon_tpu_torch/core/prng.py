"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random``.

The JAX package seeds every init and every sampling draw from a threefry
key (``jax.random.PRNGKey``), and JAX runs with ``jax_threefry_partitionable``
on (its default since 0.5): ``split`` and ``random_bits`` hash the 64-bit
index of each output, split into its high and low words, and a 32-bit draw
is the xor of the hash's two words (``jax/_src/prng.py``:
``threefry_2x32``, ``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``).  This module computes the same
values, so a port run with seed ``s`` starts from the JAX run's weights and
draws its uniforms.

A key is a ``(2,)`` int64 tensor on the CPU holding two uint32 words
(``jax.random.key_data`` of a JAX key); ``split`` returns ``(n, 2)``.  Key
arithmetic runs on Python ints; the bulk draws run on int32 tensors holding
the words' bits (additions wrap, right shifts are masked to logical ones), in
place, on the tensors' device.  On a CUDA device
``per_ray_uniform`` and ``uniform`` launch one kernel
(``ops/csrc/prng.cu``); this module's ``*_plain`` functions are its twin.

``normal`` and ``truncated_normal`` (the initialisers') go through
``torch.erfinv`` / ``torch.erf``, whose float32 results lie a few ulps from
XLA's polynomials: the same uniforms, not the same bits.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _s32(v: int) -> int:
    """A uint32 value as the int32 of the same bits."""
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _threefry_ints(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0, x1 = (x0 + k0) & M32, (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _threefry_tensors(k0: IntLike, k1: IntLike, x0: torch.Tensor,
                      x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block on int32 tensors holding the words' bits, in place on fresh
    tensors of the broadcast shape; the key words are ints or int32 tensors
    that broadcast.  On the CPU the rounds run in numpy on uint32 views of
    the same memory: one thread, where torch would split each of the ~100
    elementwise passes over its intra-op threads, whose synchronisation
    costs more than the work on a busy host.  On other devices torch's int32
    ops, whose additions wrap and whose right shifts are masked to logical
    ones."""
    if isinstance(k0, int):
        ku = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
        ks = [_s32(k) for k in ku]
        inject = [(ks[(i + 1) % 3], _s32(ku[(i + 2) % 3] + i + 1)) for i in range(5)]
    else:
        ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
        inject = [(ks[(i + 1) % 3], ks[(i + 2) % 3] + (i + 1)) for i in range(5)]
    x0, x1 = torch.broadcast_tensors(x0 + ks[0], x1 + ks[1])
    x0, x1 = x0.contiguous(), x1.contiguous()
    t = torch.empty_like(x1)
    if x0.device.type == "cpu":
        def as_u32(v):
            return v.numpy().view(np.uint32) if isinstance(v, torch.Tensor) else np.uint32(v & M32)

        a, b, c = (v.numpy().view(np.uint32) for v in (x0, x1, t))
        _rounds(a, b, c, [(as_u32(p), as_u32(q)) for p, q in inject], np.left_shift, logical=True)
    else:
        _rounds(x0, x1, t, inject, lambda v, r, out: torch.bitwise_left_shift(v, r, out=out),
                logical=False)
    return x0, x1


def _rounds(x0, x1, t, inject, shift_left, logical: bool) -> None:
    """Threefry's 20 rounds and 5 key injections, in place on ``x0`` and
    ``x1`` (``t`` scratch): numpy uint32 arrays (``logical``: their right
    shift is logical) or torch int32 tensors."""
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            shift_left(x1, r, out=t)
            x1 >>= 32 - r
            if not logical:
                x1 &= (1 << r) - 1  # the logical shift of the int32's bits
            x1 |= t
            x1 ^= x0
        x0 += inject[i][0]
        x1 += inject[i][1]


def threefry2x32(k0: IntLike, k1: IntLike, x0: IntLike, x1: IntLike) -> Tuple[IntLike, IntLike]:
    """The Threefry-2x32 block (20 rounds) of key ``(k0, k1)`` on the counter
    words ``(x0, x1)``.  On Python ints (uint32 values) it returns ints; on
    int32 tensors holding the words' bits (which broadcast; the key words
    ints or int32 tensors) it returns int32 tensors."""
    if isinstance(x0, torch.Tensor) or isinstance(x1, torch.Tensor):
        return _threefry_tensors(k0, k1, torch.as_tensor(x0, dtype=torch.int32),
                                 torch.as_tensor(x1, dtype=torch.int32))
    return _threefry_ints(k0, k1, x0, x1)


def _words(key) -> Tuple[int, int]:
    k = np.asarray(key).astype(np.uint64).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a threefry key has two words, got shape {np.shape(key)}")
    return int(k[0]), int(k[1])


def _as_key(k0: int, k1: int) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 tensors of 32-bit values -> int32 tensors of the same bits."""
    return (words & M32).to(torch.int32)


def key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _as_key(seed >> 32, seed & M32)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``(num, 2)``: subkey i hashes the
    counter ``(i >> 32, i & M32)``, so it does not depend on ``num``."""
    k0, k1 = _words(key)
    return torch.tensor([_threefry_ints(k0, k1, i >> 32, i & M32) for i in range(num)],
                        dtype=torch.int64).reshape(num, 2)


def _fold_in_words(key, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two int32 words of ``fold_in(key, d)`` for every ``d`` of ``data``."""
    k0, k1 = _words(key)
    return _threefry_tensors(k0, k1, torch.zeros_like(data, dtype=torch.int32),
                             _as_int32(data.to(torch.int64)))


def fold_in(key, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter ``(0,
    data mod 2**32)``.  ``data`` may be an int64 tensor of ids: the result is
    then ``(*data.shape, 2)`` on its device (``vmap`` of ``fold_in``)."""
    if isinstance(data, torch.Tensor):
        a, b = _fold_in_words(key, data)
        return torch.stack([a.to(torch.int64) & M32, b.to(torch.int64) & M32], dim=-1)
    return _as_key(*_threefry_ints(*_words(key), 0, int(data) & M32))


def random_bits_plain(key, shape: Sequence[int], device=None, row0: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): output j (row-major) is the
    xor of the two words of the hash of ``(j >> 32, j & M32)``, as int32 of
    the same bits.  With ``row0``, rows ``row0, row0 + 1, ...`` of a taller
    draw of ``key``."""
    k0, k1 = _words(key)
    first = row0 * math.prod(shape[1:])
    counts = torch.arange(first, first + math.prod(shape), dtype=torch.int64, device=device)
    a, b = _threefry_tensors(k0, k1, _as_int32(counts >> 32), _as_int32(counts))
    return (a ^ b).reshape(tuple(shape))


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int32) -> float32 in [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), less 1 (``jax.random.uniform``'s step)."""
    one = 0x3F800000
    return (((bits >> 9) & 0x7FFFFF) | one).view(torch.float32) - 1.0


def _scale(floats: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(minval, floats * (maxval - minval) + minval)`` in float32, the
    multiply-add rounded once as XLA's fused multiply-add rounds it (float64
    holds the product exactly)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    width = torch.tensor(maxval, dtype=torch.float32, device=floats.device) - lo
    fused = (floats.double() * width.double() + lo.double()).float()
    return torch.maximum(lo, fused)


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype != torch.float32:
        raise TypeError(f"the port draws float32 uniforms only, as its samplers use; got {dtype}")


def uniform_plain(key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
                  device=None, row0: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` in plain
    PyTorch ops on ``device`` (rows from ``row0`` on, as ``uniform``)."""
    return _scale(bits_to_unit(random_bits_plain(key, shape, device, row0)), minval, maxval)


def per_ray_uniform_plain(key, ray_ids: torch.Tensor, n: int) -> torch.Tensor:
    """``vmap(lambda r: uniform(fold_in(key, r), (n,)))(ray_ids)`` -> (B, n)
    float32 in [0, 1) on ``ray_ids``' device, in plain PyTorch ops."""
    a, b = _fold_in_words(key, ray_ids.reshape(-1))
    cols = torch.arange(n, dtype=torch.int32, device=ray_ids.device)
    x, y = _threefry_tensors(a[:, None], b[:, None], torch.zeros_like(cols), cols)
    return bits_to_unit(x ^ y)


def uniform(key, shape: Sequence[int], dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0, device=None,
            row0: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` on
    ``device`` (``ops/prng.py``: one kernel launch on a CUDA device, the plain
    ops on the CPU).  ``row0`` gives rows ``row0, row0 + 1, ...`` of the draw
    of a taller shape: a rank's block of the draw of a whole batch."""
    from aon_tpu_torch.ops.prng import threefry_uniform

    _check_dtype(dtype)
    unit = threefry_uniform(key, None, shape, "cpu" if device is None else device, row0)
    # on [0, 1) the scale is the identity, bit for bit
    return unit if (minval, maxval) == (0.0, 1.0) else _scale(unit, minval, maxval)


def per_ray_uniform(key, ray_ids: torch.Tensor, n: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, n) uniforms in [0, 1) whose row i is ``uniform(fold_in(key,
    ray_ids[i]), (n,))`` (``aon_tpu/core/sampling.py::per_ray_uniform``):
    independent of batch size, microbatching and ranks.  On ``ray_ids``'
    device, as ``uniform``."""
    from aon_tpu_torch.ops.prng import threefry_uniform

    _check_dtype(dtype)
    return threefry_uniform(key, ray_ids, (ray_ids.numel(), n), ray_ids.device)


def normal(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32, on the CPU): ``sqrt(2) *
    erfinv(u)`` of uniforms on ``[nextafter(-1, 0), 1)``; ``torch.erfinv``
    for XLA's."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return torch.erfinv(uniform(key, shape, minval=lo, maxval=1.0)) * np.float32(np.sqrt(2))


def truncated_normal(key, lower: float, upper: float, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` (float32, on
    the CPU): ``sqrt(2) * erfinv(u)`` of uniforms on ``[erf(lower/sqrt2),
    erf(upper/sqrt2))``, clipped to the open interval."""
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32)
    lower_t = torch.tensor(lower, dtype=torch.float32)
    upper_t = torch.tensor(upper, dtype=torch.float32)
    a = float(torch.erf(lower_t / sqrt2))
    b = float(torch.erf(upper_t / sqrt2))
    out = sqrt2 * torch.erfinv(uniform(key, shape, minval=a, maxval=b))
    inf = torch.tensor(math.inf, dtype=torch.float32)
    return torch.clamp(out, float(torch.nextafter(lower_t, inf)),
                       float(torch.nextafter(upper_t, -inf)))


def maybe_split(key, num: int = 2) -> list:
    """``list(split(key, num))``, or ``num`` Nones where there is no key (a
    caller that injects its draws)."""
    return [None] * num if key is None else list(split(key, num))
