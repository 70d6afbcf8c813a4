"""Threefry-2x32 keys and uniforms, as ``jax.random`` computes them with
partitionable counters (a frozen copy, in numpy, of what the measured
program draws its training samples from).

``key(seed)`` holds the seed's high and low words; ``split(k, n)[i]`` hashes
the counter ``(i >> 32, i & M32)``; ``fold_in(k, d)`` hashes ``(0, d)``; a
32-bit draw is the xor of the hash's two words, and a float32 uniform in
[0, 1) is its top 23 bits as the mantissa of a float in [1, 2), less 1.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _block(k0, k1, x0, x1):
    """Twenty rounds on uint32 arrays (or Python ints as uint32 values)."""
    k0, k1 = np.uint32(k0) if np.isscalar(k0) else k0, np.uint32(k1) if np.isscalar(k1) else k1
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = (np.asarray(x0, np.uint32) + ks[0]).astype(np.uint32)
    x1 = (np.asarray(x1, np.uint32) + ks[1]).astype(np.uint32)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32, seed & M32)


def split(k, n: int = 2):
    a, b = _block(k[0], k[1], np.arange(n, dtype=np.uint64) >> 32,
                  (np.arange(n, dtype=np.uint64) & M32))
    return [(int(a[i]), int(b[i])) for i in range(n)]


def fold_in(k, d: int):
    a, b = _block(k[0], k[1], np.zeros(1, np.uint32), np.array([int(d) & M32], np.uint32))
    return (int(a[0]), int(b[0]))


def _unit(bits: np.ndarray) -> np.ndarray:
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def uniform(k, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape)`` in [0, 1), float32."""
    n = int(np.prod(shape))
    cnt = np.arange(n, dtype=np.uint64)
    a, b = _block(k[0], k[1], (cnt >> np.uint64(32)).astype(np.uint32),
                  (cnt & np.uint64(M32)).astype(np.uint32))
    return _unit(a ^ b).reshape(shape)


def per_ray_uniform(k, ray_ids: np.ndarray, n: int) -> np.ndarray:
    """Row i: ``uniform(fold_in(k, ray_ids[i]), (n,))``, float32 (B, n)."""
    ids = np.asarray(ray_ids, np.int64).reshape(-1)
    ka, kb = _block(k[0], k[1], np.zeros(ids.shape, np.uint32),
                    (ids & M32).astype(np.uint32))
    cols = np.arange(n, dtype=np.uint32)[None, :]
    a, b = _block(ka[:, None], kb[:, None], np.zeros_like(cols), cols)
    return _unit(a ^ b)
