"""Port parity, the draws: ``aon_tpu_torch.core.prng`` against ``jax.random``
(JAX 0.9, ``jax_threefry_partitionable`` on, as the JAX package runs) and
``aon_tpu_torch.models.init`` against flax's ``init`` keys, on the CPU.

Tolerances, and why:
  * ``threefry2x32``, ``key``, ``split``, ``fold_in``, ``uniform`` (float32,
    the samplers' and initialisers' ranges) and ``per_ray_uniform``: bit for
    bit (the same integer hash, the same bit-to-float step, the scale rounded
    once as XLA's fused multiply-add rounds it);
  * ``normal``: within NORMAL_RTOL of the largest magnitude (seen 4.1e-6:
    ``torch.erfinv`` against XLA's float32 erfinv polynomial, whose errors
    grow in the tails), ``truncated_normal``: within TRUNC_ULPS ulps (seen 3;
    the same, cut at +-2 where the tails are short);
  * flax's per-parameter keys (``scope_key``): bit for bit.
The systems' whole ``init_state`` against JAX's is held in
tests/test_torch_init_keys.py.
"""

import hashlib

import jax
import jax.extend.random
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aon_tpu_torch.core import prng
from aon_tpu_torch.models import init as tinit
from aon_tpu_torch.ops import prng as kprng

NORMAL_RTOL = 2e-5
TRUNC_ULPS = 8
SEEDS = [0, 1, 42, 2**31 - 1]


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.uint32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def test_threefry2x32_is_jaxs_block():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint64)
    x = rng.integers(0, 2**32, size=64, dtype=np.uint64)
    want = np.asarray(jax.extend.random.threefry_2x32(
        (jnp.uint32(k[0]), jnp.uint32(k[1])), jnp.asarray(x.astype(np.uint32))))
    x0 = torch.from_numpy(x[:32].astype(np.uint32).view(np.int32))
    x1 = torch.from_numpy(x[32:].astype(np.uint32).view(np.int32))
    y0, y1 = prng.threefry2x32(int(k[0]), int(k[1]), x0, x1)
    np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]).view(np.uint32), want)
    # the same block on Python ints
    assert prng.threefry2x32(int(k[0]), int(k[1]), int(x[0]), int(x[32])) == (want[0], want[32])


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_are_jaxs(seed):
    jk = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_np(prng.key(seed)), np.asarray(jk))
    for n in (2, 4, 7):
        np.testing.assert_array_equal(_np(prng.split(prng.key(seed), n)),
                                      np.asarray(jax.random.split(jk, n)))
    for data in (0, 1, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(_np(prng.fold_in(prng.key(seed), data)),
                                      np.asarray(jax.random.fold_in(jk, np.uint32(data))))
    assert prng.maybe_split(None, 3) == [None] * 3


@pytest.mark.parametrize("shape", [(1,), (129,), (3, 5)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.0), (0.3, 2.5)],
                         ids=["samplers", "xavier", "general"])
def test_uniform_is_jaxs_bit_for_bit(shape, bounds):
    for seed in (0, 7):
        got = prng.uniform(prng.key(seed), shape, minval=bounds[0], maxval=bounds[1])
        want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32, *bounds)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_uniform_rows_from_row0_are_the_taller_draws_rows():
    k = prng.key(3)
    whole = prng.uniform(k, (10, 7))
    assert torch.equal(prng.uniform(k, (4, 7), row0=5), whole[5:9])
    assert torch.equal(kprng.threefry_uniform(k, None, (4, 7), "cpu", row0=5), whole[5:9])


def _jax_per_ray(seed, ids, n):
    key = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(jnp.asarray(ids, jnp.uint32))
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


@pytest.mark.parametrize("n", [17, 33])
def test_per_ray_uniform_is_jaxs_up_to_ray_id_2_31(n):
    ids = np.array([0, 1, 2, 511, 2**20 + 3, 2**31 - 2, 2**31 - 1, 2**31], np.int64)
    got = prng.per_ray_uniform(prng.key(11), torch.from_numpy(ids), n)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_per_ray(11, ids, n)))
    # the kernel's wrapper on CPU tensors runs the same plain ops
    assert torch.equal(kprng.threefry_uniform(prng.key(11), torch.from_numpy(ids),
                                              (len(ids), n), "cpu"), got)


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1),
       ids=st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=6),
       n=st.integers(1, 9))
def test_per_ray_uniform_any_seed_and_ids(seed, ids, n):
    ids = np.asarray(ids, np.int64)
    got = prng.per_ray_uniform(prng.key(seed), torch.from_numpy(ids), n)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_per_ray(seed, ids, n)))


@pytest.mark.parametrize("seed", [0, 5])
def test_normal_and_truncated_normal_within_stated_ulps(seed):
    jk = jax.random.PRNGKey(seed)
    got = prng.normal(prng.key(seed), (4096,)).numpy()
    want = np.asarray(jax.random.normal(jk, (4096,)))
    assert np.abs(got - want).max() <= NORMAL_RTOL * np.abs(want).max()
    got = prng.truncated_normal(prng.key(seed), -2.0, 2.0, (4096,)).numpy()
    want = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, (4096,)))
    ulps = np.abs(_bits(got).astype(np.int64) - _bits(want).astype(np.int64))
    assert ulps.max() <= TRUNC_ULPS and np.all(np.abs(got) < 2.0)


def test_flax_scope_keys_are_flax_lazy_rngs():
    from flax.core.scope import LazyRng

    k = jax.random.PRNGKey(9)
    for path in [("coarse_mlp", "pts_0", 1), ("layer1", "block0", "conv1", 1),
                 ("embedding_instance_shape", 1), ("fc_joint_state", 2), (300,)]:
        want = np.asarray(jax.random.key_data(LazyRng.create(k, *path).as_jax_rng())
                          if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                          else LazyRng.create(k, *path).as_jax_rng())
        np.testing.assert_array_equal(_np(tinit.scope_key(prng.key(9), path)), want)
    # an int folds in as its big-endian bytes, a name as utf-8
    digest = hashlib.sha1(b"pts_0" + (1).to_bytes(1, "big")).digest()
    np.testing.assert_array_equal(
        _np(tinit.param_key(prng.key(9), ("pts_0",), 1)),
        _np(prng.fold_in(prng.key(9), int.from_bytes(digest[:4], "big"))))


def test_wrapper_refuses_a_device_it_does_not_run_on():
    with pytest.raises(ValueError):
        kprng.threefry_uniform(prng.key(0), None, (4, 4), "meta")
    with pytest.raises(TypeError):
        prng.uniform(prng.key(0), (4,), dtype=torch.float64)
