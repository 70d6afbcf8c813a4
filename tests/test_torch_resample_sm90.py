"""The Python side of kernel rows 2 and 14 as redesigned for Hopper: the
resample kernel's planner (ray tiles, persistent grid, shared memory), the
twin of its in-kernel CDF, the fused entry's plain path against the JAX
wrapper in interpret mode, the wrappers' checks, and row 14's planner.  The
kernels themselves run on the card (tests/test_torch_cuda.py, ``-k sm90``).

Tolerances, and why:
  * ``pdf_cdf_ordered`` against ``pdf_cdf`` and the JAX wrapper's CDF: 1e-6.
    The same float32 steps; only the order of the 63-term sums differs, a
    few ulps of values in [0, 1] (measured: 4.8e-7);
  * ``fused_resample`` on the CPU against JAX ``fused_resample``: 1e-4, as
    tests/test_torch_kernels.py holds kernel 2 from the weights (the CDF's
    sums run in another order, which moves a fine sample by up to
    (bin width) x (CDF difference) / (bin mass));
  * the strided weights window against its contiguous copy: bit for bit
    (the same values in the same order).
"""

import os

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.ops.resample_pallas import fused_resample as jax_fused_resample  # noqa: E402
from aon_tpu_torch.core.sampling import eval_quantiles, pdf_cdf, unit_linspace  # noqa: E402
from aon_tpu_torch.core import sampling  # noqa: E402
from aon_tpu_torch.ops import resample as rs  # noqa: E402
from aon_tpu_torch.ops.fused_mlp_train import (  # noqa: E402
    POSENC_BLOCKS_PER_SM,
    posenc_in_kernel,
    posenc_plan,
)

TOL_CDF, TOL_SAMPLES = 1e-6, 1e-4
MAX_SMEM_BLOCK, SMEM_SM = 232448, 233472  # the H100's, bytes


# ------------------------------------------------------------ the planner

def _strides(n_t, fused=True, shared=False, n_u=None):
    """Row strides of the callers' inputs: contiguous t and bins, the weights
    as the ``wgt[..., 1:-1]`` window of a (B, n_t) array, u shared or per ray."""
    n_bins = n_t - 1
    return (n_t, n_bins, n_t if fused else n_bins, 0 if shared else n_u)


@pytest.mark.parametrize("n_rays,n_t,n_u,shared,want_rays", [
    (61440, 65, 128, True, 16),  # the render chunk, eval quantiles
    (2048, 17, 32, False, 8),    # the vanilla bench's microbatch: a warp's ray each
    (2048, 25, 48, False, 8),    # the auto-decoder bench's microbatch
    (1, 65, 128, False, 1),
    (1001, 65, 128, False, 4),
    (2048, 65, 128, False, 8),   # a training microbatch
])
def test_resample_plan_at_the_paths_shapes(n_rays, n_t, n_u, shared, want_rays):
    plan = rs.resample_plan(n_rays, n_t, n_t - 1, n_u, _strides(n_t, True, shared, n_u),
                            fused=True)
    assert plan["tile_rays"] == want_rays and plan["stages"] == 2
    assert plan["tiles"] == -(-n_rays // want_rays)
    # every SM gets a tile wherever there are the rays
    assert plan["tiles"] >= min(n_rays, 132)
    assert 1 <= plan["grid"] <= plan["tiles"]
    assert plan["grid"] <= plan["blocks_per_sm"] * 132
    assert plan["smem_bytes"] <= MAX_SMEM_BLOCK
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= SMEM_SM


def test_resample_plan_shared_memory_by_hand():
    """The render chunk's fused layout counted region by region: two stages
    of t (15 x 65 + 65 floats, 3 of shift, rounded to 16 bytes: 1,044), bins
    (1,028) and the weights window (15 x 65 + 63: 1,044); the shared u row
    (132), each ray's padding and sum (32), the built CDFs (16 rows 65 floats
    apart), the fine samples (16 x 128) and the output tile (16 x 193:
    3,092)."""
    plan = rs.resample_plan(61440, 65, 64, 128, (65, 64, 65, 0), fused=True)
    assert plan["smem_bytes"] == 4 * (2 * (1044 + 1028 + 1044) + 132 + 32 + 16 * 65 + 2048
                                      + 3092)
    assert (plan["tile_rays"], plan["grid"], plan["blocks_per_sm"]) == (16, 528, 4)
    # the CDF entry stages the CDF (1,028) and builds none
    plan = rs.resample_plan(61440, 65, 64, 128, (65, 64, 64, 0), fused=False)
    assert plan["smem_bytes"] == 4 * (2 * (1044 + 1028 + 1028) + 132 + 2048 + 3092)


def test_resample_plan_shrinks_tiles_to_fit_and_raises_past_one_ray():
    # rows 4,000 floats apart (a window of a wide array): 16 rays do not fit
    plan = rs.resample_plan(61440, 65, 64, 128, (65, 64, 4000, 128), fused=True)
    assert plan["tile_rays"] < rs.TILE_RAYS and plan["smem_bytes"] <= MAX_SMEM_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        rs.resample_plan(10, 20000, 19999, 20000)


def test_resample_plan_ignores_a_misaligned_base():
    """A view one float in changes no stride, so no plan: the kernel peels
    the span's head itself (resample.cu ``stage_span``)."""
    base = torch.zeros(2048 * 17 + 1)
    view = base[1:].view(2048, 17)
    assert view.data_ptr() % 16 != 0
    strides = (view.stride(0), 16, 17, 32)
    assert rs.resample_plan(2048, 17, 16, 32, strides, True) == rs.resample_plan(
        2048, 17, 16, 32, _strides(17, True, False, 32), True)


# ------------------------------------------------------------- the CDF twin

def _weights(kind, rng, B=40, n=63):
    w = rng.uniform(0.0, 1.0, (B, n)).astype(np.float32) ** 4
    if kind == "zero":
        w[::3] = 0.0  # eps padding, a uniform pdf
    elif kind == "tiny":
        w[::3] *= 1e-9  # mass below eps: padded
    elif kind == "last_bins":
        w[::3, :-3] = 0.0  # a long run of equal CDF values
    return w


@pytest.mark.parametrize("kind", ["random", "zero", "tiny", "last_bins"])
def test_pdf_cdf_ordered_matches_pdf_cdf_and_the_jax_cdf(rng, kind):
    w = _weights(kind, rng)
    got = rs.pdf_cdf_ordered(torch.from_numpy(w))
    assert got.shape == (40, 64) and got.dtype == torch.float32
    assert float(got[:, 0].abs().max()) == 0.0 and bool((got[:, -1] == 1.0).all())
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    np.testing.assert_allclose(got.numpy(), pdf_cdf(torch.from_numpy(w)).numpy(), rtol=0,
                               atol=TOL_CDF)
    eps = 1e-5
    ws = jnp.sum(w, axis=-1, keepdims=True)
    pad = jnp.maximum(0.0, eps - ws)
    pdf = (w + pad / w.shape[-1]) / (ws + pad)
    cdf = jnp.minimum(1.0, jnp.cumsum(pdf[..., :-1], axis=-1))
    want = np.concatenate([np.zeros((40, 1)), np.asarray(cdf), np.ones((40, 1))], -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_CDF)


def test_pdf_cdf_ordered_sums_left_to_right():
    """The kernel's order, not torch's: a sum whose order shows (1 + 2^-24
    terms lost one at a time) equals the sequential float32 sum."""
    w = np.array([[1.0] + [2.0**-24] * 8 + [1.0]], dtype=np.float32)
    got = rs.pdf_cdf_ordered(torch.from_numpy(w))
    seq = np.float32(0.0)
    for v in w[0]:
        seq = np.float32(seq + v)
    assert seq == np.float32(2.0)  # each 2^-24 is lost against 1
    assert float(got[0, 1]) == float(np.float32(np.float32(1.0) / seq))


# ------------------------------------------- the fused entry on the CPU

def _inputs(rng, B, n_t, n_u, shared):
    t = np.sort(rng.uniform(2.0, 6.0, (B, n_t)), axis=-1).astype(np.float32)
    bins = (0.5 * (t[:, 1:] + t[:, :-1])).astype(np.float32)
    wgt = rng.uniform(0.0, 1.0, (B, n_t)).astype(np.float32) ** 4
    wgt[0] = 0.0
    wgt[1] *= 1e-9
    wgt[2, :-4] = 0.0
    if shared:
        u = np.broadcast_to(np.asarray(eval_quantiles(n_u)), (B, n_u))
    else:
        u = np.sort(rng.uniform(0.0, 1.0, (B, n_u)), axis=-1).astype(np.float32)
    return t, bins, wgt, np.ascontiguousarray(u)


@pytest.mark.parametrize("n_t,n_u,shared", [(17, 32, False), (25, 48, False), (65, 128, True)])
def test_fused_resample_on_cpu_matches_jax(rng, n_t, n_u, shared):
    B = 21
    t, bins, wgt, u = _inputs(rng, B, n_t, n_u, shared)
    want = np.asarray(jax_fused_resample(jnp.asarray(t), jnp.asarray(bins),
                                         jnp.asarray(wgt[:, 1:-1]), jnp.asarray(u),
                                         num_samples=n_u))
    tu = torch.from_numpy(u)
    if shared:
        tu = eval_quantiles(n_u).expand(B, n_u)
    before = rs.resample_union.launches
    got = rs.fused_resample(torch.from_numpy(t), torch.from_numpy(bins),
                            torch.from_numpy(wgt)[:, 1:-1], tu)
    assert rs.resample_union.launches == before  # the CPU runs the twin
    assert got.shape == (B, n_t + n_u)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    assert all(np.isin(t[i], got.numpy()[i]).all() for i in range(B))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_SAMPLES)


def test_fused_resample_reads_the_strided_window_as_its_copy(rng):
    t, bins, wgt, u = _inputs(rng, 33, 65, 128, False)
    args = (torch.from_numpy(t), torch.from_numpy(bins))
    window = torch.from_numpy(wgt)[:, 1:-1]
    assert not window.is_contiguous() and window.stride(0) == 65
    got = rs.fused_resample(*args, window, torch.from_numpy(u))
    assert torch.equal(got, rs.fused_resample(*args, window.contiguous(), torch.from_numpy(u)))
    # the CPU route samples on pdf_cdf's CDF, as core.sampling.sample_pdf does
    assert torch.equal(got, rs.resample_union_plain(*args, pdf_cdf(window), torch.from_numpy(u)))


def test_resample_wrappers_raise_on_other_devices_without_counting():
    meta = {n: torch.empty(2, c, device="meta") for n, c in (("t", 5), ("b", 4), ("w", 3),
                                                                ("u", 8))}
    before = rs.resample_union.launches
    with pytest.raises(ValueError, match="no kernel"):
        rs.fused_resample(meta["t"], meta["b"], meta["w"], meta["u"])
    with pytest.raises(ValueError, match="no kernel"):
        rs.resample_union(meta["t"], meta["b"], meta["b"], meta["u"])
    assert rs.resample_union.launches == before


def test_unit_linspace_row_is_cached_per_num_and_device():
    step = np.arange(128, dtype=np.float32) * (np.float32(1) / np.float32(128))
    want = np.concatenate([step, [np.float32(1)]])
    unit_linspace(129)
    hits = sampling._unit_linspace.cache_info().hits
    a, b, c = unit_linspace(129), unit_linspace(129, "cpu"), eval_quantiles(129)
    assert sampling._unit_linspace.cache_info().hits == hits + 3
    assert unit_linspace(65).shape == (65,)
    # every call hands out its own copy: writing into one leaves the cached
    # row, and so every later render's and step's samples, as they were
    a.mul_(2.0)
    b.clamp_(0.5, 0.5)
    for row in (c, unit_linspace(129), eval_quantiles(129)):
        np.testing.assert_array_equal(row.numpy(), want)


# ----------------------------------------------------- row 14's planner

@pytest.mark.parametrize("n,width,encoder,block_rows,grid", [
    (256, 64, "elementwise", 16, 16),       # row 14's check: one block per 16 rows
    (65536, 64, "mxu", 16, POSENC_BLOCKS_PER_SM * 132),  # an extraction block
    (256, 32, "elementwise", 32, 8),        # the view encoding
    (65537, 64, "doubling", 85, POSENC_BLOCKS_PER_SM * 132),
    (1, 32, "doubling", 85, 1),
])
def test_posenc_plan(n, width, encoder, block_rows, grid):
    plan = posenc_plan(n, width, encoder)
    assert (plan["block_rows"], plan["grid"]) == (block_rows, grid)
    # the doubling tile: 85 rows, width + 4 floats apart
    assert plan["smem_bytes"] == (4 * 85 * (width + 4) if encoder == "doubling" else 0)


def test_posenc_plan_and_wrapper_refuse_other_widths():
    with pytest.raises(ValueError, match="power of two"):
        posenc_plan(256, 48)
    before = posenc_in_kernel.launches
    x = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        posenc_in_kernel(x, torch.empty(4, 48, device="meta"), torch.empty(1, 48, device="meta"))
    assert posenc_in_kernel.launches == before


# ------------------------------------------- the device-time arithmetic

def test_kernel_times_per_call_divides_by_the_recorded_launches():
    """The card's trace drops a few records: ``per_call`` divides every
    kernel's time and count by the launches recorded of the one kernel each
    call makes, and refuses a trace without exactly one such kernel."""
    from aon_tpu_torch.scripts import kernel_times

    kernels = {"void resample_kernel<true>(Rows, Rows, Rows, Rows, float*, long long, int)":
               {"ms": 9.9, "count": 99},
               "Memcpy HtoD (Pageable -> Device)": {"ms": 0.99, "count": 99}}
    got = kernel_times.per_call(kernels, "resample")
    assert got == pytest.approx({"device_ms": 0.1, "stage_device_ms": 0.11,
                                 "launches_per_call": 2.0, "recorded_calls": 99})
    with pytest.raises(RuntimeError, match="not one kernel"):
        kernel_times.per_call({k: v for k, v in kernels.items() if "Memcpy" in k}, "resample")
    with pytest.raises(RuntimeError, match="not one kernel"):
        kernel_times.per_call(dict(kernels, **{"void resample_kernel<false>()": kernels[
            next(iter(kernels))]}), "resample")
