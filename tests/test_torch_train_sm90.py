"""The vanilla training kernels' Python side (ops/csrc/train_sm90.cuh runs
only on the card): the training blob read back entry by entry against the
kernel blob, the weight gradients' work list against every entry of every
dW and every workspace row, the workspaces' sizes, the wrappers' checks, and
the weight gradients' plain twin against JAX on the same workspaces.  No
card needed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aon_tpu_torch.ops import fused_mlp as tfm
from aon_tpu_torch.ops import fused_mlp_train as tfmt
from aon_tpu_torch.ops import train_sm90 as ts

# (rows of each matrix: the layer's inputs, its outputs) of the backward blob
BWD = ("wva", "wb", "w7", "w6", "w5a", "w4", "w3", "w2", "w1")
WIDE = ("w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7", "wb", "wva", "wvb")
# workspace rows of the level and backward shapes the port runs: ragged
# counts, the bench's 2,048 rays x 17 / 49, the render's x 65 / 193 and the
# largest level, x 256
ROWS = (1000, 65553, 2048 * 17, 2048 * 49, 2048 * 65, 2048 * 193, 2048 * 256)


def _packed(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in tfm.PACKED_SHAPES.items():
        v = torch.randn(*shape, generator=g)
        out[k] = (v / shape[0] ** 0.5).to(torch.bfloat16) if k.startswith("w") else 0.1 * v
    return out


@pytest.fixture(scope="module")
def blobs():
    packed = _packed()
    wblob, bblob = tfm.kernel_blobs(packed)
    return packed, wblob, ts.train_blob(wblob)


def _decode_bwd(tblob, name):
    """W^T of ``name`` (K' = its outputs, N' = its inputs) read back from the
    backward blob: N' rows of 64 K'-columns per slab, the 16-byte group g of
    row n holding K'-columns 8 * (g ^ (n % 8)) .."""
    offset = ts.N_EVAL_WEIGHTS
    for k in BWD:
        n_in, n_out = tfm.PACKED_SHAPES[k]
        size = n_in * n_out
        if k == name:
            slabs = tblob[offset:offset + size].reshape(n_out // 64, n_in, 8, 8)
            out = torch.empty(n_out, n_in, dtype=tblob.dtype)
            for s in range(n_out // 64):
                for g in range(8):
                    n = torch.arange(n_in)
                    col = 64 * s + 8 * (g ^ (n % 8))
                    for e in range(8):
                        out[col + e, n] = slabs[s, :, g, e]
            return out
        offset += size
    raise KeyError(name)


@pytest.mark.parametrize("name", BWD)
def test_backward_blob_holds_each_transposed_matrix(blobs, name):
    packed, _, tblob = blobs
    assert tblob.numel() == ts.N_TRAIN_WEIGHTS == 1155712 and tblob.dtype == torch.bfloat16
    assert torch.equal(_decode_bwd(tblob, name), packed[name].t())


def test_training_blob_starts_with_the_eval_blob(blobs):
    packed, wblob, tblob = blobs
    ew, _ = tfm.eval_blobs(tfm.kernel_blobs(packed))
    assert torch.equal(tblob[:ts.N_EVAL_WEIGHTS], ew)
    # 34 slabs of 32 KB behind it, 16-byte aligned
    assert (ts.N_TRAIN_WEIGHTS - ts.N_EVAL_WEIGHTS) * 2 == 34 * 32768
    assert ts.N_EVAL_WEIGHTS * 2 % 16 == 0


@pytest.mark.parametrize("n_rows", ROWS)
def test_weight_gradient_items_cover_every_entry_and_row_once(n_rows):
    n_pad = ts.padded_rows(n_rows)
    assert n_pad % 128 == 0 and n_pad - n_rows < 128
    n_blocks = n_pad // 64
    items = ts.wgrad_items(n_pad, 132)
    assert items.dtype == np.int32 and items.shape[1] == len(ts.ITEM_FIELDS)
    assert len(items) <= 132  # one wave of one thread block per SM
    off = ts.kernel_offsets()
    covered = np.zeros(tfm.N_KERNEL_WEIGHTS, np.int64)
    units = {}
    for x_chunk, m, d_chunk, n, out, ld, b0, b1 in items:
        assert 0 <= b0 < b1 <= n_blocks
        assert m in (32, 64, 128) and n in (128, 256)
        assert x_chunk + -(-m // 64) <= ts.ACT_CHUNKS and d_chunk + n // 64 <= ts.GRAD_CHUNKS
        units.setdefault((x_chunk, m, d_chunk, n, out, ld), []).append((b0, b1))
    for (x_chunk, m, d_chunk, n, out, ld), ranges in units.items():
        # the unit's row blocks tile [0, n_blocks) exactly
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == n_blocks
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        idx = out + np.arange(m)[:, None] * ld + np.arange(n)[None, :]
        covered[idx.reshape(-1)] += 1
    for k in tfm._KERNEL_WEIGHTS:
        size = tfm.PACKED_SHAPES[k][0] * tfm.PACKED_SHAPES[k][1]
        want = 1 if k in WIDE else 0  # the heads' gradients come from the backward
        assert (covered[off[k]:off[k] + size] == want).all(), k


@pytest.mark.parametrize("sm_count", [1, 16, 132])
def test_weight_gradient_items_spread_the_work(sm_count):
    n_pad = ts.padded_rows(2048 * 193)
    items = ts.wgrad_items(n_pad, sm_count)
    assert len(items) == max(sm_count, 21)  # 21 output tiles, each at least once
    blocks = items[:, 7] - items[:, 6]
    cost = np.where(items[:, 3] == 256, 1.0, 0.5) * blocks
    # every block's share within a factor of two of the mean
    assert cost.max() <= 2.0 * cost.mean()


@pytest.mark.parametrize("n_rows", [1, 128, 129, 2048 * 49])
def test_train_workspaces_sizes(n_rows):
    act, grad, mask, rgb, sigma = tfmt.train_workspaces(n_rows, torch.device("cpu"))
    n_pad = -(-n_rows // 128) * 128
    # 64-row blocks of 8 KB chunks: 40 of activations, 38 of gradients
    assert act.shape == (n_pad // 64, 40, 64, 64) and act.dtype == torch.bfloat16
    assert grad.shape == (n_pad // 64, 38, 64, 64) and grad.dtype == torch.bfloat16
    assert mask.shape == (n_pad, 256) and mask.dtype == torch.uint8
    assert rgb.shape == (n_rows, 3) and sigma.shape == (n_rows, 1)
    assert all(t.is_contiguous() for t in (act, grad, mask))
    assert (ts.ACT_CHUNKS, ts.GRAD_CHUNKS, ts.MASK_BYTES) == (40, 38, 256)
    # every column of the layouts in a chunk, 16-byte groups never split
    assert ts.ACT_COLS <= 64 * ts.ACT_CHUNKS and ts.GRAD_COLS == 64 * ts.GRAD_CHUNKS
    assert all(c % 8 == 0 for c in (ts.ACT_A0, ts.ACT_BOTT, ts.ACT_V, ts.ACT_VENC, ts.GR_BOTT,
                                    ts.GR_V))


def test_blocked_workspace_is_the_swizzled_tile_image():
    """Row r, column c of a block sits in chunk c // 64, at 128 r + the
    16-byte group (c % 64) // 8 XOR r % 8, as the kernels' tiles hold it."""
    g = np.random.default_rng(4)
    rows = torch.from_numpy(g.normal(size=(192, 150)).astype(np.float32)).bfloat16()
    blocked = ts.to_blocked(rows, 3)
    assert blocked.shape == (3, 3, 64, 64)
    flat = blocked.reshape(-1)
    for r, c in ((0, 0), (5, 9), (63, 127), (64, 8), (130, 149), (191, 71)):
        b, rr = divmod(r, 64)
        byte = (b * 3 + c // 64) * 8192 + rr * 128 + ((((c % 64) // 8) ^ (rr % 8)) << 4) + (c % 8) * 2
        assert flat[byte // 2] == rows[r, c]
    back = ts.from_blocked(blocked)
    assert torch.equal(back[:, :150], rows) and not back[:, 150:].float().any()


def test_launch_inputs_raise_on_a_wrong_blob(blobs):
    packed, wblob, _ = blobs
    _, bblob = tfm.kernel_blobs(packed)
    cpu = torch.device("cpu")
    for bad in ((wblob.float(), bblob), (wblob[:-1], bblob), (wblob, bblob.double()),
                (ts.train_blob(wblob), bblob), (wblob.to("meta"), bblob)):
        with pytest.raises(ValueError, match="training kernels"):
            ts.launch_inputs(bad, 1000, cpu)


def test_weight_grads_wrapper_checks_and_cpu_twin():
    g = np.random.default_rng(5)
    act = ts.to_blocked(torch.from_numpy(g.normal(size=(128, 2528)).astype(np.float32)).bfloat16(),
                        40)
    grad = ts.to_blocked(
        torch.from_numpy(g.normal(size=(128, 2432)).astype(np.float32)).bfloat16(), 38)
    before = ts.weight_grads.launches
    got = ts.weight_grads(act, grad)  # CPU tensors: the twin, no launch
    assert ts.weight_grads.launches == before
    assert torch.equal(got, ts.weight_grads_plain(act, grad))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ts.weight_grads(act.to("meta"), grad.to("meta"))


def test_weight_grads_twin_matches_jax_on_the_same_workspaces():
    """dW = X^T D of each wide matrix, bf16 operands and f32 sums, against
    jnp.dot with float32 accumulation on the same numpy workspaces."""
    g = np.random.default_rng(6)
    n = 192
    act = g.normal(size=(n, 2528)).astype(np.float32)
    grad = g.normal(size=(n, 2432)).astype(np.float32)
    got = tfm.grads_from_blob(ts.weight_grads_plain(
        ts.to_blocked(torch.from_numpy(act).bfloat16(), 40),
        ts.to_blocked(torch.from_numpy(grad).bfloat16(), 38)))
    cols = {  # (X columns, D columns) of each matrix: train_sm90.cuh's layouts
        "w0": (0, 0), "w1": (64, 256), "w2": (320, 512), "w3": (576, 768), "w4": (832, 1024),
        "w5a": (1088, 1280), "w5b": (0, 1280), "w6": (1344, 1536), "w7": (1600, 1792),
        "wb": (1856, 2048), "wva": (2112, 2304), "wvb": (2496, 2304)}
    for k, (xc, dc) in cols.items():
        kx, nd = tfm.PACKED_SHAPES[k]
        x = jnp.asarray(act[:, xc:xc + kx], dtype=jnp.bfloat16)
        d = jnp.asarray(grad[:, dc:dc + nd], dtype=jnp.bfloat16)
        want = np.asarray(jax.lax.dot_general(x, d, (((0,), (0,)), ((), ())),
                                              preferred_element_type=jnp.float32))
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-5, atol=1e-4)
    for k in ("wd", "wrgb"):
        assert not got[k].any()
