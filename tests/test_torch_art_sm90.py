"""The articulated kernels' Python side (ops/csrc/art_sm90.cuh runs only on the
card): the eval and training blobs read back entry by entry against the
kernel blob (``fused_art.art_blobs``), the weight gradients' work list over
the 18 wide matrices against every entry of every dW and every workspace
row, the workspace, chunk and relu-mask layouts, the wrappers' checks, and
the weight gradients' units over blocked workspaces against JAX.  No card
needed."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aon_tpu_torch.ops import art_sm90 as arts
from aon_tpu_torch.ops import fused_art
from aon_tpu_torch.ops import fused_mlp as tfm
from aon_tpu_torch.ops import train_sm90 as ts
from aon_tpu_torch.ops.train_fused_level_art import fused_level_train_art_grads

HEADER = Path(arts.__file__).resolve().parent / "csrc" / "art_sm90.cuh"
# workspace rows of the shapes the articulated kernels run: ragged counts, the
# bench's 2,048 rays x 25 / 73, the render's x 65 / 193 and the largest level
ROWS = (1000, 65553, 2048 * 25, 2048 * 73, 2048 * 65, 2048 * 193, 2048 * 256)
WIDE = ("w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7", "wb", "wva", "wvb",
        "wd1", "wd2", "wd3", "wv1", "wv2", "wv3")


def _packed(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(*shape, generator=g) / shape[0] ** 0.5
            for k, shape in fused_art.EFF_SHAPES.items()}


@pytest.fixture(scope="module")
def blobs():
    packed = _packed()
    wblob, bblob = fused_art.art_blobs(packed)
    rounded = {k: v.to(torch.bfloat16) for k, v in packed.items()}
    return rounded, wblob, bblob


def _decode(seg, n_rows, k):
    """A (k, n_rows) K-major matrix read back from its 64-wide swizzled slabs:
    the 16-byte group g of row n holds K-columns 64 s + 8 (g ^ (n % 8)) .. + 7."""
    slabs = seg.reshape(-(-k // 64), n_rows, 8, 8)
    out = torch.zeros(-(-k // 64) * 64, n_rows, dtype=seg.dtype)
    n = torch.arange(n_rows)
    for s in range(slabs.shape[0]):
        for g in range(8):
            col = 64 * s + 8 * (g ^ (n % 8))
            for e in range(8):
                out[col + e, n] = slabs[s, :, g, e]
    return out[:k]


@pytest.mark.parametrize("name", arts.EVAL_SLABS)
def test_eval_blob_holds_each_128_wide_matrix(blobs, name):
    rounded, wblob, _ = blobs
    eblob = arts.eval_blob(wblob)
    assert eblob.numel() == arts.N_ART_EVAL_WEIGHTS == 697984 and eblob.dtype == torch.bfloat16
    o = tfm.N_EVAL_WEIGHTS + arts.EVAL_SLABS.index(name) * 128 * 128
    # the forward's B: N = 128 output rows of K = 128 inputs, i.e. W itself
    assert torch.equal(_decode(eblob[o:o + 128 * 128], 128, 128), rounded[name])


def test_eval_blob_starts_with_the_vanilla_eval_blob_and_ends_with_the_heads(blobs):
    rounded, wblob, _ = blobs
    eblob = arts.eval_blob(wblob)
    # the kernel blob's head is the vanilla kernel blob (the density head wdn as wd)
    ew, _ = tfm.eval_blobs((wblob[:tfm.N_KERNEL_WEIGHTS], None))
    assert torch.equal(eblob[:tfm.N_EVAL_WEIGHTS], ew)
    heads = eblob[tfm.N_EVAL_WEIGHTS + 6 * 128 * 128:]
    assert torch.equal(heads[:512].view(4, 128), rounded["wd0x"])
    assert torch.equal(heads[512:].view(128, 4), rounded["wdo"])


@pytest.mark.parametrize("name", arts.BWD_SLABS)
def test_training_blob_holds_each_transposed_matrix(blobs, name):
    rounded, wblob, _ = blobs
    tblob = arts.train_blob(wblob)
    assert tblob.numel() == arts.N_ART_TRAIN_WEIGHTS == 1418880
    o = arts.N_ART_EVAL_WEIGHTS + ts.N_BWD_WEIGHTS
    for k in arts.BWD_SLABS:
        n_in, n_out = fused_art.EFF_SHAPES[k]
        size = 128 * n_out  # the inputs' rows padded to 128
        if k == name:
            got = _decode(tblob[o:o + size], 128, n_out)  # (K' = outputs, N' = 128)
            assert torch.equal(got[:, :n_in], rounded[name].t())
            assert not got[:, n_in:].float().any()  # the padding rows are zero
            return
        o += size
    raise KeyError(name)


def test_training_blob_starts_with_the_eval_and_vanilla_backward_blobs(blobs):
    _, wblob, _ = blobs
    tblob = arts.train_blob(wblob)
    assert torch.equal(tblob[:arts.N_ART_EVAL_WEIGHTS], arts.eval_blob(wblob))
    vanilla_t = ts.train_blob(wblob[:tfm.N_KERNEL_WEIGHTS])
    assert torch.equal(tblob[arts.N_ART_EVAL_WEIGHTS:arts.N_ART_EVAL_WEIGHTS + ts.N_BWD_WEIGHTS],
                       vanilla_t[tfm.N_EVAL_WEIGHTS:])
    for off in (arts.N_ART_EVAL_WEIGHTS, arts.N_ART_EVAL_WEIGHTS + ts.N_BWD_WEIGHTS):
        assert off * 2 % 16 == 0  # the slabs are copied in 16-byte units


def test_the_header_states_the_same_layout():
    text = HEADER.read_text()
    for expr, value in (("N_ART_EVAL_WEIGHTS", arts.N_ART_EVAL_WEIGHTS),
                        ("N_ART_TRAIN_WEIGHTS", arts.N_ART_TRAIN_WEIGHTS),
                        ("Layout::ACT_CHUNKS", arts.ACT_CHUNKS),
                        ("Layout::GRAD_CHUNKS", arts.GRAD_CHUNKS),
                        ("ART_N_WEIGHTS", fused_art.N_KERNEL_WEIGHTS),
                        ("ART_N_BIASES", fused_art.N_KERNEL_BIASES)):
        assert re.search(rf"{re.escape(expr)} == {value}\b", text), expr
    for name, value in (("ACT_C_HD0", arts.ACT_C_HD0), ("ACT_C_V1", arts.ACT_C_V1),
                        ("GR_C_V1", arts.GR_C_V1), ("GR_C_DH1", arts.GR_C_DH1)):
        assert re.search(rf"{name} = .*// .*at {name} \+ 2", text), name


@pytest.mark.parametrize("n_rows", ROWS)
def test_weight_gradient_items_cover_every_entry_and_row_once(n_rows):
    n_pad = ts.padded_rows(n_rows)
    n_blocks = n_pad // 64
    items = arts.wgrad_items(n_pad, 132)
    assert items.dtype == np.int32 and items.shape[1] == len(ts.ITEM_FIELDS)
    assert len(items) <= 132
    off = arts.kernel_offsets()
    covered = np.zeros(fused_art.N_KERNEL_WEIGHTS, np.int64)
    units = {}
    for x_chunk, m, d_chunk, n, out, ld, b0, b1 in items:
        assert 0 <= b0 < b1 <= n_blocks
        assert m in (32, 64, 128) and n in (128, 256)
        assert x_chunk + -(-m // 64) <= arts.ACT_CHUNKS and d_chunk + n // 64 <= arts.GRAD_CHUNKS
        units.setdefault((x_chunk, m, d_chunk, n, out, ld), []).append((b0, b1))
    assert len(units) == 27
    for (x_chunk, m, d_chunk, n, out, ld), ranges in units.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == n_blocks
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        idx = out + np.arange(m)[:, None] * ld + np.arange(n)[None, :]
        covered[idx.reshape(-1)] += 1
    for k in fused_art._KERNEL_WEIGHTS:
        size = fused_art.EFF_SHAPES[k][0] * fused_art.EFF_SHAPES[k][1]
        want = 1 if k in WIDE else 0  # heads and wd0x / wdo come from the backward
        assert (covered[off[k]:off[k] + size] == want).all(), k


@pytest.mark.parametrize("n_rows", [1, 128, 129, 2048 * 73])
def test_train_workspaces_sizes(n_rows):
    act, grad, mask, xp, rgb, sigma = fused_art.train_workspaces(n_rows, torch.device("cpu"))
    n_pad = -(-n_rows // 128) * 128
    assert act.shape == (n_pad // 64, 54, 64, 64) and act.dtype == torch.bfloat16
    assert grad.shape == (n_pad // 64, 50, 64, 64) and grad.dtype == torch.bfloat16
    assert mask.shape == (n_pad, 256) and mask.dtype == torch.uint8  # a0..a7, as vanilla
    assert xp.shape == (n_pad, 4) and xp.dtype == torch.float32
    assert rgb.shape == (n_rows, 3) and sigma.shape == (n_rows, 1)
    assert all(t.is_contiguous() for t in (act, grad, mask, xp))


def test_workspace_chunks_do_not_overlap():
    """Every activation and gradient the kernels store has chunks of its own
    after the vanilla layout's."""
    act = {"hd0": arts.ACT_C_HD0, "hd1": arts.ACT_C_HD0 + 2, "hd2": arts.ACT_C_HD0 + 4,
           "hd3": arts.ACT_C_HD0 + 6, "v1": arts.ACT_C_V1, "v2": arts.ACT_C_V1 + 2,
           "v3": arts.ACT_C_V1 + 4}
    grad = {"dv1": arts.GR_C_V1, "dv2": arts.GR_C_V1 + 2, "dv3": arts.GR_C_V1 + 4,
            "dh1": arts.GR_C_DH1, "dh2": arts.GR_C_DH1 + 2, "dh3": arts.GR_C_DH1 + 4}
    for table, head, total in ((act, ts.ACT_CHUNKS, arts.ACT_CHUNKS),
                               (grad, ts.GRAD_CHUNKS, arts.GRAD_CHUNKS)):
        used = sorted(c for start in table.values() for c in (start, start + 1))
        assert used == list(range(head, total))


@pytest.mark.parametrize("width", [128, 256])
def test_mask_bits_name_each_column_of_a_row_once(width):
    """The fragment order of the relu-mask bits (the mask workspace's at 256,
    ``act_mask``'s at 128): lane quad position q holds columns 8i + 2q + p in
    bit 2i + p of the word i // 16 at 8q, so the bits name every column once."""
    seen = set()
    for q in range(4):
        for i in range(width // 8):
            for p in range(2):
                byte, bit = 8 * q + 4 * (i >> 4), 2 * (i & 15) + p
                assert byte + bit // 8 < 32
                seen.add((8 * i + 2 * q + p, byte * 8 + bit))
    assert sorted(c for c, _ in seen) == list(range(width))
    assert len({b for _, b in seen}) == width


def test_act_mask_reads_each_fragment_pair_from_the_workspace_chunks():
    """The backward's ``act_mask`` reads a 128-wide layer's stored values at
    the tile's pair offsets (chunk i // 8, row r at 128 r, the 16-byte group
    (i % 8) ^ (r % 8), 4 q): in the blocked workspace that word holds columns
    8i + 2q and + 1 of row r, for both rows r0 = 16 warp + x and r0 + 8 a
    lane holds."""
    g = np.random.default_rng(9)
    rows = torch.from_numpy(g.normal(size=(64, 128)).astype(np.float32)).bfloat16()
    chunks = ts.to_blocked(rows, 2).reshape(-1).view(torch.int16).numpy().view(np.uint16)
    for warp in range(4):
        for lane in range(32):
            x, q = lane >> 2, lane & 3
            for r in (16 * warp + x, 16 * warp + x + 8):
                for i in range(16):
                    byte = (i >> 3) * 8192 + r * 128 + (((i & 7) ^ (r % 8)) << 4) + 4 * q
                    pair = chunks[byte // 2:byte // 2 + 2]
                    want = rows[r, 8 * i + 2 * q:8 * i + 2 * q + 2].view(torch.int16).numpy()
                    assert (pair == want.view(np.uint16)).all()


def test_wrappers_check_their_blobs_and_devices(blobs):
    _, wblob, bblob = blobs
    cpu = torch.device("cpu")
    for bad in ((wblob.float(), bblob), (wblob[:-1], bblob), (wblob, bblob.double()),
                (arts.eval_blob(wblob), bblob)):
        with pytest.raises(ValueError, match="articulated eval kernel"):
            arts.eval_inputs(bad, 1000, cpu)
        with pytest.raises(ValueError, match="articulated training kernels"):
            arts.train_inputs(bad, 1000, cpu)
    packed = {k: v.to("meta") for k, v in _packed().items()}
    consts = {k: v.to("meta") for k, v in tfm.make_posenc_constants(device="cpu").items()}
    x, d = torch.empty(2, 3, 3, device="meta"), torch.empty(2, 3, device="meta")
    counters = (fused_art.art_mlp_fwd, fused_art.art_mlp_bwd, fused_level_train_art_grads)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_art.art_mlp_fwd(packed, consts, x, d)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_art.art_mlp_bwd(packed, consts, x, d, torch.empty(2, 3, 4, device="meta"))
    t = torch.empty(2, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_level_train_art_grads(packed, consts, t, d, d, d, d, t[:, 0], t[:, 0], False)
    assert [f.launches for f in counters] == before


def test_weight_gradient_units_read_the_articulated_columns():
    """dW = X^T D of each of the 18 matrices over blocked workspaces, the
    units' chunks read as the kernel reads them (bf16 operands, f32 sums),
    against jnp.dot on the columns each activation and gradient has in the
    row layout [vanilla | hd0..hd3 | v1..v3] and [vanilla | dv1..dv3 |
    dh1..dh3]."""
    g = np.random.default_rng(8)
    n = 128
    act = g.normal(size=(n, 64 * arts.ACT_CHUNKS)).astype(np.float32)
    grad = g.normal(size=(n, 64 * arts.GRAD_CHUNKS)).astype(np.float32)
    x_rows = ts.from_blocked(ts.to_blocked(torch.from_numpy(act).bfloat16(), arts.ACT_CHUNKS))
    d_rows = ts.from_blocked(ts.to_blocked(torch.from_numpy(grad).bfloat16(), arts.GRAD_CHUNKS))
    gw = torch.zeros(fused_art.N_KERNEL_WEIGHTS + fused_art.N_KERNEL_BIASES)
    for x_chunk, m, d_chunk, nd, out, ld in arts.wgrad_units():
        x = x_rows[:, 64 * x_chunk:64 * x_chunk + m].float()
        d = d_rows[:, 64 * d_chunk:64 * d_chunk + nd].float()
        gw[out:out + m * ld].view(m, ld).add_(x.t() @ d)
    got = fused_art.grads_from_blob(gw)
    # (X column, D column) of the six articulated matrices in the row layout
    cols = {"wd1": (2560, 2816), "wd2": (2688, 2944), "wd3": (2816, 3072),
            "wv1": (2368, 2432), "wv2": (3072, 2560), "wv3": (3200, 2688)}
    for k, (xc, dc) in cols.items():
        kx, nd = fused_art.EFF_SHAPES[k]
        x = jnp.asarray(act[:, xc:xc + kx], dtype=jnp.bfloat16)
        d = jnp.asarray(grad[:, dc:dc + nd], dtype=jnp.bfloat16)
        want = np.asarray(jax.lax.dot_general(x, d, (((0,), (0,)), ((), ())),
                                              preferred_element_type=jnp.float32))
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-5, atol=1e-4)
    for k in ("wd0x", "wdo", "wdn", "wrgb"):
        assert not got[k].any()
