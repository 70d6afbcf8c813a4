"""The eval kernel's Python side (ops/csrc/trunk_sm90.cuh runs only on the
card): the eval weight blob against the kernel blob, entry by entry; the
wrappers' checks; the launch's tile and grid arithmetic and the rows each
tile stages, against the plain twins.  No card needed."""

import numpy as np
import pytest
import torch

from aon_tpu_torch.ops import fused_mlp as tfm

SLABS = ("w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7", "wb", "wva", "wvb")
HEADS = ("wd", "wrgb")


def _packed(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in tfm.PACKED_SHAPES.items():
        v = torch.randn(*shape, generator=g)
        out[k] = (v / shape[0] ** 0.5).to(dtype) if k.startswith("w") else 0.1 * v
    # the packing's zero rows: K padded 63 -> 64 and 27 -> 32
    for k, real in (("w0", 63), ("w5b", 63), ("wvb", 27)):
        out[k][real:] = 0
    return out


def _decode(blob: torch.Tensor, name: str) -> torch.Tensor:
    """Matrix ``name`` (K, N) read back from the eval blob, its K padding to a
    multiple of 64 included: walks the blob's slabs in layer order, each N
    rows of 64 K-columns with the 16-byte group g of row n holding K-columns
    8 * (g ^ (n % 8)) .."""
    offset = 0
    for k in SLABS:
        K, N = tfm.PACKED_SHAPES[k]
        n_slabs = -(-K // 64)
        if k == name:
            slabs = blob[offset:offset + n_slabs * N * 64].reshape(n_slabs, N, 8, 8)
            out = torch.empty(n_slabs * 64, N, dtype=blob.dtype)
            for s in range(n_slabs):
                for n in range(N):
                    for g in range(8):
                        col = 64 * s + 8 * (g ^ (n % 8))
                        out[col:col + 8, n] = slabs[s, n, g]
            return out
        offset += n_slabs * N * 64
    for k in HEADS:
        size = tfm.PACKED_SHAPES[k][0] * tfm.PACKED_SHAPES[k][1]
        if k == name:
            return blob[offset:offset + size].reshape(tfm.PACKED_SHAPES[k])
        offset += size
    raise KeyError(name)


@pytest.fixture(scope="module")
def blobs():
    bf = _packed(torch.bfloat16)
    f32 = _packed(torch.float32)
    return {"bfloat16": (bf, tfm.launch_blobs(bf)), "float32": (f32, tfm.launch_blobs(f32))}


@pytest.mark.parametrize("name", SLABS + HEADS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_eval_blob_holds_each_matrix_of_the_kernel_blob(blobs, name, dtype):
    packed, (wblob, bblob) = blobs[dtype]
    assert wblob.dtype == torch.bfloat16 and wblob.numel() == tfm.N_EVAL_WEIGHTS == 598656
    assert tfm.EVAL_SLAB_BYTES == 1196032
    # the kernel blob of the same packing, rounded once as launch_blobs does
    rounded = tfm.round_packed(packed) if dtype == "float32" else packed
    kw, kb = tfm.kernel_blobs(rounded)
    assert torch.equal(bblob, kb)
    want = rounded[name]
    got = _decode(wblob, name)
    K = want.shape[0]
    assert torch.equal(got[:K], want)
    assert not got[K:].float().abs().any()  # K zero-padded to 64 (wvb: 32 -> 64)
    # and each entry is the kernel blob's entry of that matrix
    offsets, o = {}, 0
    for k in ("w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7", "wb", "wva", "wvb", "wd",
              "wrgb"):
        offsets[k] = o
        o += tfm.PACKED_SHAPES[k][0] * tfm.PACKED_SHAPES[k][1]
    assert torch.equal(got[:K].reshape(-1), kw[offsets[name]:offsets[name] + want.numel()])


def test_float32_packing_launches_the_bf16_packings_blob(blobs):
    bf, (w_bf, b_bf) = blobs["bfloat16"]
    rebuilt = tfm.launch_blobs({k: (v.float() if k.startswith("w") else v) for k, v in bf.items()})
    assert torch.equal(rebuilt[0], w_bf) and torch.equal(rebuilt[1], b_bf)


def test_eval_blob_checks_raise_on_a_wrong_blob_shape_dtype_or_alignment(blobs):
    packed, (wblob, bblob) = blobs["bfloat16"]
    cpu = torch.device("cpu")
    assert tfm._checked_blobs(packed, (wblob, bblob), cpu)[0] is wblob
    kernel_w, _ = tfm.kernel_blobs(packed)
    for bad in ((kernel_w, bblob),  # the training kernels' layout
                (wblob.float(), bblob),
                (wblob, bblob.double()),
                (torch.cat([wblob.new_zeros(1), wblob])[1:], bblob),  # 2 bytes off alignment
                (wblob.to("meta"), bblob)):
        with pytest.raises(ValueError, match="eval kernel"):
            tfm._checked_blobs(packed, bad, cpu)


def test_eval_wrappers_raise_on_a_wrong_device_shape_or_dtype():
    packed = _packed(torch.bfloat16)
    consts = tfm.make_posenc_constants(device="cpu")
    meta = torch.zeros(2, 5, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfm.fused_nerf_mlp_xyz(packed, consts, meta, torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfm.fused_nerf_mlp(packed, torch.zeros(4, 64, device="meta"),
                           torch.zeros(4, 32, device="meta"))
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="samples must be contiguous float32"):
        tfm.check_float32(cpu, samples=(torch.zeros(2, 5, 3, dtype=torch.float64), (2, 5, 3)))
    with pytest.raises(ValueError, match="viewdirs must be contiguous float32"):
        tfm.check_float32(cpu, viewdirs=(torch.zeros(3, 3), (2, 3)))
    with pytest.raises(ValueError, match="enc_consts"):
        tfm._check_enc_consts({**consts, "s_pos": consts["s_pos"][:, :63]}, cpu)


@pytest.mark.parametrize("n_rows,tiles,grid", [
    (1, 1, 1), (127, 1, 1), (128, 1, 1), (129, 2, 2), (65536 + 17, 513, 132),
    (132 * 128 * 5 + 77, 661, 132), (61440 * 193, 92640, 132)])
def test_eval_launch_covers_every_row_once(n_rows, tiles, grid):
    assert tfm.eval_launch_shape(n_rows, 132) == (tiles, grid)
    # block b walks tiles b, b + grid, ...; each tile's two warpgroups stage
    # rows tile * 128 + [0, 64) and [64, 128) and write those below n_rows
    written = np.zeros(n_rows, np.int32)
    per_block = []
    for b in range(grid):
        walked = range(b, tiles, grid)
        per_block.append(len(walked))
        for tile in walked:
            for wg in (0, 1):
                row0 = tile * 128 + 64 * wg
                written[row0:min(row0 + 64, n_rows)] += 1
    assert (written == 1).all()
    assert max(per_block) - min(per_block) <= 1 and sum(per_block) == tiles
    heads = 2 * (256 + 128 * 3)
    assert tfm.eval_l2_weight_bytes(n_rows, 132) == tiles * 1196032 + grid * heads


def _tile_rows(tile, n_rows, samples_per_ray):
    """The rows one tile stages (``stage_rows`` of fused_mlp_eval.cu): sample
    rows tile * 128 + r clamped to the last row, and the ray of each."""
    g = np.minimum(tile * 128 + np.arange(128), n_rows - 1)
    return g, g // samples_per_ray


@pytest.mark.parametrize("S", [65, 193])  # 128 is no multiple of either: rays straddle tiles
def test_per_ray_tiles_reproduce_the_twin(S):
    B = 3
    n = B * S
    g = np.random.default_rng(0)
    packed = _packed(torch.bfloat16, seed=1)
    enc = torch.from_numpy(g.normal(size=(n, 64)).astype(np.float32))
    venc = torch.from_numpy(g.normal(size=(B, 32)).astype(np.float32))
    want_rgb, want_sigma = tfm.fused_nerf_mlp_per_ray_plain(packed, enc.reshape(B, S, 64), venc)
    tiles, _ = tfm.eval_launch_shape(n, 132)
    rgb = torch.full((n, 3), float("nan"))
    sigma = torch.full((n, 1), float("nan"))
    for tile in range(tiles):
        rows, rays = _tile_rows(tile, n, S)
        got_rgb, got_sigma = tfm._mlp_compute(enc[rows].bfloat16(), venc[rays].bfloat16(), packed)
        keep = tile * 128 + np.arange(128) < n  # rows past the end are not written
        rgb[rows[keep]], sigma[rows[keep]] = got_rgb[keep], got_sigma[keep]
    # the same rows through the same math; only the CPU's float32 products
    # block 128 rows otherwise than 3 x S, so they agree to float32 rounding
    # (a row or ray off would move the outputs by O(1))
    torch.testing.assert_close(rgb, want_rgb.reshape(n, 3), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sigma, want_sigma.reshape(n, 1), rtol=1e-5, atol=1e-5)
