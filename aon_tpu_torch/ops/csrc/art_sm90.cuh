// The articulated NeRF MLP's kernels for Hopper (sm_90a), built on the
// persistent wgmma trunk of trunk_sm90.cuh and the training pieces of
// train_sm90.cuh: the deformation prefix and the view branch around the
// vanilla-shaped trunk, forward and backward.  art.cu runs them for kernel
// table rows 9, 10 and 11.
//
// The MLP per sample row: the deformation (layer 0, K = 3; layers 1..3, 128
// wide; the head wdo, 128 -> 3) gives x' = xyz + delta in f32; x' and the
// ray's viewdir are encoded; the 8x256 trunk with its skip, the density head
// and the bottleneck; the view layer v0 and three more 128-wide view layers;
// the rgb head on v3.  The latent codes are folded into the biases on the
// host (ops/fused_art.py).
//
// Blobs (ops/art_sm90.py packs them once from the row-major kernel blob):
//   * eval blob: the vanilla eval blob (trunk_sm90.cuh), then the slabs of
//     wd1..wd3 and wv1..wv3 (each 128 rows of its K = 128 in two 64-wide
//     K-major swizzled slabs of 16 KB, VSLAB_BYTES), then wd0x (4 x 128) and
//     wdo (128 x 4) row-major, which CUDA cores read through L1;
//   * training blob: the eval blob, the vanilla backward blob (34 slabs of
//     W^T, train_sm90.cuh), then W^T of wv3, wv2, wv1, of w0 and w5b (their
//     64 rows zero-padded to 128, four slabs each), and of wd3, wd2, wd1.
// The producer streams, per 128-row tile, the forward's 6 + 39 + 6 slabs or
// the backward's 6 + 34 + 8 + 6, in the order the products read them; no
// product takes more than 4 slabs, so a two-stream turn never waits for a
// slab only the other warpgroup frees (trunk_sm90.cuh STAGES).
//
// Workspaces: the vanilla layouts (train_sm90.cuh) with columns appended:
//   * act   54 chunks a block: the vanilla 40 (v = v0), hd0..hd3, v1..v3;
//   * grad  50 chunks a block: the vanilla 38 (dv = dv0), dv1..dv3, dh1..dh3;
//   * mask  the vanilla layout, a0..a7's bits (256 bytes a row).  The
//           backward takes the relu masks of the 128-wide layers (hd0..hd3,
//           v0..v3) from their stored values in the act workspace, loaded
//           before each product: bits written by those layers' epilogues
//           cost the forward more than the loads cost the backward;
//   * xp    f32 (n_pad, 4): x', which the backward's encoding VJP reads.
//
// Shared memory is the eval trunk's layout, full to 704 bytes.  The 128-wide
// layers use half of a warpgroup's 32 KB activation tile; the prefix keeps
// the tile's coordinates and x' (64 x 4 f32 each) in the other half, the
// backward d_enc (64 x 64 f32), its d_x' and the coordinates.  The backward's block sums (4,744
// floats) take the view-encoding tiles and the end of the second
// warpgroup's encoding tile, past its g rows and column sums.
//
// Roundings (art.cu): bf16 operands and f32 sums in every product; K = 3 as
// FMAs on bf16-rounded operands; x' and the encodings in f32; relu masks
// from the stored bf16 activations; D rounded to bf16 where it is stored.

#pragma once

#include "train_sm90.cuh"

namespace aon {
namespace sm90 {
namespace art {

constexpr int DEF = COND;  // width of the deformation MLP and of the view branch

// the row-major kernel blob (and the f32 gradient blob): the vanilla blob
// (wd = the density head), then these
constexpr int AOFF_WD0X = N_WEIGHTS;                // (4, 128), row 3 zero
constexpr int AOFF_WD1 = AOFF_WD0X + 4 * DEF;       // wd1..wd3 at DEF*DEF strides
constexpr int AOFF_WDO = AOFF_WD1 + 3 * DEF * DEF;  // (128, 4), column 3 zero
constexpr int AOFF_WV1 = AOFF_WDO + DEF * 4;        // wv1..wv3 at DEF*DEF strides
constexpr int ART_N_WEIGHTS = AOFF_WV1 + 3 * DEF * DEF;
static_assert(ART_N_WEIGHTS == 693888, "kernel blob layout");
// f32 bias blob: the vanilla blob (bd = bdn), then bd0..bd3, bdo (4), bv1..bv3
constexpr int AOFF_BD0 = N_BIASES;
constexpr int AOFF_BDO = AOFF_BD0 + 4 * DEF;
constexpr int AOFF_BV1 = AOFF_BDO + 4;
constexpr int ART_N_BIASES = AOFF_BV1 + 3 * DEF;
static_assert(ART_N_BIASES == 3336, "bias blob layout");

// eval blob (bf16 entries)
constexpr int DSLAB_ELEMS = DEF * KCHUNK;  // a 128-row slab, VSLAB_BYTES
static_assert(DSLAB_ELEMS * 2 == VSLAB_BYTES, "128-column slabs");
constexpr int MAT_ELEMS = DEF * DEF;       // a 128 x 128 matrix, two slabs
constexpr int EVAL_OFF_DEF = N_EVAL_WEIGHTS;             // wd1..wd3
constexpr int EVAL_OFF_VIEW = EVAL_OFF_DEF + 3 * MAT_ELEMS;  // wv1..wv3
constexpr int EVAL_OFF_WD0X = EVAL_OFF_VIEW + 3 * MAT_ELEMS;
constexpr int EVAL_OFF_WDO = EVAL_OFF_WD0X + 4 * DEF;
constexpr int N_ART_EVAL_WEIGHTS = EVAL_OFF_WDO + DEF * 4;
static_assert(N_ART_EVAL_WEIGHTS == 697984, "eval blob layout");
// training blob
constexpr int TRAIN_OFF_BWD = N_ART_EVAL_WEIGHTS;                     // the vanilla 34 slabs
constexpr int TRAIN_OFF_VIEW_T = TRAIN_OFF_BWD + N_BWD_SLABS * SLAB_BYTES / 2;  // wv3^T..wv1^T
constexpr int TRAIN_OFF_ENC_T = TRAIN_OFF_VIEW_T + 3 * MAT_ELEMS;     // w0^T, w5b^T (128 x 256)
constexpr int TRAIN_OFF_DEF_T = TRAIN_OFF_ENC_T + 2 * DEF * WIDTH;    // wd3^T..wd1^T
constexpr int N_ART_TRAIN_WEIGHTS = TRAIN_OFF_DEF_T + 3 * MAT_ELEMS;
static_assert(N_ART_TRAIN_WEIGHTS == 1418880, "training blob layout");
static_assert(EVAL_OFF_DEF % 8 == 0 && EVAL_OFF_VIEW % 8 == 0 && TRAIN_OFF_BWD % 8 == 0 &&
                  TRAIN_OFF_VIEW_T % 8 == 0 && TRAIN_OFF_ENC_T % 8 == 0 &&
                  TRAIN_OFF_DEF_T % 8 == 0,
              "slabs 16-byte aligned");

// workspaces
constexpr int ACT_C_HD0 = sm90::ACT_CHUNKS;   // hd_l at ACT_C_HD0 + 2 l, l = 0..3
constexpr int ACT_C_V1 = ACT_C_HD0 + 4 * 2;   // v_l at ACT_C_V1 + 2 (l - 1), l = 1..3
constexpr int GR_C_V1 = sm90::GRAD_CHUNKS;    // dv_l at GR_C_V1 + 2 (l - 1)
constexpr int GR_C_DH1 = GR_C_V1 + 3 * 2;     // dh_l at GR_C_DH1 + 2 (l - 1)
// the block's sums: the bias blob, then wd, wrgb, wdo (3 t + k for column t
// of hd3 and output k) and wd0x (its row-major entries of rows 0..2)
constexpr int SUM_WD = ART_N_BIASES;
constexpr int SUM_WRGB = SUM_WD + WIDTH;
constexpr int SUM_WDO = SUM_WRGB + COND * 3;
constexpr int SUM_WD0X = SUM_WDO + DEF * 3;
constexpr int N_SUMS = SUM_WD0X + 3 * DEF;

struct Layout {
  static constexpr int ACT_CHUNKS = ACT_C_V1 + 3 * 2;   // 54
  static constexpr int GRAD_CHUNKS = GR_C_DH1 + 3 * 2;  // 50
  static constexpr int SUM_WD = art::SUM_WD;
  static constexpr int SUM_WRGB = art::SUM_WRGB;
  static constexpr bool ART = true;
};
static_assert(Layout::ACT_CHUNKS == 54 && Layout::GRAD_CHUNKS == 50, "workspace layout");

// shared memory: in a warpgroup's activation tile, past the 128-wide layers'
// two chunks
constexpr int XYZ_OFFSET = 2 * A_CHUNK_BYTES;  // forward: the tile's coordinates, (64, 4) f32
static_assert(XP_OFFSET == 3 * A_CHUNK_BYTES, "x' beside them (train_sm90.cuh)");
constexpr int DENC_LD = POS_PAD + 4;            // backward: d_enc, (64, 68) f32 from 0
constexpr int DXP_OFFSET = 3 * A_CHUNK_BYTES;  // d_x', (64, 4) f32
constexpr int BXYZ_OFFSET = DXP_OFFSET + WG_ROWS * 16;  // and the coordinates
static_assert(WG_ROWS * DENC_LD * 4 <= DXP_OFFSET, "d_enc below d_x'");
// the block's sums: from the end of the second warpgroup's g rows and column
// sums (backward_tile's layout) to the heads' weights
constexpr int SUMS_OFFSET = SM_ENC + A_CHUNK_BYTES + (WG_ROWS * 4 + 4 * WIDTH) * 4;
static_assert(SUMS_OFFSET + N_SUMS * 4 <= SM_HEADS && SUMS_OFFSET % 16 == 0,
              "the block's sums fit");

struct FwdArgs : sm90::FwdArgs {
  float* xp;  // training: the xp workspace, (n_pad, 4) f32
};

struct BwdArgs : sm90::BwdArgs {
  const float* xyz;     // XYZ: (n_rows, 3)
  const float* t_vals;  // T_VALS: (n_rows), with rays_o / rays_d (B, 3)
  const float* rays_o;
  const float* rays_d;
  const float* s_pos;
  const float* p_pos;
  const float* xp;      // the xp workspace
  int samples_per_ray;
};

// ------------------------------------------------------------ producers

// A run of `count` slabs of `bytes` each from byte `offset` of the blob.
struct Segment {
  uint32_t offset, bytes;
  int count;
};

template <int NS>
__device__ __forceinline__ void produce_segments(const Block& b, const bf16* __restrict__ W,
                                                 const Segment (&segs)[NS], long long n_tiles) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(W);
  int stage = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll 1
    for (int k = 0; k < NS; ++k) {
      const Segment sg = segs[k];
      for (int s = 0; s < sg.count; ++s) {
        mbar_wait(b.empty(stage), phase ^ 1);
        mbar_expect_tx(b.full(stage), sg.bytes);
        bulk_copy(b.base + SM_RING + stage * SLAB_BYTES, src + sg.offset + s * sg.bytes, sg.bytes,
                  b.full(stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  }
}

// The forward's slabs of a tile: wd1..wd3, the trunk's, wv1..wv3.
__device__ __forceinline__ void produce_forward(const Block& b, const bf16* __restrict__ W,
                                                long long n_tiles) {
  const Segment segs[4] = {
      {2 * EVAL_OFF_DEF, VSLAB_BYTES, 6},
      {0, SLAB_BYTES, N_WIDE_SLABS},
      {N_WIDE_SLABS * SLAB_BYTES, VSLAB_BYTES, N_SLABS - N_WIDE_SLABS},
      {2 * EVAL_OFF_VIEW, VSLAB_BYTES, 6}};
  produce_segments(b, W, segs, n_tiles);
}

// The backward's: wv3^T..wv1^T, the vanilla chain's, w0^T and w5b^T, wd3^T..wd1^T.
__device__ __forceinline__ void produce_backward(const Block& b, const bf16* __restrict__ W,
                                                 long long n_tiles) {
  const Segment segs[4] = {{2 * TRAIN_OFF_VIEW_T, VSLAB_BYTES, 6},
                           {2 * TRAIN_OFF_BWD, SLAB_BYTES, N_BWD_SLABS},
                           {2 * TRAIN_OFF_ENC_T, VSLAB_BYTES, 8},
                           {2 * TRAIN_OFF_DEF_T, VSLAB_BYTES, 6}};
  produce_segments(b, W, segs, n_tiles);
}

// ------------------------------------------------------------ forward

// The sample coordinates of row g (clamped by the caller): given (XYZ), or
// o + t d of its ray with the product and the sum rounded apart (T_VALS).
template <Stage ST>
__device__ __forceinline__ float4 coords(const float* __restrict__ xyz,
                                         const float* __restrict__ t_vals,
                                         const float* __restrict__ rays_o,
                                         const float* __restrict__ rays_d, long long g,
                                         int samples_per_ray) {
  if constexpr (ST == Stage::XYZ) {
    return make_float4(xyz[3 * g], xyz[3 * g + 1], xyz[3 * g + 2], 0.0f);
  } else {
    const long long ray = g / samples_per_ray;
    const float t = t_vals[g];
    return make_float4(__fadd_rn(rays_o[3 * ray + 0], __fmul_rn(t, rays_d[3 * ray + 0])),
                       __fadd_rn(rays_o[3 * ray + 1], __fmul_rn(t, rays_d[3 * ray + 1])),
                       __fadd_rn(rays_o[3 * ray + 2], __fmul_rn(t, rays_d[3 * ray + 2])), 0.0f);
  }
}

// The deformation prefix on one warpgroup's 64 rows: the coordinates into
// the activation tile (XYZ_OFFSET; rows past the end repeat the last row),
// layer 0 on CUDA cores into its first two chunks (each thread the rows and
// columns of the accumulator fragments it would hold), layers 1..3 as
// m64n128 wgmma, then x' = xyz + (hd3 @ wdo + bdo) in f32 at XP_OFFSET,
// fenced and synchronised.  With STORE (training) every hd_l goes to the act
// workspace and x' to the xp workspace.
template <Stage ST, bool STORE>
__device__ __forceinline__ void prefix(Consumer& c, float (&acc)[128], const FwdArgs& a,
                                       long long row0) {
  constexpr Body B = Body::TWO_STREAM;
  const WsRows<Layout> ws{a, row0};
  float* xyz = reinterpret_cast<float*>(c.act() + XYZ_OFFSET);
  if (c.t < WG_ROWS)
    reinterpret_cast<float4*>(xyz)[c.t] = coords<ST>(a.xyz, a.t_vals, a.rays_o, a.rays_d,
                                                     min(row0 + c.t, a.n_rows - 1),
                                                     a.samples_per_ray);
  c.sync();

  {  // layer 0: K = 3, FMAs on bf16-rounded operands
    const int x = c.lane >> 2, q = c.lane & 3, r0 = 16 * c.warp + x;
    const float4 lo = reinterpret_cast<const float4*>(xyz)[r0];
    const float4 hi = reinterpret_cast<const float4*>(xyz)[r0 + 8];
    const float l0 = round_bf16(lo.x), l1 = round_bf16(lo.y), l2 = round_bf16(lo.z);
    const float h0 = round_bf16(hi.x), h1 = round_bf16(hi.y), h2 = round_bf16(hi.z);
    const bf16* w = a.W + EVAL_OFF_WD0X;
    const float* bias = a.bias + AOFF_BD0;
    uint8_t* tile = c.act();
#pragma unroll 1
    for (int i = 0; i < DEF / 8; ++i) {
      const int col = 8 * i + 2 * q;
      const float2 w0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + col));
      const float2 w1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + DEF + col));
      const float2 w2 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + 2 * DEF + col));
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
      float f[4];
      f[0] = fmaxf(fmaf(l2, w2.x, fmaf(l1, w1.x, l0 * w0.x)) + bv.x, 0.0f);
      f[1] = fmaxf(fmaf(l2, w2.y, fmaf(l1, w1.y, l0 * w0.y)) + bv.y, 0.0f);
      f[2] = fmaxf(fmaf(h2, w2.x, fmaf(h1, w1.x, h0 * w0.x)) + bv.x, 0.0f);
      f[3] = fmaxf(fmaf(h2, w2.y, fmaf(h1, w1.y, h0 * w0.y)) + bv.y, 0.0f);
      *reinterpret_cast<uint32_t*>(tile + pair_offset(i, r0, x, q)) = pack_bf16(f[0], f[1]);
      *reinterpret_cast<uint32_t*>(tile + pair_offset(i, r0 + 8, x, q)) = pack_bf16(f[2], f[3]);
    }
  }
  fence_async_shared();
  c.sync();
  if constexpr (STORE) store_tile(c, c.act(), ws.act(ACT_C_HD0), 2 * CHUNK_BYTES);

  // hd_l = relu(hd_{l-1} @ wd_l + bd_l), as a loop: unrolled, it slows the
  // training forward (code size)
#pragma unroll 1
  for (int layer = 1; layer <= 3; ++layer) {
    product<B, DEF, 2>(c, acc, act_addr(c));
    finish(c, acc);
    if constexpr (STORE) sync_stored(c);
    else c.sync();
    epilogue<B, Epi::HIDDEN, DEF>(c, acc, a.bias + AOFF_BD0 + layer * DEF, a.bias, a.out_rgb,
                                  a.out_sigma, row0, a.n_rows);
    fence_async_shared();
    c.sync();
    if constexpr (STORE)
      store_tile(c, c.act(), ws.act(ACT_C_HD0 + 2 * layer), 2 * CHUNK_BYTES);
  }

  {  // x' = xyz + (hd3 @ wdo + bdo) in f32: two threads a row, 64 columns
     // each, as a loop (unrolled, it slows the training forward: code size)
    const int r = c.t >> 1, half = c.t & 1;
    const uint8_t* tile = c.act() + half * A_CHUNK_BYTES;
    const bf16* w = a.W + EVAL_OFF_WDO + 4 * KCHUNK * half;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll 1
    for (int k = 0; k < KCHUNK; ++k) {
      const float h = __bfloat162float(*reinterpret_cast<const bf16*>(tile + swizzled(r, k)));
      s0 = fmaf(h, __bfloat162float(w[4 * k + 0]), s0);
      s1 = fmaf(h, __bfloat162float(w[4 * k + 1]), s1);
      s2 = fmaf(h, __bfloat162float(w[4 * k + 2]), s2);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    if (half == 0) {
      const float* bdo = a.bias + AOFF_BDO;
      const float4 p = reinterpret_cast<const float4*>(xyz)[r];
      const float4 xp = make_float4(__fadd_rn(p.x, __fadd_rn(s0, bdo[0])),
                                    __fadd_rn(p.y, __fadd_rn(s1, bdo[1])),
                                    __fadd_rn(p.z, __fadd_rn(s2, bdo[2])), 0.0f);
      reinterpret_cast<float4*>(c.act() + XP_OFFSET)[r] = xp;
      if constexpr (STORE) reinterpret_cast<float4*>(a.xp)[opaque(row0) + r] = xp;
    }
  }
  c.sync();
}

// The view branch after v0 (in the activation tile, fenced and
// synchronised): v_l = relu(v_{l-1} @ wv_l + bv_l) for l = 1..3 as m64n128
// wgmma, the rgb head on v3.  With STORE every v_l goes to the act
// workspace.
template <bool STORE>
__device__ __forceinline__ void view_branch(Consumer& c, float (&acc)[128], const FwdArgs& a,
                                            long long row0) {
  constexpr Body B = Body::TWO_STREAM;
  const WsRows<Layout> ws{a, row0};
#pragma unroll 1
  for (int layer = 1; layer <= 2; ++layer) {
    product<B, DEF, 2>(c, acc, act_addr(c));
    finish(c, acc);
    if constexpr (STORE) sync_stored(c);
    else c.sync();
    epilogue<B, Epi::HIDDEN, DEF>(c, acc, a.bias + AOFF_BV1 + (layer - 1) * DEF, a.bias,
                                  a.out_rgb, a.out_sigma, row0, a.n_rows);
    fence_async_shared();
    c.sync();
    if constexpr (STORE)
      store_tile(c, c.act(), ws.act(ACT_C_V1 + 2 * (layer - 1)), 2 * CHUNK_BYTES);
  }
  product<B, DEF, 2>(c, acc, act_addr(c));  // v3, the rgb head
  finish(c, acc);
  if constexpr (STORE) sync_stored(c);
  else c.sync();
  epilogue<B, Epi::RGB, DEF, false, STORE>(c, acc, a.bias + AOFF_BV1 + 2 * DEF, a.bias,
                                           a.out_rgb, a.out_sigma, row0, a.n_rows);
  if constexpr (STORE) {
    fence_async_shared();
    c.sync();
    store_tile(c, c.act(), ws.act(ACT_C_V1 + 4), 2 * CHUNK_BYTES);
  }
}

// One warpgroup's 64 rows of an eval tile: raw rgb and sigma.
__device__ __forceinline__ void eval_tile(Consumer& c, float (&acc)[128], const FwdArgs& a,
                                          long long row0) {
  c.sync();  // the last tile's products on its tiles are done
  prefix<Stage::XYZ, false>(c, acc, a, row0);
  stage_rows<Stage::XP>(c, a, row0);
  fence_async_shared();
  c.sync();
  trunk_tile<Body::TWO_STREAM, Epi::HIDDEN>(c, acc, a.bias, a.out_rgb, a.out_sigma, row0,
                                            a.n_rows);
  fence_async_shared();
  c.sync();
  view_branch<false>(c, acc, a, row0);
}

// One warpgroup's 64 rows of a training forward tile, every activation, relu
// and x' also sent to the workspaces.
template <Stage ST>
__device__ __forceinline__ void forward_tile(Consumer& c, float (&acc)[128], const FwdArgs& a,
                                             long long row0) {
  sync_stored(c);  // the last tile's products and copies are done
  prefix<ST, true>(c, acc, a, row0);
  stage_rows<Stage::XP>(c, a, row0);
  fence_async_shared();
  c.sync();
  forward_trunk<Layout>(c, acc, a, row0);
  view_branch<true>(c, acc, a, row0);
}

// ------------------------------------------------------------ backward

// relu'(a) of a 128-wide layer in the bits a mask row would hold (MaskRows,
// the low words), from its stored bf16 values: the warpgroup's two chunks of
// it in the act workspace, each thread the pairs an accumulator fragment
// holds, read as the shared-memory tile would be.
__device__ __forceinline__ void act_mask(MaskRows& m, const uint8_t* __restrict__ chunks,
                                         int r0, int x, int q) {
  // a bf16 is > 0 where its bits, unsigned, lie in [1, 0x7F80] (the least
  // positive subnormal .. +inf; negatives and NaNs fall outside): two bits,
  // one a half, from each pair
  auto positive = [](uint32_t pair) {
    const uint32_t p = __vcmpgtu2(pair, 0u) & __vcmpleu2(pair, 0x7F807F80u);
    return (p & 1u) | ((p >> 15) & 2u);
  };
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int i = 0; i < DEF / 8; ++i) {
    lo |= positive(__ldg(reinterpret_cast<const uint32_t*>(chunks + pair_offset(i, r0, x, q))))
          << (2 * i);
    hi |= positive(__ldg(reinterpret_cast<const uint32_t*>(chunks + pair_offset(i, r0 + 8, x, q))))
          << (2 * i);
  }
  m.lo[0] = lo, m.hi[0] = hi, m.lo[1] = 0u, m.hi[1] = 0u;
}

// A 128-wide layer backwards: D = (bf16(D') @ W^T) * relu'(a) from the D'
// tile in the activation tile, the mask of `a` from its stored values (the
// act workspace's chunk `a_chunk`), D over the tile (fenced, synchronised)
// and its column sums to sums + `bias`.
__device__ __forceinline__ void narrow_back(Consumer& c, float (&acc)[128], const BwdArgs& a,
                                            long long row0, int a_chunk, const float* gt,
                                            float* part, float* sums, int bias) {
  constexpr Body B = Body::TWO_STREAM;
  product<B, DEF, 2>(c, acc, c.act());
  MaskRows m;  // loaded while the product runs
  act_mask(m, ws_block(a.act, Layout::ACT_CHUNKS, row0) + a_chunk * CHUNK_BYTES,
           16 * c.warp + (c.lane >> 2), c.lane >> 2, c.lane & 3);
  finish(c, acc);
  sync_stored(c);
  backward_epilogue<true, false, DEF>(c, acc, m, gt, part);
  fence_async_shared();
  c.sync();
  add_parts<DEF>(c, part, sums + bias);
}

// One warpgroup's 64 rows of a backward tile: the rgb head's VJP onto v3,
// dv3 -> dv0 through wv3^T..wv1^T, the vanilla chain (dbott, D7..D0), then
// d_enc = bf16(D0) @ w0^T + bf16(D5) @ w5b^T, the encoding's VJP to d_x', the
// deformation head's VJP (CUDA cores), dh3 -> dh0 through wd3^T..wd1^T and
// wd0x = bf16(xyz)^T bf16(dh0).
template <Stage ST>
__device__ __forceinline__ void backward_tile(Consumer& c, float (&acc)[128], const BwdArgs& a,
                                              long long row0, float* sums) {
  constexpr Body B = Body::TWO_STREAM;
  float* gt = reinterpret_cast<float*>(c.enc());  // the tile's g rows, (64, 4)
  float* part = gt + WG_ROWS * 4;                  // the warps' column sums, (4, 256)
  // the grad workspace's block, made again where it is used
  auto grad_at = [&](int chunk) {
    return ws_block(a.grad, Layout::GRAD_CHUNKS, opaque(row0)) + chunk * CHUNK_BYTES;
  };

  sync_stored(c);  // the last tile's reads of its g rows, D tiles and copies are done
  load_g(c, a, row0, gt);
  head_phase<Layout>(c, a, gt, row0, sums, ACT_C_V1 + 4, AOFF_BV1 + 2 * DEF);
  fence_async_shared();
  c.sync();
  store_tile(c, c.act(), grad_at(GR_C_V1 + 4), 2 * CHUNK_BYTES);
#pragma unroll 1
  for (int i = 3; i >= 1; --i) {  // dv_{i-1} = (bf16(dv_i) @ wv_i^T) * relu'(v_{i-1})
    narrow_back(c, acc, a, row0, i > 1 ? ACT_C_V1 + 2 * (i - 2) : ACT_C_V, gt, part, sums,
                i > 1 ? AOFF_BV1 + (i - 2) * DEF : OFF_BV);
    store_tile(c, c.act(), grad_at(i > 1 ? GR_C_V1 + 2 * (i - 2) : GR_C_V),
               2 * CHUNK_BYTES);
  }
  backward_chain<Layout>(c, acc, a, row0, gt, part, sums);

  // d_enc: D0's product from the tile, then D5's, which comes back from the
  // grad workspace into the tile once its store (and D0's) is complete
  product<B, DEF, 4>(c, acc, c.act());
  finish(c, acc);
  if (c.t == 0) {
    bulk_wait();
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  c.sync();
  {
    const uint4* src = reinterpret_cast<const uint4*>(grad_at(5 * 4));
    uint4* dst = reinterpret_cast<uint4*>(c.act());
#pragma unroll 4
    for (int i = c.t; i < 4 * CHUNK_BYTES / 16; i += WG_THREADS) dst[i] = __ldcg(src + i);
  }
  fence_async_shared();
  c.sync();
  product<B, DEF, 4, KCHUNK / 16, true>(c, acc, c.act());
  finish(c, acc);
  c.sync();  // every warp's products on the tile are done before it is overwritten

  float* dxp = reinterpret_cast<float*>(c.act() + DXP_OFFSET);
  float* xyz = reinterpret_cast<float*>(c.act() + BXYZ_OFFSET);
  if (c.t < WG_ROWS)
    reinterpret_cast<float4*>(xyz)[c.t] = coords<ST>(a.xyz, a.t_vals, a.rays_o, a.rays_d,
                                                     min(row0 + c.t, a.n_rows - 1),
                                                     a.samples_per_ray);
  // d_enc's 64 live columns out of the accumulator into the tile (f32, rows
  // DENC_LD apart), so that the encoding's VJP runs as a loop: unrolled over
  // the accumulator, its 32 cosines outgrow the instruction cache
  float* denc = reinterpret_cast<float*>(c.act());
  {
    const int x = c.lane >> 2, q = c.lane & 3, r0 = 16 * c.warp + x;
#pragma unroll
    for (int i = 0; i < POS_PAD / 8; ++i) {
      *reinterpret_cast<float2*>(denc + r0 * DENC_LD + 8 * i + 2 * q) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(denc + (r0 + 8) * DENC_LD + 8 * i + 2 * q) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  c.sync();
  {  // the encoding's VJP: d_x' = bf16(d_pre) @ s^T, d_pre = d_enc times the
     // cosine of the reduced argument past the identity columns.  A quad of
     // lanes takes a row, each lane 16 of its columns.
    const int q = c.lane & 3;
#pragma unroll 1
    for (int r = c.t >> 2; r < WG_ROWS; r += WG_THREADS / 4) {
      const float4 p = __ldg(reinterpret_cast<const float4*>(a.xp) + row0 + r);
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
#pragma unroll 4
      for (int col = q; col < POS_PAD; col += 4) {
        float e = denc[r * DENC_LD + col];
        if (col >= 3)
          e *= cosf(reduce_arg(encode_pre(p.x, p.y, p.z, a.s_pos, a.p_pos, POS_PAD, col)));
        e = round_bf16(e);  // s holds powers of two: exact in bf16
        d0 = fmaf(e, __ldg(a.s_pos + col), d0);
        d1 = fmaf(e, __ldg(a.s_pos + POS_PAD + col), d1);
        d2 = fmaf(e, __ldg(a.s_pos + 2 * POS_PAD + col), d2);
      }
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, m);
        d1 += __shfl_xor_sync(0xffffffffu, d1, m);
        d2 += __shfl_xor_sync(0xffffffffu, d2, m);
      }
      if (q == 0) reinterpret_cast<float4*>(dxp)[r] = make_float4(d0, d1, d2, 0.0f);
    }
  }
  c.sync();

  {  // the deformation head: dh3 = (bf16(d_x') @ wdo^T) * relu'(hd3); wdo's
     // gradient hd3^T bf16(d_x'), bd3's and bdo's sums.  hd3 comes into the
     // tile from the act workspace; thread t owns its column t.
    {  // hd3's two chunks into the tile, every load in flight at once
      const uint4* src = reinterpret_cast<const uint4*>(
          ws_block(a.act, Layout::ACT_CHUNKS, row0) + (ACT_C_HD0 + 6) * CHUNK_BYTES);
      uint4* dst = reinterpret_cast<uint4*>(c.act());
      uint4 v[2 * CHUNK_BYTES / 16 / WG_THREADS];
#pragma unroll
      for (int j = 0; j < 2 * CHUNK_BYTES / 16 / WG_THREADS; ++j)
        v[j] = __ldg(src + c.t + WG_THREADS * j);
#pragma unroll
      for (int j = 0; j < 2 * CHUNK_BYTES / 16 / WG_THREADS; ++j) dst[c.t + WG_THREADS * j] = v[j];
    }
    c.sync();
    const int col = c.t;
    const bf16* w = a.W + EVAL_OFF_WDO + 4 * col;
    const float w0 = __bfloat162float(w[0]), w1 = __bfloat162float(w[1]),
                w2 = __bfloat162float(w[2]);
    float bs = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    uint8_t* tile = c.act() + (col >> 6) * A_CHUNK_BYTES;
#pragma unroll 4
    for (int r = 0; r < WG_ROWS; ++r) {  // dh3 over hd3, in place
      bf16* at = reinterpret_cast<bf16*>(tile + swizzled(r, col & 63));
      const float4 d = reinterpret_cast<const float4*>(dxp)[r];
      const float d0 = round_bf16(d.x), d1 = round_bf16(d.y), d2 = round_bf16(d.z);
      const float hv = __bfloat162float(*at);
      float dh = fmaf(d2, w2, fmaf(d1, w1, d0 * w0));
      if (!(hv > 0.0f)) dh = 0.0f;
      bs += dh;
      g0 = fmaf(hv, d0, g0), g1 = fmaf(hv, d1, g1), g2 = fmaf(hv, d2, g2);
      *at = __float2bfloat16_rn(dh);
    }
    sum_add(sums + AOFF_BD0 + 3 * DEF + col, bs);
    sum_add(sums + SUM_WDO + 3 * col, g0);
    sum_add(sums + SUM_WDO + 3 * col + 1, g1);
    sum_add(sums + SUM_WDO + 3 * col + 2, g2);
    if (c.t < 3) {  // bdo: sums of the unrounded d_x'
      float s = 0.0f;
      for (int r = 0; r < WG_ROWS; ++r) s += dxp[4 * r + c.t];
      sum_add(sums + AOFF_BDO + c.t, s);
    }
  }
  fence_async_shared();
  c.sync();
  store_tile(c, c.act(), grad_at(GR_C_DH1 + 4), 2 * CHUNK_BYTES);
#pragma unroll 1
  for (int i = 3; i >= 1; --i) {  // dh_{i-1} = (bf16(dh_i) @ wd_i^T) * relu'(hd_{i-1})
    narrow_back(c, acc, a, row0, ACT_C_HD0 + 2 * (i - 1), gt, part, sums,
                AOFF_BD0 + (i - 1) * DEF);
    if (i > 1)
      store_tile(c, c.act(), grad_at(GR_C_DH1 + 2 * (i - 2)), 2 * CHUNK_BYTES);
  }
  {  // wd0x = bf16(xyz)^T bf16(dh0): thread t owns column t
    const int col = c.t;
    const uint8_t* tile = c.act() + (col >> 6) * A_CHUNK_BYTES;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
    for (int r = 0; r < WG_ROWS; ++r) {
      const float d =
          __bfloat162float(*reinterpret_cast<const bf16*>(tile + swizzled(r, col & 63)));
      const float4 p = reinterpret_cast<const float4*>(xyz)[r];
      s0 = fmaf(round_bf16(p.x), d, s0);
      s1 = fmaf(round_bf16(p.y), d, s1);
      s2 = fmaf(round_bf16(p.z), d, s2);
    }
    sum_add(sums + SUM_WD0X + col, s0);
    sum_add(sums + SUM_WD0X + DEF + col, s1);
    sum_add(sums + SUM_WD0X + 2 * DEF + col, s2);
  }
}

// The block's sums into the gradient blob, once per block.
__device__ __forceinline__ void flush_sums(const float* sums, float* __restrict__ gw) {
  bar_sync(BAR_CONSUMERS, CONSUMER_THREADS);
  for (int i = threadIdx.x; i < N_SUMS; i += CONSUMER_THREADS) {
    int dst;
    if (i < SUM_WD) dst = ART_N_WEIGHTS + i;
    else if (i < SUM_WRGB) dst = OFF_WD + i - SUM_WD;
    else if (i < SUM_WDO) dst = OFF_WRGB + i - SUM_WRGB;
    else if (i < SUM_WD0X) dst = AOFF_WDO + 4 * ((i - SUM_WDO) / 3) + (i - SUM_WDO) % 3;
    else dst = AOFF_WD0X + i - SUM_WD0X;
    atomicAdd(gw + dst, sums[i]);
  }
}

}  // namespace art
}  // namespace sm90
}  // namespace aon
