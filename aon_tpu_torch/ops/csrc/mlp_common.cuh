// Shared device code of the NeRF MLP kernels (fused_mlp_eval.cu,
// level_train.cu, art.cu): the packed weight layout of the vanilla-shaped
// trunk, the in-kernel positional encoding and the WMMA forward over one tile
// of TILE sample rows.  The articulated kernels (art.cu) embed this layout as
// the head of their own blobs and workspaces and run the same trunk.
//
// Matmul operands are bf16 with f32 accumulation and activations are rounded
// to bf16 between layers, as `_mlp_compute` (aon_tpu/ops/fused_mlp.py) and
// `_fwd_activations` (aon_tpu/ops/fused_mlp_train.py) do.
//
// Precision: the sine arguments reach about 3000 rad, so the encoding reduces
// them explicitly, pre - 2pi * floor(pre / 2pi + 0.5), with the subtraction
// rounded once by an explicit __fmaf_rn (as XLA does where it contracts the
// JAX kernel's line; a separately rounded product moves the result by up to
// 1.5e-4 rad), and then calls the accurate sinf.  Every other step uses the
// _rn intrinsics so no contraction is left to the compiler.  Build without
// --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace aon {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TILE = 64;  // sample rows per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RT = TILE / 16;  // 16-row tiles per block
constexpr int WIDTH = 256;
constexpr int COND = 128;
constexpr int POS_PAD = 64;
constexpr int VIEW_PAD = 32;
// +8 bf16 (16 B) per row staggers the rows across shared-memory banks and
// keeps every 16-row fragment 32-byte aligned, as WMMA requires.
constexpr int LDH = WIDTH + 8;
constexpr int LDE = POS_PAD + 8;
constexpr int LDV = VIEW_PAD + 8;

// bf16 weight blob: (in, out) row-major matrices in this order; the order is
// fixed by aon_tpu_torch/ops/fused_mlp.py (_KERNEL_WEIGHTS).  The f32
// gradient blob of level_train.cu has the same offsets.
constexpr int OFF_W0 = 0;
constexpr int OFF_W1 = OFF_W0 + POS_PAD * WIDTH;  // w1..w4, w5a follow at WIDTH*WIDTH strides
constexpr int OFF_W5B = OFF_W1 + 5 * WIDTH * WIDTH;
constexpr int OFF_W6 = OFF_W5B + POS_PAD * WIDTH;  // w6, w7
constexpr int OFF_WB = OFF_W6 + 2 * WIDTH * WIDTH;
constexpr int OFF_WVA = OFF_WB + WIDTH * WIDTH;
constexpr int OFF_WVB = OFF_WVA + WIDTH * COND;
constexpr int OFF_WD = OFF_WVB + VIEW_PAD * COND;
constexpr int OFF_WRGB = OFF_WD + WIDTH;
constexpr int N_WEIGHTS = OFF_WRGB + COND * 3;
static_assert(N_WEIGHTS == 594560, "weight blob layout");

// f32 bias blob: b0..b7, bb, bv, bd, brgb (_KERNEL_BIASES).
constexpr int OFF_BB = 8 * WIDTH;
constexpr int OFF_BV = OFF_BB + WIDTH;
constexpr int OFF_BD = OFF_BV + COND;
constexpr int OFF_BRGB = OFF_BD + 1;
constexpr int N_BIASES = OFF_BRGB + 3;

// bf16 activation workspace of the training kernels, one row per sample:
// [enc | a0..a7 | bottleneck | v | venc].  Every block starts on a multiple
// of 16 columns, so a 16-wide fragment read from global memory is 32-byte
// aligned.
constexpr int ACT_ENC = 0;
constexpr int ACT_A0 = ACT_ENC + POS_PAD;  // a_i at ACT_A0 + i * WIDTH
constexpr int ACT_BOTT = ACT_A0 + 8 * WIDTH;
constexpr int ACT_V = ACT_BOTT + WIDTH;
constexpr int ACT_VENC = ACT_V + COND;
constexpr int LDA = ACT_VENC + VIEW_PAD;
static_assert(LDA == 2528, "activation workspace layout");

constexpr float TWO_PI = static_cast<float>(2.0 * 3.14159265358979);

struct Smem {
  bf16 h[2][TILE * LDH];
  bf16 enc[TILE * LDE];
  bf16 venc[TILE * LDV];
  float scratch[WARPS][16 * 16];
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The pre-activation of one channel of the in-kernel positional encoding,
// the formula of `_encode_in_kernel`: pre = x0*s0 + x1*s1 + x2*s2 + p
// (s: (4, width), p: (1, width)).
__device__ __forceinline__ float encode_pre(float x0, float x1, float x2,
                                            const float* __restrict__ s,
                                            const float* __restrict__ p, int width, int col) {
  float pre = __fmul_rn(x0, __ldg(s + col));
  pre = __fadd_rn(pre, __fmul_rn(x1, __ldg(s + width + col)));
  pre = __fadd_rn(pre, __fmul_rn(x2, __ldg(s + 2 * width + col)));
  return __fadd_rn(pre, __ldg(p + col));
}

// pre - 2pi * floor(pre / 2pi + 0.5), the subtraction rounded once.
__device__ __forceinline__ float reduce_arg(float pre) {
  const float k = floorf(__fadd_rn(__fdiv_rn(pre, TWO_PI), 0.5f));
  return __fmaf_rn(-TWO_PI, k, pre);
}

// One channel of the encoding: channels < 3 pass pre through, the rest are
// sin(reduced).
__device__ __forceinline__ float encode(float x0, float x1, float x2,
                                        const float* __restrict__ s,
                                        const float* __restrict__ p, int width, int col) {
  const float pre = encode_pre(x0, x1, x2, s, p, width, col);
  return col < 3 ? pre : sinf(reduce_arg(pre));
}

// R 16-row tiles by NT 16-column tiles of accumulators (R = RT: the block's
// TILE rows; the two-stream body of fused_mlp_eval.cu gives a warp half of them)
template <int R, int NT>
__device__ __forceinline__ void zero(FragC (&acc)[R][NT]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[r][j], 0.0f);
}

// acc[r][j] += A[16r:16r+16, :K] @ W[:K, col0+16j : col0+16j+16]
template <int R, int NT>
__device__ __forceinline__ void mma_tile(FragC (&acc)[R][NT], const bf16* A, int lda, int K,
                                         const bf16* __restrict__ W, int ldw, int col0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    FragB b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::load_matrix_sync(b[j], W + static_cast<size_t>(k) * ldw + col0 + 16 * j, ldw);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      FragA a;
      wmma::load_matrix_sync(a, A + r * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::mma_sync(acc[r][j], a, b[j], acc[r][j]);
    }
  }
}

// out[:, col0 + 16j + c] = bf16(act(acc + bias)) through a per-warp f32 tile.
// With SAVE the same values also go to the tile's rows of the activation
// workspace (`lds` columns per row), `save` pointing at this layer's first
// column of the tile's first row.
template <bool SAVE, int R, int NT>
__device__ __forceinline__ void store_bias_act(FragC (&acc)[R][NT], const float* __restrict__ bias,
                                               bool relu, bf16* out, int ldo, int col0,
                                               float* scratch, int lane, bf16* save = nullptr,
                                               int lds = LDA) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(scratch, acc[r][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = 16 * r + (e >> 4), col = col0 + 16 * j + (e & 15);
        float v = scratch[e] + __ldg(bias + col);
        if (relu) v = fmaxf(v, 0.0f);
        const bf16 h = __float2bfloat16_rn(v);
        out[row * ldo + col] = h;
        if (SAVE) save[static_cast<size_t>(row) * lds + col] = h;
      }
      __syncwarp();
    }
  }
}

// The density head on h7 (TILE rows of LDH columns in shared memory): raw
// sigma (n_rows, 1) for the rows below n_rows; 64 rows x 4 partial sums of 64.
// Thread t serves row t / 4, so each half of the block reads only its half of
// the rows.
__device__ __forceinline__ void density_head(const bf16* h_tile, const bf16* __restrict__ W,
                                             const float* __restrict__ bias,
                                             float* __restrict__ out_sigma, long long row0,
                                             long long n_rows) {
  const int tid = threadIdx.x;
  const int r = tid >> 2, part = tid & 3;
  const bf16* h = h_tile + r * LDH + 64 * part;
  const bf16* w = W + OFF_WD + 64 * part;
  float s = 0.0f;
  for (int k = 0; k < 64; ++k) s = fmaf(__bfloat162float(h[k]), __bfloat162float(w[k]), s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const long long g = row0 + r;
  if (part == 0 && g < n_rows) out_sigma[g] = s + bias[OFF_BD];
}

__device__ __forceinline__ int trunk_offset(int layer) {  // layers 1..7 of the trunk
  return layer <= 5 ? OFF_W1 + (layer - 1) * WIDTH * WIDTH : OFF_W6 + (layer - 6) * WIDTH * WIDTH;
}

// The trunk of the MLP forward over the tile whose encodings are in sm.enc /
// sm.venc (the caller filled them and synchronised): layers 0..7, the density
// head (raw sigma (n_rows, 1) for the rows below n_rows), the bottleneck and
// the first view layer.  Leaves v = relu(view layer) in sm.h[1], all threads
// synchronised; sm.h[0] is free.  With SAVE every activation (a0..a7,
// bottleneck, v) is also written as bf16 to `act`, the tile's first row of an
// activation workspace of `lds` columns whose head has the ACT_* layout, for
// all TILE rows.
template <bool SAVE>
__device__ __forceinline__ void trunk_forward(Smem& sm, const bf16* __restrict__ W,
                                              const float* __restrict__ bias,
                                              float* __restrict__ out_sigma, long long row0,
                                              long long n_rows, bf16* act, int lds = LDA) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scratch = sm.scratch[warp];
  const int col0 = 32 * warp;
  bf16* hin = sm.h[0];
  bf16* hout = sm.h[1];
  FragC acc[RT][2];

  zero(acc);
  mma_tile(acc, sm.enc, LDE, POS_PAD, W + OFF_W0, WIDTH, col0);
  store_bias_act<SAVE>(acc, bias, true, hin, LDH, col0, scratch, lane, act + ACT_A0, lds);
  __syncthreads();

#pragma unroll 1
  for (int layer = 1; layer < 8; ++layer) {
    zero(acc);
    mma_tile(acc, hin, LDH, WIDTH, W + trunk_offset(layer), WIDTH, col0);
    if (layer == 5)  // skip: layer5(cat[h, enc]) == h @ w5a + enc @ w5b
      mma_tile(acc, sm.enc, LDE, POS_PAD, W + OFF_W5B, WIDTH, col0);
    store_bias_act<SAVE>(acc, bias + layer * WIDTH, true, hout, LDH, col0, scratch, lane,
                         act + ACT_A0 + layer * WIDTH, lds);
    __syncthreads();
    bf16* t = hin; hin = hout; hout = t;
  }

  // hin (sm.h[1]) holds h7: the bottleneck goes to hout, then the density
  // head reads h7.
  zero(acc);
  mma_tile(acc, hin, LDH, WIDTH, W + OFF_WB, WIDTH, col0);
  store_bias_act<SAVE>(acc, bias + OFF_BB, false, hout, LDH, col0, scratch, lane, act + ACT_BOTT,
                       lds);
  density_head(hin, W, bias, out_sigma, row0, n_rows);
  __syncthreads();
  { bf16* t = hin; hin = hout; hout = t; }

  // view layer: 128 outputs, 16 per warp; v = relu(bott @ wva + venc @ wvb + bv)
  FragC vacc[RT][1];
  zero(vacc);
  mma_tile(vacc, hin, LDH, WIDTH, W + OFF_WVA, COND, 16 * warp);
  mma_tile(vacc, sm.venc, LDV, VIEW_PAD, W + OFF_WVB, COND, 16 * warp);
  store_bias_act<SAVE>(vacc, bias + OFF_BV, true, hout, LDH, 16 * warp, scratch, lane,
                       act + ACT_V, lds);
  __syncthreads();
}

// The rgb head on v (TILE rows of LDH columns in shared memory, 128 used):
// raw rgb (n_rows, 3) for the rows below n_rows; 64 rows x 4 partial sums of
// 32, thread t on row t / 4 as in density_head.
__device__ __forceinline__ void rgb_head(const bf16* v_tile, const bf16* __restrict__ W,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out_rgb, long long row0,
                                         long long n_rows) {
  const int tid = threadIdx.x;
  const int r = tid >> 2, part = tid & 3;
  const bf16* v = v_tile + r * LDH + 32 * part;
  const bf16* w = W + OFF_WRGB + 3 * 32 * part;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int k = 0; k < 32; ++k) {
    const float a = __bfloat162float(v[k]);
    s0 = fmaf(a, __bfloat162float(w[3 * k + 0]), s0);
    s1 = fmaf(a, __bfloat162float(w[3 * k + 1]), s1);
    s2 = fmaf(a, __bfloat162float(w[3 * k + 2]), s2);
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    s2 += __shfl_xor_sync(0xffffffffu, s2, m);
  }
  const long long g = row0 + r;
  if (part == 0 && g < n_rows) {
    out_rgb[3 * g + 0] = s0 + bias[OFF_BRGB + 0];
    out_rgb[3 * g + 1] = s1 + bias[OFF_BRGB + 1];
    out_rgb[3 * g + 2] = s2 + bias[OFF_BRGB + 2];
  }
}

// The whole vanilla MLP forward over the tile: trunk_forward, then the rgb
// head on its v.
template <bool SAVE>
__device__ __forceinline__ void mlp_forward(Smem& sm, const bf16* __restrict__ W,
                                            const float* __restrict__ bias,
                                            float* __restrict__ out_rgb,
                                            float* __restrict__ out_sigma, long long row0,
                                            long long n_rows, bf16* act) {
  trunk_forward<SAVE>(sm, W, bias, out_sigma, row0, n_rows, act);
  rgb_head(sm.h[1], W, bias, out_rgb, row0, n_rows);
}

}  // namespace aon
