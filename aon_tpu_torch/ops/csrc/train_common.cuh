// Shared device code of the articulated training kernels (art.cu): the
// backward of the vanilla-shaped trunk over one tile of TILE sample rows and
// the split-K weight-gradient kernel.  The vanilla training kernels
// (train_sm90.cuh) take its gradient workspace layout (GR_*, LDG).
//
// Both run over two bf16 workspaces in global memory, one row per sample:
// the activations the forward wrote (`lda` columns, head in the ACT_* layout
// of mlp_common.cuh) and the gradients of the pre-activations (`ldg` columns,
// head [D0..D7 | dbott | dv], D_i the gradient of trunk layer i's
// pre-activation).  The articulated kernels append their own columns to both.
//
// Roundings follow the TPU kernels' `dot_tn` / `dot_nt`: every product rounds
// both operands to bf16 and accumulates in f32, the f32 gradients included;
// relu masks come from the stored bf16 activations; bias gradients are f32
// column sums of the unrounded values, added by atomicAdd.

#pragma once

#include "mlp_common.cuh"

namespace aon {

// gradient workspace, the head every training kernel shares
constexpr int GR_BOTT = 8 * WIDTH;
constexpr int GR_V = GR_BOTT + WIDTH;
constexpr int LDG = GR_V + COND;
static_assert(LDG == 2432, "gradient workspace layout");

using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct SmemBwd {
  bf16 h[2][TILE * LDH];
  float g[TILE * 4];
  float scratch[WARPS][16 * 16];
};

// acc[r][j] += A[16r:16r+16, :K] @ W[col0+16j : col0+16j+16, :K]^T, W (n, K)
// row-major: the backward product through a forward weight.
template <int NT>
__device__ __forceinline__ void mma_tile_t(FragC (&acc)[RT][NT], const bf16* A, int lda, int K,
                                           const bf16* __restrict__ W, int ldw, int col0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    FragBT b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::load_matrix_sync(b[j], W + static_cast<size_t>(col0 + 16 * j) * ldw + k, ldw);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      FragA a;
      wmma::load_matrix_sync(a, A + r * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::mma_sync(acc[r][j], a, b[j], acc[r][j]);
    }
  }
}

// D = relu'(mask) * (acc + bf16(g_sigma) * wd) for this warp's 16 * NT
// columns from col0: f32 column sums added to bias_grad, D as bf16 to `out`
// (the next product's A operand, LDH columns) and to `save` (the gradient
// workspace, `ldg` columns).  `mask` is the stored activation of the layer
// (`lda` columns per row; null: no mask), `gs` the tile's g rows where the
// density head joins (null elsewhere); with wd_grad the head's own gradient
// a7^T bf16(g_sigma) is summed alongside.
template <int NT>
__device__ __forceinline__ void store_grad(FragC (&acc)[RT][NT], const bf16* __restrict__ mask,
                                           int lda, const float* gs,
                                           const bf16* __restrict__ wd,
                                           float* __restrict__ bias_grad,
                                           float* __restrict__ wd_grad, bf16* out, int col0,
                                           float* scratch, int lane, bf16* save, int ldg) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = col0 + 16 * j + (lane & 15);
    const float wdc = gs != nullptr ? __bfloat162float(wd[col]) : 0.0f;
    float csum = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(scratch, acc[r][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = 16 * r + (e >> 4);
        float v = scratch[e];
        float gsig = 0.0f;
        if (gs != nullptr) {
          gsig = round_bf16(gs[4 * row + 3]);
          v += gsig * wdc;
        }
        if (mask != nullptr) {
          const float a = __bfloat162float(mask[static_cast<size_t>(row) * lda + col]);
          if (!(a > 0.0f)) v = 0.0f;
          wsum += a * gsig;
        }
        csum += v;
        const bf16 h = __float2bfloat16_rn(v);
        out[row * LDH + col] = h;
        save[static_cast<size_t>(row) * ldg + col] = h;
      }
      __syncwarp();
    }
    csum += __shfl_xor_sync(0xffffffffu, csum, 16);
    wsum += __shfl_xor_sync(0xffffffffu, wsum, 16);
    if (lane < 16) {
      atomicAdd(bias_grad + col, csum);
      if (wd_grad != nullptr) atomicAdd(wd_grad + col, wsum);
    }
  }
}

// Backward through a 3-column head and the relu of the 128-wide layer before
// it: D[:, c] = (bf16(g) @ w^T)[:, c] * relu'(a[:, c]) for the head's weight
// w (128, wstride) with 3 live columns and the cotangent rows g4 (TILE, 4,
// the first three used) in shared memory.  Thread t takes column t & 127 and
// half the rows.  D goes as bf16 to `out` (LDH columns) and `save`; its f32
// column sums to bias_grad; the head's own gradient a^T bf16(g) to w_grad
// (128, wstride) by atomicAdd.  `a` is the layer's stored activation.
__device__ __forceinline__ void head3_bwd(const float* g4, const bf16* __restrict__ w,
                                          int wstride, const bf16* __restrict__ a, int lda,
                                          float* __restrict__ bias_grad,
                                          float* __restrict__ w_grad, bf16* out, bf16* save,
                                          int ldg) {
  const int tid = threadIdx.x;
  const int c = tid & (COND - 1), half = tid >> 7;
  const float w0 = __bfloat162float(w[wstride * c + 0]);
  const float w1 = __bfloat162float(w[wstride * c + 1]);
  const float w2 = __bfloat162float(w[wstride * c + 2]);
  float bsum = 0.0f, wg0 = 0.0f, wg1 = 0.0f, wg2 = 0.0f;
  for (int r = half * (TILE / 2); r < (half + 1) * (TILE / 2); ++r) {
    const float g0 = round_bf16(g4[4 * r + 0]);
    const float g1 = round_bf16(g4[4 * r + 1]);
    const float g2 = round_bf16(g4[4 * r + 2]);
    const float v = __bfloat162float(a[static_cast<size_t>(r) * lda + c]);
    float dv = fmaf(g2, w2, fmaf(g1, w1, g0 * w0));
    if (!(v > 0.0f)) dv = 0.0f;
    bsum += dv;
    wg0 = fmaf(v, g0, wg0), wg1 = fmaf(v, g1, wg1), wg2 = fmaf(v, g2, wg2);
    const bf16 h = __float2bfloat16_rn(dv);
    out[r * LDH + c] = h;
    save[static_cast<size_t>(r) * ldg + c] = h;
  }
  atomicAdd(bias_grad + c, bsum);
  atomicAdd(w_grad + wstride * c + 0, wg0);
  atomicAdd(w_grad + wstride * c + 1, wg1);
  atomicAdd(w_grad + wstride * c + 2, wg2);
}

// The trunk's backward from dv, the gradient of the first view layer's
// pre-activation, which the caller left in sm.h[0] (128 columns) and
// synchronised: dbott, D7 (joined by the density head's g_sigma = g[:, 3],
// whose own weight gradient goes out alongside), D6..D0 of `_bwd_from_acts`,
// W^T read as column-major WMMA fragments.  Every D goes to the gradient
// workspace and its column sums to the bias gradients `gb` (`gw` has the
// weight blob's offsets, `gb` the bias blob's).  Leaves D0 in
// sm.h[1], all threads synchronised; sm.h[0] is free.
__device__ __forceinline__ void trunk_backward(SmemBwd& sm, const bf16* __restrict__ W,
                                               const bf16* __restrict__ act_tile, int lda,
                                               bf16* __restrict__ grad_tile, int ldg,
                                               float* __restrict__ gw, float* __restrict__ gb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = sm.scratch[warp];
  const int col0 = 32 * warp;
  bf16* hin = sm.h[0];
  bf16* hout = sm.h[1];
  FragC acc[RT][2];

  // dbott = bf16(dv) @ wva^T
  zero(acc);
  mma_tile_t(acc, hin, LDH, COND, W + OFF_WVA, COND, col0);
  store_grad(acc, nullptr, lda, nullptr, nullptr, gb + OFF_BB, nullptr, hout, col0, scratch, lane,
             grad_tile + GR_BOTT, ldg);
  __syncthreads();
  { bf16* t = hin; hin = hout; hout = t; }

  // D7 = (bf16(dbott) @ wb^T + bf16(g_sigma) wd^T) * relu'(a7); wd's gradient alongside
  zero(acc);
  mma_tile_t(acc, hin, LDH, WIDTH, W + OFF_WB, WIDTH, col0);
  store_grad(acc, act_tile + ACT_A0 + 7 * WIDTH, lda, sm.g, W + OFF_WD, gb + 7 * WIDTH,
             gw + OFF_WD, hout, col0, scratch, lane, grad_tile + 7 * WIDTH, ldg);
  __syncthreads();
  { bf16* t = hin; hin = hout; hout = t; }

  // D_l = (bf16(D_{l+1}) @ w_{l+1}^T) * relu'(a_l); layer 5 backpropagates
  // through w5a only here (the articulated kernels take d_enc afterwards)
#pragma unroll 1
  for (int layer = 6; layer >= 0; --layer) {
    zero(acc);
    mma_tile_t(acc, hin, LDH, WIDTH, W + trunk_offset(layer + 1), WIDTH, col0);
    store_grad(acc, act_tile + ACT_A0 + layer * WIDTH, lda, nullptr, nullptr, gb + layer * WIDTH,
               nullptr, hout, col0, scratch, lane, grad_tile + layer * WIDTH, ldg);
    __syncthreads();
    bf16* t = hin; hin = hout; hout = t;
  }
}

// ---------------------------------------------------- backward, weight grads

struct WgradJob {
  int x_col, kx;  // X = act[:, x_col : x_col + kx]
  int d_col, nd;  // D = grad[:, d_col : d_col + nd]
  int out;        // dW (kx, nd) at gw + out
};
template <int NJ>
struct WgradJobs {
  WgradJob job[NJ];
};
constexpr int WG_WARPS = 8;
constexpr int WG_WARP_M = 32, WG_WARP_N = 64;  // output tile of one warp

// dW = X^T D for every job as split-K WMMA products over the workspaces,
// partial sums added by atomicAdd.  blockIdx.x: output tile of the job,
// blockIdx.y: chunk of rows, blockIdx.z: job.  The 8 warps of a block tile the
// output as (kx / 32, at most 4) x the rest, 32 x 64 each: 128 x 128 for a dW
// of 128 rows or more, 64 x 256 for the 64-row ones, so each fragment a warp
// loads feeds 2 or 4 products and the warps of a block share their rows of X
// and D through L1.  The tiles of one chunk are neighbours in launch order,
// so the rows they share are read from device memory once and then from L2.
template <int NJ>
__global__ void __launch_bounds__(32 * WG_WARPS, 2)
wgrad_kernel(const bf16* __restrict__ act, int lda, const bf16* __restrict__ grad, int ldg,
             float* __restrict__ gw, long long n_pad, int rows_per_chunk, WgradJobs<NJ> jobs) {
  __shared__ float scratch_all[WG_WARPS][16 * 16];
  const WgradJob job = jobs.job[blockIdx.z];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps_m = min(4, job.kx / WG_WARP_M), warps_n = WG_WARPS / warps_m;
  const int tile_m = WG_WARP_M * warps_m, tile_n = WG_WARP_N * warps_n;
  const int tiles_n = (job.nd + tile_n - 1) / tile_n;
  const int tile = blockIdx.x;
  if (tile >= (job.kx / tile_m) * tiles_n) return;
  const int m0 = (tile / tiles_n) * tile_m + WG_WARP_M * (warp % warps_m);
  const int n0 = (tile % tiles_n) * tile_n + WG_WARP_N * (warp / warps_m);
  if (n0 >= job.nd) return;
  const long long k0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long k1 = min(k0 + rows_per_chunk, n_pad);

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const bf16* x = act + job.x_col + m0;
  const bf16* d = grad + job.d_col + n0;
  for (long long k = k0; k < k1; k += 16) {
    FragAT a[2];  // X^T[m0 + 16i : m0 + 16i + 16, k : k + 16]
    FragB b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], x + static_cast<size_t>(k) * lda + 16 * i, lda);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(b[j], d + static_cast<size_t>(k) * ldg + 16 * j, ldg);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
  float* scratch = scratch_all[warp];
  float* out = gw + job.out;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        atomicAdd(out + static_cast<size_t>(m0 + 16 * i + (e >> 4)) * job.nd + n0 + 16 * j +
                      (e & 15),
                  scratch[e]);
      __syncwarp();
    }
  }
}

// The 12 wide weight matrices of the trunk and the first view layer, into
// jobs[0..12).
inline int trunk_wgrad_jobs(WgradJob* job) {
  constexpr int WW = WIDTH * WIDTH;
  int n = 0;
  job[n++] = {ACT_ENC, POS_PAD, 0, WIDTH, OFF_W0};
  for (int i = 1; i <= 4; ++i)
    job[n++] = {ACT_A0 + (i - 1) * WIDTH, WIDTH, i * WIDTH, WIDTH, OFF_W1 + (i - 1) * WW};
  job[n++] = {ACT_A0 + 4 * WIDTH, WIDTH, 5 * WIDTH, WIDTH, OFF_W1 + 4 * WW};  // w5a
  job[n++] = {ACT_ENC, POS_PAD, 5 * WIDTH, WIDTH, OFF_W5B};
  job[n++] = {ACT_A0 + 5 * WIDTH, WIDTH, 6 * WIDTH, WIDTH, OFF_W6};
  job[n++] = {ACT_A0 + 6 * WIDTH, WIDTH, 7 * WIDTH, WIDTH, OFF_W6 + WW};
  job[n++] = {ACT_A0 + 7 * WIDTH, WIDTH, GR_BOTT, WIDTH, OFF_WB};
  job[n++] = {ACT_BOTT, WIDTH, GR_V, COND, OFF_WVA};
  job[n++] = {ACT_VENC, VIEW_PAD, GR_V, COND, OFF_WVB};
  return n;
}
constexpr int N_TRUNK_JOBS = 12;

// Launches wgrad_kernel over n_pad workspace rows (a multiple of TILE).
template <int NJ>
inline int launch_wgrad(const bf16* act, int lda, const bf16* grad, int ldg, float* gw,
                        long long n_pad, const WgradJobs<NJ>& jobs, cudaStream_t stream) {
  long long rows_per_chunk = ((n_pad + 47) / 48 + 15) / 16 * 16;
  if (rows_per_chunk < 256) rows_per_chunk = 256;
  const long long chunks = (n_pad + rows_per_chunk - 1) / rows_per_chunk;
  // at most 4 tiles per job: (256 / 128) x (256 / 128)
  const dim3 grid(4, static_cast<unsigned>(chunks), NJ);
  wgrad_kernel<NJ><<<grid, 32 * WG_WARPS, 0, stream>>>(act, lda, grad, ldg, gw, n_pad,
                                                      static_cast<int>(rows_per_chunk), jobs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace aon
