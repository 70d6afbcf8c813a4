// Articulated NeRF MLP kernels for Hopper (sm_90a): the eval forward, the
// backward of the two-kernel training route, and one fused training level.
//
// Replaces three TPU kernels:
//   * `_art_fwd_kernel` (aon_tpu/ops/fused_art.py, reached through
//     fused_art_mlp_eval and the forward of fused_art_mlp_train; body
//     `_art_forward`): 4x128 deformation MLP on raw xyz with the latent codes
//     folded into its first bias, x' = xyz + delta in f32, positional encoding
//     of x' and of the ray's viewdir in the kernel, the 8x256 trunk with the
//     skip after layer 4, the density head, the bottleneck, a 4x128 view
//     branch and the rgb head -> raw (rgb, sigma);
//   * `_art_bwd_kernel` (same file, reached through the backward of
//     fused_art_mlp_train; body `_art_bwd_from_acts` + `_posenc_vjp`): forward
//     recomputed, then the backward from a cotangent g (N, 4) to the 42
//     effective gradients, through the encoding into the deformation MLP;
//   * `_art_level_kernel` (aon_tpu/ops/train_fused_level_art.py, reached
//     through fused_level_train_art_grads): samples o + t*d, that forward, the
//     head activations (padded sigmoid rgb; softplus(sigma + bias) or relu),
//     compositing, the per-ray weighted squared error, the compositing VJP
//     with the optional telescoped opacity-BCE term, the head VJPs and the
//     same backward.
//
// Bound on the H100: operations (1.385 MFLOP per sample row forward, three
// times that for a training level, against a few dozen bytes of input), so
// the tensor cores set the floor.
//
// Design: that of the vanilla kernels (fused_mlp_eval.cu, level_train.cu),
// whose trunk code these share.  Blocks of TILE = 64 sample rows, 8 warps,
// bf16 WMMA with f32 accumulation, weights read as fragments from global
// memory (1.39 MB bf16, resident in L2).  The weight, bias and gradient blobs
// and both training workspaces start with the vanilla layout of
// mlp_common.cuh / train_common.cuh and append the deformation prefix and the
// three extra view layers, so trunk_forward, trunk_backward and wgrad_kernel
// run unchanged.  A training launch is a chain on one stream:
//
//   1. art_fwd_kernel<true>   deformation, x', encodings, trunk, view branch;
//                             every activation to the bf16 workspace, x' f32;
//   2. art_composite_kernel   one warp per ray (level route only);
//   3. art_bwd_data_kernel    view branch back to dv0, trunk_backward, then
//                             d_enc = D5 w5b^T + D0 w0^T, the encoding's VJP
//                             (cos of the reduced argument) to d_x', and the
//                             deformation MLP back to its first layer;
//   4. wgrad_kernel           18 wide weight gradients, split-K.
//
// Narrow products.  The deformation's first layer has K = 3: plain FMAs on
// the bf16-rounded coordinates and weights, f32 accumulation (the products of
// two bf16 values are exact in f32, so this is the padded K = 4 MMA of the
// TPU kernel up to summation order).  wdo (128, 4, fourth column zero), wdn
// and wrgb run as shuffled partial sums; their gradients and wd0x's go out by
// atomicAdd from the data-backward kernel.
//
// Roundings follow the TPU kernel; accurate expf / log1pf / sinf / cosf and
// IEEE division: no --use_fast_math.  float atomicAdd makes the gradients
// differ in the last bits from run to run.  The gradient blob must be zeroed
// on the same stream before every launch.

#include "train_common.cuh"

using namespace aon;

namespace {

constexpr int DEF = 128;  // width of the deformation MLP and of the view branch

// bf16 weight blob: the vanilla blob (wd = the density head wdn), then
constexpr int AOFF_WD0X = N_WEIGHTS;               // (4, 128), row 3 zero
constexpr int AOFF_WD1 = AOFF_WD0X + 4 * DEF;      // wd1..wd3 at DEF*DEF strides
constexpr int AOFF_WDO = AOFF_WD1 + 3 * DEF * DEF;  // (128, 4), column 3 zero
constexpr int AOFF_WV1 = AOFF_WDO + DEF * 4;       // wv1..wv3 at DEF*DEF strides
constexpr int ART_N_WEIGHTS = AOFF_WV1 + 3 * DEF * DEF;
static_assert(ART_N_WEIGHTS == 693888, "weight blob layout");
static_assert(AOFF_WD1 % 16 == 0 && AOFF_WV1 % 16 == 0, "fragment alignment");

// f32 bias blob: the vanilla blob (bd = bdn), then bd0..bd3, bdo (4), bv1..bv3
constexpr int AOFF_BD0 = N_BIASES;
constexpr int AOFF_BDO = AOFF_BD0 + 4 * DEF;
constexpr int AOFF_BV1 = AOFF_BDO + 4;
constexpr int ART_N_BIASES = AOFF_BV1 + 3 * DEF;
static_assert(ART_N_BIASES == 3336, "bias blob layout");

// activation workspace: the vanilla row (v = v0), then hd0..hd3, v1..v3
constexpr int ACT_HD0 = LDA;
constexpr int ACT_V1 = ACT_HD0 + 4 * DEF;
constexpr int ART_LDA = ACT_V1 + 3 * DEF;
static_assert(ART_LDA == 3424, "activation workspace layout");

// gradient workspace: the vanilla row (dv = dv0), then dv1..dv3, dh0..dh3
constexpr int GR_V1 = LDG;
constexpr int GR_DH0 = GR_V1 + 3 * DEF;
constexpr int ART_LDG = GR_DH0 + 4 * DEF;
static_assert(ART_LDG == 3328, "gradient workspace layout");

constexpr int MAX_SAMPLES_PER_LANE = 8;  // art_composite_kernel: S <= 256

struct SmemArt {
  Smem m;
  float xyz[TILE * 4];
  float xp[TILE * 4];
};

struct SmemArtBwd {
  SmemBwd m;
  float xyz[TILE * 4];
  float dxp[TILE * 4];
};

// The tile's sample coordinates into shared memory, (TILE, 4) with the first
// three used: from xyz (n_rows, 3) or, where xyz is null, o + t * d with the
// product and the sum rounded separately as the plain version rounds them.
// Rows past the end repeat the last row.
__device__ __forceinline__ void load_xyz(float* out, const float* __restrict__ xyz,
                                         const float* __restrict__ t_vals,
                                         const float* __restrict__ rays_o,
                                         const float* __restrict__ rays_d, long long row0,
                                         long long n_rows, int samples_per_ray) {
  const int tid = threadIdx.x;
  if (tid < TILE * 3) {
    const int r = tid / 3, c = tid % 3;
    const long long g = min(row0 + r, n_rows - 1);
    float x;
    if (xyz != nullptr) {
      x = xyz[3 * g + c];
    } else {
      const long long ray = g / samples_per_ray;
      x = __fadd_rn(rays_o[3 * ray + c], __fmul_rn(t_vals[g], rays_d[3 * ray + c]));
    }
    out[4 * r + c] = x;
  }
}

// One 128 -> 128 layer over the tile, 16 output columns per warp:
// out = bf16(relu(in @ w + bias)).
template <bool SAVE>
__device__ __forceinline__ void dense128(const bf16* in, const bf16* __restrict__ w,
                                         const float* __restrict__ bias, bf16* out,
                                         float* scratch, int warp, int lane, bf16* save) {
  FragC acc[RT][1];
  zero(acc);
  mma_tile(acc, in, LDH, DEF, w, DEF, 16 * warp);
  store_bias_act<SAVE>(acc, bias, true, out, LDH, 16 * warp, scratch, lane, save, ART_LDA);
}

// ---------------------------------------------------------------- 1. forward

template <bool SAVE>
__global__ void __launch_bounds__(THREADS, 2)
art_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ t_vals,
               const float* __restrict__ rays_o, const float* __restrict__ rays_d,
               const float* __restrict__ vdir, const float* __restrict__ s_pos,
               const float* __restrict__ p_pos, const float* __restrict__ s_view,
               const float* __restrict__ p_view, const bf16* __restrict__ W,
               const float* __restrict__ bias, float* __restrict__ out_rgb,
               float* __restrict__ out_sigma, bf16* __restrict__ act, float* __restrict__ xp_ws,
               long long n_rows, int samples_per_ray) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemArt& sm = *reinterpret_cast<SmemArt*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;
  bf16* act_tile = SAVE ? act + static_cast<size_t>(row0) * ART_LDA : nullptr;
  float* scratch = sm.m.scratch[warp];
  bf16* h0 = sm.m.h[0];
  bf16* h1 = sm.m.h[1];

  load_xyz(sm.xyz, xyz, t_vals, rays_o, rays_d, row0, n_rows, samples_per_ray);
  __syncthreads();

  // deformation layer 0: K = 3, FMAs on bf16-rounded operands
  for (int i = tid; i < TILE * DEF; i += THREADS) {
    const int r = i / DEF, c = i % DEF;
    float v = round_bf16(sm.xyz[4 * r]) * __bfloat162float(W[AOFF_WD0X + c]);
    v = fmaf(round_bf16(sm.xyz[4 * r + 1]), __bfloat162float(W[AOFF_WD0X + DEF + c]), v);
    v = fmaf(round_bf16(sm.xyz[4 * r + 2]), __bfloat162float(W[AOFF_WD0X + 2 * DEF + c]), v);
    const bf16 h = __float2bfloat16_rn(fmaxf(v + __ldg(bias + AOFF_BD0 + c), 0.0f));
    h0[r * LDH + c] = h;
    if (SAVE) act_tile[static_cast<size_t>(r) * ART_LDA + ACT_HD0 + c] = h;
  }
  __syncthreads();
  // deformation layers 1..3, ping-pong: hd3 lands in sm.h[1], which h0 then names
#pragma unroll 1
  for (int layer = 1; layer <= 3; ++layer) {
    dense128<SAVE>(h0, W + AOFF_WD1 + (layer - 1) * DEF * DEF, bias + AOFF_BD0 + layer * DEF, h1,
                   scratch, warp, lane, act_tile + ACT_HD0 + layer * DEF);
    __syncthreads();
    bf16* t = h0; h0 = h1; h1 = t;
  }
  {  // x' = xyz + (hd3 @ wdo + bdo) in f32: 64 rows x 4 partial sums of 32
    const int r = tid >> 2, part = tid & 3;
    const bf16* h = h0 + r * LDH + 32 * part;
    const bf16* w = W + AOFF_WDO + 4 * 32 * part;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < 32; ++k) {
      const float a = __bfloat162float(h[k]);
      s0 = fmaf(a, __bfloat162float(w[4 * k + 0]), s0);
      s1 = fmaf(a, __bfloat162float(w[4 * k + 1]), s1);
      s2 = fmaf(a, __bfloat162float(w[4 * k + 2]), s2);
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      s2 += __shfl_xor_sync(0xffffffffu, s2, m);
    }
    if (part == 0) {
      const float x0 = __fadd_rn(sm.xyz[4 * r + 0], __fadd_rn(s0, bias[AOFF_BDO + 0]));
      const float x1 = __fadd_rn(sm.xyz[4 * r + 1], __fadd_rn(s1, bias[AOFF_BDO + 1]));
      const float x2 = __fadd_rn(sm.xyz[4 * r + 2], __fadd_rn(s2, bias[AOFF_BDO + 2]));
      sm.xp[4 * r + 0] = x0, sm.xp[4 * r + 1] = x1, sm.xp[4 * r + 2] = x2;
      if (SAVE) {
        float* o = xp_ws + 4 * (row0 + r);
        o[0] = x0, o[1] = x1, o[2] = x2, o[3] = 0.0f;
      }
    }
  }
  __syncthreads();

  // encodings of x' and of the ray's viewdir
  for (int i = tid; i < TILE * POS_PAD; i += THREADS) {
    const int r = i / POS_PAD, c = i % POS_PAD;
    const bf16 h = __float2bfloat16_rn(
        encode(sm.xp[4 * r], sm.xp[4 * r + 1], sm.xp[4 * r + 2], s_pos, p_pos, POS_PAD, c));
    sm.m.enc[r * LDE + c] = h;
    if (SAVE) act_tile[static_cast<size_t>(r) * ART_LDA + ACT_ENC + c] = h;
  }
  for (int i = tid; i < TILE * VIEW_PAD; i += THREADS) {
    const int r = i / VIEW_PAD, c = i % VIEW_PAD;
    const float* v = vdir + 3 * (min(row0 + r, n_rows - 1) / samples_per_ray);
    const bf16 h = __float2bfloat16_rn(encode(v[0], v[1], v[2], s_view, p_view, VIEW_PAD, c));
    sm.m.venc[r * LDV + c] = h;
    if (SAVE) act_tile[static_cast<size_t>(r) * ART_LDA + ACT_VENC + c] = h;
  }
  __syncthreads();

  trunk_forward<SAVE>(sm.m, W, bias, out_sigma, row0, n_rows, act_tile, ART_LDA);

  // view layers 1..3 from v0 in sm.h[1]: v3 lands in sm.h[0]
  h0 = sm.m.h[1];
  h1 = sm.m.h[0];
#pragma unroll 1
  for (int layer = 1; layer <= 3; ++layer) {
    dense128<SAVE>(h0, W + AOFF_WV1 + (layer - 1) * DEF * DEF, bias + AOFF_BV1 + (layer - 1) * DEF,
                   h1, scratch, warp, lane, act_tile + ACT_V1 + (layer - 1) * DEF);
    __syncthreads();
    bf16* t = h0; h0 = h1; h1 = t;
  }
  rgb_head(h0, W, bias, out_rgb, row0, n_rows);
}

// ------------------------------------------------------------- 2. compositing

// One warp per ray; lane l holds samples [l*C, (l+1)*C), C = ceil(S / 32).
// Contract of `_art_level_kernel`: rgb = sigmoid(raw) * (1 + 2 pad) - pad;
// sigma = softplus(raw + density_bias) or relu(raw); last dist 1e10, alpha =
// 1 - exp(-sigma * dist), u = max(1 - alpha, 0) + 1e-10, T the exclusive
// product of u, optional white background; dists are not scaled by |rays_d|.
// Loss sum_r lw_r |comp_r - target_r|^2.  Backward: dcomp = 2 lw err, G =
// <dcomp, rgb> - <dcomp, 1> (white), P the exclusive suffix sum of w * G,
// d_alpha = T * G - P / u, plus, with bce_over_b != 0, the opacity BCE's
// telescoped term (sigmoid(acc) - m) * bce_over_b * T_total / u.
__global__ void art_composite_kernel(const float* __restrict__ raw_rgb,
                                     const float* __restrict__ raw_sigma,
                                     const float* __restrict__ t_vals,
                                     const float* __restrict__ target,
                                     const float* __restrict__ loss_w,
                                     const float* __restrict__ mask, float* __restrict__ g,
                                     float* __restrict__ weights, float* __restrict__ acc_out,
                                     float* __restrict__ photo_loss, int n_rays, int S, int white,
                                     float rgb_padding, float density_bias, float bce_over_b,
                                     int softplus) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // the whole warp leaves together
  const int C = (S + 31) / 32;
  const int s0 = lane * C;
  const long long base = static_cast<long long>(ray) * S;
  const float pad_scale = 1.0f + 2.0f * rgb_padding;

  float alpha[MAX_SAMPLES_PER_LANE], u[MAX_SAMPLES_PER_LANE], dist[MAX_SAMPLES_PER_LANE];
  float T[MAX_SAMPLES_PER_LANE], dsig[MAX_SAMPLES_PER_LANE];
  float sg[MAX_SAMPLES_PER_LANE][3], rgb[MAX_SAMPLES_PER_LANE][3];

  float prod = 1.0f;
#pragma unroll
  for (int i = 0; i < MAX_SAMPLES_PER_LANE; ++i) {
    const int s = s0 + i;
    const bool live = i < C && s < S;
    alpha[i] = 0.0f, u[i] = 1.0f, dist[i] = 0.0f, dsig[i] = 0.0f, T[i] = prod;
    sg[i][0] = sg[i][1] = sg[i][2] = 0.0f;
    rgb[i][0] = rgb[i][1] = rgb[i][2] = 0.0f;
    if (live) {
      const float t = t_vals[base + s];
      dist[i] = (s == S - 1) ? 1e10f : t_vals[base + s + 1] - t;
      const float rs = raw_sigma[base + s];
      float sigma;
      if (softplus) {  // dsig: d sigma / d raw
        const float x = rs + density_bias;
        sigma = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
        dsig[i] = 1.0f / (1.0f + expf(-x));
      } else {
        sigma = fmaxf(rs, 0.0f);
        dsig[i] = rs > 0.0f ? 1.0f : 0.0f;
      }
      alpha[i] = 1.0f - expf(-sigma * dist[i]);
      u[i] = fmaxf(1.0f - alpha[i], 0.0f) + 1e-10f;
      prod *= u[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sg[i][c] = 1.0f / (1.0f + expf(-raw_rgb[3 * (base + s) + c]));
        rgb[i][c] = sg[i][c] * pad_scale - rgb_padding;
      }
    }
  }
  // exclusive product of the lanes' chunk products
  float incl = prod;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl *= v;
  }
  float before = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) before = 1.0f;
  const float T_total = __shfl_sync(FULL, incl, 31);  // T * u at the last sample

  float w[MAX_SAMPLES_PER_LANE];
  float comp[3] = {0.0f, 0.0f, 0.0f}, acc = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_SAMPLES_PER_LANE; ++i) {
    T[i] *= before;
    w[i] = alpha[i] * T[i];
    acc += w[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) comp[c] += w[i] * rgb[i][c];
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    acc += __shfl_xor_sync(FULL, acc, m);
#pragma unroll
    for (int c = 0; c < 3; ++c) comp[c] += __shfl_xor_sync(FULL, comp[c], m);
  }

  const float lw = loss_w[ray];
  float dcomp[3], dsum = 0.0f, err2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (white) comp[c] += 1.0f - acc;
    const float err = comp[c] - target[3 * ray + c];
    err2 += err * err;
    dcomp[c] = 2.0f * lw * err;
    dsum += dcomp[c];
  }
  if (lane == 0) {
    atomicAdd(photo_loss, err2 * lw);
    acc_out[ray] = acc;
  }
  float bce_term = 0.0f;  // d_acc * T_total
  if (bce_over_b != 0.0f)
    bce_term = (1.0f / (1.0f + expf(-acc)) - mask[ray]) * bce_over_b * T_total;

  // G per sample, then the exclusive suffix sum of w * G
  float G[MAX_SAMPLES_PER_LANE], P[MAX_SAMPLES_PER_LANE];
  float tail = 0.0f;
#pragma unroll
  for (int i = MAX_SAMPLES_PER_LANE - 1; i >= 0; --i) {
    G[i] = dcomp[0] * rgb[i][0] + dcomp[1] * rgb[i][1] + dcomp[2] * rgb[i][2];
    if (white) G[i] -= dsum;
    P[i] = tail;
    tail += w[i] * G[i];
  }
  float incl_s = tail;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float v = __shfl_down_sync(FULL, incl_s, d);
    if (lane + d < 32) incl_s += v;
  }
  float after = __shfl_down_sync(FULL, incl_s, 1);
  if (lane == 31) after = 0.0f;

#pragma unroll
  for (int i = 0; i < MAX_SAMPLES_PER_LANE; ++i) {
    const int s = s0 + i;
    if (i < C && s < S) {
      float d_alpha = T[i] * G[i] - (P[i] + after) / u[i];
      if (bce_over_b != 0.0f) d_alpha += bce_term / u[i];
      const float d_sigma = d_alpha * dist[i] * (1.0f - alpha[i]);
      float* out = g + 4 * (base + s);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[c] = w[i] * dcomp[c] * pad_scale * sg[i][c] * (1.0f - sg[i][c]);
      out[3] = d_sigma * dsig[i];
      weights[base + s] = w[i];
    }
  }
}

// ------------------------------------------------------ 3. backward, data path

// One 128 -> 128 layer backwards, 16 columns per warp:
// out = bf16((in @ w^T) * relu'(a)), column sums to bias_grad.
__device__ __forceinline__ void dense128_bwd(const bf16* in, const bf16* __restrict__ w,
                                             const bf16* __restrict__ a,
                                             float* __restrict__ bias_grad, bf16* out,
                                             float* scratch, int warp, int lane, bf16* save) {
  FragC acc[RT][1];
  zero(acc);
  mma_tile_t(acc, in, LDH, DEF, w, DEF, 16 * warp);
  store_grad(acc, a, ART_LDA, nullptr, nullptr, bias_grad, nullptr, out, 16 * warp, scratch, lane,
             save, ART_LDG);
}

// gw: the f32 gradient blob, weights at the offsets of the weight blob, then
// the biases at ART_N_WEIGHTS.
__global__ void __launch_bounds__(THREADS, 2)
art_bwd_data_kernel(const float* __restrict__ g, const float* __restrict__ xyz,
                    const float* __restrict__ t_vals, const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d, const float* __restrict__ s_pos,
                    const float* __restrict__ p_pos, const bf16* __restrict__ W,
                    const bf16* __restrict__ act, const float* __restrict__ xp_ws, bf16* grad,
                    float* __restrict__ gw, long long n_rows, int samples_per_ray) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemArtBwd& sm = *reinterpret_cast<SmemArtBwd*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;
  const bf16* act_tile = act + static_cast<size_t>(row0) * ART_LDA;
  bf16* grad_tile = grad + static_cast<size_t>(row0) * ART_LDG;
  float* gb = gw + ART_N_WEIGHTS;
  float* scratch = sm.m.scratch[warp];

  {  // cotangent rows; rows past the end are 0 and so is everything after them
    const int r = tid >> 2;
    sm.m.g[tid] = row0 + r < n_rows ? g[4 * row0 + tid] : 0.0f;
  }
  load_xyz(sm.xyz, xyz, t_vals, rays_o, rays_d, row0, n_rows, samples_per_ray);
  __syncthreads();
  if (tid < 4) {  // brgb, bdn: sums of the unrounded g
    float s = 0.0f;
    for (int r = 0; r < TILE; ++r) s += sm.m.g[4 * r + tid];
    atomicAdd(gb + (tid < 3 ? OFF_BRGB + tid : OFF_BD), s);
  }

  // rgb head and view layer 3: dv3 = (bf16(g_rgb) @ wrgb^T) * relu'(v3)
  bf16* hin = sm.m.h[1];
  bf16* hout = sm.m.h[0];
  head3_bwd(sm.m.g, W + OFF_WRGB, 3, act_tile + ACT_V1 + 2 * DEF, ART_LDA, gb + AOFF_BV1 + 2 * DEF,
            gw + OFF_WRGB, hin, grad_tile + GR_V1 + 2 * DEF, ART_LDG);
  __syncthreads();
  // dv_{i-1} = (bf16(dv_i) @ wv_i^T) * relu'(v_{i-1}) for i = 3, 2, 1; v0 and
  // dv0 sit in the vanilla columns.  dv0 lands in sm.h[0], where
  // trunk_backward takes it.
#pragma unroll 1
  for (int i = 3; i >= 1; --i) {
    const bf16* a = i > 1 ? act_tile + ACT_V1 + (i - 2) * DEF : act_tile + ACT_V;
    float* bg = i > 1 ? gb + AOFF_BV1 + (i - 2) * DEF : gb + OFF_BV;
    bf16* save = i > 1 ? grad_tile + GR_V1 + (i - 2) * DEF : grad_tile + GR_V;
    dense128_bwd(hin, W + AOFF_WV1 + (i - 1) * DEF * DEF, a, bg, hout, scratch, warp, lane, save);
    __syncthreads();
    bf16* t = hin; hin = hout; hout = t;
  }
  trunk_backward(sm.m, W, act_tile, ART_LDA, grad_tile, ART_LDG, gw, gb);

  // d_enc = bf16(D5) @ w5b^T + bf16(D0) @ w0^T, (TILE, 64) f32 into sm.h[0]'s
  // room: D0 is in sm.h[1], D5 comes back from the gradient workspace (this
  // block wrote it; trunk_backward ended on a barrier).  Warps 0..3 take 16
  // columns each.
  float* d_enc = reinterpret_cast<float*>(sm.m.h[0]);
  if (warp < POS_PAD / 16) {
    FragC acc[RT][1];
    zero(acc);
    mma_tile_t(acc, grad_tile + 5 * WIDTH, ART_LDG, WIDTH, W + OFF_W5B, WIDTH, 16 * warp);
    mma_tile_t(acc, sm.m.h[1], LDH, WIDTH, W + OFF_W0, WIDTH, 16 * warp);
#pragma unroll
    for (int r = 0; r < RT; ++r)
      wmma::store_matrix_sync(d_enc + 16 * r * POS_PAD + 16 * warp, acc[r][0], POS_PAD,
                              wmma::mem_row_major);
  }
  __syncthreads();

  {  // the encoding's VJP at x': d_x' = bf16(d_pre) @ bf16(s)^T, 64 rows x 4 parts of 16 columns
    const int r = tid >> 2, part = tid & 3;
    const float* xp = xp_ws + 4 * (row0 + r);
    const float x0 = xp[0], x1 = xp[1], x2 = xp[2];
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    for (int c = 16 * part; c < 16 * part + 16; ++c) {
      float d_pre = d_enc[r * POS_PAD + c];
      if (c >= 3) d_pre *= cosf(reduce_arg(encode_pre(x0, x1, x2, s_pos, p_pos, POS_PAD, c)));
      d_pre = round_bf16(d_pre);
      d0 = fmaf(d_pre, __ldg(s_pos + c), d0);  // s holds powers of two: exact in bf16
      d1 = fmaf(d_pre, __ldg(s_pos + POS_PAD + c), d1);
      d2 = fmaf(d_pre, __ldg(s_pos + 2 * POS_PAD + c), d2);
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, m);
      d1 += __shfl_xor_sync(0xffffffffu, d1, m);
      d2 += __shfl_xor_sync(0xffffffffu, d2, m);
    }
    if (part == 0)
      sm.dxp[4 * r + 0] = d0, sm.dxp[4 * r + 1] = d1, sm.dxp[4 * r + 2] = d2, sm.dxp[4 * r + 3] = 0.0f;
  }
  __syncthreads();
  if (tid < 3) {  // bdo: sums of the unrounded d_x'
    float s = 0.0f;
    for (int r = 0; r < TILE; ++r) s += sm.dxp[4 * r + tid];
    atomicAdd(gb + AOFF_BDO + tid, s);
  }

  // deformation head and layer 3: dh3 = (bf16(d_x') @ wdo^T) * relu'(hd3)
  hin = sm.m.h[1];
  hout = sm.m.h[0];
  __syncthreads();  // d_enc (sm.h[0]) and D0 (sm.h[1]) are done with
  head3_bwd(sm.dxp, W + AOFF_WDO, 4, act_tile + ACT_HD0 + 3 * DEF, ART_LDA, gb + AOFF_BD0 + 3 * DEF,
            gw + AOFF_WDO, hin, grad_tile + GR_DH0 + 3 * DEF, ART_LDG);
  __syncthreads();
#pragma unroll 1
  for (int i = 3; i >= 1; --i) {  // dh_{i-1} = (bf16(dh_i) @ wd_i^T) * relu'(hd_{i-1})
    dense128_bwd(hin, W + AOFF_WD1 + (i - 1) * DEF * DEF, act_tile + ACT_HD0 + (i - 1) * DEF,
                 gb + AOFF_BD0 + (i - 1) * DEF, hout, scratch, warp, lane,
                 grad_tile + GR_DH0 + (i - 1) * DEF);
    __syncthreads();
    bf16* t = hin; hin = hout; hout = t;
  }
  {  // wd0x = bf16(xyz)^T @ bf16(dh0): column tid & 127, half the rows each
    const int c = tid & (DEF - 1), half = tid >> 7;
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
    for (int r = half * (TILE / 2); r < (half + 1) * (TILE / 2); ++r) {
      const float d = __bfloat162float(hin[r * LDH + c]);
      w0 = fmaf(round_bf16(sm.xyz[4 * r + 0]), d, w0);
      w1 = fmaf(round_bf16(sm.xyz[4 * r + 1]), d, w1);
      w2 = fmaf(round_bf16(sm.xyz[4 * r + 2]), d, w2);
    }
    atomicAdd(gw + AOFF_WD0X + c, w0);
    atomicAdd(gw + AOFF_WD0X + DEF + c, w1);
    atomicAdd(gw + AOFF_WD0X + 2 * DEF + c, w2);
  }
}

// ------------------------------------------------------------------ launches

constexpr int N_ART_JOBS = N_TRUNK_JOBS + 6;

WgradJobs<N_ART_JOBS> art_wgrad_jobs() {
  WgradJobs<N_ART_JOBS> t;
  int n = trunk_wgrad_jobs(t.job);
  for (int i = 1; i <= 3; ++i) {  // wd_i = hd_{i-1}^T dh_i; wv_i = v_{i-1}^T dv_i
    t.job[n++] = {ACT_HD0 + (i - 1) * DEF, DEF, GR_DH0 + i * DEF, DEF,
                  AOFF_WD1 + (i - 1) * DEF * DEF};
    t.job[n++] = {i > 1 ? ACT_V1 + (i - 2) * DEF : ACT_V, DEF, GR_V1 + (i - 1) * DEF, DEF,
                  AOFF_WV1 + (i - 1) * DEF * DEF};
  }
  return t;
}

template <bool SAVE>
int launch_forward(const float* xyz, const float* t_vals, const float* rays_o,
                   const float* rays_d, const float* vdir, const float* s_pos,
                   const float* p_pos, const float* s_view, const float* p_view,
                   const void* weights, const float* biases, float* raw_rgb, float* raw_sigma,
                   void* act, float* xp_ws, long long n_rows, int samples_per_ray,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(SmemArt));
  cudaError_t err = cudaFuncSetAttribute(art_fwd_kernel<SAVE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + TILE - 1) / TILE;
  art_fwd_kernel<SAVE><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      xyz, t_vals, rays_o, rays_d, vdir, s_pos, p_pos, s_view, p_view,
      static_cast<const bf16*>(weights), biases, raw_rgb, raw_sigma, static_cast<bf16*>(act),
      xp_ws, n_rows, samples_per_ray);
  return static_cast<int>(cudaGetLastError());
}

int launch_backward(const float* g, const float* xyz, const float* t_vals, const float* rays_o,
                    const float* rays_d, const float* s_pos, const float* p_pos,
                    const void* weights, const void* act, const float* xp_ws, void* grad,
                    float* gw, long long n_rows, int samples_per_ray, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(SmemArtBwd));
  cudaError_t err = cudaFuncSetAttribute(art_bwd_data_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + TILE - 1) / TILE;
  art_bwd_data_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      g, xyz, t_vals, rays_o, rays_d, s_pos, p_pos, static_cast<const bf16*>(weights),
      static_cast<const bf16*>(act), xp_ws, static_cast<bf16*>(grad), gw, n_rows,
      samples_per_ray);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_wgrad(static_cast<const bf16*>(act), ART_LDA, static_cast<const bf16*>(grad),
                      ART_LDG, gw, blocks * TILE, art_wgrad_jobs(), stream);
}

}  // namespace

// Blobs: weights bf16 (693888), biases f32 (3336), both in the layout above.
// Workspaces of the training launches (caller-allocated, any contents): act
// bf16 (n_pad, 3424), grad bf16 (n_pad, 3328), xp f32 (n_pad, 4) with n_pad =
// n_rows rounded up to 64; raw_rgb (n_rows, 3), raw_sigma (n_rows), g
// (n_rows, 4) f32.  gw: f32 (693888 + 3336), zeroed by the caller on this
// stream.

// The forward alone: raw_rgb (n_rows, 3) and raw_sigma (n_rows, 1) for n_rows =
// B * samples_per_ray sample coordinates xyz (n_rows, 3) and per-ray viewdirs
// vdir (B, 3).
extern "C" int aon_art_fwd_launch(const float* xyz, const float* vdir, const float* s_pos,
                                  const float* p_pos, const float* s_view, const float* p_view,
                                  const void* weights, const float* biases, float* out_rgb,
                                  float* out_sigma, long long n_rows, int samples_per_ray,
                                  void* stream) {
  if (n_rows <= 0) return 0;
  return launch_forward<false>(xyz, nullptr, nullptr, nullptr, vdir, s_pos, p_pos, s_view, p_view,
                               weights, biases, out_rgb, out_sigma, nullptr, nullptr, n_rows,
                               samples_per_ray, static_cast<cudaStream_t>(stream));
}

// The backward alone: forward recomputed from xyz (n_rows, 3) and per-ray
// vdir, then gw = sum over rows of d(raw . g) / d(weights, biases) for the
// cotangent g (n_rows, 4) = (g_rgb, g_sigma).
extern "C" int aon_art_bwd_launch(const float* xyz, const float* vdir, const float* g,
                                  const float* s_pos, const float* p_pos, const float* s_view,
                                  const float* p_view, const void* weights, const float* biases,
                                  float* raw_rgb, float* raw_sigma, void* act, float* xp_ws,
                                  void* grad, float* gw, long long n_rows, int samples_per_ray,
                                  void* stream_) {
  if (n_rows <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int err = launch_forward<true>(xyz, nullptr, nullptr, nullptr, vdir, s_pos, p_pos, s_view,
                                       p_view, weights, biases, raw_rgb, raw_sigma, act, xp_ws,
                                       n_rows, samples_per_ray, stream);
  if (err != 0) return err;
  return launch_backward(g, xyz, nullptr, nullptr, nullptr, s_pos, p_pos, weights, act, xp_ws,
                         grad, gw, n_rows, samples_per_ray, stream);
}

// One training level.  t_vals (B, S) ascending, rays_o / rays_d (unit) /
// vdir / target (B, 3), loss_w / mask (B).  Outputs: photo_loss (1, zeroed by
// the caller) = sum_r loss_w_r |comp_r - target_r|^2, weights (B, S), acc (B),
// gw = d(photo_loss + bce_weight * mean BCE(acc, mask)) / d(weights, biases).
extern "C" int aon_art_level_launch(
    const float* t_vals, const float* rays_o, const float* rays_d, const float* vdir,
    const float* target, const float* loss_w, const float* mask, const float* s_pos,
    const float* p_pos, const float* s_view, const float* p_view, const void* weights,
    const float* biases, float* raw_rgb, float* raw_sigma, float* g, void* act, float* xp_ws,
    void* grad, float* out_weights, float* out_acc, float* photo_loss, float* gw, int n_rays,
    int samples_per_ray, int white_bkgd, float rgb_padding, float density_bias, float bce_weight,
    int softplus, void* stream_) {
  if (n_rays <= 0 || samples_per_ray <= 0) return 0;
  if (samples_per_ray > 32 * MAX_SAMPLES_PER_LANE) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n_rows = static_cast<long long>(n_rays) * samples_per_ray;
  int err = launch_forward<true>(nullptr, t_vals, rays_o, rays_d, vdir, s_pos, p_pos, s_view,
                                 p_view, weights, biases, raw_rgb, raw_sigma, act, xp_ws, n_rows,
                                 samples_per_ray, stream);
  if (err != 0) return err;
  const int rays_per_block = 4;
  art_composite_kernel<<<(n_rays + rays_per_block - 1) / rays_per_block, 32 * rays_per_block, 0,
                         stream>>>(raw_rgb, raw_sigma, t_vals, target, loss_w, mask, g,
                                   out_weights, out_acc, photo_loss, n_rays, samples_per_ray,
                                   white_bkgd, rgb_padding, density_bias, bce_weight / n_rays,
                                   softplus);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_backward(g, nullptr, t_vals, rays_o, rays_d, s_pos, p_pos, weights, act, xp_ws,
                         grad, gw, n_rows, samples_per_ray, stream);
}
