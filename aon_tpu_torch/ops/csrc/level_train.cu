// Vanilla NeRF training kernels for Hopper (sm_90a): one fused training level
// and the MLP backward of the two-kernel route.
//
// Replaces three TPU kernels:
//   * `_level_kernel` (aon_tpu/ops/train_fused_level.py, reached through
//     fused_level_train_grads): samples o + t*d, in-kernel encodings, MLP
//     forward, compositing, squared error against the target, compositing
//     VJP and the full MLP backward into the 26 weight gradients;
//   * `_bwd_kernel_xyz_flat` (aon_tpu/ops/fused_mlp_train.py, reached through
//     _bwd_call_xyz; body `_bwd_body`): forward recomputed from raw xyz, then
//     the same backward from a cotangent g (N, 4);
//   * `_bwd_kernel` (aon_tpu/ops/fused_mlp_train.py, reached through _bwd_call,
//     the backward of fused_mlp_train): the same from given f32 encodings
//     (N, 64) and (N, 32), rounded to bf16 where they are staged, so the
//     w0 / w5b / wvb gradients read them as `dot_tn(enc, da)` does.
//
// Bound on the H100: operations (about 3.6 MFLOP per sample row against a
// few dozen bytes of input), so the tensor cores set the floor.
//
// Design.  The TPU keeps a tile of 1024-2048 rows of activations and all 26
// gradient accumulators in VMEM and walks its grid in order.  A block here
// has 227 KB of shared memory, a fine ray alone is 193 rows, and blocks run
// concurrently, so the level is four kernels on one stream, sharing two bf16
// workspaces in global memory (activations, LDA columns per row; gradients of
// the pre-activations, LDG columns per row):
//
//   1. train_fwd_kernel   64-row tiles: encodings and the WMMA forward of
//                         mlp_common.cuh, every activation also written to
//                         the workspace as the bf16 value the next layer read;
//   2. composite_kernel   one warp per ray: compositing, error, and the
//                         compositing VJP into g = (g_rgb, g_sigma), with
//                         warp-shuffle scans for the exclusive product and
//                         the exclusive suffix sum (level route only);
//   3. bwd_data_kernel    64-row tiles: the chain dv, dbott, D7..D0 of
//                         `_bwd_from_acts` with W^T read as column-major WMMA
//                         fragments; relu masks from the stored activations;
//                         each D goes to the gradient workspace as bf16 (the
//                         rounding `dot_tn` applies to it), and the f32 column
//                         sums (bias gradients) and the two narrow heads'
//                         gradients go out by atomicAdd;
//   4. wgrad_kernel       dW = X^T D for the 12 wide weight matrices as
//                         split-K WMMA products over the workspaces, output
//                         tiles of up to 128x128, partial sums added by
//                         atomicAdd.
//
// Kernels 3 and 4 are built from train_common.cuh, which the articulated
// kernels (art.cu) share.
//
// The gradient blob must be zeroed on the same stream before every launch.
// float atomicAdd makes the gradients (and sq_err_sum) differ in the last
// bits from run to run.  Rows past n_rows in the last tile carry g = 0, so
// every D of theirs is 0 and they add nothing to any gradient.
//
// Roundings follow the TPU kernel: bf16 operands and f32 accumulation in
// every product, including the f32 gradients g_rgb, g_sigma, dv and da that
// `dot_tn`/`dot_nt` cast to bf16; bias gradients are sums of the unrounded
// f32 values.  IEEE division and accurate expf/sinf: no --use_fast_math.

#include "train_common.cuh"

using namespace aon;

namespace {

constexpr int MAX_SAMPLES_PER_LANE = 8;  // composite_kernel: S <= 256

// ---------------------------------------------------------------- 1. forward

// The encodings come either from enc_in (n_rows, 64) and venc_in (n_rows, 32)
// f32 or, where enc_in is null, are computed from sample coordinates and the
// per-ray vdir: from xyz (n_rows, 3) or, where xyz is null too, from t_vals
// (n_rows) and per-ray origins and directions as o + t * d, the product and
// the sum rounded separately as the plain version rounds them.
__global__ void __launch_bounds__(THREADS, 2)
train_fwd_kernel(const float* __restrict__ enc_in, const float* __restrict__ venc_in,
                 const float* __restrict__ xyz, const float* __restrict__ t_vals,
                 const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                 const float* __restrict__ vdir, const float* __restrict__ s_pos,
                 const float* __restrict__ p_pos, const float* __restrict__ s_view,
                 const float* __restrict__ p_view, const bf16* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ out_rgb,
                 float* __restrict__ out_sigma, bf16* __restrict__ act, long long n_rows,
                 int samples_per_ray) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;
  bf16* act_tile = act + static_cast<size_t>(row0) * LDA;

  // Encodings of this tile's samples; rows past the end repeat the last row.
  for (int i = tid; i < TILE * POS_PAD; i += THREADS) {
    const int r = i / POS_PAD, c = i % POS_PAD;
    const long long g = min(row0 + r, n_rows - 1);
    float e;
    if (enc_in != nullptr) {
      e = enc_in[g * POS_PAD + c];
    } else {
      float x0, x1, x2;
      if (xyz != nullptr) {
        x0 = xyz[3 * g], x1 = xyz[3 * g + 1], x2 = xyz[3 * g + 2];
      } else {
        const long long ray = g / samples_per_ray;
        const float t = t_vals[g];
        x0 = __fadd_rn(rays_o[3 * ray + 0], __fmul_rn(t, rays_d[3 * ray + 0]));
        x1 = __fadd_rn(rays_o[3 * ray + 1], __fmul_rn(t, rays_d[3 * ray + 1]));
        x2 = __fadd_rn(rays_o[3 * ray + 2], __fmul_rn(t, rays_d[3 * ray + 2]));
      }
      e = encode(x0, x1, x2, s_pos, p_pos, POS_PAD, c);
    }
    const bf16 h = __float2bfloat16_rn(e);
    sm.enc[r * LDE + c] = h;
    act_tile[static_cast<size_t>(r) * LDA + ACT_ENC + c] = h;
  }
  for (int i = tid; i < TILE * VIEW_PAD; i += THREADS) {
    const int r = i / VIEW_PAD, c = i % VIEW_PAD;
    const long long g = min(row0 + r, n_rows - 1);
    float e;
    if (venc_in != nullptr) {
      e = venc_in[g * VIEW_PAD + c];
    } else {
      const float* v = vdir + 3 * (g / samples_per_ray);
      e = encode(v[0], v[1], v[2], s_view, p_view, VIEW_PAD, c);
    }
    const bf16 h = __float2bfloat16_rn(e);
    sm.venc[r * LDV + c] = h;
    act_tile[static_cast<size_t>(r) * LDA + ACT_VENC + c] = h;
  }
  __syncthreads();

  mlp_forward<true>(sm, W, bias, out_rgb, out_sigma, row0, n_rows, act_tile);
}

// ------------------------------------------------------------- 2. compositing

// One warp per ray; lane l holds samples [l*C, (l+1)*C), C = ceil(S / 32).
// Contract of `_level_kernel`: last dist 1e10, alpha = 1 - exp(-relu(sigma) *
// dist), u = max(1 - alpha, 0) + 1e-10, T the exclusive product of u, white
// background comp + (1 - acc); dists are not scaled by |rays_d|.  Backward:
// dcomp = 2 err / (B * 3), G = <dcomp, rgb> - <dcomp, 1> (white), P the
// exclusive suffix sum of w * G, d_alpha = T * G - P / u.
__global__ void composite_kernel(const float* __restrict__ raw_rgb,
                                 const float* __restrict__ raw_sigma,
                                 const float* __restrict__ t_vals,
                                 const float* __restrict__ target, float* __restrict__ g,
                                 float* __restrict__ weights, float* __restrict__ sq_err_sum,
                                 int n_rays, int S, int white, float dcomp_scale) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // the whole warp leaves together
  const int C = (S + 31) / 32;
  const int s0 = lane * C;
  const long long base = static_cast<long long>(ray) * S;

  float alpha[MAX_SAMPLES_PER_LANE], u[MAX_SAMPLES_PER_LANE], dist[MAX_SAMPLES_PER_LANE];
  float T[MAX_SAMPLES_PER_LANE], rs[MAX_SAMPLES_PER_LANE], rgb[MAX_SAMPLES_PER_LANE][3];

  float prod = 1.0f;
#pragma unroll
  for (int i = 0; i < MAX_SAMPLES_PER_LANE; ++i) {
    const int s = s0 + i;
    const bool live = i < C && s < S;
    alpha[i] = 0.0f, u[i] = 1.0f, dist[i] = 0.0f, rs[i] = 0.0f, T[i] = prod;
    rgb[i][0] = rgb[i][1] = rgb[i][2] = 0.0f;
    if (live) {
      const float t = t_vals[base + s];
      dist[i] = (s == S - 1) ? 1e10f : t_vals[base + s + 1] - t;
      rs[i] = raw_sigma[base + s];
      alpha[i] = 1.0f - expf(-fmaxf(rs[i], 0.0f) * dist[i]);
      u[i] = fmaxf(1.0f - alpha[i], 0.0f) + 1e-10f;
      prod *= u[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[i][c] = 1.0f / (1.0f + expf(-raw_rgb[3 * (base + s) + c]));
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

  float dcomp[3], dsum = 0.0f, err2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (white) comp[c] += 1.0f - acc;
    const float err = comp[c] - target[3 * ray + c];
    err2 += err * err;
    dcomp[c] = err * dcomp_scale;
    dsum += dcomp[c];
  }
  if (lane == 0) atomicAdd(sq_err_sum, err2);

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
      const float d_alpha = T[i] * G[i] - (P[i] + after) / u[i];
      const float d_sigma = d_alpha * dist[i] * (1.0f - alpha[i]);
      float* out = g + 4 * (base + s);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[c] = w[i] * dcomp[c] * rgb[i][c] * (1.0f - rgb[i][c]);  // sigmoid'
      out[3] = rs[i] > 0.0f ? d_sigma : 0.0f;                       // relu'
      weights[base + s] = w[i];
    }
  }
}

// ------------------------------------------------------ 3. backward, data path

// gw: the f32 gradient blob, weights at the offsets of the weight blob, then
// the biases at N_WEIGHTS.  The chain itself is train_common.cuh's.
__global__ void __launch_bounds__(THREADS, 2)
bwd_data_kernel(const float* __restrict__ g, const bf16* __restrict__ W,
                const bf16* __restrict__ act, bf16* __restrict__ grad, float* __restrict__ gw,
                long long n_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemBwd& sm = *reinterpret_cast<SmemBwd*>(smem_raw);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;
  const bf16* act_tile = act + static_cast<size_t>(row0) * LDA;
  bf16* grad_tile = grad + static_cast<size_t>(row0) * LDG;
  float* gb = gw + N_WEIGHTS;

  {  // cotangent rows; rows past the end are 0 and so is everything after them
    const int r = tid >> 2;
    sm.g[tid] = row0 + r < n_rows ? g[4 * row0 + tid] : 0.0f;
  }
  __syncthreads();
  if (tid < 4) {  // brgb, bd: sums of the unrounded g
    float s = 0.0f;
    for (int r = 0; r < TILE; ++r) s += sm.g[4 * r + tid];
    atomicAdd(gb + (tid < 3 ? OFF_BRGB + tid : OFF_BD), s);
  }

  // rgb head and view layer: dv = (bf16(g_rgb) @ wrgb^T) * relu'(v)
  head3_bwd(sm.g, W + OFF_WRGB, 3, act_tile + ACT_V, LDA, gb + OFF_BV, gw + OFF_WRGB, sm.h[0],
            grad_tile + GR_V, LDG);
  __syncthreads();
  trunk_backward(sm, W, act_tile, LDA, grad_tile, LDG, gw, gb);
}

// -------------------------------------------------- 4. backward, weight grads

int launch_forward(const float* enc, const float* venc, const float* xyz, const float* t_vals,
                   const float* rays_o, const float* rays_d, const float* vdir,
                   const float* s_pos, const float* p_pos, const float* s_view,
                   const float* p_view, const void* weights, const float* biases,
                   float* raw_rgb, float* raw_sigma, void* act, long long n_rows,
                   int samples_per_ray, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err =
      cudaFuncSetAttribute(train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + TILE - 1) / TILE;
  train_fwd_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      enc, venc, xyz, t_vals, rays_o, rays_d, vdir, s_pos, p_pos, s_view, p_view,
      static_cast<const bf16*>(weights), biases, raw_rgb, raw_sigma, static_cast<bf16*>(act),
      n_rows, samples_per_ray);
  return static_cast<int>(cudaGetLastError());
}

int launch_backward(const float* g, const void* weights, const void* act, void* grad, float* gw,
                    long long n_rows, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(SmemBwd));
  cudaError_t err =
      cudaFuncSetAttribute(bwd_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + TILE - 1) / TILE;
  bwd_data_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      g, static_cast<const bf16*>(weights), static_cast<const bf16*>(act),
      static_cast<bf16*>(grad), gw, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  WgradJobs<N_TRUNK_JOBS> jobs;
  trunk_wgrad_jobs(jobs.job);
  return launch_wgrad(static_cast<const bf16*>(act), LDA, static_cast<const bf16*>(grad), LDG, gw,
                      blocks * TILE, jobs, stream);
}

}  // namespace

// Workspaces (caller-allocated, any contents): act bf16 (n_pad, 2528) and grad
// bf16 (n_pad, 2432) with n_pad = n_rows rounded up to 64; raw_rgb (n_rows, 3),
// raw_sigma (n_rows), g (n_rows, 4) f32.  gw: f32 (594560 + 2436), zeroed by
// the caller on this stream.

// One training level.  t_vals (B, S) ascending, rays_o / rays_d (unit) /
// vdir / target (B, 3).  Outputs: sq_err_sum (1, zeroed by the caller),
// weights (B, S), gw = d(sq_err_sum / (3B)) / d(weights, biases).
extern "C" int aon_level_train_launch(
    const float* t_vals, const float* rays_o, const float* rays_d, const float* vdir,
    const float* target, const float* s_pos, const float* p_pos, const float* s_view,
    const float* p_view, const void* weights, const float* biases, float* raw_rgb,
    float* raw_sigma, float* g, void* act, void* grad, float* out_weights, float* sq_err_sum,
    float* gw, int n_rays, int samples_per_ray, int white_bkgd, void* stream_) {
  if (n_rays <= 0 || samples_per_ray <= 0) return 0;
  if (samples_per_ray > 32 * MAX_SAMPLES_PER_LANE) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n_rows = static_cast<long long>(n_rays) * samples_per_ray;
  int err = launch_forward(nullptr, nullptr, nullptr, t_vals, rays_o, rays_d, vdir, s_pos, p_pos,
                           s_view, p_view, weights, biases, raw_rgb, raw_sigma, act, n_rows,
                           samples_per_ray, stream);
  if (err != 0) return err;
  const int rays_per_block = 4;
  const float dcomp_scale = static_cast<float>(2.0 / (n_rays * 3.0));
  composite_kernel<<<(n_rays + rays_per_block - 1) / rays_per_block, 32 * rays_per_block, 0,
                     stream>>>(raw_rgb, raw_sigma, t_vals, target, g, out_weights, sq_err_sum,
                               n_rays, samples_per_ray, white_bkgd, dcomp_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_backward(g, weights, act, grad, gw, n_rows, stream);
}

// The MLP backward alone: forward recomputed from xyz (n_rows, 3) and per-ray
// vdir, then gw = sum over rows of d(raw . g) / d(weights, biases) for the
// cotangent g (n_rows, 4) = (g_rgb, g_sigma).
extern "C" int aon_mlp_bwd_launch(const float* xyz, const float* vdir, const float* g,
                                  const float* s_pos, const float* p_pos, const float* s_view,
                                  const float* p_view, const void* weights, const float* biases,
                                  float* raw_rgb, float* raw_sigma, void* act, void* grad,
                                  float* gw, long long n_rows, int samples_per_ray,
                                  void* stream_) {
  if (n_rows <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int err = launch_forward(nullptr, nullptr, xyz, nullptr, nullptr, nullptr, vdir, s_pos,
                                 p_pos, s_view, p_view, weights, biases, raw_rgb, raw_sigma, act,
                                 n_rows, samples_per_ray, stream);
  if (err != 0) return err;
  return launch_backward(g, weights, act, grad, gw, n_rows, stream);
}

// The MLP backward from given encodings enc (n_rows, 64) and venc (n_rows, 32)
// f32 (kernel table row 6): the forward recomputed from them, then gw as for
// aon_mlp_bwd_launch.  Rows past n_rows in the last tile carry g = 0.
extern "C" int aon_mlp_bwd_enc_launch(const float* enc, const float* venc, const float* g,
                                      const void* weights, const float* biases, float* raw_rgb,
                                      float* raw_sigma, void* act, void* grad, float* gw,
                                      long long n_rows, void* stream_) {
  if (n_rows <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int err = launch_forward(enc, venc, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, weights, biases, raw_rgb, raw_sigma,
                                 act, n_rows, 1, stream);
  if (err != 0) return err;
  return launch_backward(g, weights, act, grad, gw, n_rows, stream);
}
