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
//     branch and the rgb head -> raw (rgb, sigma) (kernel table row 10);
//   * `_art_bwd_kernel` (same file, reached through the backward of
//     fused_art_mlp_train; body `_art_bwd_from_acts` + `_posenc_vjp`): forward
//     recomputed, then the backward from a cotangent g (N, 4) to the 42
//     effective gradients, through the encoding into the deformation MLP
//     (row 11);
//   * `_art_level_kernel` (aon_tpu/ops/train_fused_level_art.py, reached
//     through fused_level_train_art_grads): samples o + t*d, that forward, the
//     head activations (padded sigmoid rgb; softplus(sigma + bias) or relu),
//     compositing, the per-ray weighted squared error, the compositing VJP
//     with the optional telescoped opacity-BCE term, the head VJPs and the
//     same backward (row 9).
//
// Bound on the H100: operations (1.385 MFLOP per sample row forward, three
// times that for a training level, against a few dozen bytes of input); the
// training workspaces (about 13.8 KB a row, written once and read once or
// twice) add a byte floor of the same order.
//
// Design: that of the vanilla kernels (fused_mlp_eval.cu, level_train.cu) on
// art_sm90.cuh: persistent blocks of two consumer warpgroups and a producer
// thread, one per SM, over 128-row tiles; wgmma on K-major swizzled operands
// in shared memory, the weights streamed through a 4-stage ring of slabs by
// bulk copies on mbarriers; the consumers run half a layer apart
// (two-stream).  The 128-wide deformation and view layers are m64n128 wgmma;
// the K = 3 first layer, the deformation head wdo and the encoding's VJP run
// on CUDA cores.  The eval kernel keeps every activation on chip.  A
// training launch is a chain on one stream:
//
//   1. art_train_fwd       prefix, encodings, trunk, view branch; every
//                          activation to the blocked act workspace by bulk
//                          copies, the trunk's relu masks as bits, x' as f32;
//   2. art_composite_kernel one warp per ray (level route only);
//   3. art_train_bwd       the view branch back to dv0, the vanilla chain to
//                          D0, d_enc = D0 w0^T + D5 w5b^T, the encoding's VJP
//                          (cos of the reduced argument) to d_x', and the
//                          deformation MLP back to its first layer; each D to
//                          the blocked grad workspace, bias and head sums per
//                          block;
//   4. wgrad_kernel        dW = X^T D for the 18 wide matrices (the vanilla
//                          12, wd1..wd3, wv1..wv3), one block per output tile
//                          and row range, sums in registers.
//
// Roundings follow the TPU kernel: bf16 operands and f32 sums in every
// product; K = 3 as FMAs on bf16-rounded operands; x' and the encodings in
// f32; relu masks from the stored bf16 activations; D rounded to bf16 where
// it is stored; accurate expf / log1pf / sinf / cosf and IEEE division (no
// --use_fast_math).  float atomicAdd makes the gradients differ in the last
// bits from run to run.  The gradient blob must be zeroed on the same stream
// before every launch; rows past n_rows carry g = 0.

#include "art_sm90.cuh"

using namespace aon;
using sm90::Stage;
namespace art = sm90::art;

namespace {

constexpr int MAX_SAMPLES_PER_LANE = 8;  // art_composite_kernel: S <= 256

// ---------------------------------------------------------------- forwards

// The eval forward: one persistent block per SM over the 128-row tiles
// blockIdx.x, + gridDim.x, ...; W the eval blob.
__global__ void __launch_bounds__(sm90::THREADS, 1) art_eval_kernel(art::FwdArgs a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_setup(smem_raw, a.W);
  const long long n_tiles = (a.n_rows + TILE_ROWS - 1) / TILE_ROWS;
  // one branch per role for the kernel's whole life, as setmaxnreg needs
  if (threadIdx.x >= CONSUMER_THREADS) {
    producer_registers();
    if (threadIdx.x == CONSUMER_THREADS) art::produce_forward(blk, a.W, n_tiles);
  } else {
    consumer_registers();
    Consumer c(blk);
    float acc[128];  // each layer's first wgmma writes it whole
    if (c.wg == 1) bar_arrive(BAR_TURN, CONSUMER_THREADS);  // warpgroup 0 takes the first turn
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      art::eval_tile(c, acc, a, tile * TILE_ROWS + c.wg * WG_ROWS);
    if (c.wg == 0) bar_sync(BAR_TURN, CONSUMER_THREADS);  // the turn warpgroup 1 handed over last
  }
}

// The training forward: the same shell; W the training blob.
template <Stage ST>
__global__ void __launch_bounds__(sm90::THREADS, 1) art_train_fwd(art::FwdArgs a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_setup(smem_raw, a.W);
  const int n_tiles = static_cast<int>((a.n_rows + TILE_ROWS - 1) / TILE_ROWS);
  if (threadIdx.x >= CONSUMER_THREADS) {
    producer_registers();
    if (threadIdx.x == CONSUMER_THREADS) art::produce_forward(blk, a.W, n_tiles);
  } else {
    consumer_registers();
    Consumer c(blk);
    float acc[128];
    if (c.wg == 1) bar_arrive(BAR_TURN, CONSUMER_THREADS);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      art::forward_tile<ST>(c, acc, a, static_cast<long long>(tile) * TILE_ROWS + c.wg * WG_ROWS);
    if (c.wg == 0) bar_sync(BAR_TURN, CONSUMER_THREADS);
    if (c.t == 0) bulk_wait();  // the tile stores are complete before the block's memory goes
  }
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

// The same persistent shape over the same tiles; the block's sums (bias and
// head gradients) at art::SUMS_OFFSET.
template <Stage ST>
__global__ void __launch_bounds__(sm90::THREADS, 1) art_train_bwd(art::BwdArgs a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_setup(smem_raw, a.W);
  float* sums = reinterpret_cast<float*>(blk.smem + art::SUMS_OFFSET);
  for (int i = threadIdx.x; i < art::N_SUMS; i += sm90::THREADS) sums[i] = 0.0f;
  __syncthreads();
  const int n_tiles = static_cast<int>((a.n_rows + TILE_ROWS - 1) / TILE_ROWS);
  if (threadIdx.x >= CONSUMER_THREADS) {
    producer_registers();
    if (threadIdx.x == CONSUMER_THREADS) art::produce_backward(blk, a.W, n_tiles);
  } else {
    consumer_registers();
    Consumer c(blk);
    float acc[128];
    if (c.wg == 1) bar_arrive(BAR_TURN, CONSUMER_THREADS);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      art::backward_tile<ST>(c, acc, a,
                             static_cast<long long>(tile) * TILE_ROWS + c.wg * WG_ROWS, sums);
    if (c.wg == 0) bar_sync(BAR_TURN, CONSUMER_THREADS);
    if (c.t == 0) bulk_wait();
    art::flush_sums(sums, a.gw);
  }
}

// ------------------------------------------------------------------ launches

template <class Kernel, class Args>
int launch_persistent(Kernel kernel, const Args& a, int grid, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), sm90::THREADS, sm90::SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward data path, then the weight gradients over its workspaces.
template <Stage ST>
int launch_backward(const art::BwdArgs& a, const int* items, int n_items, int grid,
                    cudaStream_t stream) {
  int err = launch_persistent(art_train_bwd<ST>, a, grid, stream);
  if (err != 0) return err;
  constexpr int ACTC = art::Layout::ACT_CHUNKS, GRADC = art::Layout::GRAD_CHUNKS;
  cudaError_t e = cudaFuncSetAttribute(sm90::wgrad_kernel<ACTC, GRADC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       sm90::WGRAD_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  sm90::wgrad_kernel<ACTC, GRADC><<<static_cast<unsigned>(n_items), sm90::WGRAD_THREADS,
                                    sm90::WGRAD_SMEM_BYTES, stream>>>(a.act, a.grad, a.gw, items);
  return static_cast<int>(cudaGetLastError());
}

art::FwdArgs fwd_args(const float* xyz, const float* t_vals, const float* rays_o,
                      const float* rays_d, const float* vdir, const float* s_pos,
                      const float* p_pos, const float* s_view, const float* p_view,
                      const void* weights, const float* biases, float* raw_rgb, float* raw_sigma,
                      void* act, void* mask, float* xp, long long n_rows, int samples_per_ray) {
  art::FwdArgs a;
  a.enc = nullptr, a.venc = nullptr, a.xyz = xyz, a.t_vals = t_vals, a.rays_o = rays_o;
  a.rays_d = rays_d, a.vdir = vdir, a.s_pos = s_pos, a.p_pos = p_pos, a.s_view = s_view;
  a.p_view = p_view, a.W = static_cast<const bf16*>(weights), a.bias = biases;
  a.out_rgb = raw_rgb, a.out_sigma = raw_sigma, a.act = static_cast<bf16*>(act);
  a.mask = static_cast<uint8_t*>(mask), a.n_rows = n_rows, a.samples_per_ray = samples_per_ray;
  a.xp = xp;
  return a;
}

art::BwdArgs bwd_args(const float* g, const void* weights, void* act, void* mask, void* grad,
                      float* gw, const float* xyz, const float* t_vals, const float* rays_o,
                      const float* rays_d, const float* s_pos, const float* p_pos,
                      const float* xp, long long n_rows, int samples_per_ray) {
  art::BwdArgs a;
  a.g = g, a.W = static_cast<const bf16*>(weights), a.act = static_cast<const bf16*>(act);
  a.mask = static_cast<const uint8_t*>(mask), a.grad = static_cast<bf16*>(grad), a.gw = gw;
  a.n_rows = n_rows, a.xyz = xyz, a.t_vals = t_vals, a.rays_o = rays_o, a.rays_d = rays_d;
  a.s_pos = s_pos, a.p_pos = p_pos, a.xp = xp, a.samples_per_ray = samples_per_ray;
  return a;
}

}  // namespace

// Blobs (ops/art_sm90.py): the eval forward takes the eval blob, the
// training launches the training blob, both 16-byte aligned; biases f32
// (3336).  Workspaces of the training launches (caller-allocated, any
// contents; ops/fused_art.py train_workspaces), n_pad = n_rows rounded up to
// 128: act bf16 in blocks of 64 rows x 54 swizzled chunks, grad bf16 in
// blocks of 64 rows x 50 chunks, mask u8 (n_pad, 256), xp f32 (n_pad, 4);
// raw_rgb (n_rows, 3), raw_sigma (n_rows), g (n_rows, 4) f32.  gw: f32
// (693888 + 3336), zeroed by the caller on this stream.  items: the weight
// gradients' work list (ops/art_sm90.py wgrad_items) for n_pad, on the
// device.  grid: the persistent blocks, at most one per SM and at most the
// number of 128-row tiles.

// The forward alone: raw_rgb (n_rows, 3) and raw_sigma (n_rows, 1) for n_rows =
// B * samples_per_ray sample coordinates xyz (n_rows, 3) and per-ray viewdirs
// vdir (B, 3).
extern "C" int aon_art_fwd_launch(const float* xyz, const float* vdir, const float* s_pos,
                                  const float* p_pos, const float* s_view, const float* p_view,
                                  const void* weights, const float* biases, float* out_rgb,
                                  float* out_sigma, long long n_rows, int samples_per_ray,
                                  int grid, void* stream) {
  if (n_rows <= 0) return 0;
  if (grid <= 0 || samples_per_ray <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const art::FwdArgs a = fwd_args(xyz, nullptr, nullptr, nullptr, vdir, s_pos, p_pos, s_view,
                                  p_view, weights, biases, out_rgb, out_sigma, nullptr, nullptr,
                                  nullptr, n_rows, samples_per_ray);
  return launch_persistent(art_eval_kernel, a, grid, static_cast<cudaStream_t>(stream));
}

// The backward alone: forward recomputed from xyz (n_rows, 3) and per-ray
// vdir, then gw = sum over rows of d(raw . g) / d(weights, biases) for the
// cotangent g (n_rows, 4) = (g_rgb, g_sigma).
extern "C" int aon_art_bwd_launch(const float* xyz, const float* vdir, const float* g,
                                  const float* s_pos, const float* p_pos, const float* s_view,
                                  const float* p_view, const void* weights, const float* biases,
                                  float* raw_rgb, float* raw_sigma, void* act, float* xp,
                                  void* grad, void* mask, float* gw, const int* items,
                                  int n_items, long long n_rows, int samples_per_ray, int grid,
                                  void* stream_) {
  if (n_rows <= 0) return 0;
  if (samples_per_ray <= 0 || grid <= 0 || n_items <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const art::FwdArgs fa = fwd_args(xyz, nullptr, nullptr, nullptr, vdir, s_pos, p_pos, s_view,
                                   p_view, weights, biases, raw_rgb, raw_sigma, act, mask, xp,
                                   n_rows, samples_per_ray);
  const int err = launch_persistent(art_train_fwd<Stage::XYZ>, fa, grid, stream);
  if (err != 0) return err;
  const art::BwdArgs ba = bwd_args(g, weights, act, mask, grad, gw, xyz, nullptr, nullptr,
                                   nullptr, s_pos, p_pos, xp, n_rows, samples_per_ray);
  return launch_backward<Stage::XYZ>(ba, items, n_items, grid, stream);
}

// One training level.  t_vals (B, S) ascending, rays_o / rays_d (unit) /
// vdir / target (B, 3), loss_w / mask (B).  Outputs: photo_loss (1, zeroed by
// the caller) = sum_r loss_w_r |comp_r - target_r|^2, weights (B, S), acc (B),
// gw = d(photo_loss + bce_weight * mean BCE(acc, mask)) / d(weights, biases).
extern "C" int aon_art_level_launch(
    const float* t_vals, const float* rays_o, const float* rays_d, const float* vdir,
    const float* target, const float* loss_w, const float* mask, const float* s_pos,
    const float* p_pos, const float* s_view, const float* p_view, const void* weights,
    const float* biases, float* raw_rgb, float* raw_sigma, float* g, void* act, float* xp,
    void* grad, void* relu_mask, float* out_weights, float* out_acc, float* photo_loss, float* gw,
    const int* items, int n_items, int n_rays, int samples_per_ray, int white_bkgd,
    float rgb_padding, float density_bias, float bce_weight, int softplus, int grid,
    void* stream_) {
  if (n_rays <= 0 || samples_per_ray <= 0) return 0;
  if (samples_per_ray > 32 * MAX_SAMPLES_PER_LANE || grid <= 0 || n_items <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n_rows = static_cast<long long>(n_rays) * samples_per_ray;
  const art::FwdArgs fa = fwd_args(nullptr, t_vals, rays_o, rays_d, vdir, s_pos, p_pos, s_view,
                                   p_view, weights, biases, raw_rgb, raw_sigma, act, relu_mask,
                                   xp, n_rows, samples_per_ray);
  int err = launch_persistent(art_train_fwd<Stage::T_VALS>, fa, grid, stream);
  if (err != 0) return err;
  const int rays_per_block = 4;
  art_composite_kernel<<<(n_rays + rays_per_block - 1) / rays_per_block, 32 * rays_per_block, 0,
                         stream>>>(raw_rgb, raw_sigma, t_vals, target, loss_w, mask, g,
                                   out_weights, out_acc, photo_loss, n_rays, samples_per_ray,
                                   white_bkgd, rgb_padding, density_bias, bce_weight / n_rays,
                                   softplus);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const art::BwdArgs ba = bwd_args(g, weights, act, relu_mask, grad, gw, nullptr, t_vals, rays_o,
                                   rays_d, s_pos, p_pos, xp, n_rows, samples_per_ray);
  return launch_backward<Stage::T_VALS>(ba, items, n_items, grid, stream);
}
