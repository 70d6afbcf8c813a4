// Vanilla NeRF training kernels for Hopper (sm_90a): one fused training level
// and the MLP backward of the two-kernel route.
//
// Replaces three TPU kernels:
//   * `_level_kernel` (aon_tpu/ops/train_fused_level.py, reached through
//     fused_level_train_grads): samples o + t*d, in-kernel encodings, MLP
//     forward, compositing, squared error against the target, compositing
//     VJP and the full MLP backward into the 26 weight gradients (row 3);
//   * `_bwd_kernel_xyz_flat` (aon_tpu/ops/fused_mlp_train.py, reached through
//     _bwd_call_xyz; body `_bwd_body`): forward recomputed from raw xyz, then
//     the same backward from a cotangent g (N, 4) (row 4);
//   * `_bwd_kernel` (aon_tpu/ops/fused_mlp_train.py, reached through _bwd_call,
//     the backward of fused_mlp_train): the same from given f32 encodings
//     (N, 64) and (N, 32), rounded to bf16 where they are staged, so the
//     w0 / w5b / wvb gradients read them as `dot_tn(enc, da)` does (row 6).
//
// Bound on the H100: operations (about 3.6 MFLOP per sample row against a
// few dozen bytes of input), so the tensor cores set the floor; the
// workspaces the stages hand each other (about 10 KB a row, written once and
// read once or twice) add a byte floor of roughly twice the flop floor.
//
// Design.  The TPU keeps a tile of 1024-2048 rows of activations and all 26
// gradient accumulators in VMEM and walks its grid in order.  A block here
// has 227 KB of shared memory and blocks run concurrently, so a level is four
// kernels on one stream that hand each other workspaces in global memory
// (train_sm90.cuh):
//
//   1. fwd_kernel        persistent wgmma forward over 128-row tiles (the eval
//                        trunk's two-stream body), the inputs staged three ways
//                        (Stage): t_vals on the rays (row 3), raw xyz (row 4),
//                        f32 encodings (row 6); every activation and its relu
//                        mask stored;
//   2. composite_kernel  one warp per ray: compositing, error, and the
//                        compositing VJP into g = (g_rgb, g_sigma), with
//                        warp-shuffle scans for the exclusive product and
//                        the exclusive suffix sum (level route only);
//   3. bwd_kernel        persistent wgmma backward, data path: dv, dbott,
//                        D7..D0 with W^T streamed from the backward blob, each
//                        D to the gradient workspace, the bias and head
//                        gradients summed per block;
//   4. wgrad_kernel      dW = X^T D for the 12 wide weight matrices, one block
//                        per (output tile, row range), sums in registers.
//
// The weights are the training blob (ops/train_sm90.py: the eval blob, then
// the backward blob); the gradient blob must be zeroed on the same stream
// before every launch.  float atomicAdd makes the gradients (and
// sq_err_sum) differ in the last bits from run to run.  Rows past n_rows in
// the last tile carry g = 0, so every D of theirs is 0 and they add nothing
// to any gradient.
//
// Roundings follow the TPU kernel: bf16 operands and f32 accumulation in
// every product, including the f32 gradients g_rgb, g_sigma, dv and da that
// `dot_tn`/`dot_nt` cast to bf16; relu masks from the stored bf16
// activations; bias gradients are sums of the unrounded f32 values.  IEEE
// division and accurate expf/sinf: no --use_fast_math.

#include "train_sm90.cuh"

using namespace aon;
using sm90::Stage;

extern "C" int aon_wgrad_run(const void* act, const void* grad, float* gw, const int* items,
                             int n_items, void* stream_);

namespace {

constexpr int MAX_SAMPLES_PER_LANE = 8;  // composite_kernel: S <= 256

// ---------------------------------------------------------------- 1. forward

// One persistent block per SM over the 128-row tiles blockIdx.x, + gridDim.x, ...
template <Stage ST>
__global__ void __launch_bounds__(sm90::THREADS, 1) sm90_train_fwd(sm90::FwdArgs a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_setup(smem_raw, a.W);
  const int n_tiles = static_cast<int>((a.n_rows + TILE_ROWS - 1) / TILE_ROWS);
  // one branch per role for the kernel's whole life, as setmaxnreg needs
  if (threadIdx.x >= CONSUMER_THREADS) {
    producer_registers();
    if (threadIdx.x == CONSUMER_THREADS) produce(blk, a.W, n_tiles);
  } else {
    consumer_registers();
    Consumer c(blk);
    float acc[128];  // each layer's first wgmma writes it whole
    if (c.wg == 1) bar_arrive(BAR_TURN, CONSUMER_THREADS);  // warpgroup 0 takes the first turn
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      forward_tile<ST>(c, acc, a, static_cast<long long>(tile) * TILE_ROWS + c.wg * WG_ROWS);
    if (c.wg == 0) bar_sync(BAR_TURN, CONSUMER_THREADS);  // the turn warpgroup 1 handed over last
    if (c.t == 0) bulk_wait();  // the tile stores are complete before the block's memory goes
  }
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

// The same persistent shape over the same tiles; the block's sums (bias and
// head gradients) live in the eval layout's view-encoding tiles.
__global__ void __launch_bounds__(sm90::THREADS, 1) sm90_train_bwd(sm90::BwdArgs a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_setup(smem_raw, a.W);
  float* sums = reinterpret_cast<float*>(blk.smem + SM_VENC);
  for (int i = threadIdx.x; i < N_SUMS; i += sm90::THREADS) sums[i] = 0.0f;
  __syncthreads();
  const int n_tiles = static_cast<int>((a.n_rows + TILE_ROWS - 1) / TILE_ROWS);
  if (threadIdx.x >= CONSUMER_THREADS) {
    producer_registers();
    if (threadIdx.x == CONSUMER_THREADS) produce_backward(blk, a.W, n_tiles);
  } else {
    consumer_registers();
    Consumer c(blk);
    float acc[128];
    if (c.wg == 1) bar_arrive(BAR_TURN, CONSUMER_THREADS);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      backward_tile(c, acc, a, static_cast<long long>(tile) * TILE_ROWS + c.wg * WG_ROWS,
                    sums);
    if (c.wg == 0) bar_sync(BAR_TURN, CONSUMER_THREADS);
    if (c.t == 0) bulk_wait();
    flush_sums(sums, a.gw);
  }
}

// ------------------------------------------------------------------ launches

template <Stage ST>
int launch_forward(const sm90::FwdArgs& a, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sm90_train_fwd<ST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sm90::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  sm90_train_fwd<ST><<<static_cast<unsigned>(grid), sm90::THREADS, sm90::SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward data path, then the weight gradients over its workspaces.
int launch_backward(const sm90::BwdArgs& a, const int* items, int n_items, int grid,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sm90_train_bwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sm90::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  sm90_train_bwd<<<static_cast<unsigned>(grid), sm90::THREADS, sm90::SMEM_BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return aon_wgrad_run(a.act, a.grad, a.gw, items, n_items, stream);
}

}  // namespace

// Workspaces (caller-allocated, any contents; ops/fused_mlp_train.py
// train_workspaces), n_pad = n_rows rounded up to 128: act bf16 in blocks of
// 64 rows x 40 swizzled chunks, grad bf16 in blocks of 64 rows x 38 chunks
// (train_sm90.cuh), mask u8 (n_pad, 256); raw_rgb (n_rows, 3),
// raw_sigma (n_rows), g (n_rows, 4) f32.  weights: the training blob
// (ops/train_sm90.py), 16-byte aligned.  gw: f32 (594560 + 2436), zeroed by
// the caller on this stream.  items: the weight gradients' work list
// (ops/train_sm90.py wgrad_items) for n_pad, on the device.  grid: the
// persistent blocks of the forward and the backward, at most one per SM and
// at most the number of 128-row tiles.

// One training level.  t_vals (B, S) ascending, rays_o / rays_d (unit) /
// vdir / target (B, 3).  Outputs: sq_err_sum (1, zeroed by the caller),
// weights (B, S), gw = d(sq_err_sum / (3B)) / d(weights, biases).
extern "C" int aon_level_train_launch(
    const float* t_vals, const float* rays_o, const float* rays_d, const float* vdir,
    const float* target, const float* s_pos, const float* p_pos, const float* s_view,
    const float* p_view, const void* weights, const float* biases, float* raw_rgb,
    float* raw_sigma, float* g, void* act, void* grad, void* mask, float* out_weights,
    float* sq_err_sum, float* gw, const int* items, int n_items, int n_rays,
    int samples_per_ray, int white_bkgd, int grid, void* stream_) {
  if (n_rays <= 0 || samples_per_ray <= 0) return 0;
  if (samples_per_ray > 32 * MAX_SAMPLES_PER_LANE || grid <= 0 || n_items <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n_rows = static_cast<long long>(n_rays) * samples_per_ray;
  const sm90::FwdArgs fa{nullptr, nullptr, nullptr, t_vals, rays_o, rays_d, vdir, s_pos, p_pos,
                         s_view, p_view, static_cast<const bf16*>(weights), biases, raw_rgb,
                         raw_sigma, static_cast<bf16*>(act), static_cast<uint8_t*>(mask), n_rows,
                         samples_per_ray};
  int err = launch_forward<Stage::T_VALS>(fa, grid, stream);
  if (err != 0) return err;
  const int rays_per_block = 4;
  const float dcomp_scale = static_cast<float>(2.0 / (n_rays * 3.0));
  composite_kernel<<<(n_rays + rays_per_block - 1) / rays_per_block, 32 * rays_per_block, 0,
                     stream>>>(raw_rgb, raw_sigma, t_vals, target, g, out_weights, sq_err_sum,
                               n_rays, samples_per_ray, white_bkgd, dcomp_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const sm90::BwdArgs ba{g, static_cast<const bf16*>(weights), static_cast<const bf16*>(act),
                         static_cast<const uint8_t*>(mask), static_cast<bf16*>(grad), gw, n_rows};
  return launch_backward(ba, items, n_items, grid, stream);
}

// The MLP backward alone: forward recomputed from xyz (n_rows, 3) and per-ray
// vdir, then gw = sum over rows of d(raw . g) / d(weights, biases) for the
// cotangent g (n_rows, 4) = (g_rgb, g_sigma).
extern "C" int aon_mlp_bwd_launch(const float* xyz, const float* vdir, const float* g,
                                  const float* s_pos, const float* p_pos, const float* s_view,
                                  const float* p_view, const void* weights, const float* biases,
                                  float* raw_rgb, float* raw_sigma, void* act, void* grad,
                                  void* mask, float* gw, const int* items, int n_items,
                                  long long n_rows, int samples_per_ray, int grid, void* stream_) {
  if (n_rows <= 0) return 0;
  if (samples_per_ray <= 0 || grid <= 0 || n_items <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const sm90::FwdArgs fa{nullptr, nullptr, xyz, nullptr, nullptr, nullptr, vdir, s_pos, p_pos,
                         s_view, p_view, static_cast<const bf16*>(weights), biases, raw_rgb,
                         raw_sigma, static_cast<bf16*>(act), static_cast<uint8_t*>(mask), n_rows,
                         samples_per_ray};
  const int err = launch_forward<Stage::XYZ>(fa, grid, stream);
  if (err != 0) return err;
  const sm90::BwdArgs ba{g, static_cast<const bf16*>(weights), static_cast<const bf16*>(act),
                         static_cast<const uint8_t*>(mask), static_cast<bf16*>(grad), gw, n_rows};
  return launch_backward(ba, items, n_items, grid, stream);
}

// The MLP backward from given encodings enc (n_rows, 64) and venc (n_rows, 32)
// f32 (kernel table row 6): the forward recomputed from them, then gw as for
// aon_mlp_bwd_launch.
extern "C" int aon_mlp_bwd_enc_launch(const float* enc, const float* venc, const float* g,
                                      const void* weights, const float* biases, float* raw_rgb,
                                      float* raw_sigma, void* act, void* grad, void* mask,
                                      float* gw, const int* items, int n_items, long long n_rows,
                                      int grid, void* stream_) {
  if (n_rows <= 0) return 0;
  if (grid <= 0 || n_items <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const sm90::FwdArgs fa{enc, venc, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, static_cast<const bf16*>(weights), biases,
                         raw_rgb, raw_sigma, static_cast<bf16*>(act),
                         static_cast<uint8_t*>(mask), n_rows, 1};
  const int err = launch_forward<Stage::ENC>(fa, grid, stream);
  if (err != 0) return err;
  const sm90::BwdArgs ba{g, static_cast<const bf16*>(weights), static_cast<const bf16*>(act),
                         static_cast<const uint8_t*>(mask), static_cast<bf16*>(grad), gw, n_rows};
  return launch_backward(ba, items, n_items, grid, stream);
}

// The weight gradients alone over given blocked workspaces act and grad:
// gw += X^T D for every item (ops/train_sm90.py
// weight_grads, the check of the wgmma layouts it reads).
extern "C" int aon_wgrad_run(const void* act, const void* grad, float* gw, const int* items,
                             int n_items, void* stream_) {
  if (n_items <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = cudaFuncSetAttribute(sm90::wgrad_kernel<>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sm90::WGRAD_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  sm90::wgrad_kernel<> <<<static_cast<unsigned>(n_items), sm90::WGRAD_THREADS,
                       sm90::WGRAD_SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(act), static_cast<const bf16*>(grad), gw, items);
  return static_cast<int>(cudaGetLastError());
}
