// Fused vanilla NeRF MLP eval forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_xyz_flat` (aon_tpu/ops/fused_mlp_train.py,
// reached through fused_nerf_mlp_xyz_eval -> _fwd_call_xyz; body
// `_encode_in_kernel` + `_mlp_compute` in aon_tpu/ops/fused_mlp.py).
//
// Per sample row: positional encoding of xyz (degree 10) and of the ray's
// viewdir (degree 4) computed in f32, the 8x256 trunk with the skip after
// layer 4, the density head, the bottleneck, the 1x128 view layer and the
// rgb head.  Matmul operands are bf16 with f32 accumulation and activations
// are rounded to bf16 between layers, as `_mlp_compute` does.
//
// Bound on the H100: operations.  About 1.19 MFLOP per sample (padded K)
// against 16 B in and 16 B out, so the tensor cores, not HBM, set the floor.
// Design for that: every activation stays in shared memory (a double buffer
// of TILE x 256 bf16); only coordinates go in and four floats per sample come
// out.  Each block takes TILE = 64 samples; each of its 8 warps owns 32 output
// columns of a 256-wide layer for all 64 rows, so one B fragment feeds four
// mma.sync tiles.  The packed weights (1.19 MB bf16) are read as WMMA
// fragments straight from global memory and stay resident in L2.  This is the
// simple first version: no TMA, no wgmma, no weight staging in shared memory.
//
// Precision and the shared forward: mlp_common.cuh.

#include "mlp_common.cuh"

using namespace aon;

namespace {

__global__ void __launch_bounds__(THREADS, 2)
mlp_eval_kernel(const float* __restrict__ xyz, const float* __restrict__ vdir,
                const float* __restrict__ s_pos, const float* __restrict__ p_pos,
                const float* __restrict__ s_view, const float* __restrict__ p_view,
                const bf16* __restrict__ W, const float* __restrict__ bias,
                float* __restrict__ out_rgb, float* __restrict__ out_sigma,
                long long n_rows, int samples_per_ray) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;

  // Encodings of this tile's samples; rows past the end repeat the last row.
  for (int i = tid; i < TILE * POS_PAD; i += THREADS) {
    const int r = i / POS_PAD, c = i % POS_PAD;
    const float* x = xyz + 3 * min(row0 + r, n_rows - 1);
    sm.enc[r * LDE + c] = __float2bfloat16_rn(encode(x[0], x[1], x[2], s_pos, p_pos, POS_PAD, c));
  }
  for (int i = tid; i < TILE * VIEW_PAD; i += THREADS) {
    const int r = i / VIEW_PAD, c = i % VIEW_PAD;
    const float* v = vdir + 3 * (min(row0 + r, n_rows - 1) / samples_per_ray);
    sm.venc[r * LDV + c] =
        __float2bfloat16_rn(encode(v[0], v[1], v[2], s_view, p_view, VIEW_PAD, c));
  }
  __syncthreads();

  mlp_forward<false>(sm, W, bias, out_rgb, out_sigma, row0, n_rows, nullptr);
}

__global__ void posenc_kernel(const float* __restrict__ x, const float* __restrict__ s,
                              const float* __restrict__ p, int width, long long n,
                              float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * width) return;
  const long long r = i / width;
  out[i] = encode(x[3 * r], x[3 * r + 1], x[3 * r + 2], s, p, width, static_cast<int>(i % width));
}

}  // namespace

// raw_rgb (n_rows, 3) and raw_sigma (n_rows, 1) for n_rows = B * samples_per_ray
// sample coordinates xyz (n_rows, 3) and per-ray viewdirs vdir (B, 3).
extern "C" int aon_mlp_eval_launch(const float* xyz, const float* vdir, const float* s_pos,
                                   const float* p_pos, const float* s_view, const float* p_view,
                                   const void* weights, const float* biases, float* out_rgb,
                                   float* out_sigma, long long n_rows, int samples_per_ray,
                                   void* stream) {
  if (n_rows <= 0) return 0;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err =
      cudaFuncSetAttribute(mlp_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + TILE - 1) / TILE;
  mlp_eval_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      xyz, vdir, s_pos, p_pos, s_view, p_view, static_cast<const bf16*>(weights), biases,
      out_rgb, out_sigma, n_rows, samples_per_ray);
  return static_cast<int>(cudaGetLastError());
}

// The f32 encoding alone, (n, width), for checking the range reduction.
extern "C" int aon_posenc_launch(const float* x, const float* s, const float* p, int width,
                                 long long n, float* out, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n * width + 255) / 256;
  posenc_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, s, p, width, n, out);
  return static_cast<int>(cudaGetLastError());
}
