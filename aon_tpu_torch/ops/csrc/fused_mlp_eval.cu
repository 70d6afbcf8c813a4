// Fused vanilla NeRF MLP eval forward for Hopper (sm_90a), with three ways
// of staging its input.
//
// Replaces four TPU kernels that run one trunk (`_mlp_compute` in
// aon_tpu/ops/fused_mlp.py) and differ only in how they stage the encodings:
//   * `_kernel_xyz_flat` (aon_tpu/ops/fused_mlp_train.py, reached through
//     fused_nerf_mlp_xyz_eval -> _fwd_call_xyz): raw xyz per sample and a
//     per-ray viewdir, both encoded in the kernel (kernel table row 1);
//   * `_kernel_xyz_per_ray` (fused_mlp.py, reached through
//     fused_nerf_mlp_xyz): the same inputs, the same staging (row 8);
//   * `_kernel` (fused_mlp.py, reached through fused_nerf_mlp and the
//     forward of fused_mlp_train): per-sample encodings (row 5);
//   * `_kernel_per_ray` (fused_mlp.py, reached through
//     fused_nerf_mlp_per_ray): per-sample position encodings and per-ray
//     view encodings (row 7).
//
// Per sample row: the 8x256 trunk with the skip after layer 4, the density
// head, the bottleneck, the 1x128 view layer and the rgb head.  Matmul
// operands are bf16 with f32 accumulation and activations are rounded to
// bf16 between layers, as `_mlp_compute` does with bf16 weights.
//
// Staging.  XYZ: positional encoding of xyz (degree 10) and of the ray's
// viewdir (degree 4) in f32 (`encode`), then rounded to bf16; the viewdir is
// gathered per ray in f32 before it is encoded, the f32 selection product of
// `_kernel_xyz_per_ray`.  ENC: the given f32 (n_rows, 64) and (n_rows, 32)
// encodings rounded to bf16.  ENC_PER_RAY: the same, with the view encoding's
// row `row / samples_per_ray` of a (B, 32) array; the TPU kernel expands it
// with a 0/1 selection product in the compute dtype, which is exact on the
// rounded values, so a gather of the bf16-rounded row is the same thing.
//
// Bound on the H100: operations.  About 1.19 MFLOP per sample (padded K)
// against 12-384 B in and 16 B out, so the tensor cores, not HBM, set the
// floor (the 384 B of ENC are ~1.4 ms of HBM per 11.9 M rows against ~14 ms
// of bf16 MMA at the peak).  Design for that: every activation stays in
// shared memory (a double buffer of TILE x 256 bf16); only the staged inputs
// go in and four floats per sample come out.  Each block takes TILE = 64
// samples; each of its 8 warps owns 32 output columns of a 256-wide layer for
// all 64 rows, so one B fragment feeds four mma.sync tiles.  The packed
// weights (1.19 MB bf16) are read as WMMA fragments straight from global
// memory and stay resident in L2.  This is the simple first version: no TMA,
// no wgmma, no weight staging in shared memory.
//
// Precision and the shared forward: mlp_common.cuh.

#include "mlp_common.cuh"

using namespace aon;

namespace {

enum class Staging { XYZ, ENC, ENC_PER_RAY };

// in0 / in1: XYZ: xyz (n_rows, 3) and per-ray vdir (B, 3); ENC: enc
// (n_rows, 64) and venc (n_rows, 32); ENC_PER_RAY: enc (n_rows, 64) and venc
// (B, 32).  Rows past the end repeat the last row.
template <Staging ST>
__global__ void __launch_bounds__(THREADS, 2)
mlp_eval_kernel(const float* __restrict__ in0, const float* __restrict__ in1,
                const float* __restrict__ s_pos, const float* __restrict__ p_pos,
                const float* __restrict__ s_view, const float* __restrict__ p_view,
                const bf16* __restrict__ W, const float* __restrict__ bias,
                float* __restrict__ out_rgb, float* __restrict__ out_sigma,
                long long n_rows, int samples_per_ray) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;

  for (int i = tid; i < TILE * POS_PAD; i += THREADS) {
    const int r = i / POS_PAD, c = i % POS_PAD;
    const long long g = min(row0 + r, n_rows - 1);
    float v;
    if constexpr (ST == Staging::XYZ) {
      const float* x = in0 + 3 * g;
      v = encode(x[0], x[1], x[2], s_pos, p_pos, POS_PAD, c);
    } else {
      v = in0[g * POS_PAD + c];
    }
    sm.enc[r * LDE + c] = __float2bfloat16_rn(v);
  }
  for (int i = tid; i < TILE * VIEW_PAD; i += THREADS) {
    const int r = i / VIEW_PAD, c = i % VIEW_PAD;
    const long long g = min(row0 + r, n_rows - 1);
    float v;
    if constexpr (ST == Staging::XYZ) {
      const float* d = in1 + 3 * (g / samples_per_ray);
      v = encode(d[0], d[1], d[2], s_view, p_view, VIEW_PAD, c);
    } else if constexpr (ST == Staging::ENC) {
      v = in1[g * VIEW_PAD + c];
    } else {
      v = in1[(g / samples_per_ray) * VIEW_PAD + c];
    }
    sm.venc[r * LDV + c] = __float2bfloat16_rn(v);
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

template <Staging ST>
int launch(const float* in0, const float* in1, const float* s_pos, const float* p_pos,
           const float* s_view, const float* p_view, const void* weights, const float* biases,
           float* out_rgb, float* out_sigma, long long n_rows, int samples_per_ray,
           void* stream) {
  if (n_rows <= 0) return 0;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(mlp_eval_kernel<ST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + TILE - 1) / TILE;
  mlp_eval_kernel<ST><<<static_cast<unsigned>(blocks), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      in0, in1, s_pos, p_pos, s_view, p_view, static_cast<const bf16*>(weights), biases,
      out_rgb, out_sigma, n_rows, samples_per_ray);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// raw_rgb (n_rows, 3) and raw_sigma (n_rows, 1) for n_rows = B * samples_per_ray
// sample coordinates xyz (n_rows, 3) and per-ray viewdirs vdir (B, 3).
// Kernel table row 1 (fused_nerf_mlp_xyz_eval).
extern "C" int aon_mlp_eval_launch(const float* xyz, const float* vdir, const float* s_pos,
                                   const float* p_pos, const float* s_view, const float* p_view,
                                   const void* weights, const float* biases, float* out_rgb,
                                   float* out_sigma, long long n_rows, int samples_per_ray,
                                   void* stream) {
  return launch<Staging::XYZ>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases, out_rgb,
                              out_sigma, n_rows, samples_per_ray, stream);
}

// The same function from the same inputs, launched through its own entry so
// that its launches are counted apart: kernel table row 8 (fused_nerf_mlp_xyz).
extern "C" int aon_mlp_xyz_per_ray_launch(const float* xyz, const float* vdir,
                                          const float* s_pos, const float* p_pos,
                                          const float* s_view, const float* p_view,
                                          const void* weights, const float* biases,
                                          float* out_rgb, float* out_sigma, long long n_rows,
                                          int samples_per_ray, void* stream) {
  return launch<Staging::XYZ>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases, out_rgb,
                              out_sigma, n_rows, samples_per_ray, stream);
}

// Pre-encoded inputs: enc (n_rows, 64) and venc (n_rows, 32) f32.  Kernel
// table row 5 (fused_nerf_mlp, the forward of fused_mlp_train).
extern "C" int aon_mlp_enc_launch(const float* enc, const float* venc, const void* weights,
                                  const float* biases, float* out_rgb, float* out_sigma,
                                  long long n_rows, void* stream) {
  return launch<Staging::ENC>(enc, venc, nullptr, nullptr, nullptr, nullptr, weights, biases,
                              out_rgb, out_sigma, n_rows, 1, stream);
}

// Pre-encoded inputs with per-ray view encodings: enc (n_rows, 64) and venc
// (B, 32) f32 for n_rows = B * samples_per_ray.  Kernel table row 7
// (fused_nerf_mlp_per_ray).
extern "C" int aon_mlp_enc_per_ray_launch(const float* enc, const float* venc,
                                          const void* weights, const float* biases,
                                          float* out_rgb, float* out_sigma, long long n_rows,
                                          int samples_per_ray, void* stream) {
  return launch<Staging::ENC_PER_RAY>(enc, venc, nullptr, nullptr, nullptr, nullptr, weights,
                                      biases, out_rgb, out_sigma, n_rows, samples_per_ray,
                                      stream);
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
