// Fused vanilla NeRF MLP eval forward for Hopper (sm_90a), with five ways of
// staging its input and three bodies, and the positional encoding alone.
//
// Replaces six TPU kernels that run one trunk (`_mlp_compute` in
// aon_tpu/ops/fused_mlp.py, or a variant of it) and differ in how they stage
// the encodings or in the body:
//   * `_kernel_xyz_flat` (aon_tpu/ops/fused_mlp_train.py, reached through
//     fused_nerf_mlp_xyz_eval -> _fwd_call_xyz): raw xyz per sample and a
//     per-ray viewdir, both encoded in the kernel (kernel table row 1);
//   * `_kernel_xyz_per_ray` (fused_mlp.py, reached through
//     fused_nerf_mlp_xyz): the same inputs, the same staging (row 8);
//   * `_kernel` (fused_mlp.py, reached through fused_nerf_mlp and the
//     forward of fused_mlp_train): per-sample encodings (row 5);
//   * `_kernel_per_ray` (fused_mlp.py, reached through
//     fused_nerf_mlp_per_ray): per-sample position encodings and per-ray
//     view encodings (row 7);
//   * the inner `kernel` of `_make_fwd` (scripts/bench_kernels.py): row 5's
//     function with one of three bodies, `_mlp_body`, `_mlp_body_2s` or
//     `_mlp_body_bf16acc` (row 12, template argument Body);
//   * the inner `kernel` of `bench_xyz_body` (scripts/bench_kernels.py):
//     raw xyz and viewdir per sample, encoded by `_encode_in_kernel`,
//     `_encode_mxu` or `_encode_doubling` (row 13, stagings XYZ, XYZ_MXU,
//     XYZ_DOUBLING with one sample per ray);
// and, through `posenc_kernel`, the encoding alone of the test wrapper in
// tests_tpu/test_kernel_parity.py (row 14), with any of the three encoders.
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
// XYZ_MXU and XYZ_DOUBLING: the XYZ staging with the bench's two other
// encoders (`encode_mxu`, `encode_doubling_coord` below).
//
// Body (row 12).  BASE is the trunk of mlp_common.cuh.  TWO_STREAM is
// `_mlp_body_2s`: the tile's two halves of 32 rows go through the layer
// chain as two independent streams, warps 0-3 on rows 0-31 and warps 4-7 on
// rows 32-63, each group synchronised by its own named barrier, so one
// half's bias/relu/store overlaps the other half's products.  Per row it
// computes what BASE computes, with K in the same order: bit-identical.
// BF16ACC is `_mlp_body_bf16acc`: each trunk and view product is rounded to
// bf16 as it leaves its f32 accumulator (Hopper's bf16 MMA has no bf16
// accumulator; XLA's bf16-output dot rounds the f32 sum once), the bias is
// rounded to bf16, and the sums and the relu are bf16, rounded after each
// add.  The skip and view layers add two such products, each rounded apart:
// the second product is parked as bf16 in the layer's output tile and added
// in the first one's epilogue.  The density head and the bottleneck stay f32
// as in BASE.
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

enum class Staging { XYZ, ENC, ENC_PER_RAY, XYZ_MXU, XYZ_DOUBLING };
enum class Body { BASE, TWO_STREAM, BF16ACC };
// the encoder argument of the launchers: 0 elementwise, 1 MXU, 2 doubling
enum Encoder { ENCODER_ELEMENTWISE = 0, ENCODER_MXU = 1, ENCODER_DOUBLING = 2 };

constexpr float INV_TWO_PI = static_cast<float>(1.0 / (2.0 * 3.14159265358979));

// One channel of `_encode_mxu`: pre is the product x4 @ s + p, which the
// bench states in float32 and which interpret mode on the CPU computes in
// float32: every column of s holds one nonzero, a power of two, so the
// product is exact and equals `encode_pre`.  (On a TPU at default precision
// this float32 product would run as bf16 passes and round the coordinates.)
// The reduction multiplies by the float32 reciprocal of 2pi instead of
// dividing by 2pi.
__device__ __forceinline__ float encode_mxu(float x0, float x1, float x2,
                                            const float* __restrict__ s,
                                            const float* __restrict__ p, int width, int col) {
  const float pre = encode_pre(x0, x1, x2, s, p, width, col);
  if (col < 3) return pre;
  const float k = floorf(__fadd_rn(__fmul_rn(pre, INV_TWO_PI), 0.5f));
  return sinf(__fmaf_rn(-TWO_PI, k, pre));
}

// Every column of `_encode_doubling` that reads coordinate c of x, handed to
// write(col, value): the identity column c, the sine and cosine of x_c * 2^d
// for d < deg by the doubling recurrences s' = 2sc, c' = 1 - 2s^2 from the
// sine and cosine of the reduced x_c (two transcendentals per coordinate),
// and the padding columns past 3 + 6 deg, which carry x_c itself (the JAX
// encoder fills them with the raw coordinate of their column; the packed
// weights' zero rows make that harmless).  Every rounding is explicit.
template <typename Write>
__device__ __forceinline__ void encode_doubling_coord(float xc, int c, int width, Write write) {
  const int deg = (width / 3 - 1) / 2;  // 64 -> 10, 32 -> 4
  write(c, xc);
  const float k = floorf(__fadd_rn(__fmul_rn(xc, INV_TWO_PI), 0.5f));
  const float r = __fmaf_rn(-TWO_PI, k, xc);
  float sn = sinf(r), cs = cosf(r);
  for (int d = 0; d < deg; ++d) {
    write(3 + 3 * d + c, sn);
    write(3 + 3 * deg + 3 * d + c, cs);
    const float two_s = __fmul_rn(2.0f, sn);
    const float s_next = __fmul_rn(two_s, cs);
    cs = __fsub_rn(1.0f, __fmul_rn(two_s, sn));
    sn = s_next;
  }
  for (int col = 3 + 6 * deg; col < width; ++col)
    if ((col - 3) % 3 == c) write(col, xc);
}

// Barrier of one stream of the body: the whole block, or the 128 threads of
// one half (named barriers 1 and 2; 0 is __syncthreads).
template <int GROUPS>
__device__ __forceinline__ void stream_sync(int group) {
  if constexpr (GROUPS == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(THREADS / GROUPS) : "memory");
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// BF16ACC epilogue: out = relu(bf16(bf16(bf16(acc) [+ out]) + bf16(bias)));
// with PARK the product alone, bf16(acc), goes to out for the next product's
// epilogue to add.
template <bool PARK, bool ADD, int R, int NT>
__device__ __forceinline__ void store_bf16acc(FragC (&acc)[R][NT], const float* __restrict__ bias,
                                              bf16* out, int col0, float* scratch, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(scratch, acc[r][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = 16 * r + (e >> 4), col = col0 + 16 * j + (e & 15);
        float v = round_bf16(scratch[e]);
        if (!PARK) {
          if (ADD) v = round_bf16(__fadd_rn(v, __bfloat162float(out[row * LDH + col])));
          v = fmaxf(round_bf16(__fadd_rn(v, round_bf16(__ldg(bias + col)))), 0.0f);
        }
        out[row * LDH + col] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

// One layer's epilogue of the variant bodies: BF16ACC's, or BASE's
// bf16(act(acc + bias)).
template <Body B, bool ADD, int R, int NT>
__device__ __forceinline__ void store_layer(FragC (&acc)[R][NT], const float* __restrict__ bias,
                                            bool relu, bf16* out, int col0, float* scratch,
                                            int lane) {
  if constexpr (B == Body::BF16ACC)
    store_bf16acc<false, ADD>(acc, bias, out, col0, scratch, lane);
  else
    store_bias_act<false>(acc, bias, relu, out, LDH, col0, scratch, lane);
}

// The whole MLP forward over the tile, for the bodies TWO_STREAM and BF16ACC
// (BASE is mlp_forward of mlp_common.cuh).  A stream is GROUP_WARPS warps on
// R 16-row tiles; each warp owns NT 16-column tiles of a 256-wide layer and
// NTV of the 128-wide view layer.  Activations alternate between sm.h[0] and
// sm.h[1], as in trunk_forward.
template <Body B>
__device__ __forceinline__ void variant_forward(Smem& sm, const bf16* __restrict__ W,
                                                const float* __restrict__ bias,
                                                float* __restrict__ out_rgb,
                                                float* __restrict__ out_sigma, long long row0,
                                                long long n_rows) {
  constexpr int GROUPS = B == Body::TWO_STREAM ? 2 : 1;
  constexpr int GROUP_WARPS = WARPS / GROUPS;
  constexpr int R = RT / GROUPS;
  constexpr int NT = WIDTH / 16 / GROUP_WARPS;
  constexpr int NTV = COND / 16 / GROUP_WARPS;
  constexpr bool SPLIT = B == Body::BF16ACC;  // two separately rounded products
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / GROUP_WARPS;
  const int first = 16 * R * group;  // the stream's first row of the tile
  const int col0 = 16 * NT * (warp % GROUP_WARPS);
  const int vcol0 = 16 * NTV * (warp % GROUP_WARPS);
  float* scratch = sm.scratch[warp];
  const bf16* enc = sm.enc + first * LDE;
  const bf16* venc = sm.venc + first * LDV;
  bf16* hin = sm.h[0] + first * LDH;
  bf16* hout = sm.h[1] + first * LDH;
  FragC acc[R][NT];

  zero(acc);
  mma_tile(acc, enc, LDE, POS_PAD, W + OFF_W0, WIDTH, col0);
  store_layer<B, false>(acc, bias, true, hin, col0, scratch, lane);
  stream_sync<GROUPS>(group);

#pragma unroll 1
  for (int layer = 1; layer < 8; ++layer) {
    const bool skip = layer == 5;  // layer5(cat[h, enc]) == h @ w5a + enc @ w5b
    if (SPLIT && skip) {
      zero(acc);
      mma_tile(acc, enc, LDE, POS_PAD, W + OFF_W5B, WIDTH, col0);
      store_bf16acc<true, false>(acc, nullptr, hout, col0, scratch, lane);
    }
    zero(acc);
    mma_tile(acc, hin, LDH, WIDTH, W + trunk_offset(layer), WIDTH, col0);
    if (!SPLIT && skip) mma_tile(acc, enc, LDE, POS_PAD, W + OFF_W5B, WIDTH, col0);
    if (SPLIT && skip)
      store_layer<B, true>(acc, bias + layer * WIDTH, true, hout, col0, scratch, lane);
    else
      store_layer<B, false>(acc, bias + layer * WIDTH, true, hout, col0, scratch, lane);
    stream_sync<GROUPS>(group);
    bf16* t = hin; hin = hout; hout = t;
  }

  // hin holds h7: the bottleneck (f32 + bias, rounded) goes to hout, then the
  // density head reads h7
  zero(acc);
  mma_tile(acc, hin, LDH, WIDTH, W + OFF_WB, WIDTH, col0);
  store_bias_act<false>(acc, bias + OFF_BB, false, hout, LDH, col0, scratch, lane);
  density_head(sm.h[1], W, bias, out_sigma, row0, n_rows);
  stream_sync<GROUPS>(group);
  { bf16* t = hin; hin = hout; hout = t; }

  // view layer: v = relu(bott @ wva + venc @ wvb + bv) into sm.h[1]
  FragC vacc[R][NTV];
  if (SPLIT) {
    zero(vacc);
    mma_tile(vacc, venc, LDV, VIEW_PAD, W + OFF_WVB, COND, vcol0);
    store_bf16acc<true, false>(vacc, nullptr, hout, vcol0, scratch, lane);
  }
  zero(vacc);
  mma_tile(vacc, hin, LDH, WIDTH, W + OFF_WVA, COND, vcol0);
  if (!SPLIT) mma_tile(vacc, venc, LDV, VIEW_PAD, W + OFF_WVB, COND, vcol0);
  store_layer<B, SPLIT>(vacc, bias + OFF_BV, true, hout, vcol0, scratch, lane);
  stream_sync<GROUPS>(group);
  rgb_head(sm.h[1], W, bias, out_rgb, row0, n_rows);
}

// in0 / in1: XYZ, XYZ_MXU, XYZ_DOUBLING: xyz (n_rows, 3) and per-ray vdir
// (B, 3); ENC: enc (n_rows, 64) and venc (n_rows, 32); ENC_PER_RAY: enc
// (n_rows, 64) and venc (B, 32).  Rows past the end repeat the last row.
template <Staging ST, Body B = Body::BASE>
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

  if constexpr (ST == Staging::XYZ_DOUBLING) {
    // one thread per (row, coordinate): TILE x 3 of each input
    for (int i = tid; i < 2 * TILE * 3; i += THREADS) {
      const bool view = i >= TILE * 3;
      const int r = (i % (TILE * 3)) / 3, c = i % 3;
      const long long g = min(row0 + r, n_rows - 1);
      if (view) {
        bf16* row = sm.venc + r * LDV;
        encode_doubling_coord(in1[3 * (g / samples_per_ray) + c], c, VIEW_PAD,
                              [row](int col, float v) { row[col] = __float2bfloat16_rn(v); });
      } else {
        bf16* row = sm.enc + r * LDE;
        encode_doubling_coord(in0[3 * g + c], c, POS_PAD,
                              [row](int col, float v) { row[col] = __float2bfloat16_rn(v); });
      }
    }
  } else {
    for (int i = tid; i < TILE * POS_PAD; i += THREADS) {
      const int r = i / POS_PAD, c = i % POS_PAD;
      const long long g = min(row0 + r, n_rows - 1);
      float v;
      if constexpr (ST == Staging::XYZ || ST == Staging::XYZ_MXU) {
        const float* x = in0 + 3 * g;
        v = ST == Staging::XYZ ? encode(x[0], x[1], x[2], s_pos, p_pos, POS_PAD, c)
                               : encode_mxu(x[0], x[1], x[2], s_pos, p_pos, POS_PAD, c);
      } else {
        v = in0[g * POS_PAD + c];
      }
      sm.enc[r * LDE + c] = __float2bfloat16_rn(v);
    }
    for (int i = tid; i < TILE * VIEW_PAD; i += THREADS) {
      const int r = i / VIEW_PAD, c = i % VIEW_PAD;
      const long long g = min(row0 + r, n_rows - 1);
      float v;
      if constexpr (ST == Staging::XYZ || ST == Staging::XYZ_MXU) {
        const float* d = in1 + 3 * (g / samples_per_ray);
        v = ST == Staging::XYZ ? encode(d[0], d[1], d[2], s_view, p_view, VIEW_PAD, c)
                               : encode_mxu(d[0], d[1], d[2], s_view, p_view, VIEW_PAD, c);
      } else if constexpr (ST == Staging::ENC) {
        v = in1[g * VIEW_PAD + c];
      } else {
        v = in1[(g / samples_per_ray) * VIEW_PAD + c];
      }
      sm.venc[r * LDV + c] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  if constexpr (B == Body::BASE)
    mlp_forward<false>(sm, W, bias, out_rgb, out_sigma, row0, n_rows, nullptr);
  else
    variant_forward<B>(sm, W, bias, out_rgb, out_sigma, row0, n_rows);
}

// The f32 encoding alone, (n, width), by one of the three encoders: one
// thread per element, or per (row, coordinate) for the doubling encoder.
__global__ void posenc_kernel(const float* __restrict__ x, const float* __restrict__ s,
                              const float* __restrict__ p, int width, long long n, int encoder,
                              float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (encoder == ENCODER_DOUBLING) {
    if (i >= n * 3) return;
    const long long r = i / 3;
    float* row = out + r * width;
    encode_doubling_coord(x[i], static_cast<int>(i % 3), width,
                          [row](int col, float v) { row[col] = v; });
    return;
  }
  if (i >= n * width) return;
  const long long r = i / width;
  const int col = static_cast<int>(i % width);
  out[i] = encoder == ENCODER_MXU
               ? encode_mxu(x[3 * r], x[3 * r + 1], x[3 * r + 2], s, p, width, col)
               : encode(x[3 * r], x[3 * r + 1], x[3 * r + 2], s, p, width, col);
}

template <Staging ST, Body B = Body::BASE>
int launch(const float* in0, const float* in1, const float* s_pos, const float* p_pos,
           const float* s_view, const float* p_view, const void* weights, const float* biases,
           float* out_rgb, float* out_sigma, long long n_rows, int samples_per_ray,
           void* stream) {
  if (n_rows <= 0) return 0;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(mlp_eval_kernel<ST, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + TILE - 1) / TILE;
  mlp_eval_kernel<ST, B><<<static_cast<unsigned>(blocks), THREADS, smem,
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

// Pre-encoded inputs, enc (n_rows, 64) and venc (n_rows, 32) f32, through
// one of the bench's three bodies: 0 `_mlp_body` (row 5's instance), 1
// `_mlp_body_2s`, 2 `_mlp_body_bf16acc`.  Kernel table row 12 (`_make_fwd`).
extern "C" int aon_mlp_body_launch(const float* enc, const float* venc, const void* weights,
                                   const float* biases, float* out_rgb, float* out_sigma,
                                   long long n_rows, int body, void* stream) {
  switch (body) {
    case 0:
      return launch<Staging::ENC, Body::BASE>(enc, venc, nullptr, nullptr, nullptr, nullptr,
                                              weights, biases, out_rgb, out_sigma, n_rows, 1,
                                              stream);
    case 1:
      return launch<Staging::ENC, Body::TWO_STREAM>(enc, venc, nullptr, nullptr, nullptr,
                                                    nullptr, weights, biases, out_rgb,
                                                    out_sigma, n_rows, 1, stream);
    case 2:
      return launch<Staging::ENC, Body::BF16ACC>(enc, venc, nullptr, nullptr, nullptr, nullptr,
                                                 weights, biases, out_rgb, out_sigma, n_rows, 1,
                                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Raw xyz (n_rows, 3) and viewdir (n_rows, 3) per sample, encoded in the
// kernel by one of the bench's three encoders (Encoder), then `_mlp_body`.
// Kernel table row 13 (`bench_xyz_body`).
extern "C" int aon_mlp_xyz_body_launch(const float* xyz, const float* vdir, const float* s_pos,
                                       const float* p_pos, const float* s_view,
                                       const float* p_view, const void* weights,
                                       const float* biases, float* out_rgb, float* out_sigma,
                                       long long n_rows, int encoder, void* stream) {
  switch (encoder) {
    case ENCODER_ELEMENTWISE:
      return launch<Staging::XYZ>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases,
                                  out_rgb, out_sigma, n_rows, 1, stream);
    case ENCODER_MXU:
      return launch<Staging::XYZ_MXU>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases,
                                      out_rgb, out_sigma, n_rows, 1, stream);
    case ENCODER_DOUBLING:
      return launch<Staging::XYZ_DOUBLING>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights,
                                           biases, out_rgb, out_sigma, n_rows, 1, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 encoding alone, (n, width), by one of the three encoders
// (Encoder): the check of the range reduction, kernel table row 14.
extern "C" int aon_posenc_launch(const float* x, const float* s, const float* p, int width,
                                 long long n, int encoder, float* out, void* stream) {
  if (n <= 0) return 0;
  if (encoder < ENCODER_ELEMENTWISE || encoder > ENCODER_DOUBLING)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = encoder == ENCODER_DOUBLING ? n * 3 : n * width;
  const long long blocks = (threads + 255) / 256;
  posenc_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, s, p, width, n, encoder, out);
  return static_cast<int>(cudaGetLastError());
}
