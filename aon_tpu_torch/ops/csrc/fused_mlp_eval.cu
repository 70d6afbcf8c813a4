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
// and, through `posenc_cols_kernel` and `posenc_doubling_kernel`, the
// encoding alone of the test wrapper in tests_tpu/test_kernel_parity.py
// (row 14), with any of the three encoders.
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
// Body (row 12): BASE, TWO_STREAM (`_mlp_body_2s`) or BF16ACC
// (`_mlp_body_bf16acc`), the trunk's template argument (trunk_sm90.cuh).
// Rows 1, 5, 7, 8 and 13 compute `_mlp_body`'s function on the two-stream
// schedule (MAIN_PATH): per row it is BASE's arithmetic in BASE's order, bit
// for bit, and it measured 10-14% faster than the lockstep BASE on every one
// of them (its ping-pong overlaps one warpgroup's epilogues and staging with
// the other's products); row 12's `base` keeps the lockstep schedule of the
// bench's own `_mlp_body`.
//
// Bound on the H100: operations.  About 1.19 MFLOP per sample (padded K)
// against 12-384 B in and 16 B out, so the tensor cores, not HBM, set the
// floor (the 384 B of ENC are ~1.4 ms of HBM per 11.9 M rows against ~14 ms
// of bf16 MMA at the peak).  Design for that (trunk_sm90.cuh): one persistent
// block per SM, two consumer warpgroups on wgmma over 128-row tiles, the
// weights streamed into a ring of shared-memory slabs by a producer thread,
// every activation kept on chip; only the staged inputs go in and four
// floats per sample come out.  Each consumer warpgroup stages its own 64
// rows of a tile into its swizzled enc / venc tiles before the layer chain.
//
// Precision and the encoders: mlp_common.cuh.

#include "trunk_sm90.cuh"

using namespace aon;
using sm90::Body;

namespace {

enum class Staging { XYZ, ENC, ENC_PER_RAY, XYZ_MXU, XYZ_DOUBLING };
constexpr Body MAIN_PATH = Body::TWO_STREAM;  // the schedule of rows 1, 5, 7, 8 and 13
// the encoder argument of the launchers: 0 elementwise, 1 MXU, 2 doubling
enum Encoder { ENCODER_ELEMENTWISE = 0, ENCODER_MXU = 1, ENCODER_DOUBLING = 2 };

constexpr float INV_TWO_PI = static_cast<float>(1.0 / (2.0 * 3.14159265358979));
// row 14's kernels: threads a block, and blocks an SM (a register budget of
// 64 a thread), which aon_tpu_torch/ops/fused_mlp_train.py::posenc_plan mirrors
constexpr int POSENC_THREADS = 256;
constexpr int POSENC_BLOCKS_PER_SM = 4;

// One channel of `_encode_mxu`: pre is the product x4 @ s + p, which the
// bench states in float32 and which interpret mode on the CPU computes in
// float32: every column of s holds one nonzero, a power of two, so the
// product is exact and equals `encode_pre`.  (On a TPU at default precision
// this float32 product would run as bf16 passes and round the coordinates.)
// The reduction multiplies by the float32 reciprocal of 2pi instead of
// dividing by 2pi.
__device__ __forceinline__ float encode_mxu_from_pre(float pre, int col) {
  if (col < 3) return pre;
  const float k = floorf(__fadd_rn(__fmul_rn(pre, INV_TWO_PI), 0.5f));
  return sinf(__fmaf_rn(-TWO_PI, k, pre));
}

__device__ __forceinline__ float encode_mxu(float x0, float x1, float x2,
                                            const float* __restrict__ s,
                                            const float* __restrict__ p, int width, int col) {
  return encode_mxu_from_pre(encode_pre(x0, x1, x2, s, p, width, col), col);
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

// Writes one warpgroup's 64 rows of a tile, row0 .. row0 + 63, into its
// swizzled bf16 enc / venc tiles; rows past the end repeat the last row.
// in0 / in1: XYZ, XYZ_MXU, XYZ_DOUBLING: xyz (n_rows, 3) and per-ray vdir
// (B, 3); ENC: enc (n_rows, 64) and venc (n_rows, 32); ENC_PER_RAY: enc
// (n_rows, 64) and venc (B, 32).  Each thread keeps one column, so its
// encoding constants load once; every global load of the tile is issued
// before the first value is used (the staging is latency-bound, not
// throughput-bound): the ENC loops unroll whole, and in the XYZ stagings
// each lane loads one row's coordinates, which the warp then shares by
// shuffles.
template <Staging ST>
__device__ __forceinline__ void stage_rows(const sm90::Consumer& c, const float* __restrict__ in0,
                                           const float* __restrict__ in1,
                                           const float* __restrict__ s_pos,
                                           const float* __restrict__ p_pos,
                                           const float* __restrict__ s_view,
                                           const float* __restrict__ p_view, long long row0,
                                           long long n_rows, int samples_per_ray) {
  constexpr int ROWS = sm90::WG_ROWS;
  uint8_t* enc = c.enc();
  uint8_t* venc = c.venc();
  auto put = [](uint8_t* tile, int r, int col, float v) {
    *reinterpret_cast<bf16*>(tile + sm90::swizzled(r, col)) = __float2bfloat16_rn(v);
  };
  auto row = [&](int r) { return min(row0 + r, n_rows - 1); };
  if constexpr (ST == Staging::XYZ_DOUBLING) {
    // one thread per (row, coordinate) of each input
    for (int i = c.t; i < 2 * ROWS * 3; i += sm90::WG_THREADS) {
      const bool view = i >= ROWS * 3;
      const int r = (i % (ROWS * 3)) / 3, k = i % 3;
      const long long g = row(r);
      if (view)
        encode_doubling_coord(in1[3 * (g / samples_per_ray) + k], k, VIEW_PAD,
                              [&](int col, float v) { put(venc, r, col, v); });
      else
        encode_doubling_coord(in0[3 * g + k], k, POS_PAD,
                              [&](int col, float v) { put(enc, r, col, v); });
    }
  } else if constexpr (ST == Staging::XYZ || ST == Staging::XYZ_MXU) {
    auto enc_one = [](float x0, float x1, float x2, const float* s, const float* p, int width,
                      int col) {
      return ST == Staging::XYZ ? encode(x0, x1, x2, s, p, width, col)
                                : encode_mxu(x0, x1, x2, s, p, width, col);
    };
    // positions: warp w stages column 32 (w % 2) + lane of rows w / 2 + 2j,
    // j < 32; lane j loads row w / 2 + 2j
    const int col = 32 * (c.warp & 1) + c.lane;
    const long long gl = row((c.warp >> 1) + 2 * c.lane);
    const float xl0 = in0[3 * gl], xl1 = in0[3 * gl + 1], xl2 = in0[3 * gl + 2];
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const float x0 = __shfl_sync(0xffffffffu, xl0, j), x1 = __shfl_sync(0xffffffffu, xl1, j),
                  x2 = __shfl_sync(0xffffffffu, xl2, j);
      put(enc, (c.warp >> 1) + 2 * j, col, enc_one(x0, x1, x2, s_pos, p_pos, POS_PAD, col));
    }
    // view directions: warp w stages column lane of rows w + 4j, j < 16;
    // lane j (and j + 16) loads the ray of row w + 4j
    const float* d = in1 + 3 * (row(c.warp + 4 * (c.lane & 15)) / samples_per_ray);
    const float dl0 = d[0], dl1 = d[1], dl2 = d[2];
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const float d0 = __shfl_sync(0xffffffffu, dl0, j), d1 = __shfl_sync(0xffffffffu, dl1, j),
                  d2 = __shfl_sync(0xffffffffu, dl2, j);
      put(venc, c.warp + 4 * j, c.lane, enc_one(d0, d1, d2, s_view, p_view, VIEW_PAD, c.lane));
    }
  } else {
    const int col = c.t % POS_PAD;
    float v[ROWS * POS_PAD / sm90::WG_THREADS];
#pragma unroll
    for (int j = 0; j < ROWS * POS_PAD / sm90::WG_THREADS; ++j)
      v[j] = in0[row(c.t / POS_PAD + 2 * j) * POS_PAD + col];
#pragma unroll
    for (int j = 0; j < ROWS * POS_PAD / sm90::WG_THREADS; ++j)
      put(enc, c.t / POS_PAD + 2 * j, col, v[j]);
    const int vcol = c.t % VIEW_PAD;
    float w[ROWS * VIEW_PAD / sm90::WG_THREADS];
#pragma unroll
    for (int j = 0; j < ROWS * VIEW_PAD / sm90::WG_THREADS; ++j) {
      const long long g = row(c.t / VIEW_PAD + 4 * j);
      w[j] = in1[(ST == Staging::ENC ? g : g / samples_per_ray) * VIEW_PAD + vcol];
    }
#pragma unroll
    for (int j = 0; j < ROWS * VIEW_PAD / sm90::WG_THREADS; ++j)
      put(venc, c.t / VIEW_PAD + 4 * j, vcol, w[j]);
  }
}

// One persistent block per SM over the tiles blockIdx.x, + gridDim.x, ...;
// W is the eval blob (trunk_sm90.cuh), bias the f32 bias blob.
template <Staging ST, Body B>
__global__ void __launch_bounds__(sm90::THREADS, 1)
mlp_eval_kernel(const float* __restrict__ in0, const float* __restrict__ in1,
                const float* __restrict__ s_pos, const float* __restrict__ p_pos,
                const float* __restrict__ s_view, const float* __restrict__ p_view,
                const bf16* __restrict__ W, const float* __restrict__ bias,
                float* __restrict__ out_rgb, float* __restrict__ out_sigma,
                long long n_rows, int samples_per_ray) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_setup(smem_raw, W);
  const long long n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  // one branch per role for the kernel's whole life, as setmaxnreg needs
  if (threadIdx.x >= CONSUMER_THREADS) {
    producer_registers();
    if (threadIdx.x == CONSUMER_THREADS) produce(blk, W, n_tiles);
  } else {
    consumer_registers();
    Consumer c(blk);
    float acc[128];  // each layer's first wgmma writes it whole
    if constexpr (B == Body::TWO_STREAM)  // warpgroup 0 takes the first turn
      if (c.wg == 1) bar_arrive(BAR_TURN, CONSUMER_THREADS);
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long row0 = tile * TILE_ROWS + c.wg * WG_ROWS;
      c.sync();  // the last tile's products on enc / venc are done
      stage_rows<ST>(c, in0, in1, s_pos, p_pos, s_view, p_view, row0, n_rows, samples_per_ray);
      fence_async_shared();
      c.sync();
      trunk_tile<B>(c, acc, bias, out_rgb, out_sigma, row0, n_rows);
    }
    if constexpr (B == Body::TWO_STREAM)  // the turn warpgroup 1 handed over last
      if (c.wg == 0) bar_sync(BAR_TURN, CONSUMER_THREADS);
  }
}

// The f32 encoding alone, (n, width), by the elementwise or the MXU encoder
// (kernel table row 14, a check of the trunk's device functions).  Bound by
// bytes: 12 bytes in and 4 * width out a row.  Persistent blocks walk over
// the rows; each thread keeps four consecutive columns (their s and p in
// registers) and writes them as one 16-byte store, so a warp stores whole
// rows.  A warp's rows' coordinates load once, one per lane, and reach the
// row's threads by shuffles.  width / 4 divides 32 and is at least 4.
template <Encoder E>
__global__ void __launch_bounds__(POSENC_THREADS, POSENC_BLOCKS_PER_SM)
posenc_cols_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ p, int width, long long n,
                   float* __restrict__ out) {
  const int tpr = width >> 2;                 // threads a row
  const int warp_rows = 32 / tpr;             // rows a warp covers
  const int lane = threadIdx.x & 31, wr = lane / tpr;
  const int c0 = 4 * (lane - wr * tpr);
  float s0[4], s1[4], s2[4], pc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s0[k] = s[c0 + k];
    s1[k] = s[width + c0 + k];
    s2[k] = s[2 * width + c0 + k];
    pc[k] = p[c0 + k];
  }
  const int block_rows = (POSENC_THREADS / 32) * warp_rows;
  const long long step = static_cast<long long>(gridDim.x) * block_rows;
  for (long long row0 = static_cast<long long>(blockIdx.x) * block_rows +
                        (threadIdx.x >> 5) * warp_rows;
       row0 < n; row0 += step) {  // row0 is the warp's: the shuffles see whole warps
    const long long xi = 3 * row0 + lane;
    const float v = lane < 3 * warp_rows && xi < 3 * n ? x[xi] : 0.0f;
    const float x0 = __shfl_sync(0xffffffffu, v, 3 * wr);
    const float x1 = __shfl_sync(0xffffffffu, v, 3 * wr + 1);
    const float x2 = __shfl_sync(0xffffffffu, v, 3 * wr + 2);
    const long long row = row0 + wr;
    if (row < n) {
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float pre = encode_pre_v(x0, x1, x2, s0[k], s1[k], s2[k], pc[k]);
        o[k] = E == ENCODER_MXU ? encode_mxu_from_pre(pre, c0 + k) : encode_from_pre(pre, c0 + k);
      }
      *reinterpret_cast<float4*>(out + row * width + c0) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The doubling encoder's rows (row 14): a tile of POSENC_THREADS / 3 rows,
// one thread per (row, coordinate) writing through encode_doubling_coord
// into shared memory (rows width + 4 floats apart), then the tile leaves as
// one contiguous span of 16-byte stores.  Persistent blocks walk the tiles.
__global__ void __launch_bounds__(POSENC_THREADS)
posenc_doubling_kernel(const float* __restrict__ x, int width, long long n,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float tile[];
  constexpr int ROWS = POSENC_THREADS / 3;
  const int ld = width + 4, log_tpr = __ffs(width >> 2) - 1;
  for (long long r0 = static_cast<long long>(blockIdx.x) * ROWS; r0 < n;
       r0 += static_cast<long long>(gridDim.x) * ROWS) {
    const int rows = static_cast<int>(min(static_cast<long long>(ROWS), n - r0));
    if (threadIdx.x < 3 * rows) {
      const int r = threadIdx.x / 3;
      float* row = tile + r * ld;
      encode_doubling_coord(x[3 * r0 + threadIdx.x], threadIdx.x - 3 * r, width,
                            [row](int col, float v) { row[col] = v; });
    }
    __syncthreads();
    float* dst = out + r0 * width;
    for (int k = threadIdx.x; k < rows << log_tpr; k += POSENC_THREADS) {
      const int r = k >> log_tpr, q = k - (r << log_tpr);
      *reinterpret_cast<float4*>(dst + r * width + 4 * q) =
          *reinterpret_cast<const float4*>(tile + r * ld + 4 * q);
    }
    __syncthreads();
  }
}

// grid: the number of persistent blocks, at most one per SM and at most the
// number of 128-row tiles (aon_tpu_torch/ops/fused_mlp.py::eval_launch_shape).
template <Staging ST, Body B = MAIN_PATH>
int launch(const float* in0, const float* in1, const float* s_pos, const float* p_pos,
           const float* s_view, const float* p_view, const void* weights, const float* biases,
           float* out_rgb, float* out_sigma, long long n_rows, int samples_per_ray, int grid,
           void* stream) {
  if (n_rows <= 0) return 0;
  if (grid <= 0 || samples_per_ray <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_eval_kernel<ST, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_eval_kernel<ST, B><<<static_cast<unsigned>(grid), sm90::THREADS, sm90::SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      in0, in1, s_pos, p_pos, s_view, p_view, static_cast<const bf16*>(weights), biases,
      out_rgb, out_sigma, n_rows, samples_per_ray);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every MLP launcher takes the eval blob as `weights` (trunk_sm90.cuh) and
// `grid`, the number of persistent blocks.

// raw_rgb (n_rows, 3) and raw_sigma (n_rows, 1) for n_rows = B * samples_per_ray
// sample coordinates xyz (n_rows, 3) and per-ray viewdirs vdir (B, 3).
// Kernel table row 1 (fused_nerf_mlp_xyz_eval).
extern "C" int aon_mlp_eval_launch(const float* xyz, const float* vdir, const float* s_pos,
                                   const float* p_pos, const float* s_view, const float* p_view,
                                   const void* weights, const float* biases, float* out_rgb,
                                   float* out_sigma, long long n_rows, int samples_per_ray,
                                   int grid, void* stream) {
  return launch<Staging::XYZ>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases, out_rgb,
                              out_sigma, n_rows, samples_per_ray, grid, stream);
}

// The same function from the same inputs, launched through its own entry so
// that its launches are counted apart: kernel table row 8 (fused_nerf_mlp_xyz).
extern "C" int aon_mlp_xyz_per_ray_launch(const float* xyz, const float* vdir,
                                          const float* s_pos, const float* p_pos,
                                          const float* s_view, const float* p_view,
                                          const void* weights, const float* biases,
                                          float* out_rgb, float* out_sigma, long long n_rows,
                                          int samples_per_ray, int grid, void* stream) {
  return launch<Staging::XYZ>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases, out_rgb,
                              out_sigma, n_rows, samples_per_ray, grid, stream);
}

// Pre-encoded inputs: enc (n_rows, 64) and venc (n_rows, 32) f32.  Kernel
// table row 5 (fused_nerf_mlp, the forward of fused_mlp_train).
extern "C" int aon_mlp_enc_launch(const float* enc, const float* venc, const void* weights,
                                  const float* biases, float* out_rgb, float* out_sigma,
                                  long long n_rows, int grid, void* stream) {
  return launch<Staging::ENC>(enc, venc, nullptr, nullptr, nullptr, nullptr, weights, biases,
                              out_rgb, out_sigma, n_rows, 1, grid, stream);
}

// Pre-encoded inputs with per-ray view encodings: enc (n_rows, 64) and venc
// (B, 32) f32 for n_rows = B * samples_per_ray.  Kernel table row 7
// (fused_nerf_mlp_per_ray).
extern "C" int aon_mlp_enc_per_ray_launch(const float* enc, const float* venc,
                                          const void* weights, const float* biases,
                                          float* out_rgb, float* out_sigma, long long n_rows,
                                          int samples_per_ray, int grid, void* stream) {
  return launch<Staging::ENC_PER_RAY>(enc, venc, nullptr, nullptr, nullptr, nullptr, weights,
                                      biases, out_rgb, out_sigma, n_rows, samples_per_ray, grid,
                                      stream);
}

// Pre-encoded inputs, enc (n_rows, 64) and venc (n_rows, 32) f32, through
// one of the bench's three bodies: 0 `_mlp_body` (row 5's instance), 1
// `_mlp_body_2s`, 2 `_mlp_body_bf16acc`.  Kernel table row 12 (`_make_fwd`).
extern "C" int aon_mlp_body_launch(const float* enc, const float* venc, const void* weights,
                                   const float* biases, float* out_rgb, float* out_sigma,
                                   long long n_rows, int body, int grid, void* stream) {
  switch (body) {
    case 0:
      return launch<Staging::ENC, Body::BASE>(enc, venc, nullptr, nullptr, nullptr, nullptr,
                                              weights, biases, out_rgb, out_sigma, n_rows, 1,
                                              grid, stream);
    case 1:
      return launch<Staging::ENC, Body::TWO_STREAM>(enc, venc, nullptr, nullptr, nullptr,
                                                    nullptr, weights, biases, out_rgb,
                                                    out_sigma, n_rows, 1, grid, stream);
    case 2:
      return launch<Staging::ENC, Body::BF16ACC>(enc, venc, nullptr, nullptr, nullptr, nullptr,
                                                 weights, biases, out_rgb, out_sigma, n_rows, 1,
                                                 grid, stream);
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
                                       long long n_rows, int encoder, int grid, void* stream) {
  switch (encoder) {
    case ENCODER_ELEMENTWISE:
      return launch<Staging::XYZ>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases,
                                  out_rgb, out_sigma, n_rows, 1, grid, stream);
    case ENCODER_MXU:
      return launch<Staging::XYZ_MXU>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights, biases,
                                      out_rgb, out_sigma, n_rows, 1, grid, stream);
    case ENCODER_DOUBLING:
      return launch<Staging::XYZ_DOUBLING>(xyz, vdir, s_pos, p_pos, s_view, p_view, weights,
                                           biases, out_rgb, out_sigma, n_rows, 1, grid, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 encoding alone, (n, width), by one of the three encoders
// (Encoder) on `grid` persistent blocks (aon_tpu_torch/ops/fused_mlp_train.py::
// posenc_plan): the check of the range reduction, kernel table row 14.
extern "C" int aon_posenc_launch(const float* x, const float* s, const float* p, int width,
                                 long long n, int encoder, int grid, float* out, void* stream) {
  if (n <= 0) return 0;
  if (encoder < ENCODER_ELEMENTWISE || encoder > ENCODER_DOUBLING || grid < 1 ||
      width < 16 || width > 128 || (width & (width - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (encoder == ENCODER_DOUBLING) {
    const size_t smem = sizeof(float) * (POSENC_THREADS / 3) * (width + 4);
    posenc_doubling_kernel<<<grid, POSENC_THREADS, smem, st>>>(x, width, n, out);
  } else if (encoder == ENCODER_MXU) {
    posenc_cols_kernel<ENCODER_MXU><<<grid, POSENC_THREADS, 0, st>>>(x, s, p, width, n, out);
  } else {
    posenc_cols_kernel<ENCODER_ELEMENTWISE><<<grid, POSENC_THREADS, 0, st>>>(x, s, p, width, n,
                                                                            out);
  }
  return static_cast<int>(cudaGetLastError());
}
