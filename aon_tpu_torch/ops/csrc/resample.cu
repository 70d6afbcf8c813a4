// Inverse-CDF fine sampling plus the sorted coarse/fine merge, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_resample_kernel` with its `_bitonic_merge_desc_asc`
// network (aon_tpu/ops/resample_pallas.py:85) and its wrapper `fused_resample`
// (:137), which builds the CDF in XLA before the kernel: here the fused entry
// (FUSED) builds the CDF inside the kernel from the bin weights, and the
// other entry takes a CDF, as the TPU kernel body does.
//
// Per ray: for each quantile u_j (ascending), lo = last bin with cdf <= u and
// hi = first bin with cdf > u (clamped to bins[0] / cdf 0 and bins[-1] /
// cdf 1 at the ends), t = clip((u - lo_cdf) / denom, 0, 1) (0 where
// denom <= 0), sample = lo_bin + t * (hi_bin - lo_bin).  The fine samples
// come out ascending because u is, so they merge with the ascending coarse
// t-values by rank: coarse i goes to i + #{fine < t_i}, fine j to
// j + #{coarse <= s_j}.  Both inputs must be sorted ascending, as for the
// TPU kernel's merge network.
//
// Bound on the H100: bytes.  About 1.5 KB per ray in and out (t, bins, the
// CDF or the weights, the quantiles, the union) against a few hundred
// comparisons.  The design keeps enough bytes in flight and writes only
// whole spans:
// - A block works on a tile of R consecutive rays (the planner,
//   ops/resample.py::resample_plan, picks R and the grid).  Each array's
//   tile is one span of global memory ((R - 1) * row stride + row length
//   floats), staged into shared memory by cp.async: 16 bytes at a time over
//   the span's aligned middle, 4 at a time for its head and tail, so any
//   base address and row length work.  Every copy of a tile is issued before
//   any is waited on.  (TMA bulk copies on an mbarrier, one thread issuing
//   each span, measured 3% slower: the copies' instructions do not bind.)
// - STAGES stages: the blocks are persistent and walk over the tiles, and
//   the next STAGES - 1 tiles' copies are in flight while this one is
//   searched and merged.  A shared quantile row (row stride 0, the eval
//   case) is staged once per block.
// - The CDF (FUSED): pdf_cdf's steps in its order, the sums sequential in
//   float32 (ops/resample.py::pdf_cdf_ordered is the twin): the sums one
//   lane per ray, the divisions spread over the block (build_cdfs), into
//   shared memory where the other entry stages its CDF.
// - One warp per ray searches and merges in shared memory.  Each lane takes
//   quantiles lane + 32 q and runs four branchless binary searches at once:
//   every search takes the same number of steps, so the four chains of
//   dependent loads overlap (a search followed by a forward walk over a run
//   of quantiles measured slower: one chain).  The union is a merge path:
//   each lane finds where its run of outputs starts with one binary search
//   along the diagonal, then merges its run.  The output tile in shared
//   memory leaves as one span of 16-byte stores: no scatter to global
//   memory.
// Arithmetic uses the _rn intrinsics so no FMA contraction moves a sample.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks an SM: a budget of 64 registers a thread (ops/resample.py mirrors it)
constexpr int BLOCKS_PER_SM = 4;
constexpr int STAGES = 2;
constexpr float CDF_EPS = 1e-5f;  // pdf_cdf's mass padding
constexpr int QB = 4;  // quantiles a lane searches at once

// A (n_rays, len) float array whose rows lie `stride` floats apart (0: one
// row shared by every ray), the last dimension contiguous.
struct Rows {
  const float* ptr;
  int stride;
  int len;
};

// Row stride of the built CDFs: odd, so that the lanes of warp 0, one per
// ray, store to distinct banks.
__host__ __device__ inline int cdf_stride(int n_bins) { return n_bins | 1; }

// Floats of a shared-memory region that holds `rays` rows of length `len`,
// `stride` floats apart, as one span at any of the four offsets within a
// 16-byte line, rounded to whole lines.
// ops/resample.py::_region mirrors this.
__host__ __device__ inline int region(int stride, int len, int rays) {
  return ((rays - 1) * stride + len + 6) / 4 * 4;
}

// Shared-memory layout in floats: STAGES x (t, bins, cdf or weights,
// per-ray u), then the shared u row, the CDF passes' per-ray padding and sum
// and the built CDFs (FUSED), the fine samples and the output tile.
// ops/resample.py::_smem_bytes mirrors this.
struct Layout {
  int t, b, c, u, stage, shared_u, stats, cdf, fine, out, total;
  __host__ __device__ Layout(const Rows& tv, const Rows& bins, const Rows& third, const Rows& u_,
                             bool fused, int rays, int n_out) {
    t = region(tv.stride, tv.len, rays);
    b = region(bins.stride, bins.len, rays);
    c = region(third.stride, third.len, rays);
    u = u_.stride ? region(u_.stride, u_.len, rays) : 0;
    stage = t + b + c + u;
    shared_u = u_.stride ? 0 : region(0, u_.len, 1);
    stats = fused ? (2 * rays + 3) / 4 * 4 : 0;
    cdf = fused ? (rays * cdf_stride(bins.len) + 3) / 4 * 4 : 0;
    fine = (rays * u_.len + 3) / 4 * 4;
    out = region(n_out, n_out, rays);
    total = STAGES * stage + shared_u + stats + cdf + fine + out;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's latest groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Where a span starting at `g` begins within its 16-byte line, in floats:
// element e of the span lives at region[shift(g) + e], so the span's
// aligned middle lands on aligned shared memory.
__device__ __forceinline__ int shift(const void* g) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// Issues the copies of the span src[0, n) into dst[shift(src) + e]: 16 bytes
// at a time over its aligned middle, 4 at a time for its head and tail.
__device__ __forceinline__ void stage_span(float* dst, const float* src, int n) {
  const int sh = shift(src);
  const int head = min((4 - sh) & 3, n);
  const int end = head + ((n - head) & ~3);
  const int tid = threadIdx.x;
  float* d = dst + sh;
  if (tid < head) cp_async4(d + tid, src + tid);
  for (int e = head + 4 * tid; e < end; e += 4 * THREADS) cp_async16(d + e, src + e);
  if (end + tid < n) cp_async4(d + end + tid, src + end + tid);
}

// Stores src[shift(dst) + e] to the span dst[0, n): 16 bytes at a time over
// its aligned middle.
__device__ __forceinline__ void store_span(float* dst, const float* src, int n) {
  const int sh = shift(dst);
  const int head = min((4 - sh) & 3, n);
  const int end = head + ((n - head) & ~3);
  const int tid = threadIdx.x;
  const float* s = src + sh;
  if (tid < head) dst[tid] = s[tid];
  for (int e = head + 4 * tid; e < end; e += 4 * THREADS)
    *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(s + e);
  if (end + tid < n) dst[end + tid] = s[end + tid];
}

__device__ __forceinline__ int span(const Rows& a, int rays) {
  return (rays - 1) * a.stride + a.len;
}

// pdf_cdf for a tile's rays in its order, in three passes over shared
// memory: (1) one lane of warp 0 per ray sums its n weights left to right and
// pads the sum to eps; (2) every warp divides its rays' padded weights by the
// padded sum, a lane per weight (the divisions are independent; one lane
// doing all of a ray's would serialise on the division's slow-path branch);
// (3) one lane of warp 0 per ray runs the running sum left to right, clamped
// at 1, with 0 and 1 at the ends (n + 1 values).  `stats` holds each ray's
// spread padding and padded sum between the passes.
__device__ __forceinline__ void build_cdfs(const float* w, int w_stride, int n, float* cdf,
                                           int cdf_ld, float* stats, int rays, int warp,
                                           int lane) {
  if (warp == 0) {
    for (int r = lane; r < rays; r += 32) {
      const float* wr = w + r * w_stride;
      float sum = wr[0];
#pragma unroll 4
      for (int k = 1; k < n; ++k) sum = __fadd_rn(sum, wr[k]);
      const float pad = fmaxf(__fsub_rn(CDF_EPS, sum), 0.0f);
      stats[2 * r] = __fdiv_rn(pad, static_cast<float>(n));
      stats[2 * r + 1] = __fadd_rn(sum, pad);
    }
  }
  __syncthreads();
  for (int r = warp; r < rays; r += WARPS) {
    const float* wr = w + r * w_stride;
    const float pad_each = stats[2 * r], total = stats[2 * r + 1];
    for (int k = lane; k < n - 1; k += 32)
      cdf[r * cdf_ld + k + 1] = __fdiv_rn(__fadd_rn(wr[k], pad_each), total);
  }
  __syncthreads();
  if (warp == 0) {
    for (int r = lane; r < rays; r += 32) {
      float* cr = cdf + r * cdf_ld;
      float acc = 0.0f;
      cr[0] = 0.0f;
#pragma unroll 4
      for (int k = 1; k < n; ++k) {
        acc = __fadd_rn(acc, cr[k]);
        cr[k] = fminf(acc, 1.0f);
      }
      cr[n] = 1.0f;
    }
  }
  __syncthreads();
}

// One ray by one warp: the fine samples sf (n_u) from the CDF, then the
// union into o (n_t + n_u).
__device__ __forceinline__ void resample_ray(const float* st, const float* sb, const float* sc,
                                             const float* su, float* sf, float* o, int n_t,
                                             int n_b, int n_u, int lane) {
  // the inverse CDF: lane takes quantiles lane + 32 q, QB at a time, with
  // interleaved branchless searches (the same steps for every lane and
  // quantile, no bounds to test, so the QB chains of shared-memory loads
  // overlap): lo = #{i : cdf_i <= u}
  for (int j0 = 0; j0 < n_u; j0 += 32 * QB) {
    float uq[QB];
    int lo[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      uq[q] = su[min(j0 + lane + 32 * q, n_u - 1)];
      lo[q] = 0;
    }
    for (int n = n_b; n > 1; n -= n >> 1) {  // lo + n - 1 < n_b throughout
      const int half = n >> 1;
#pragma unroll
      for (int q = 0; q < QB; ++q) lo[q] = sc[lo[q] + half - 1] <= uq[q] ? lo[q] + half : lo[q];
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) lo[q] += sc[lo[q]] <= uq[q];
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int j = j0 + lane + 32 * q;
      if (j >= n_u) continue;
      const float lo_cdf = lo[q] > 0 ? sc[lo[q] - 1] : 0.0f;
      const float lo_bin = lo[q] > 0 ? sb[lo[q] - 1] : sb[0];
      const float hi_cdf = lo[q] < n_b ? sc[lo[q]] : 1.0f;
      const float hi_bin = lo[q] < n_b ? sb[lo[q]] : sb[n_b - 1];
      const float denom = __fsub_rn(hi_cdf, lo_cdf);
      float t = 0.0f;
      if (denom > 0.0f) t = fminf(fmaxf(__fdiv_rn(__fsub_rn(uq[q], lo_cdf), denom), 0.0f), 1.0f);
      sf[j] = __fadd_rn(lo_bin, __fmul_rn(t, __fsub_rn(hi_bin, lo_bin)));
    }
  }
  __syncwarp();
  // the union by merge path: lane takes outputs [d0, d1); a coarse value
  // goes before a fine one it equals (coarse i at i + #{fine < t_i}, fine j
  // at j + #{coarse <= s_j})
  const int n_out = n_t + n_u, per = (n_out + 31) >> 5;
  const int d0 = min(lane * per, n_out), d1 = min(d0 + per, n_out);
  int lo = max(0, d0 - n_u), hi = min(d0, n_t);  // coarse among the first d0
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (st[mid] <= sf[d0 - mid - 1]) lo = mid + 1; else hi = mid;
  }
  int i = lo, j = d0 - lo;
  for (int d = d0; d < d1; ++d) {  // branchless: both heads load, clamped
    const float a = st[min(i, n_t - 1)], b = sf[min(j, n_u - 1)];
    const bool coarse = j >= n_u || (i < n_t && a <= b);
    o[d] = coarse ? a : b;
    i += coarse;
    j += !coarse;
  }
}

// FUSED: `third` holds the weights (n_bins - 1 a row), else the CDF (n_bins).
template <bool FUSED>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
resample_kernel(Rows tv, Rows bins, Rows third, Rows u, float* __restrict__ out,
                long long n_rays, int tile_rays) {
  extern __shared__ __align__(16) float smem[];
  const int n_t = tv.len, n_b = bins.len, n_u = u.len, n_out = n_t + n_u;
  const Layout L(tv, bins, third, u, FUSED, tile_rays, n_out);
  float* shared_u = smem + STAGES * L.stage;
  float* stats = shared_u + L.shared_u;
  float* cdf = stats + L.stats;
  float* fine = cdf + L.cdf;
  float* otile = fine + L.fine;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (n_rays + tile_rays - 1) / tile_rays;

  auto issue = [&](long long tile, int s) {
    const long long r0 = tile * tile_rays;
    const int rays = static_cast<int>(min(static_cast<long long>(tile_rays), n_rays - r0));
    float* base = smem + s * L.stage;
    stage_span(base, tv.ptr + r0 * tv.stride, span(tv, rays));
    stage_span(base + L.t, bins.ptr + r0 * bins.stride, span(bins, rays));
    stage_span(base + L.t + L.b, third.ptr + r0 * third.stride, span(third, rays));
    if (u.stride) stage_span(base + L.t + L.b + L.c, u.ptr + r0 * u.stride, span(u, rays));
  };

  long long tile = blockIdx.x;
  if (tile >= tiles) return;
  if (!u.stride) stage_span(shared_u, u.ptr, n_u);
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {  // the first STAGES - 1 tiles in flight
    if (tile + p * gridDim.x < tiles) issue(tile + p * gridDim.x, p);
    cp_async_commit();
  }
  for (int k = 0; tile < tiles; tile += gridDim.x, ++k) {
    const int s = k % STAGES;
    // the stage this refills was computed on last turn, before its barrier
    const long long ahead = tile + static_cast<long long>(STAGES - 1) * gridDim.x;
    if (ahead < tiles) issue(ahead, (k + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this tile's group
    __syncthreads();

    const long long r0 = tile * tile_rays;
    const int rays = static_cast<int>(min(static_cast<long long>(tile_rays), n_rays - r0));
    const float* base = smem + s * L.stage;
    const float* st = base + shift(tv.ptr + r0 * tv.stride);
    const float* sb = base + L.t + shift(bins.ptr + r0 * bins.stride);
    const float* s3 = base + L.t + L.b + shift(third.ptr + r0 * third.stride);
    const float* su = u.stride ? base + L.t + L.b + L.c + shift(u.ptr + r0 * u.stride)
                               : shared_u + shift(u.ptr);
    float* so = otile + shift(out + r0 * n_out);
    if constexpr (FUSED)
      build_cdfs(s3, third.stride, n_b - 1, cdf, cdf_stride(n_b), stats, rays, warp, lane);
    // a warp searches and merges rays warp, warp + WARPS, ...
    for (int r = warp; r < rays; r += WARPS) {
      const float* sc = FUSED ? cdf + r * cdf_stride(n_b) : s3 + r * third.stride;
      resample_ray(st + r * tv.stride, sb + r * bins.stride, sc, su + r * u.stride,
                   fine + r * n_u, so + r * n_out, n_t, n_b, n_u, lane);
    }
    __syncthreads();
    store_span(out + r0 * n_out, otile, rays * n_out);
  }
}

template <bool FUSED>
int launch(const Rows& tv, const Rows& bins, const Rows& third, const Rows& u, float* out,
           long long n_rays, int tile_rays, int grid, cudaStream_t stream) {
  const Layout L(tv, bins, third, u, FUSED, tile_rays, tv.len + u.len);
  const size_t smem = sizeof(float) * L.total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resample_kernel<FUSED><<<grid, THREADS, smem, stream>>>(tv, bins, third, u, out, n_rays,
                                                          tile_rays);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t_union (n_rays, n_t + n_u), contiguous, from t_vals (n_rays, n_t), bins
// (n_rays, n_bins), `third` (the CDF, n_bins a row; or with `fused` the
// weights, n_bins - 1 a row) and ascending quantiles u (n_u a row; row
// stride 0: one shared row), each with its own row stride in floats.
// tile_rays and grid: ops/resample.py::resample_plan.
extern "C" int aon_resample_launch(const float* t_vals, long long t_stride, const float* bins,
                                   long long b_stride, const float* third, long long c_stride,
                                   int fused, const float* u, long long u_stride, float* out,
                                   long long n_rays, int n_t, int n_bins, int n_u,
                                   int tile_rays, int grid, void* stream) {
  if (n_rays <= 0) return 0;
  constexpr long long MAX_STRIDE = 1 << 24;  // rows a tile spans stay int-indexed
  if (tile_rays < 1 || grid < 1 || n_t < 1 || n_u < 1 || n_bins < (fused ? 2 : 1) ||
      t_stride > MAX_STRIDE || b_stride > MAX_STRIDE || c_stride > MAX_STRIDE ||
      u_stride > MAX_STRIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ts = static_cast<int>(t_stride), bs = static_cast<int>(b_stride);
  const int cs = static_cast<int>(c_stride), us = static_cast<int>(u_stride);
  const Rows tv{t_vals, ts, n_t}, b{bins, bs, n_bins};
  const Rows c{third, cs, fused ? n_bins - 1 : n_bins}, uu{u, us, n_u};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fused ? launch<true>(tv, b, c, uu, out, n_rays, tile_rays, grid, s)
               : launch<false>(tv, b, c, uu, out, n_rays, tile_rays, grid, s);
}
