// Threefry-2x32 uniforms, bit for bit jax.random's, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA generates the threefry hash of
// jax.random.uniform inline.  The JAX package's training draws are
// `per_ray_uniform` (aon_tpu/core/sampling.py:42-50) and
// `sorted_per_ray_uniform` (aon_tpu/ops/resample_pallas.py:52-60): row i is
// uniform(fold_in(key, ray_ids[i]), (n,)).  In plain PyTorch ops the two
// hashes are some 250 elementwise launches on int64 tensors; this kernel is
// one launch a draw.  Its twin is aon_tpu_torch/core/prng.py
// (`per_ray_uniform_plain`, `uniform_plain`).
//
// Per element (jax_threefry_partitionable on, JAX's default):
//   per ray: (a, b) = threefry(key, (0, ray_id))       (fold_in)
//            (x, y) = threefry((a, b), (0, j))          (column j)
//   flat:    (x, y) = threefry(key, (j >> 32, j))       (element j, row-major,
//                                                        from `offset` on)
//   out = float((x ^ y) >> 9 | 0x3f800000) - 1          (uniform's bits)
//
// Bound on the H100: integer operations.  A hash is ~120 32-bit integer
// operations and each output is 4 bytes, so at 3.35 TB/s and the CUDA cores'
// rate the hash takes ~1.5x the store.  A block takes TILE_ROWS rays: their
// keys are hashed once, into shared memory, and the block's threads then walk
// its (TILE_ROWS, n) tile in row-major order, so the stores coalesce and no
// fold_in is hashed twice.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 32;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define AON_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
  AON_ROUND(13) AON_ROUND(15) AON_ROUND(26) AON_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  AON_ROUND(17) AON_ROUND(29) AON_ROUND(16) AON_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  AON_ROUND(13) AON_ROUND(15) AON_ROUND(26) AON_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  AON_ROUND(17) AON_ROUND(29) AON_ROUND(16) AON_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  AON_ROUND(13) AON_ROUND(15) AON_ROUND(26) AON_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef AON_ROUND
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// (rows, n) uniforms, row i from fold_in(key, ray_ids[i]).
__global__ void __launch_bounds__(THREADS)
per_ray_kernel(uint32_t k0, uint32_t k1, const int64_t* __restrict__ ray_ids, long long rows,
               int n, float* __restrict__ out) {
  __shared__ uint32_t keys[TILE_ROWS][2];
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE_ROWS;
  const int tile_rows = static_cast<int>(min(static_cast<long long>(TILE_ROWS), rows - row0));
  if (threadIdx.x < tile_rows) {
    uint32_t a = 0u, b = static_cast<uint32_t>(ray_ids[row0 + threadIdx.x]);
    threefry2x32(k0, k1, a, b);
    keys[threadIdx.x][0] = a;
    keys[threadIdx.x][1] = b;
  }
  __syncthreads();
  const int count = tile_rows * n;
  float* tile = out + row0 * n;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    const int r = e / n;
    uint32_t x = 0u, y = static_cast<uint32_t>(e - r * n);
    threefry2x32(keys[r][0], keys[r][1], x, y);
    tile[e] = unit_float(x ^ y);
  }
}

// `total` uniforms of one key, element j hashing the counter of j + offset,
// (hi, lo) = ((j + offset) >> 32, j + offset).
__global__ void __launch_bounds__(THREADS)
flat_kernel(uint32_t k0, uint32_t k1, long long total, long long offset,
            float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; j < total;
       j += stride) {
    const unsigned long long c = static_cast<unsigned long long>(j + offset);
    uint32_t x = static_cast<uint32_t>(c >> 32);
    uint32_t y = static_cast<uint32_t>(c);
    threefry2x32(k0, k1, x, y);
    out[j] = unit_float(x ^ y);
  }
}

}  // namespace

// ray_ids null: the flat draw of rows * n elements from counter `offset` on.
// Else (rows, n) per-ray rows (offset unused).
extern "C" int aon_threefry_uniform_launch(unsigned int k0, unsigned int k1,
                                           const int64_t* ray_ids, long long rows, int n,
                                           long long offset, float* out, int grid,
                                           void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (grid < 1 || offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ray_ids == nullptr) {
    flat_kernel<<<grid, THREADS, 0, s>>>(k0, k1, rows * n, offset, out);
  } else {
    const long long blocks = (rows + TILE_ROWS - 1) / TILE_ROWS;
    if (blocks > 0x7FFFFFFFLL || static_cast<long long>(TILE_ROWS) * n > 0x7FFFFFFFLL)
      return static_cast<int>(cudaErrorInvalidValue);
    per_ray_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0, s>>>(k0, k1, ray_ids, rows,
                                                                         n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
