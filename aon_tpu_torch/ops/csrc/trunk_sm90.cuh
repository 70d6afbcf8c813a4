// The vanilla NeRF MLP trunk for Hopper (sm_90a): weights streamed through
// shared memory, products on wgmma warpgroups, persistent blocks.  The eval
// kernel of fused_mlp_eval.cu runs it, and the vanilla training kernels
// (level_train.cu) and the articulated kernels (art.cu) build on it through
// train_sm90.cuh and art_sm90.cuh.
//
// Block: three warpgroups, one per SM, walking tiles of TILE_ROWS = 128
// sample rows (blockIdx.x, + gridDim.x, ...).  Warpgroups 0 and 1 are the
// consumers: each owns 64 rows of the tile and keeps its f32 accumulator,
// 64 x 256, in registers (128 a thread; setmaxnreg gives them the
// producer's registers).  Warpgroup 2 is the producer: one thread streams
// the weights into a ring of STAGES K-slabs (64 K-rows x 256 columns, 32 KB)
// with 1-D cp.async.bulk copies that complete on an mbarrier; the consumers
// free a slab with one arrival per warp once their wgmma on it is done.  So
// the next layer's slabs arrive while this layer's last products run.  Each
// consumer warpgroup stages its own rows' inputs at the start of a tile
// (fused_mlp_eval.cu).
//
// Every operand wgmma reads lies in shared memory in the K-major layout with
// the 128-byte swizzle: a K-chunk of 64 bf16 per 128-byte row, the 16-byte
// group g of row r stored at group g ^ (r % 8), 8-row groups 1024 B apart.
// The weights arrive that way already: the wrapper packs them once into the
// eval blob (ops/fused_mlp.py::eval_blobs), each (K, N) matrix as N rows of
// its zero-padded K, cut into 64-wide slabs, in the order the layers read
// them, followed by the two heads' weights.  Activations stay on chip: each
// layer's epilogue adds the bias, applies the relu, rounds to bf16 and writes
// the tile back over its own input in the same swizzled layout (after every
// warp's products on it are done), where the next layer's wgmma reads it as
// A.  The skip layer (h @ w5a + enc @ w5b) and the view layer (bott @ wva +
// venc @ wvb) accumulate their two products into one accumulator.  The
// density head (256 -> 1 on h7) and the rgb head (128 -> 3 on v) are dot
// products over the accumulator fragments: each thread holds a quarter of a
// row, a quad of lanes sums it with two shuffles; bf16 operands, f32 sums,
// the f32 bias added last.
//
// Bodies (kernel table row 12; fused_mlp_eval.cu runs rows 1, 5, 7, 8 and 13
// on the two-stream schedule).  BASE: both consumers step through the
// layers side by side.  TWO_STREAM (`_mlp_body_2s`): the two run half a layer
// apart, their turns to issue products ordered by two named barriers
// (ping-pong), so one's epilogue overlaps the other's products; per row it
// computes what BASE computes, the products in the same K order:
// bit-identical.  The skip and view layers take a turn for each of their two
// products: a turn over both would wait for a slab that only the other
// warpgroup's next turn frees.  BF16ACC (`_mlp_body_bf16acc`): each trunk
// and view product is rounded to bf16 as it leaves f32, the bias rounded to
// bf16, the sums and the relu in bf16; the skip and view layers' first
// product is parked, rounded, in the activation tile while the second runs,
// and the two are added rounded apart.  The density head and the bottleneck
// stay f32 as in BASE.
//
// Bound on the H100: operations (1.19 MFLOP per row against 12-384 B of
// input).  Next to them runs the weight stream: each tile pulls the 1.20 MB
// of slabs from L2 for 128 rows x 2 x 593,408 FLOP, so the bf16 peak would
// need about 7.8 TB/s of L2 reads over the card.  On an NVIDIA H100 80GB
// HBM3 at 700 W a block's time per tile does not change between 33 and 132
// blocks (chip_smoke.py's trunk_grid_sweep, PERF.md): each SM's own pipeline
// (the drain at every layer's end, the epilogues, the staging) binds, not L2.
//
// wgmma, mbarriers and the bulk copies are inline PTX (no CUTLASS headers).

#pragma once

#include <cstdint>

#include "mlp_common.cuh"

namespace aon {
namespace sm90 {

constexpr int TILE_ROWS = 128;  // sample rows per tile
constexpr int WG_ROWS = 64;     // rows per consumer warpgroup
constexpr int WG_THREADS = 128;
constexpr int CONSUMER_THREADS = 2 * WG_THREADS;
constexpr int THREADS = CONSUMER_THREADS + WG_THREADS;  // + the producer warpgroup
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int STAGES = 4;
// A two-stream turn issues a whole product, up to 4 slabs, before the other
// warpgroup's turn frees the product's first slab: with fewer stages the
// turn waits for a slab that never comes (a 3-stage ring hung on an H100).
static_assert(STAGES >= 4, "a two-stream turn must hold a whole product in the ring");
constexpr int KCHUNK = 64;                              // K per slab and per A chunk
constexpr int SLAB_BYTES = WIDTH * KCHUNK * 2;          // a 256-column slab, 32 KB
constexpr int VSLAB_BYTES = COND * KCHUNK * 2;          // a 128-column slab of the view layer
constexpr int A_CHUNK_BYTES = WG_ROWS * KCHUNK * 2;     // 64 rows x 64 K of an A operand
// Slabs in the order the layers read them: w0 (1), w1..w4 (4 each), w5a (4),
// w5b (1), w6, w7, wb (4 each): 34 of 256 columns; wva (4), wvb (1, K 32
// zero-padded to 64): 5 of 128.
constexpr int N_WIDE_SLABS = 34;
constexpr int N_SLABS = N_WIDE_SLABS + 5;
constexpr int EVAL_SLAB_BYTES = N_WIDE_SLABS * SLAB_BYTES + 5 * VSLAB_BYTES;
// bf16 eval blob: the slabs, then wd (256) and wrgb (128 x 3, row-major),
// the heads' weights as in the kernel blob (aon_tpu_torch/ops/fused_mlp.py)
constexpr int EVAL_OFF_WD = EVAL_SLAB_BYTES / 2;
constexpr int N_HEAD_WEIGHTS = WIDTH + COND * 3;
constexpr int N_EVAL_WEIGHTS = EVAL_OFF_WD + N_HEAD_WEIGHTS;
static_assert(N_EVAL_WEIGHTS == 598656, "eval blob layout");

// Byte offsets in the block's shared memory (its base aligned to 1024 B,
// which the swizzle needs of every tile).
constexpr int SM_RING = 0;
constexpr int SM_ACT = SM_RING + STAGES * SLAB_BYTES;      // 2 x (4 chunks of 64 x 64)
constexpr int SM_ENC = SM_ACT + 2 * 4 * A_CHUNK_BYTES;     // 2 x 64 rows x 64
constexpr int SM_VENC = SM_ENC + 2 * A_CHUNK_BYTES;        // 2 x 64 rows x 32 (128 B rows)
constexpr int SM_HEADS = SM_VENC + 2 * A_CHUNK_BYTES;      // wd, then wrgb
constexpr int SM_BARS = SM_HEADS + N_HEAD_WEIGHTS * 2;     // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = SM_BARS + 2 * STAGES * 8 + 1024;  // + room to align the base
static_assert(SM_ACT % 1024 == 0 && SM_ENC % 1024 == 0 && SM_VENC % 1024 == 0, "alignment");
static_assert(SM_BARS % 8 == 0 && SMEM_BYTES <= 232448, "shared memory budget");

// named barriers: 0 is __syncthreads; 1 + wg each consumer warpgroup's own;
// TURN + wg the two-stream body's turns
constexpr int BAR_WG = 1;
constexpr int BAR_TURN = 3;

enum class Body { BASE, TWO_STREAM, BF16ACC };

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (row, col) in a swizzled tile of 128-byte rows
// (col < 64: one K-chunk).
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 B apart (stride byte offset 64 x 16 B); the leading byte offset is
// unused by this layout.  Stepping K by 16 inside a chunk adds 32 B.
__device__ __forceinline__ uint64_t descriptor(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void acc_fence(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes on bar's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return reinterpret_cast<uint32_t&>(h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(reinterpret_cast<__nv_bfloat162&>(u));
}

// ------------------------------------------------------------ wgmma

// D[64 x 256] += A[64 x 16] B[16 x 256], both from shared memory (K-major, 128 B
// swizzle); the accumulator is d[0..127] in wgmma's fragment order.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// D = A B (scale-d false): the accumulator is written only, so
// its old values are dead to the compiler.
__device__ __forceinline__ void wgmma_n256_first(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]),
        "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]),
        "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]),
        "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]),
        "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]),
        "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]),
        "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]),
        "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]), "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]),
        "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
      : "l"(a), "l"(b), "r"(0));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], both from shared memory (K-major, 128 B
// swizzle); the accumulator is d[0..63] in wgmma's fragment order.
__device__ __forceinline__ void wgmma_n128(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// D = A B (scale-d false): the accumulator is written only, so
// its old values are dead to the compiler.
__device__ __forceinline__ void wgmma_n128_first(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

// ------------------------------------------------------------ the block

// Shared memory of one block, its base aligned to 1024 B.
struct Block {
  uint8_t* smem;
  uint32_t base;  // its shared-space address
  __device__ __forceinline__ uint32_t full(int s) const { return base + SM_BARS + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + SM_BARS + 8 * (STAGES + s);
  }
};

// Aligns the dynamic shared memory, initialises the ring's barriers and
// copies the heads' weights; every thread of the block calls it once.
__device__ __forceinline__ Block block_setup(unsigned char* smem_raw, const bf16* __restrict__ W) {
  const uint32_t raw = smem_addr(smem_raw);
  Block b;
  b.smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  b.base = smem_addr(b.smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(b.full(s), 1);
      mbar_init(b.empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  bf16* heads = reinterpret_cast<bf16*>(b.smem + SM_HEADS);
  for (int i = threadIdx.x; i < N_HEAD_WEIGHTS; i += THREADS) heads[i] = W[EVAL_OFF_WD + i];
  __syncthreads();
  return b;
}

__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// The producer thread: every slab of every tile of this block, in order.
__device__ __forceinline__ void produce(const Block& b, const bf16* __restrict__ W,
                                        long long n_tiles) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(W);
  int stage = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    uint32_t offset = 0;
    for (int s = 0; s < N_SLABS; ++s) {
      const uint32_t bytes = s < N_WIDE_SLABS ? SLAB_BYTES : VSLAB_BYTES;
      mbar_wait(b.empty(stage), phase ^ 1);
      mbar_expect_tx(b.full(stage), bytes);
      bulk_copy(b.base + SM_RING + stage * SLAB_BYTES, src + offset, bytes, b.full(stage));
      offset += bytes;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
  }
}

// One consumer warpgroup: its tiles, its place in the ring.
struct Consumer {
  Block b;
  int wg, warp, lane, t;  // warpgroup 0/1, warp in it, lane, thread in it
  int stage = 0, pending = -1;  // pending: the stage of the last product group not yet freed
  uint32_t phase = 0;

  __device__ __forceinline__ Consumer(const Block& blk) : b(blk) {
    wg = threadIdx.x / WG_THREADS;
    t = threadIdx.x % WG_THREADS;
    warp = t >> 5;
    lane = t & 31;
  }
  __device__ __forceinline__ uint8_t* act() const { return b.smem + SM_ACT + wg * 4 * A_CHUNK_BYTES; }
  __device__ __forceinline__ uint8_t* enc() const { return b.smem + SM_ENC + wg * A_CHUNK_BYTES; }
  __device__ __forceinline__ uint8_t* venc() const { return b.smem + SM_VENC + wg * A_CHUNK_BYTES; }
  __device__ __forceinline__ void sync() const { bar_sync(BAR_WG + wg, WG_THREADS); }
};

// Issues acc (+)= A @ slabs for NS slabs of N columns, A's K-chunks at
// shared address a0, a0 + A_CHUNK_BYTES, ...; the last slab with KLAST
// 16-deep steps.  Frees each slab once the group after it is committed; the
// last stays pending.
template <int N, int NS, int KLAST = KCHUNK / 16, bool ACCUMULATE = false>
__device__ __forceinline__ void issue(Consumer& c, float (&acc)[128], uint32_t a0) {
  if constexpr (ACCUMULATE) acc_fence(acc);  // a fresh sum reads nothing of acc
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    mbar_wait(c.b.full(c.stage), c.phase);
    const uint32_t slab = c.b.base + SM_RING + c.stage * SLAB_BYTES;
    constexpr int K_STEPS = KCHUNK / 16;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < (s == NS - 1 ? KLAST : K_STEPS); ++k) {
      const uint64_t da = descriptor(a0 + s * A_CHUNK_BYTES + 32 * k);
      const uint64_t db = descriptor(slab + 32 * k);
      if (!ACCUMULATE && s == 0 && k == 0) {  // a fresh sum: the old one is dead
        if constexpr (N == WIDTH) wgmma_n256_first(acc, da, db);
        else wgmma_n128_first(acc, da, db);
      } else {
        if constexpr (N == WIDTH) wgmma_n256(acc, da, db);
        else wgmma_n128(acc, da, db);
      }
    }
    wgmma_commit();
    if (c.pending >= 0) {
      wgmma_wait<1>();
      if (c.lane == 0) mbar_arrive(c.b.empty(c.pending));
    }
    c.pending = c.stage;
    if (++c.stage == STAGES) { c.stage = 0; c.phase ^= 1; }
  }
}

template <int N, int NS, int KLAST = KCHUNK / 16, bool ACCUMULATE = false>
__device__ __forceinline__ void issue(Consumer& c, float (&acc)[128], const uint8_t* a) {
  issue<N, NS, KLAST, ACCUMULATE>(c, acc, smem_addr(a));
}

// Waits for every product issued and frees the last slab.
__device__ __forceinline__ void finish(Consumer& c, float (&acc)[128]) {
  wgmma_wait<0>();
  acc_fence(acc);
  if (c.lane == 0) mbar_arrive(c.b.empty(c.pending));
  c.pending = -1;
}

// One product of a layer, in the body's turn; A a tile's pointer or its
// shared address.
template <Body B, int N, int NS, int KLAST = KCHUNK / 16, bool ACCUMULATE = false, class A>
__device__ __forceinline__ void product(Consumer& c, float (&acc)[128], A a) {
  if constexpr (B == Body::TWO_STREAM) bar_sync(BAR_TURN + c.wg, CONSUMER_THREADS);
  issue<N, NS, KLAST, ACCUMULATE>(c, acc, a);
  if constexpr (B == Body::TWO_STREAM) bar_arrive(BAR_TURN + (c.wg ^ 1), CONSUMER_THREADS);
}

// Byte offset in the activation tile of the pair (row, 8i + 2q .. + 1) that
// fragment block i holds; x = row % 8.
__device__ __forceinline__ uint32_t pair_offset(int i, int row, int x, int q) {
  return (i >> 3) * A_CHUNK_BYTES + row * 128 + ((((i & 7) ^ x)) << 4) + 4 * q;
}

// BF16ACC: the first of two products, rounded to bf16, parked in the
// activation tile where the epilogue will read it back.
template <int N>
__device__ __forceinline__ void park(const Consumer& c, const float (&acc)[128]) {
  const int x = c.lane >> 2, q = c.lane & 3, r0 = 16 * c.warp + x;
  uint8_t* act = c.act();
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    *reinterpret_cast<uint32_t*>(act + pair_offset(i, r0, x, q)) = pack_bf16(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(act + pair_offset(i, r0 + 8, x, q)) =
        pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

enum class Epi { HIDDEN, DENSITY, BOTTLENECK, RGB };

// One layer's output value: act(acc + bias), or BF16ACC's rounded chain
// (with ADD the parked product added first).
template <Body B, Epi E, bool ADD>
__device__ __forceinline__ float out_value(float a, float bias, float parked) {
  if constexpr (B == Body::BF16ACC && E != Epi::BOTTLENECK) {
    float v = round_bf16(a);
    if constexpr (ADD) v = round_bf16(v + parked);
    return fmaxf(round_bf16(v + round_bf16(bias)), 0.0f);
  } else {
    const float v = a + bias;
    return E == Epi::BOTTLENECK ? v : fmaxf(v, 0.0f);
  }
}

// A layer's epilogue on the accumulator of its N columns (lb: its biases):
// HIDDEN and BOTTLENECK write the bf16 tile over the layer's input; DENSITY
// also sums the density head on it into out_sigma; RGB sums the rgb head on
// v into out_rgb and writes nothing to shared memory, unless KEEP (the
// training forward, which stores v).  Rows at or past n_rows are not written.
// With a `mask` (the training forward: the warpgroup's first row of this
// layer's relu-mask bytes, `ldm` bytes a row; N = WIDTH) the output's relu
// mask goes there too, in fragment order: the 8 bytes at 8q of a row hold the
// bits of the columns lane quad position q holds, bit 2i + p for column
// 8i + 2q + p, where the backward's lane of the same position reads them.
// A column's bit is set where its bf16 value is > 0, that is where the f32
// value rounded to it exceeds 2^-134 (half the least bf16 subnormal rounds
// to even, to 0).  The compiler would load all N / 4 bias pairs up front;
// with the mask (MASKS) it loads them a half at a time, which leaves the
// registers the bits need beside the accumulator.
template <Body B, Epi E, int N, bool ADD = false, bool KEEP = false, bool MASKS = false>
__device__ __forceinline__ void epilogue(const Consumer& c, const float (&acc)[128],
                                         const float* __restrict__ lb,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out_rgb,
                                         float* __restrict__ out_sigma, long long row0,
                                         long long n_rows, uint8_t* __restrict__ mask = nullptr,
                                         int ldm = 0) {
  constexpr int HEADS = E == Epi::DENSITY ? 1 : E == Epi::RGB ? 3 : 0;
  const int x = c.lane >> 2, q = c.lane & 3, r0 = 16 * c.warp + x;
  uint8_t* act = c.act();
  const bf16* heads = reinterpret_cast<const bf16*>(c.b.smem + SM_HEADS);
  float s_lo[3] = {0.0f, 0.0f, 0.0f}, s_hi[3] = {0.0f, 0.0f, 0.0f};
  uint32_t m_lo[2] = {0u, 0u}, m_hi[2] = {0u, 0u};  // the mask bits of rows r0, r0 + 8
  const float positive = __int_as_float(0x00008000);  // 2^-134
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    if constexpr (MASKS)
      if (i == N / 16) asm volatile("" ::: "memory");
    const int col = 8 * i + 2 * q;
    const float2 bv = __ldg(reinterpret_cast<const float2*>(lb + col));
    const uint32_t o_lo = pair_offset(i, r0, x, q), o_hi = pair_offset(i, r0 + 8, x, q);
    float2 p_lo = make_float2(0.0f, 0.0f), p_hi = p_lo;
    if constexpr (ADD) {
      p_lo = unpack_bf16(*reinterpret_cast<const uint32_t*>(act + o_lo));
      p_hi = unpack_bf16(*reinterpret_cast<const uint32_t*>(act + o_hi));
    }
    const float f0 = out_value<B, E, ADD>(acc[4 * i], bv.x, p_lo.x);
    const float f1 = out_value<B, E, ADD>(acc[4 * i + 1], bv.y, p_lo.y);
    const float f2 = out_value<B, E, ADD>(acc[4 * i + 2], bv.x, p_hi.x);
    const float f3 = out_value<B, E, ADD>(acc[4 * i + 3], bv.y, p_hi.y);
    const uint32_t lo = pack_bf16(f0, f1), hi = pack_bf16(f2, f3);
    if constexpr (E != Epi::RGB || KEEP) {
      *reinterpret_cast<uint32_t*>(act + o_lo) = lo;
      *reinterpret_cast<uint32_t*>(act + o_hi) = hi;
    }
    if constexpr (MASKS) {
      const int b = 2 * (i & 15);
      if (f0 > positive) m_lo[i >> 4] |= 1u << b;
      if (f1 > positive) m_lo[i >> 4] |= 2u << b;
      if (f2 > positive) m_hi[i >> 4] |= 1u << b;
      if (f3 > positive) m_hi[i >> 4] |= 2u << b;
    }
    if constexpr (HEADS > 0) {
      const float2 v_lo = unpack_bf16(lo), v_hi = unpack_bf16(hi);
      if constexpr (E == Epi::DENSITY) {
        const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(heads + col));
        s_lo[0] = fmaf(v_lo.x, w.x, fmaf(v_lo.y, w.y, s_lo[0]));
        s_hi[0] = fmaf(v_hi.x, w.x, fmaf(v_hi.y, w.y, s_hi[0]));
      } else {  // wrgb rows col and col + 1: six bf16 from 4-byte aligned pairs
        const __nv_bfloat162* w2 =
            reinterpret_cast<const __nv_bfloat162*>(heads + WIDTH + 3 * col);
        const float2 w01 = __bfloat1622float2(w2[0]), w23 = __bfloat1622float2(w2[1]),
                     w45 = __bfloat1622float2(w2[2]);
        const float w[2][3] = {{w01.x, w01.y, w23.x}, {w23.y, w45.x, w45.y}};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          s_lo[k] = fmaf(v_lo.x, w[0][k], fmaf(v_lo.y, w[1][k], s_lo[k]));
          s_hi[k] = fmaf(v_hi.x, w[0][k], fmaf(v_hi.y, w[1][k], s_hi[k]));
        }
      }
    }
  }
  if constexpr (MASKS) {
    uint8_t* lo_row = mask + static_cast<size_t>(r0) * ldm + 8 * q;
    *reinterpret_cast<uint2*>(lo_row) = make_uint2(m_lo[0], m_lo[1]);
    *reinterpret_cast<uint2*>(lo_row + 8 * ldm) = make_uint2(m_hi[0], m_hi[1]);
  }
  if constexpr (HEADS > 0) {
#pragma unroll
    for (int k = 0; k < HEADS; ++k) {
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        s_lo[k] += __shfl_xor_sync(0xffffffffu, s_lo[k], m);
        s_hi[k] += __shfl_xor_sync(0xffffffffu, s_hi[k], m);
      }
    }
    const long long g_lo = row0 + r0, g_hi = g_lo + 8;
    if (q == 0) {
      if constexpr (E == Epi::DENSITY) {
        if (g_lo < n_rows) out_sigma[g_lo] = s_lo[0] + bias[OFF_BD];
        if (g_hi < n_rows) out_sigma[g_hi] = s_hi[0] + bias[OFF_BD];
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (g_lo < n_rows) out_rgb[3 * g_lo + k] = s_lo[k] + bias[OFF_BRGB + k];
          if (g_hi < n_rows) out_rgb[3 * g_hi + k] = s_hi[k] + bias[OFF_BRGB + k];
        }
      }
    }
  }
}

// A layer of two products into one accumulator (the skip and view layers):
// BF16ACC rounds the first apart and parks it.
template <Body B, int N, int KLAST2>
__device__ __forceinline__ void two_products(Consumer& c, float (&acc)[128], const uint8_t* a2) {
  product<B, N, 4>(c, acc, c.act());
  if constexpr (B == Body::BF16ACC) {
    finish(c, acc);
    c.sync();  // every warp's products on the tile done before it is overwritten
    park<N>(c, acc);
    product<B, N, 1, KLAST2>(c, acc, a2);
  } else {
    product<B, N, 1, KLAST2, true>(c, acc, a2);
  }
  finish(c, acc);
}

// The MLP on one warpgroup's 64 rows of a tile whose inputs it has staged
// (c.enc(), c.venc(); fenced and synchronised): raw sigma (n_rows, 1) and raw
// rgb (n_rows, 3) of the rows row0 .. row0 + 63 below n_rows.  VIEW is the
// view layer's epilogue: RGB (the vanilla MLP) ends the tile with the rgb
// head; HIDDEN (the articulated MLP) leaves v0 in the activation tile,
// written but not yet fenced or synchronised, for the layers after it.
template <Body B, Epi VIEW = Epi::RGB>
__device__ __forceinline__ void trunk_tile(Consumer& c, float (&acc)[128],
                                           const float* __restrict__ bias,
                                           float* __restrict__ out_rgb,
                                           float* __restrict__ out_sigma, long long row0,
                                           long long n_rows) {
  constexpr bool SPLIT = B == Body::BF16ACC;
  product<B, WIDTH, 1>(c, acc, c.enc());
  finish(c, acc);
  c.sync();
  epilogue<B, Epi::HIDDEN, WIDTH>(c, acc, bias, bias, out_rgb, out_sigma, row0, n_rows);
  fence_async_shared();
  c.sync();

#pragma unroll 1
  for (int layer = 1; layer < 8; ++layer) {
    const float* lb = bias + layer * WIDTH;
    if (layer == 5) {  // skip: layer5(cat[h, enc]) == h @ w5a + enc @ w5b
      two_products<B, WIDTH, KCHUNK / 16>(c, acc, c.enc());
    } else {
      product<B, WIDTH, 4>(c, acc, c.act());
      finish(c, acc);
    }
    c.sync();
    if (layer == 5 && SPLIT)
      epilogue<B, Epi::HIDDEN, WIDTH, SPLIT>(c, acc, lb, bias, out_rgb, out_sigma, row0, n_rows);
    else if (layer == 7)
      epilogue<B, Epi::DENSITY, WIDTH>(c, acc, lb, bias, out_rgb, out_sigma, row0, n_rows);
    else
      epilogue<B, Epi::HIDDEN, WIDTH>(c, acc, lb, bias, out_rgb, out_sigma, row0, n_rows);
    fence_async_shared();
    c.sync();
  }

  // the bottleneck (f32 + bias, rounded; no relu) over h7
  product<B, WIDTH, 4>(c, acc, c.act());
  finish(c, acc);
  c.sync();
  epilogue<B, Epi::BOTTLENECK, WIDTH>(c, acc, bias + OFF_BB, bias, out_rgb, out_sigma, row0,
                                      n_rows);
  fence_async_shared();
  c.sync();

  // view layer: v = relu(bott @ wva + venc @ wvb + bv), K of wvb 32; the rgb head
  two_products<B, COND, VIEW_PAD / 16>(c, acc, c.venc());
  if constexpr (VIEW != Epi::RGB) c.sync();  // every warp's products on bott are done
  epilogue<B, VIEW, COND, SPLIT>(c, acc, bias + OFF_BV, bias, out_rgb, out_sigma, row0, n_rows);
}

}  // namespace sm90
}  // namespace aon
