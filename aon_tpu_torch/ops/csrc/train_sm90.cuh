// The vanilla NeRF MLP's training kernels for Hopper (sm_90a), built on the
// persistent wgmma trunk of trunk_sm90.cuh: a forward that stores its
// activations, the backward's data path (the chain dv, dbott, D7..D0), and
// the weight gradients dW = X^T D.  level_train.cu runs them for kernel table
// rows 3, 4 and 6.  The articulated kernels (art_sm90.cuh) run the same
// pieces around their deformation prefix and view branch, in a workspace
// layout that appends their columns (the template argument L).
//
// Workspaces.  n_pad = n_rows rounded up to TILE_ROWS; the forward and the
// backward write every row of every tile (rows past n_rows repeat the last
// row's inputs and carry g = 0, so every D of theirs is 0).  The activations
// and the gradients are kept in the layout wgmma reads and the epilogues
// write: blocks of 64 rows, each a run of chunks of 64 columns, a chunk 64
// rows of 128 B with the 128-byte swizzle (the 16-byte group g of row r
// stored at g ^ (r % 8)), 8 KB, the image of a shared-memory tile.  So a
// tile goes out, and a workspace chunk comes in, as one bulk copy:
//   * act   ACT_CHUNKS chunks a block: enc | a0..a7 (4 each) | bottleneck (4)
//           | v (2) | venc (its 32 columns in a chunk's first half), the
//           bf16 values the next layer read (columns of mlp_common.cuh ACT_*,
//           64 to a chunk);
//   * grad  GRAD_CHUNKS chunks a block: D0..D7 (4 each) | dbott (4) | dv (2),
//           each D rounded to bf16 as `dot_tn` rounds it (train_common.cuh
//           GR_*);
//   * mask  u8 (n_pad, LDM), row by row: the relu masks of a0..a7 as bits,
//           32 bytes a layer in the accumulator's fragment order: the 8
//           bytes at 32 l + 8 q hold bit 2i + p for column 8i + 2q + p, set
//           where a_l's bf16 value there is > 0 (trunk_sm90.cuh `epilogue`),
//           so the forward's and the backward's lanes of one position write
//           and read their own bits.
//
// 1. Forward (`forward_tile`): the two-stream trunk of trunk_sm90.cuh over
//    128-row tiles, weights from the eval blob.  After each layer's epilogue
//    (its bf16 tile back in shared memory) one thread of the warpgroup sends
//    the tile to the act workspace by a bulk copy (cp.async.bulk, its own
//    async group), which drains while the products run; the epilogue writes
//    the mask bytes from its registers (no second read of the tile: shared
//    memory's bandwidth is what the trunk is short of).  Before an epilogue
//    overwrites the tile, that thread waits for the copy to have read it.
// 2. Backward, data path (`backward_tile`): the same persistent shape.  The
//    weights arrive as the backward blob: W^T of wva, wb, w7, w6, w5a, w4,
//    w3, w2, w1 in the order the chain reads them, each as N' = 256 rows of
//    its K' (the layer's outputs) in 64-wide K-major swizzled slabs, 34 slabs
//    of 32 KB (ops/train_sm90.py packs it on the host from the kernel blob).
//    Each D tile stays in shared memory as the A operand of the next product
//    and goes to the grad workspace by a bulk copy; the relu masks come from
//    the mask workspace, loaded before the product; the bias gradients are
//    f32 column sums of the unrounded values, reduced over the lanes and
//    then the warps of a column, summed in shared memory over the block's
//    tiles and added to the gradient blob once per block, with the heads'
//    weight gradients (wrgb, wd), which CUDA cores sum in the head phase.
//    (Shared-memory float adds are compare-and-swap loops: each column gets
//    one a layer from each warpgroup, never a contended one per warp.)
// 3. Weight gradients (`wgrad_kernel`): the 12 wide matrices as products
//    over the sample rows.  A work item is a 128 x 256 (or x 128) output tile
//    and a range of row blocks; two consumer warpgroups own 64 of its rows
//    each and keep their f32 sums in registers over the whole range, then
//    add them to the gradient blob once.  A producer thread streams the X
//    and D chunks of each 64-row block into a 4-stage ring by bulk copies on
//    mbarriers.  Both are operands in the MN-major layout (a sample row is a
//    K-line), which wgmma reads with its transpose bits.
//
// Roundings: bf16 operands and f32 sums in every product,
// the f32 gradients g_rgb, g_sigma, dv and D included; relu masks from the
// stored bf16 activations; D rounded to bf16 where it is stored.

#pragma once

#include "train_common.cuh"
#include "trunk_sm90.cuh"

namespace aon {
namespace sm90 {

// ------------------------------------------------------------ layouts

constexpr int CHUNK_BYTES = A_CHUNK_BYTES;  // 64 rows x 64 columns, swizzled
constexpr int BLOCK_ROWS = WG_ROWS;         // rows of a workspace block
// act chunks: enc, a_l at ACT_C_A0 + 4 l, bottleneck, v, venc
constexpr int ACT_C_ENC = ACT_ENC / KCHUNK;
constexpr int ACT_C_A0 = ACT_A0 / KCHUNK;
constexpr int ACT_C_BOTT = ACT_BOTT / KCHUNK;
constexpr int ACT_C_V = ACT_V / KCHUNK;
constexpr int ACT_C_VENC = ACT_VENC / KCHUNK;
constexpr int ACT_CHUNKS = ACT_C_VENC + 1;  // 40
// grad chunks: D_l at 4 l, dbott, dv
constexpr int GR_C_BOTT = GR_BOTT / KCHUNK;
constexpr int GR_C_V = GR_V / KCHUNK;
constexpr int GRAD_CHUNKS = LDG / KCHUNK;  // 38
static_assert(ACT_CHUNKS == 40 && GRAD_CHUNKS == 38 && LDG % KCHUNK == 0, "workspace chunks");

constexpr int LDM = 8 * WIDTH / 8;  // mask bytes per row, 256

// the backward blob follows the eval blob in the training blob
constexpr int N_BWD_SLABS = 2 + 8 * 4;  // wva^T (K' 128), then 4 each of wb^T, w7^T .. w1^T
constexpr int TRAIN_OFF_BWD = N_EVAL_WEIGHTS;
constexpr int N_TRAIN_WEIGHTS = N_EVAL_WEIGHTS + N_BWD_SLABS * SLAB_BYTES / 2;
static_assert(N_TRAIN_WEIGHTS == 1155712, "training blob layout");
static_assert((TRAIN_OFF_BWD * 2) % 16 == 0, "the backward slabs are 16-byte aligned");

// the backward's block sums in shared memory (the eval layout's view-encoding
// tiles): the bias gradients in the bias blob's order, then wd's and wrgb's
constexpr int SUM_WD = N_BIASES;
constexpr int SUM_WRGB = SUM_WD + WIDTH;
constexpr int N_SUMS = SUM_WRGB + COND * 3;
static_assert(N_SUMS * 4 <= 2 * A_CHUNK_BYTES, "block sums fit the view-encoding tiles");
constexpr int BAR_CONSUMERS = 5;  // named barrier of both consumer warpgroups

// A workspace layout, the template argument of the pieces the articulated
// kernels share (art_sm90.cuh appends its columns to these): chunks a block
// of the act and grad workspaces, where the block's sums keep the heads'
// weight gradients, and whether the view layer ends the MLP (the rgb head)
// or feeds the articulated kernels' view branch.  Both keep the mask
// workspace's layout.
struct VanillaLayout {
  static constexpr int ACT_CHUNKS = sm90::ACT_CHUNKS;
  static constexpr int GRAD_CHUNKS = sm90::GRAD_CHUNKS;
  static constexpr int SUM_WD = sm90::SUM_WD;
  static constexpr int SUM_WRGB = sm90::SUM_WRGB;
  static constexpr bool ART = false;
};

// ------------------------------------------------------------ bulk stores

// bytes (a multiple of 16) from shared src to global dst, both 16-byte
// aligned, in this thread's bulk async group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// *p += v for p in shared memory (the block's sums), without a return value
__device__ __forceinline__ void sum_add(float* p, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;\n" ::"r"(smem_addr(p)), "f"(v) : "memory");
}

// Sends `bytes` of a shared-memory tile (written, fenced and synchronised)
// to the workspace by one thread of the warpgroup.
__device__ __forceinline__ void store_tile(const Consumer& c, const uint8_t* tile, uint8_t* dst,
                                           uint32_t bytes) {
  if (c.t == 0) bulk_store(dst, smem_addr(tile), bytes);
}
// Synchronises the warpgroup once the tile stores it sent have read their
// tiles (before a tile is overwritten).
__device__ __forceinline__ void sync_stored(const Consumer& c) {
  if (c.t == 0) bulk_wait_read();
  c.sync();
}

// The workspace block of the warpgroup's 64 rows, row0 .. row0 + 63.
__device__ __forceinline__ uint8_t* ws_block(const bf16* ws, int chunks, long long row0) {
  return reinterpret_cast<uint8_t*>(const_cast<bf16*>(ws)) +
         static_cast<size_t>(row0 / BLOCK_ROWS) * chunks * CHUNK_BYTES;
}

// ------------------------------------------------------------ forward

// XP: the articulated kernels' deformed coordinates x', which their prefix
// left in the warpgroup's activation tile (XP_OFFSET, (64, 4) f32)
enum class Stage { T_VALS, XYZ, ENC, XP };
constexpr int XP_OFFSET = 3 * A_CHUNK_BYTES;

struct FwdArgs {
  const float* enc;      // ENC: (n_rows, 64) f32
  const float* venc;     // ENC: (n_rows, 32) f32
  const float* xyz;      // XYZ: (n_rows, 3)
  const float* t_vals;   // T_VALS: (n_rows), with rays_o / rays_d (B, 3)
  const float* rays_o;
  const float* rays_d;
  const float* vdir;     // XYZ, T_VALS: (B, 3)
  const float* s_pos;
  const float* p_pos;
  const float* s_view;
  const float* p_view;
  const bf16* W;         // the training blob (its head is the eval blob)
  const float* bias;
  float* out_rgb;
  float* out_sigma;
  bf16* act;             // blocked, ACT_CHUNKS chunks a block
  uint8_t* mask;
  long long n_rows;
  int samples_per_ray;
};

// One column of the in-kernel positional encoding with its constants in
// registers: mlp_common.cuh `encode`, the same roundings.  The constants are
// loaded by volatile loads, once a tile, so that the compiler keeps them
// only while a tile is staged and not across the layers, where the
// accumulator needs the registers.
struct Encoding {
  float s0, s1, s2, p;
  __device__ __forceinline__ float operator()(float x0, float x1, float x2, int col) const {
    float pre = __fmul_rn(x0, s0);
    pre = __fadd_rn(pre, __fmul_rn(x1, s1));
    pre = __fadd_rn(pre, __fmul_rn(x2, s2));
    pre = __fadd_rn(pre, p);
    return col < 3 ? pre : sinf(reduce_arg(pre));
  }
};

__device__ __forceinline__ float load_volatile(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ Encoding encoding(const float* s, const float* p, int width, int col) {
  return {load_volatile(s + col), load_volatile(s + width + col),
          load_volatile(s + 2 * width + col), load_volatile(p + col)};
}

// Writes the warpgroup's 64 rows, row0 .. row0 + 63, into its swizzled bf16
// enc / venc tiles; rows past the end repeat the last row.  T_VALS: the
// sample at o + t d of its ray, the product and the sum rounded apart as the
// plain version rounds them; XYZ: given coordinates; both encoded in f32 as
// mlp_common.cuh's `encode` encodes (`Encoding`), with the ray's viewdir.  ENC: the given f32
// encodings.  The loads of a tile are issued before the first use, as in the
// eval kernel's staging (fused_mlp_eval.cu).
template <Stage ST>
__device__ __forceinline__ void stage_rows(const Consumer& c, const FwdArgs& a, long long row0) {
  constexpr int ROWS = WG_ROWS;
  uint8_t* enc = c.enc();
  uint8_t* venc = c.venc();
  auto put = [](uint8_t* tile, int r, int col, float v) {
    *reinterpret_cast<bf16*>(tile + swizzled(r, col)) = __float2bfloat16_rn(v);
  };
  auto row = [&](int r) { return min(row0 + r, a.n_rows - 1); };
  if constexpr (ST == Stage::ENC) {
    const int col = c.t % POS_PAD;
    float v[ROWS * POS_PAD / WG_THREADS];
#pragma unroll
    for (int j = 0; j < ROWS * POS_PAD / WG_THREADS; ++j)
      v[j] = a.enc[row(c.t / POS_PAD + 2 * j) * POS_PAD + col];
#pragma unroll
    for (int j = 0; j < ROWS * POS_PAD / WG_THREADS; ++j)
      put(enc, c.t / POS_PAD + 2 * j, col, v[j]);
    const int vcol = c.t % VIEW_PAD;
    float w[ROWS * VIEW_PAD / WG_THREADS];
#pragma unroll
    for (int j = 0; j < ROWS * VIEW_PAD / WG_THREADS; ++j)
      w[j] = a.venc[row(c.t / VIEW_PAD + 4 * j) * VIEW_PAD + vcol];
#pragma unroll
    for (int j = 0; j < ROWS * VIEW_PAD / WG_THREADS; ++j)
      put(venc, c.t / VIEW_PAD + 4 * j, vcol, w[j]);
  } else {
    // positions: warp w stages column 32 (w % 2) + lane of rows w / 2 + 2j,
    // j < 32; lane j loads (or makes) the coordinates of row w / 2 + 2j
    const int col = 32 * (c.warp & 1) + c.lane;
    const Encoding pos = encoding(a.s_pos, a.p_pos, POS_PAD, col);
    const Encoding view = encoding(a.s_view, a.p_view, VIEW_PAD, c.lane);
    const long long gl = row((c.warp >> 1) + 2 * c.lane);
    float xl0, xl1, xl2;
    if constexpr (ST == Stage::XYZ) {
      xl0 = a.xyz[3 * gl], xl1 = a.xyz[3 * gl + 1], xl2 = a.xyz[3 * gl + 2];
    } else if constexpr (ST == Stage::XP) {  // the prefix clamped its rows already
      const float* xp =
          reinterpret_cast<const float*>(c.act() + XP_OFFSET) + 4 * ((c.warp >> 1) + 2 * c.lane);
      xl0 = xp[0], xl1 = xp[1], xl2 = xp[2];
    } else {
      const long long ray = gl / a.samples_per_ray;
      const float t = a.t_vals[gl];
      xl0 = __fadd_rn(a.rays_o[3 * ray + 0], __fmul_rn(t, a.rays_d[3 * ray + 0]));
      xl1 = __fadd_rn(a.rays_o[3 * ray + 1], __fmul_rn(t, a.rays_d[3 * ray + 1]));
      xl2 = __fadd_rn(a.rays_o[3 * ray + 2], __fmul_rn(t, a.rays_d[3 * ray + 2]));
    }
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const float x0 = __shfl_sync(0xffffffffu, xl0, j), x1 = __shfl_sync(0xffffffffu, xl1, j),
                  x2 = __shfl_sync(0xffffffffu, xl2, j);
      put(enc, (c.warp >> 1) + 2 * j, col, pos(x0, x1, x2, col));
    }
    // view directions: warp w stages column lane of rows w + 4j, j < 16;
    // lane j (and j + 16) loads the ray of row w + 4j
    const float* d = a.vdir + 3 * (row(c.warp + 4 * (c.lane & 15)) / a.samples_per_ray);
    const float dl0 = d[0], dl1 = d[1], dl2 = d[2];
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const float d0 = __shfl_sync(0xffffffffu, dl0, j), d1 = __shfl_sync(0xffffffffu, dl1, j),
                  d2 = __shfl_sync(0xffffffffu, dl2, j);
      put(venc, c.warp + 4 * j, c.lane, view(d0, d1, d2, c.lane));
    }
  }
}

// A 64-bit value, or the shared address of a warpgroup's tile, opaque to the
// compiler where it is made: what is made from it (a product's descriptors,
// a workspace row's address) is made again at each use, not hoisted out of
// the tile loop into registers the accumulator needs.
template <class T>
__device__ __forceinline__ T opaque(T v) {
  asm volatile("" : "+l"(v));
  return v;
}
__device__ __forceinline__ uint32_t tile_addr(const Consumer& c, int offset) {
  uint32_t a = c.b.base + offset;
  asm volatile("" : "+r"(a));
  return a;
}
__device__ __forceinline__ uint32_t act_addr(const Consumer& c) {
  return tile_addr(c, SM_ACT + c.wg * 4 * A_CHUNK_BYTES);
}
__device__ __forceinline__ uint32_t enc_addr(const Consumer& c) {
  return tile_addr(c, SM_ENC + c.wg * A_CHUNK_BYTES);
}
__device__ __forceinline__ uint32_t venc_addr(const Consumer& c) {
  return tile_addr(c, SM_VENC + c.wg * A_CHUNK_BYTES);
}

// The act workspace's chunks of the warpgroup's block, made again where
// they are used: kept across the layers, they would take registers the
// accumulator and the epilogue's bias loads need.
template <class L>
struct WsRows {
  const FwdArgs& a;
  long long row0;
  __device__ __forceinline__ uint8_t* act(int chunk) const {
    return ws_block(a.act, L::ACT_CHUNKS, opaque(row0)) + chunk * CHUNK_BYTES;
  }
};

// One warpgroup's 64 rows of a forward tile from its staged enc / venc
// tiles (fenced and synchronised): the two-stream body of trunk_tile, every
// activation also sent to the workspaces.  In the vanilla layout the view
// layer ends the MLP with the rgb head; in the articulated one (L::ART) it
// is a hidden layer, and v0 is left in the activation tile for the view
// branch.
template <class L>
__device__ __forceinline__ void forward_trunk(Consumer& c, float (&acc)[128], const FwdArgs& a,
                                              long long row0) {
  constexpr Body B = Body::TWO_STREAM;
  const WsRows<L> ws{a, row0};
  auto act = [&](int chunk) { return ws.act(chunk); };
  auto mask = [&](int layer) {
    return a.mask + static_cast<size_t>(opaque(row0)) * LDM + layer * WIDTH / 8;
  };
  store_tile(c, c.enc(), act(ACT_C_ENC), CHUNK_BYTES);
  store_tile(c, c.venc(), act(ACT_C_VENC), CHUNK_BYTES);

  product<B, WIDTH, 1>(c, acc, enc_addr(c));
  finish(c, acc);
  sync_stored(c);
  epilogue<B, Epi::HIDDEN, WIDTH, false, false, true>(c, acc, a.bias, a.bias, a.out_rgb,
                                                     a.out_sigma, row0, a.n_rows, mask(0), LDM);
  fence_async_shared();
  c.sync();
  store_tile(c, c.act(), act(ACT_C_A0), 4 * CHUNK_BYTES);

#pragma unroll 1
  for (int layer = 1; layer < 8; ++layer) {
    const float* lb = a.bias + layer * WIDTH;
    product<B, WIDTH, 4>(c, acc, act_addr(c));
    if (layer == 5)  // skip: layer5(cat[h, enc]) == h @ w5a + enc @ w5b
      product<B, WIDTH, 1, KCHUNK / 16, true>(c, acc, enc_addr(c));
    finish(c, acc);
    sync_stored(c);
    uint8_t* lm = mask(layer);
    if (layer == 7)
      epilogue<B, Epi::DENSITY, WIDTH, false, false, true>(c, acc, lb, a.bias, a.out_rgb,
                                                           a.out_sigma, row0, a.n_rows, lm, LDM);
    else
      epilogue<B, Epi::HIDDEN, WIDTH, false, false, true>(c, acc, lb, a.bias, a.out_rgb,
                                                          a.out_sigma, row0, a.n_rows, lm, LDM);
    fence_async_shared();
    c.sync();
    store_tile(c, c.act(), act(ACT_C_A0 + 4 * layer), 4 * CHUNK_BYTES);
  }

  // the bottleneck (f32 + bias, rounded; no relu) over h7
  product<B, WIDTH, 4>(c, acc, act_addr(c));
  finish(c, acc);
  sync_stored(c);
  epilogue<B, Epi::BOTTLENECK, WIDTH>(c, acc, a.bias + OFF_BB, a.bias, a.out_rgb, a.out_sigma,
                                      row0, a.n_rows);
  fence_async_shared();
  c.sync();
  store_tile(c, c.act(), act(ACT_C_BOTT), 4 * CHUNK_BYTES);

  // view layer: v = relu(bott @ wva + venc @ wvb + bv), kept for the
  // backward; the rgb head (vanilla)
  product<B, COND, 4>(c, acc, act_addr(c));
  product<B, COND, 1, VIEW_PAD / 16, true>(c, acc, venc_addr(c));
  finish(c, acc);
  sync_stored(c);  // every warp's products on bott, and its copy, are done
  if constexpr (L::ART)
    epilogue<B, Epi::HIDDEN, COND>(c, acc, a.bias + OFF_BV, a.bias, a.out_rgb, a.out_sigma, row0,
                                   a.n_rows);
  else
    epilogue<B, Epi::RGB, COND, false, true>(c, acc, a.bias + OFF_BV, a.bias, a.out_rgb,
                                             a.out_sigma, row0, a.n_rows);
  fence_async_shared();
  c.sync();
  store_tile(c, c.act(), act(ACT_C_V), 2 * CHUNK_BYTES);
}

// One warpgroup's 64 rows of a vanilla forward tile: its inputs staged, then
// forward_trunk.
template <Stage ST>
__device__ __forceinline__ void forward_tile(Consumer& c, float (&acc)[128], const FwdArgs& a,
                                             long long row0) {
  sync_stored(c);  // the last tile's products on enc / venc are done, and its copies
  stage_rows<ST>(c, a, row0);
  fence_async_shared();
  c.sync();
  forward_trunk<VanillaLayout>(c, acc, a, row0);
}

// ------------------------------------------------------------ backward

struct BwdArgs {
  const float* g;   // (n_rows, 4) = (g_rgb, g_sigma)
  const bf16* W;    // the training blob
  const bf16* act;  // blocked, ACT_CHUNKS chunks a block
  const uint8_t* mask;
  bf16* grad;       // blocked, GRAD_CHUNKS chunks a block
  float* gw;        // f32 gradient blob: weights at the kernel blob's offsets, then biases
  long long n_rows;
};

// The producer of the backward: the 34 slabs of each tile, all 32 KB.
__device__ __forceinline__ void produce_backward(const Block& b, const bf16* __restrict__ W,
                                                 long long n_tiles) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(W + TRAIN_OFF_BWD);
  int stage = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int s = 0; s < N_BWD_SLABS; ++s) {
      mbar_wait(b.empty(stage), phase ^ 1);
      mbar_expect_tx(b.full(stage), SLAB_BYTES);
      bulk_copy(b.base + SM_RING + stage * SLAB_BYTES, src + static_cast<size_t>(s) * SLAB_BYTES,
                SLAB_BYTES, b.full(stage));
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
  }
}

// The relu mask bits of layer l for the two rows a thread's fragments hold
// (r0 and r0 + 8 of the warpgroup's 64), in fragment order: bit 2i + p of
// the 64 for column 8i + 2q + p.
struct MaskRows {
  uint32_t lo[2], hi[2];
};

__device__ __forceinline__ void load_mask(MaskRows& m, const uint8_t* __restrict__ mask_rows,
                                          int r0, int q, int byte0) {
  const uint8_t* lo = mask_rows + static_cast<size_t>(r0) * LDM + byte0 + 8 * q;
  const uint2 l = __ldg(reinterpret_cast<const uint2*>(lo));
  const uint2 h = __ldg(reinterpret_cast<const uint2*>(lo + 8 * LDM));
  m.lo[0] = l.x, m.lo[1] = l.y, m.hi[0] = h.x, m.hi[1] = h.y;
}

// One halving exchange of a column-sum reduction: the lane and its partner
// (lane ^ lane_mask) each keep one half of s[0, 2 HALF) (the upper one where
// `upper`), summed with the partner's copy of it, in s[0, HALF).
template <int HALF, int M>
__device__ __forceinline__ void halve(float (&s)[M], bool upper, int lane_mask) {
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? s[j] : s[j + HALF];
    const float keep = upper ? s[j + HALF] : s[j];
    s[j] = keep + __shfl_xor_sync(0xffffffffu, send, lane_mask);
  }
}

// A backward layer's epilogue on the accumulator of its N columns (256, or
// 128 in the articulated kernels' narrow layers): with JOIN the density
// head's bf16(g_sigma) wd^T added (D7), with MASK the relu mask applied; D as
// bf16 over the layer's input tile, and the f32 column sums of the result as
// the warp's row of `part` (4 warps x N).  A thread holds two rows of N / 4
// columns; the eight lanes that share its columns sum them in three halving
// exchanges (56 shuffles at N = 256, not 3 x 64), after which each holds N /
// 32 whole column sums of the warp's 16 rows.  `add_parts` then adds the
// four rows to the block's sums.
template <bool MASK, bool JOIN, int N = WIDTH>
__device__ __forceinline__ void backward_epilogue(const Consumer& c, const float (&acc)[128],
                                                  const MaskRows& m, const float* gt,
                                                  float* part) {
  constexpr int S = N / 4;
  const int x = c.lane >> 2, q = c.lane & 3, r0 = 16 * c.warp + x;
  uint8_t* tile = c.act();
  const bf16* wd = reinterpret_cast<const bf16*>(c.b.smem + SM_HEADS);
  float gs_lo = 0.0f, gs_hi = 0.0f;
  if constexpr (JOIN) {
    gs_lo = round_bf16(gt[4 * r0 + 3]);
    gs_hi = round_bf16(gt[4 * (r0 + 8) + 3]);
  }
  float s[S];  // column 8 (j / 2) + 2q + j % 2, both rows
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = 8 * i + 2 * q;
    float v0 = acc[4 * i], v1 = acc[4 * i + 1], v2 = acc[4 * i + 2], v3 = acc[4 * i + 3];
    if constexpr (JOIN) {
      const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wd + col));
      v0 += gs_lo * w.x, v1 += gs_lo * w.y, v2 += gs_hi * w.x, v3 += gs_hi * w.y;
    }
    if constexpr (MASK) {
      const uint32_t bl = m.lo[i >> 4] >> (2 * (i & 15));
      const uint32_t bh = m.hi[i >> 4] >> (2 * (i & 15));
      if (!(bl & 1u)) v0 = 0.0f;
      if (!(bl & 2u)) v1 = 0.0f;
      if (!(bh & 1u)) v2 = 0.0f;
      if (!(bh & 2u)) v3 = 0.0f;
    }
    s[2 * i] = v0 + v2;
    s[2 * i + 1] = v1 + v3;
    *reinterpret_cast<uint32_t*>(tile + pair_offset(i, r0, x, q)) = pack_bf16(v0, v1);
    *reinterpret_cast<uint32_t*>(tile + pair_offset(i, r0 + 8, x, q)) = pack_bf16(v2, v3);
  }
  halve<S / 2>(s, x & 1, 4);
  halve<S / 4>(s, (x >> 1) & 1, 8);
  halve<S / 8>(s, (x >> 2) & 1, 16);
  const int base = (S / 2) * (x & 1) + (S / 4) * ((x >> 1) & 1) + (S / 8) * ((x >> 2) & 1);
  float* row = part + N * c.warp;
#pragma unroll
  for (int j = 0; j < S / 8; ++j) {
    const int idx = base + j;
    row[8 * (idx >> 1) + 2 * q + (idx & 1)] = s[j];
  }
}

// The four warps' rows of column sums (written and synchronised) into the
// block's sums of a layer: thread t adds columns 2t and 2t + 1 (N = 256) or
// column t (N = 128).
template <int N = WIDTH>
__device__ __forceinline__ void add_parts(const Consumer& c, const float* part, float* sums) {
  if constexpr (N == COND) {
    sum_add(sums + c.t,
            (part[c.t] + part[COND + c.t]) + (part[2 * COND + c.t] + part[3 * COND + c.t]));
  } else {
    const float2 p0 = reinterpret_cast<const float2*>(part)[c.t];
    const float2 p1 = reinterpret_cast<const float2*>(part + WIDTH)[c.t];
    const float2 p2 = reinterpret_cast<const float2*>(part + 2 * WIDTH)[c.t];
    const float2 p3 = reinterpret_cast<const float2*>(part + 3 * WIDTH)[c.t];
    sum_add(sums + 2 * c.t, (p0.x + p1.x) + (p2.x + p3.x));
    sum_add(sums + 2 * c.t + 1, (p0.y + p1.y) + (p2.y + p3.y));
  }
}

// The head phase of a backward tile: dv = (bf16(g_rgb) @ wrgb^T) * relu'(v)
// into the D tile (K-chunks 0 and 1); the sums of dv (bv), of v^T bf16(g_rgb)
// (wrgb), of a7^T bf16(g_sigma) (wd) and of the unrounded g (brgb, bd) into
// the block's sums.  Thread t owns column t of v and columns t and t + 128 of
// a7 over the 64 rows, so its sums need no exchange; a warp's loads of a row
// are 64 contiguous bytes of the act workspace's swizzled chunks, 16 rows
// in flight at a time.
// In the articulated layout (L) the head sits on v3: `v_chunk` and `bv` name
// its activation's chunk and its bias's place in the block's sums.
template <class L = VanillaLayout>
__device__ __forceinline__ void head_phase(const Consumer& c, const BwdArgs& a, const float* gt,
                                           long long row0, float* sums, int v_chunk = ACT_C_V,
                                           int bv = OFF_BV) {
  constexpr int BATCH = 16;
  const uint8_t* act = ws_block(a.act, L::ACT_CHUNKS, row0);
  auto at = [&](int chunk, int r, int col) {  // bf16 (r, col) of a run of chunks
    return *reinterpret_cast<const bf16*>(act + (chunk + (col >> 6)) * CHUNK_BYTES +
                                          swizzled(r, col & 63));
  };
  const int col = c.t;
  const bf16* heads = reinterpret_cast<const bf16*>(c.b.smem + SM_HEADS);
  const float w0 = __bfloat162float(heads[WIDTH + 3 * col]);
  const float w1 = __bfloat162float(heads[WIDTH + 3 * col + 1]);
  const float w2 = __bfloat162float(heads[WIDTH + 3 * col + 2]);
  float bs = 0.0f, wg0 = 0.0f, wg1 = 0.0f, wg2 = 0.0f, wd_lo = 0.0f, wd_hi = 0.0f;
  uint8_t* tile = c.act();
#pragma unroll 1
  for (int r0 = 0; r0 < WG_ROWS; r0 += BATCH) {
    bf16 v[BATCH], lo[BATCH], hi[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      v[j] = at(v_chunk, r0 + j, col);
      lo[j] = at(ACT_C_A0 + 4 * 7, r0 + j, col);
      hi[j] = at(ACT_C_A0 + 4 * 7, r0 + j, col + COND);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + j;
      const float g0 = round_bf16(gt[4 * r]), g1 = round_bf16(gt[4 * r + 1]),
                  g2 = round_bf16(gt[4 * r + 2]), gs = round_bf16(gt[4 * r + 3]);
      const float vv = __bfloat162float(v[j]);
      float dv = fmaf(g2, w2, fmaf(g1, w1, g0 * w0));
      if (!(vv > 0.0f)) dv = 0.0f;
      bs += dv;
      wg0 = fmaf(vv, g0, wg0), wg1 = fmaf(vv, g1, wg1), wg2 = fmaf(vv, g2, wg2);
      wd_lo = fmaf(__bfloat162float(lo[j]), gs, wd_lo);
      wd_hi = fmaf(__bfloat162float(hi[j]), gs, wd_hi);
      *reinterpret_cast<bf16*>(tile + (col >> 6) * A_CHUNK_BYTES + swizzled(r, col & 63)) =
          __float2bfloat16_rn(dv);
    }
  }
  sum_add(sums + bv + col, bs);
  sum_add(sums + L::SUM_WRGB + 3 * col, wg0);
  sum_add(sums + L::SUM_WRGB + 3 * col + 1, wg1);
  sum_add(sums + L::SUM_WRGB + 3 * col + 2, wg2);
  sum_add(sums + L::SUM_WD + col, wd_lo);
  sum_add(sums + L::SUM_WD + COND + col, wd_hi);
  if (c.t < 4) {  // brgb, bd: sums of the unrounded g
    float sg = 0.0f;
    for (int r = 0; r < WG_ROWS; ++r) sg += gt[4 * r + c.t];
    sum_add(sums + (c.t < 3 ? OFF_BRGB + c.t : OFF_BD), sg);
  }
}

// The chain from dv, the view layer's D, which the caller left in the
// activation tile (K-chunks 0 and 1; written, fenced and synchronised) and
// sent to the grad workspace: dbott = bf16(dv) @ wva^T, D7 = (bf16(dbott) @
// wb^T + bf16(g_sigma) wd^T) * relu'(a7) and D_l = (bf16(D_{l+1}) @
// w_{l+1}^T) * relu'(a_l) down to D0, each D to the grad workspace and its
// column sums to the block's sums.  Layer 5 backpropagates through w5a only.
// Leaves D0 in the activation tile, fenced and synchronised, its store sent.
template <class L>
__device__ __forceinline__ void backward_chain(Consumer& c, float (&acc)[128], const BwdArgs& a,
                                               long long row0, const float* gt, float* part,
                                               float* sums) {
  constexpr Body B = Body::TWO_STREAM;
  const uint8_t* mask = a.mask + static_cast<size_t>(row0) * LDM;
  uint8_t* grad = ws_block(a.grad, L::GRAD_CHUNKS, row0);
  const int r0 = 16 * c.warp + (c.lane >> 2);

  MaskRows m;
  product<B, WIDTH, COND / KCHUNK>(c, acc, c.act());
  finish(c, acc);
  sync_stored(c);
  backward_epilogue<false, false>(c, acc, m, gt, part);
  fence_async_shared();
  c.sync();
  store_tile(c, c.act(), grad + GR_C_BOTT * CHUNK_BYTES, 4 * CHUNK_BYTES);
  add_parts(c, part, sums + OFF_BB);

#pragma unroll 1
  for (int layer = 7; layer >= 0; --layer) {
    load_mask(m, mask, r0, c.lane & 3, layer * WIDTH / 8);
    product<B, WIDTH, 4>(c, acc, c.act());
    finish(c, acc);
    sync_stored(c);
    if (layer == 7)
      backward_epilogue<true, true>(c, acc, m, gt, part);
    else
      backward_epilogue<true, false>(c, acc, m, gt, part);
    fence_async_shared();
    c.sync();
    store_tile(c, c.act(), grad + 4 * layer * CHUNK_BYTES, 4 * CHUNK_BYTES);
    add_parts(c, part, sums + layer * WIDTH);
  }
}

// The tile's g rows, (64, 4), into gt: rows past n_rows are 0.
__device__ __forceinline__ void load_g(const Consumer& c, const BwdArgs& a, long long row0,
                                       float* gt) {
  for (int i = c.t; i < WG_ROWS * 4; i += WG_THREADS)
    gt[i] = row0 + (i >> 2) < a.n_rows ? a.g[4 * row0 + i] : 0.0f;
  c.sync();
}

// One warpgroup's 64 rows of a backward tile, the two-stream schedule of the
// forward: the head phase, then backward_chain.
__device__ __forceinline__ void backward_tile(Consumer& c, float (&acc)[128], const BwdArgs& a,
                                              long long row0, float* sums) {
  float* gt = reinterpret_cast<float*>(c.enc());  // the tile's g rows, (64, 4)
  float* part = gt + WG_ROWS * 4;                  // the warps' column sums, (4, 256)
  uint8_t* grad = ws_block(a.grad, GRAD_CHUNKS, row0);

  sync_stored(c);  // the last tile's reads of its g rows, D tile and copies are done
  load_g(c, a, row0, gt);
  head_phase(c, a, gt, row0, sums);
  fence_async_shared();
  c.sync();
  store_tile(c, c.act(), grad + GR_C_V * CHUNK_BYTES, 2 * CHUNK_BYTES);
  backward_chain<VanillaLayout>(c, acc, a, row0, gt, part, sums);
}

// The block's sums into the gradient blob, once per block; the consumer
// threads call it after their last tile.
__device__ __forceinline__ void flush_sums(const float* sums, float* __restrict__ gw) {
  bar_sync(BAR_CONSUMERS, CONSUMER_THREADS);
  for (int i = threadIdx.x; i < N_SUMS; i += CONSUMER_THREADS) {
    const int dst = i < SUM_WD ? N_WEIGHTS + i
                               : (i < SUM_WRGB ? OFF_WD + i - SUM_WD : OFF_WRGB + i - SUM_WRGB);
    atomicAdd(gw + dst, sums[i]);
  }
}

// ------------------------------------------------------------ weight gradients

constexpr int WGRAD_STAGES = 4;
constexpr int WGRAD_X_BYTES = 2 * CHUNK_BYTES;                   // 2 x 64 features of X
constexpr int WGRAD_STAGE_BYTES = WGRAD_X_BYTES + 4 * CHUNK_BYTES;  // + 256 columns of D
constexpr int WGRAD_BARS = WGRAD_STAGES * WGRAD_STAGE_BYTES;     // full[S], empty[S]
constexpr int WGRAD_SMEM_BYTES = WGRAD_BARS + 2 * WGRAD_STAGES * 8 + 1024;
constexpr int WGRAD_THREADS = CONSUMER_THREADS + 32;             // + the producer warp
constexpr int WGRAD_ITEM_INTS = 8;
static_assert(WGRAD_SMEM_BYTES <= 232448, "shared memory budget");

// A work item of the weight gradients (ops/train_sm90.py `wgrad_items`):
// dW[m, n] += sum over the rows of blocks [block_begin, block_end) of X[r, m]
// D[r, n] for m < m_count, n < n_count, at gw[out + m * ld_out + n]; X is
// the act workspace's chunks from x_chunk (m_count <= 128 columns), D the
// grad workspace's chunks from d_chunk (n_count columns).
struct WgradItem {
  int x_chunk, m_count, d_chunk, n_count, out, ld_out, block_begin, block_end;
};

// wgmma shared-memory descriptor of an MN-major operand with the 128-byte
// swizzle: K-lines of 64 MN-elements 128 B apart, 8-line groups 1024 B apart
// (stride byte offset), 64-element MN-blocks `lbo` bytes apart (leading byte
// offset).  Stepping K by 16 adds 2048 B.
__device__ __forceinline__ uint64_t descriptor_mn(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// D[64 x 256] += A[64 x 16] B[16 x 256], both from shared memory in the
// MN-major layout (transpose bits set); d[0..127] in wgmma's fragment order.
__device__ __forceinline__ void wgmma_n256_mn(float (&d)[128], uint64_t a, uint64_t b) {
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
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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

// D[64 x 128] += A[64 x 16] B[16 x 128], both from shared memory in the
// MN-major layout (transpose bits set); d[0..63] in wgmma's fragment order.
__device__ __forceinline__ void wgmma_n128_mn(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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

// The producer thread: every row block of the item, X's and D's chunks of
// it into a ring stage; ACTC / GRADC chunks a workspace block.
template <int ACTC, int GRADC>
__device__ __forceinline__ void wgrad_produce(uint32_t ring, const WgradItem& it,
                                              const uint8_t* act, const uint8_t* grad) {
  const int xb = it.m_count > KCHUNK ? 2 : 1, db = it.n_count / KCHUNK;
  const uint32_t bytes = (xb + db) * CHUNK_BYTES;
  int stage = 0;
  uint32_t phase = 0;
  for (int blk = it.block_begin; blk < it.block_end; ++blk) {
    const uint32_t full = ring + WGRAD_BARS + 8 * stage;
    const uint32_t empty = full + 8 * WGRAD_STAGES;
    const uint32_t dst = ring + stage * WGRAD_STAGE_BYTES;
    mbar_wait(empty, phase ^ 1);
    mbar_expect_tx(full, bytes);
    const uint8_t* x = act + (static_cast<size_t>(blk) * ACTC + it.x_chunk) * CHUNK_BYTES;
    const uint8_t* d = grad + (static_cast<size_t>(blk) * GRADC + it.d_chunk) * CHUNK_BYTES;
    for (int j = 0; j < xb; ++j) bulk_copy(dst + j * CHUNK_BYTES, x + j * CHUNK_BYTES, CHUNK_BYTES, full);
    for (int j = 0; j < db; ++j)
      bulk_copy(dst + WGRAD_X_BYTES + j * CHUNK_BYTES, d + j * CHUNK_BYTES, CHUNK_BYTES, full);
    if (++stage == WGRAD_STAGES) { stage = 0; phase ^= 1; }
  }
}

// A consumer warpgroup: its 64 rows of dW over every row block, then its
// sums to gw.  A warpgroup past m_count (a 64- or 32-row dW) only frees the
// stages.
template <int N>
__device__ __forceinline__ void wgrad_consume(uint32_t ring, const WgradItem& it,
                                              float* __restrict__ gw) {
  const int wg = threadIdx.x / WG_THREADS, t = threadIdx.x % WG_THREADS;
  const int warp = t >> 5, lane = t & 31;
  const bool active = wg * KCHUNK < it.m_count;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int stage = 0, pending = -1;
  uint32_t phase = 0;
#pragma unroll 1
  for (int blk = it.block_begin; blk < it.block_end; ++blk) {
    const uint32_t full = ring + WGRAD_BARS + 8 * stage;
    mbar_wait(full, phase);
    if (active) {
      const uint32_t xa = ring + stage * WGRAD_STAGE_BYTES + wg * CHUNK_BYTES;
      const uint32_t db = ring + stage * WGRAD_STAGE_BYTES + WGRAD_X_BYTES;
      acc_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BLOCK_ROWS / 16; ++k) {
        const uint64_t da = descriptor_mn(xa + 2048 * k, CHUNK_BYTES);
        const uint64_t dd = descriptor_mn(db + 2048 * k, CHUNK_BYTES);
        if constexpr (N == WIDTH) wgmma_n256_mn(acc, da, dd);
        else wgmma_n128_mn(acc, da, dd);
      }
      wgmma_commit();
      if (pending >= 0) {  // the block before this one is done: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(ring + WGRAD_BARS + 8 * (WGRAD_STAGES + pending));
      }
      pending = stage;
      acc_fence(acc);
    } else if (lane == 0) {
      mbar_arrive(ring + WGRAD_BARS + 8 * (WGRAD_STAGES + stage));
    }
    if (++stage == WGRAD_STAGES) { stage = 0; phase ^= 1; }
  }
  if (!active) return;
  wgmma_wait<0>();
  acc_fence(acc);
  const int x = lane >> 2, q = lane & 3;
  const int m_lo = wg * KCHUNK + 16 * warp + x, m_hi = m_lo + 8;
  float* out = gw + it.out;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int n = 8 * i + 2 * q;
    if (m_lo < it.m_count) {
      atomicAdd(out + static_cast<size_t>(m_lo) * it.ld_out + n, acc[4 * i]);
      atomicAdd(out + static_cast<size_t>(m_lo) * it.ld_out + n + 1, acc[4 * i + 1]);
    }
    if (m_hi < it.m_count) {
      atomicAdd(out + static_cast<size_t>(m_hi) * it.ld_out + n, acc[4 * i + 2]);
      atomicAdd(out + static_cast<size_t>(m_hi) * it.ld_out + n + 1, acc[4 * i + 3]);
    }
  }
}

// One block per work item (items: WGRAD_ITEM_INTS ints each): two consumer
// warpgroups and a producer warp; the workspaces have ACTC / GRADC chunks a
// block (the vanilla layout's 40 / 38 by default).
template <int ACTC = ACT_CHUNKS, int GRADC = GRAD_CHUNKS>
__global__ void __launch_bounds__(WGRAD_THREADS, 1)
wgrad_kernel(const bf16* __restrict__ act, const bf16* __restrict__ grad, float* __restrict__ gw,
             const int* __restrict__ items) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = raw + ((1024 - (raw & 1023)) & 1023);
  const int* p = items + WGRAD_ITEM_INTS * blockIdx.x;
  const WgradItem it{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  if (threadIdx.x == 0) {
    for (int s = 0; s < WGRAD_STAGES; ++s) {
      mbar_init(ring + WGRAD_BARS + 8 * s, 1);
      mbar_init(ring + WGRAD_BARS + 8 * (WGRAD_STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMER_THREADS) {
    if (threadIdx.x == CONSUMER_THREADS)
      wgrad_produce<ACTC, GRADC>(ring, it, reinterpret_cast<const uint8_t*>(act),
                    reinterpret_cast<const uint8_t*>(grad));
  } else if (it.n_count == WIDTH) {
    wgrad_consume<WIDTH>(ring, it, gw);
  } else {
    wgrad_consume<COND>(ring, it, gw);
  }
}

}  // namespace sm90
}  // namespace aon
