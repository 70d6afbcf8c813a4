// Shared device code of the NeRF MLP kernels (fused_mlp_eval.cu,
// level_train.cu, art.cu): the packed weight layout of the vanilla-shaped
// trunk (the row-major kernel blob, which the eval and training blobs are
// gathered from, and the gradient blob), the activation workspace's columns
// and the in-kernel positional encoding.  The articulated kernels embed this
// layout as the head of their own blobs and workspaces.
//
// Matmul operands are bf16 with f32 accumulation and activations are rounded
// to bf16 between layers, as `_mlp_compute` (aon_tpu/ops/fused_mlp.py) and
// `_fwd_activations` (aon_tpu/ops/fused_mlp_train.py) do.
//
// Precision: the sine arguments reach about 3000 rad, so the encoding reduces
// them explicitly, pre - 2pi * floor(pre / 2pi + 0.5), with the subtraction
// rounded once by an explicit __fmaf_rn (as XLA does where it contracts the
// JAX kernel's line; a separately rounded product moves the result by up to
// 1.5e-4 rad), and then calls the accurate sinf.  Every other step uses the
// _rn intrinsics so no contraction is left to the compiler.  Build without
// --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace aon {

using bf16 = __nv_bfloat16;

constexpr int WIDTH = 256;
constexpr int COND = 128;
constexpr int POS_PAD = 64;
constexpr int VIEW_PAD = 32;
// bf16 weight blob: (in, out) row-major matrices in this order; the order is
// fixed by aon_tpu_torch/ops/fused_mlp.py (_KERNEL_WEIGHTS).  The f32
// gradient blob of level_train.cu has the same offsets.
constexpr int OFF_W0 = 0;
constexpr int OFF_W1 = OFF_W0 + POS_PAD * WIDTH;  // w1..w4, w5a follow at WIDTH*WIDTH strides
constexpr int OFF_W5B = OFF_W1 + 5 * WIDTH * WIDTH;
constexpr int OFF_W6 = OFF_W5B + POS_PAD * WIDTH;  // w6, w7
constexpr int OFF_WB = OFF_W6 + 2 * WIDTH * WIDTH;
constexpr int OFF_WVA = OFF_WB + WIDTH * WIDTH;
constexpr int OFF_WVB = OFF_WVA + WIDTH * COND;
constexpr int OFF_WD = OFF_WVB + VIEW_PAD * COND;
constexpr int OFF_WRGB = OFF_WD + WIDTH;
constexpr int N_WEIGHTS = OFF_WRGB + COND * 3;
static_assert(N_WEIGHTS == 594560, "weight blob layout");

// f32 bias blob: b0..b7, bb, bv, bd, brgb (_KERNEL_BIASES).
constexpr int OFF_BB = 8 * WIDTH;
constexpr int OFF_BV = OFF_BB + WIDTH;
constexpr int OFF_BD = OFF_BV + COND;
constexpr int OFF_BRGB = OFF_BD + 1;
constexpr int N_BIASES = OFF_BRGB + 3;

// bf16 activation workspace of the training kernels, one row per sample:
// [enc | a0..a7 | bottleneck | v | venc].  Every block starts on a multiple
// of 64 columns: a chunk of the blocked workspaces (train_sm90.cuh).
constexpr int ACT_ENC = 0;
constexpr int ACT_A0 = ACT_ENC + POS_PAD;  // a_i at ACT_A0 + i * WIDTH
constexpr int ACT_BOTT = ACT_A0 + 8 * WIDTH;
constexpr int ACT_V = ACT_BOTT + WIDTH;
constexpr int ACT_VENC = ACT_V + COND;
constexpr int LDA = ACT_VENC + VIEW_PAD;
static_assert(LDA == 2528, "activation workspace layout");

constexpr float TWO_PI = static_cast<float>(2.0 * 3.14159265358979);

// The pre-activation of one channel of the in-kernel positional encoding,
// the formula of `_encode_in_kernel`: pre = x0*s0 + x1*s1 + x2*s2 + p
// (s: (4, width), p: (1, width)).
__device__ __forceinline__ float encode_pre(float x0, float x1, float x2,
                                            const float* __restrict__ s,
                                            const float* __restrict__ p, int width, int col) {
  float pre = __fmul_rn(x0, __ldg(s + col));
  pre = __fadd_rn(pre, __fmul_rn(x1, __ldg(s + width + col)));
  pre = __fadd_rn(pre, __fmul_rn(x2, __ldg(s + 2 * width + col)));
  return __fadd_rn(pre, __ldg(p + col));
}

// pre - 2pi * floor(pre / 2pi + 0.5), the subtraction rounded once.
__device__ __forceinline__ float reduce_arg(float pre) {
  const float k = floorf(__fadd_rn(__fdiv_rn(pre, TWO_PI), 0.5f));
  return __fmaf_rn(-TWO_PI, k, pre);
}

// One channel of the encoding: channels < 3 pass pre through, the rest are
// sin(reduced).
__device__ __forceinline__ float encode(float x0, float x1, float x2,
                                        const float* __restrict__ s,
                                        const float* __restrict__ p, int width, int col) {
  const float pre = encode_pre(x0, x1, x2, s, p, width, col);
  return col < 3 ? pre : sinf(reduce_arg(pre));
}

}  // namespace aon
