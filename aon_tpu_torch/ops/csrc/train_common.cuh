// The gradient workspace's columns, the head that the vanilla training
// kernels (train_sm90.cuh) lay out and the articulated kernels
// (art_sm90.cuh) extend: [D0..D7 | dbott | dv], D_i the gradient of trunk
// layer i's pre-activation, each rounded to bf16 where it is stored.

#pragma once

#include "mlp_common.cuh"

namespace aon {

constexpr int GR_BOTT = 8 * WIDTH;
constexpr int GR_V = GR_BOTT + WIDTH;
constexpr int LDG = GR_V + COND;
static_assert(LDG == 2432, "gradient workspace layout");

}  // namespace aon
