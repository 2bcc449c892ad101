// Shared pieces of the f32 GRU recurrence kernels (K5-fwd in gru_fwd.cu,
// K5-bwd in gru_bwd.cu): the block layout, K1's with three gates. K5 on
// bf16 streams has builds of its own (gru_mma.cuh).
#pragma once

#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace gru {

constexpr int UNITS = 4;                  // hidden units owned by one block
constexpr int GATES = 3;                  // r, z, n
constexpr int ROWS = GATES * UNITS;       // gate rows owned by one block
constexpr int BT = 64;                    // batch rows per tile
constexpr int KSPLIT = 4;                 // the product's K split four ways
constexpr int THREADS = 256;
// the product's 4x4 register tiles: (K slice, gate, 4 batch rows) for 192
// threads; the gate update takes all 256, (batch row, unit)
constexpr int PRODUCT_THREADS = KSPLIT * GATES * (BT / 4);
static_assert(PRODUCT_THREADS <= THREADS, "product layout");
static_assert(THREADS == BT * UNITS, "gate-update layout");

}  // namespace gru
