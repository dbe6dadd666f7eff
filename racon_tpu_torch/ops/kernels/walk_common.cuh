// One traceback step over the packed direction matrix, shared by the
// walk_ops and walk_vote kernels (the same decode as the XLA walk,
// racon_tpu/ops/nw.py:_walk_op). Returns the op of the step from (i, j):
// 0 = M, 1 = I (consume query), 2 = D (consume target), 3 = done or band
// escape (the position stops moving, so a final (i, j) != (0, 0) flags an
// escape).
#pragma once

#include <cstdint>

__device__ __forceinline__ int walk_decode(const uint8_t* __restrict__ pk,
                                           int i, int j, int c, int U,
                                           int RB, long long cells) {
    if (i == 0) return j == 0 ? 3 : 2;   // done / only D left
    if (j == 0) return 1;                 // only I left
    const int a = i + j;
    const int p = (a + c) & 1;
    const int u = (j - i + c - p) / 2;    // even numerator: exact
    if (u < 0 || u >= U) return 3;        // escaped the band
    long long pos = static_cast<long long>(a - 1) * RB + u % RB;
    if (pos > cells - 1) pos = cells - 1; // truncated sweep: clipped read
    return (pk[pos] >> (2 * (u / RB))) & 3;
}
