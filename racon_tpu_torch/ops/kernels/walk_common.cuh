// One traceback step over the packed direction matrix, shared by the
// walk_ops and walk_vote kernels (the same decode as the XLA walk,
// racon_tpu/ops/nw.py:_walk_op). Ops: 0 = M, 1 = I (consume query),
// 2 = D (consume target), 3 = done or band escape (the position stops
// moving, so a final (i, j) != (0, 0) flags an escape).
#pragma once

#include <cstdint>

// ceil(2^32 / RB), a reciprocal for walk_locate (0 for RB == 1):
// 0xffffffff / RB + 1 is that for every RB >= 2, power of two or not.
__device__ __forceinline__ unsigned walk_inv(int RB) {
    return RB == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(RB) + 1u;
}

// Where the step from (i, j) reads: op >= 0 when the step needs no read
// (i == 0, j == 0, or the band escaped); else the 2-bit code of lane u
// sits in direction row `row`, byte u % RB, plane u / RB. Written with
// selects, no branch, so that a caller's step can stay one straight line.
// u / RB is a division, or, given inv = walk_inv(RB) != 0 (computed once
// by the caller), the high word of u * inv: exact while u * RB < 2^32,
// and u < U = band / 2 <= 4 RB + 3 for every band below 2^17
// (cuda_nw.WALK_MAX_BAND).
struct WalkLoc {
    int op, row, byte, plane;
};

__device__ __forceinline__ WalkLoc walk_locate(int i, int j, int c, int U,
                                               int RB, unsigned inv = 0) {
    const int a = i + j;
    const int p = (a + c) & 1;
    const int u = (j - i + c - p) >> 1;   // even numerator: exact
    const int plane = inv ? static_cast<int>(__umulhi(
                                static_cast<unsigned>(u), inv))
                          : u / RB;
    const int op = i == 0 ? (j == 0 ? 3 : 2)     // done / only D left
                   : j == 0 ? 1                  // only I left
                   : (u < 0 || u >= U) ? 3       // escaped the band
                   : -1;
    return {op, a - 1, plane * -RB + u, plane};
}

// The byte offset a located read takes in its pair's cells: rows at or
// past S are the truncated sweep's clipped read.
__device__ __forceinline__ long long walk_pos(int row, int byte, int RB,
                                              long long cells) {
    const long long pos = static_cast<long long>(row) * RB + byte;
    return pos > cells - 1 ? cells - 1 : pos;
}

// The op of the step from (i, j), read from device memory.
__device__ __forceinline__ int walk_decode(const uint8_t* __restrict__ pk,
                                           int i, int j, int c, int U,
                                           int RB, long long cells) {
    const WalkLoc l = walk_locate(i, j, c, U, RB);
    if (l.op >= 0) return l.op;
    return (pk[walk_pos(l.row, l.byte, RB, cells)] >> (2 * l.plane)) & 3;
}
