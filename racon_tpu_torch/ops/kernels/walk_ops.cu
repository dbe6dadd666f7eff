// Traceback walk emitting the aligner's packed op stream, for Hopper.
//
// Replaces racon_tpu/ops/pallas_nw.py:643 (_walk_kernel, K2), launched from
// pallas_walk_ops at racon_tpu/ops/pallas_nw.py:720. Output layout is the
// sequential one of the XLA twin racon_tpu/ops/nw.py:_traceback_kernel: op t
// of the backward walk from (n, m) lands in byte t / 4 at shift 2 * (t % 4)
// (0 = M, 1 = I, 2 = D, 3 = inactive), every step after the walk ends is 3,
// and the final (fi, fj) is returned ((0, 0) unless the walk escaped).
//
// Design: one thread per pair, a sequential pointer chase; a thread stops
// at its pair's last real step and fills the rest of its row with 0xFF.
// The Pallas walk's wavefront-synchronised gap codes are a Mosaic device
// (every consumer keeps only op < 3) and are not reproduced.
//
// Bound on this card: bytes. Each step reads one direction byte chosen by
// the previous step, so the chase is latency-bound per pair; across pairs
// the traffic is one byte read per real step plus S/4 bytes written per
// pair. Pairs run in parallel, one per thread; the reads hit the L2 lines
// the forward pass just wrote.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

__global__ void walk_ops_kernel(const uint8_t* __restrict__ dirs,
                                const int32_t* __restrict__ n_arr,
                                const int32_t* __restrict__ m_arr,
                                uint8_t* __restrict__ ops,
                                int32_t* __restrict__ fi_out,
                                int32_t* __restrict__ fj_out, int B, int S,
                                int band) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int c = band / 2, U = band / 2, RB = U / 4;
    const long long cells = static_cast<long long>(S) * RB;
    const uint8_t* pk = dirs + static_cast<size_t>(b) * cells;
    uint8_t* out = ops + static_cast<size_t>(b) * (S / 4);
    int i = n_arr[b], j = m_arr[b];
    unsigned cur = 0;
    int t = 0;
    for (; t < S; ++t) {
        const int op = walk_decode(pk, i, j, c, U, RB, cells);
        if (op == 3) break;
        cur |= static_cast<unsigned>(op) << (2 * (t & 3));
        if ((t & 3) == 3) {
            out[t >> 2] = static_cast<uint8_t>(cur);
            cur = 0;
        }
        i -= op != 2;
        j -= op != 1;
    }
    // inactive tail: code 3 in every remaining slot
    if (t < S && (t & 3)) {
        for (int k = t & 3; k < 4; ++k) cur |= 3u << (2 * k);
        out[t >> 2] = static_cast<uint8_t>(cur);
        t = (t | 3) + 1;
    }
    for (int k = t >> 2; k < S / 4; ++k) out[k] = 0xFF;
    fi_out[b] = i;
    fj_out[b] = j;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int rt_walk_ops(const void* dirs, const void* n, const void* m, void* ops,
                void* fi, void* fj, int B, int S, int band, void* stream) {
    if (B <= 0) return 0;
    const int threads = 64;
    walk_ops_kernel<<<(B + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(m), static_cast<uint8_t*>(ops),
        static_cast<int32_t*>(fi), static_cast<int32_t*>(fj), B, S, band);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
