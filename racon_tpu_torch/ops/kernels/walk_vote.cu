// Fused traceback walk and vote emission for the consensus engine, for
// Hopper.
//
// Replaces racon_tpu/ops/pallas_nw.py:973 (_walk_vote_kernel, K3), launched
// from pallas_walk_vote at racon_tpu/ops/pallas_nw.py:1090. Output is the
// stream of the XLA twins racon_tpu/ops/nw.py:_walk_ops_kernel +
// racon_tpu/ops/poa.py:_vote_from_ops, step for step: for step t of the
// backward walk from (n, m), at position (i, j) before the step,
//   M: idx = col*CH + base          D: idx = col*CH + DEL
//   I: idx = (L + col*K + slot)*CH + base, slot = min(run, K-1)
// with col = bg + j - 1, base/weight from the packed weight<<3|code query
// lane qpw[i-1] (clipped to the row), run the number of I steps just
// before t. A vote is valid when j >= 1 and 0 <= col < L, and an insertion
// run votes only its first K steps of the backward walk (its last K bases);
// invalid steps and every step after the walk ends carry the sink
// VOT = L*(1+K)*CH with weight 0. Returns (fi, fj) like walk_ops.
//
// Design: one thread per pair, a sequential pointer chase that reads
// qpw[i-1] directly (the Pallas kernel's O(Lq) masked-max scan per step
// exists only because Mosaic has no dynamic gather).
//
// Bound on this card: bytes. The walk reads one direction byte and one
// 2-byte query lane per real step and writes 5 bytes (int32 idx + uint8
// weight) for each of the S steps of every pair.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

__global__ void walk_vote_kernel(const uint8_t* __restrict__ dirs,
                                 const int32_t* __restrict__ n_arr,
                                 const int32_t* __restrict__ m_arr,
                                 const int32_t* __restrict__ bg_arr,
                                 const uint16_t* __restrict__ qpw,
                                 int32_t* __restrict__ idx_out,
                                 uint8_t* __restrict__ w_out,
                                 int32_t* __restrict__ fi_out,
                                 int32_t* __restrict__ fj_out, int B, int S,
                                 int band, int Lq, int L, int K, int CH,
                                 int DEL) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int c = band / 2, U = band / 2, RB = U / 4;
    const int VOT = L * (1 + K) * CH;
    const long long cells = static_cast<long long>(S) * RB;
    const uint8_t* pk = dirs + static_cast<size_t>(b) * cells;
    const uint16_t* qrow = qpw + static_cast<size_t>(b) * Lq;
    int32_t* idx = idx_out + static_cast<size_t>(b) * S;
    uint8_t* wv = w_out + static_cast<size_t>(b) * S;
    const int bg = bg_arr[b];
    int i = n_arr[b], j = m_arr[b];
    int run = 0;
    int t = 0;
    for (; t < S; ++t) {
        const int op = walk_decode(pk, i, j, c, U, RB, cells);
        if (op == 3) break;
        int qpos = i - 1;
        qpos = qpos < 0 ? 0 : (qpos > Lq - 1 ? Lq - 1 : qpos);
        const unsigned pw = qrow[qpos];
        const int base = static_cast<int>(pw & 7u);
        const int col = bg + j - 1;
        const int slot = run < K - 1 ? run : K - 1;
        int addr;
        if (op == 0)
            addr = col * CH + base;
        else if (op == 2)
            addr = col * CH + DEL;
        else
            addr = (L + col * K + slot) * CH + base;
        const bool valid = j >= 1 && col >= 0 && col < L
                           && !(op == 1 && run >= K);
        idx[t] = valid ? addr : VOT;
        wv[t] = valid ? static_cast<uint8_t>(pw >> 3) : 0;
        run = op == 1 ? run + 1 : 0;
        i -= op != 2;
        j -= op != 1;
    }
    for (; t < S; ++t) {
        idx[t] = VOT;
        wv[t] = 0;
    }
    fi_out[b] = i;
    fj_out[b] = j;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int rt_walk_vote(const void* dirs, const void* n, const void* m,
                 const void* bg, const void* qpw, void* idx, void* w,
                 void* fi, void* fj, int B, int S, int band, int Lq, int L,
                 int K, int CH, int DEL, void* stream) {
    if (B <= 0) return 0;
    const int threads = 64;
    walk_vote_kernel<<<(B + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(bg),
        static_cast<const uint16_t*>(qpw), static_cast<int32_t*>(idx),
        static_cast<uint8_t*>(w), static_cast<int32_t*>(fi),
        static_cast<int32_t*>(fj), B, S, band, Lq, L, K, CH, DEL);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
