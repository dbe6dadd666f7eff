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
// Bound on this card: bytes. Each real step reads one direction byte of a
// row no other step of the pair reads; the rows are 64 B apart at band 512
// and the matrix (B x S x band/8, 2.4 GB at the consensus shape) is far
// larger than the 50 MB L2, so each read moves a whole 32 B sector. The
// stream is 5 bytes (int32 idx + uint8 weight) for each of the S steps of
// every pair.
//
// Design: lane = pair, one warp walks 32 pairs (blocks of 4 warps), each
// lane a sequential pointer chase that reads qpw[i-1] directly (the
// Pallas kernel's O(Lq) masked-max scan per step exists only because
// Mosaic has no dynamic gather). Against the two costs of a thread that
// writes its own rows:
// - the stores: the warp walks in lockstep chunks of 32 steps, each lane
//   writing its step k into row `lane`, column k of a per-warp shared
//   tile (idx rows padded to 33 words, weight rows to 36 bytes: both row
//   strides are coprime to the 32 banks in words, so the column writes and
//   the row reads are free of bank conflicts). After the chunk the tile
//   goes out transposed, one pair's 32 steps per store instruction: a
//   128 B line of idx and a 32 B sector of w. Once no lane of the warp is
//   live, the rest of each row is filled with the sink, lanes striding
//   along it;
// - the chase: each live step hints the direction byte the walk will read
//   PREFETCH_ROWS anti-diagonals on into L2 (prefetch.global.L2), its lane
//   predicted from the current diagonal j - i, clamped to the pair's own
//   rows. A hint changes no byte of the output. It pays only while few
//   walks run at once: with every pair of a 32768-pair consensus group
//   walking, the direction reads alone keep device memory busy and the
//   hints, each pulling more than the sector a step reads, slowed the
//   launch by half; in the later rounds, where a tenth of the pairs still
//   walk, they sped it up by a fifth (an H100, PERF.md). So a launch hints
//   only when it expects at most PREFETCH_MAX_WALKS walks: every warp
//   reads the same 32 pairs, spread over the whole batch, and scales the
//   share of them with n + m > 0 to B (a group's empty pairs come in runs,
//   one per converged window, so a warp's own pairs would not do). The
//   hint is a predicated instruction: no branch in the step.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int IDX_ROW = 33;   // words per idx tile row
constexpr int W_ROW = 36;     // bytes per weight tile row
// anti-diagonals between the row a step reads and the row it prefetches;
// even, so the prefetched row has the current row's parity and the
// predicted lane is exact on a path that keeps to its diagonal
constexpr int PREFETCH_ROWS = 32;
static_assert(PREFETCH_ROWS % 2 == 0, "the lane prediction needs even rows");
// the most walks expected in flight at which a launch still hints: hints
// measured faster up to 8790 walks and 37% slower at 16384 (H100)
constexpr int PREFETCH_MAX_WALKS = 12288;

// prefetch.global.L2 of p when on
__device__ __forceinline__ void prefetch_l2_if(const void* p, bool on) {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %1, 0;\n\t"
        "@q prefetch.global.L2 [%0];\n\t}" ::"l"(p),
        "r"(static_cast<int>(on)));
}

__global__ void __launch_bounds__(WARPS * 32)
walk_vote_kernel(const uint8_t* __restrict__ dirs,
                 const int32_t* __restrict__ n_arr,
                 const int32_t* __restrict__ m_arr,
                 const int32_t* __restrict__ bg_arr,
                 const uint16_t* __restrict__ qpw,
                 int32_t* __restrict__ idx_out, uint8_t* __restrict__ w_out,
                 int32_t* __restrict__ fi_out, int32_t* __restrict__ fj_out,
                 int B, int S, int band, int Lq, int L, int K, int CH,
                 int DEL) {
    __shared__ int32_t sidx_all[WARPS][32 * IDX_ROW];
    __shared__ uint8_t sw_all[WARPS][32 * W_ROW];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t* sidx = sidx_all[warp];
    uint8_t* sw = sw_all[warp];
    const int b0 = (blockIdx.x * WARPS + warp) * 32;   // the warp's pair 0
    const int b = b0 + lane;
    const int c = band / 2, U = band / 2, RB = U / 4;
    const int VOT = L * (1 + K) * CH;
    const long long cells = static_cast<long long>(S) * RB;
    // lanes past B stay in the warp (the collectives need all 32), idle
    bool live = b < B;
    const int bb = live ? b : 0;
    const uint8_t* pk = dirs + static_cast<size_t>(bb) * cells;
    const uint16_t* qrow = qpw + static_cast<size_t>(bb) * Lq;
    const int bg = live ? bg_arr[b] : 0;
    int i = live ? n_arr[b] : 0, j = live ? m_arr[b] : 0;
    // pair lane * B / 32 + lane: the offset keeps a pattern whose period
    // divides B / 32 from aliasing with the stride
    const int ps = static_cast<int>(
        (static_cast<long long>(lane) * B / 32 + lane) % B);
    const long long walks =
        static_cast<long long>(
            __popc(__ballot_sync(FULL, n_arr[ps] + m_arr[ps] > 0)))
        * B / 32;
    const bool hint = walks <= PREFETCH_MAX_WALKS;   // the same in every warp
    int run = 0;
    int t0 = 0;
    for (; t0 < S && __any_sync(FULL, live); t0 += 32) {
        const int kn = S - t0 < 32 ? S - t0 : 32;
        for (int k = 0; k < kn; ++k) {
            int addr = VOT;
            unsigned wt = 0;
            if (live) {
                int qpos = i - 1;
                qpos = qpos < 0 ? 0 : (qpos > Lq - 1 ? Lq - 1 : qpos);
                const unsigned pw = qrow[qpos];
                {   // the byte walk_decode reads PREFETCH_ROWS rows on
                    const int ap = i + j - PREFETCH_ROWS;
                    const int pp = (ap + c) & 1;
                    int up = (j - i + c - pp) / 2;
                    up = up < 0 ? 0 : (up > U - 1 ? U - 1 : up);
                    const int row = ap - 1 > 0 ? ap - 1 : 0;
                    long long pf = static_cast<long long>(row) * RB
                                   + up % RB;
                    if (pf > cells - 1) pf = cells - 1;
                    prefetch_l2_if(pk + pf, hint);
                }
                const int op = walk_decode(pk, i, j, c, U, RB, cells);
                if (op == 3) {
                    live = false;
                } else {
                    const int base = static_cast<int>(pw & 7u);
                    const int col = bg + j - 1;
                    const int slot = run < K - 1 ? run : K - 1;
                    int a;
                    if (op == 0)
                        a = col * CH + base;
                    else if (op == 2)
                        a = col * CH + DEL;
                    else
                        a = (L + col * K + slot) * CH + base;
                    if (j >= 1 && col >= 0 && col < L
                        && !(op == 1 && run >= K)) {
                        addr = a;
                        wt = (pw >> 3) & 0xffu;
                    }
                    run = op == 1 ? run + 1 : 0;
                    i -= op != 2;
                    j -= op != 1;
                }
            }
            sidx[lane * IDX_ROW + k] = addr;
            sw[lane * W_ROW + k] = static_cast<uint8_t>(wt);
        }
        __syncwarp();
        for (int p = 0; p < 32 && b0 + p < B; ++p) {
            if (lane < kn) {
                const size_t o = static_cast<size_t>(b0 + p) * S + t0 + lane;
                idx_out[o] = sidx[p * IDX_ROW + lane];
                w_out[o] = sw[p * W_ROW + lane];
            }
        }
        __syncwarp();
    }
    for (int p = 0; p < 32 && b0 + p < B; ++p) {
        const size_t row = static_cast<size_t>(b0 + p) * S;
        for (int t = t0 + lane; t < S; t += 32) {
            idx_out[row + t] = VOT;
            w_out[row + t] = 0;
        }
    }
    if (b < B) {
        fi_out[b] = i;
        fj_out[b] = j;
    }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int rt_walk_vote(const void* dirs, const void* n, const void* m,
                 const void* bg, const void* qpw, void* idx, void* w,
                 void* fi, void* fj, int B, int S, int band, int Lq, int L,
                 int K, int CH, int DEL, void* stream) {
    if (B <= 0) return 0;
    const int pairs = WARPS * 32;
    walk_vote_kernel<<<(B + pairs - 1) / pairs, pairs, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(bg),
        static_cast<const uint16_t*>(qpw), static_cast<int32_t*>(idx),
        static_cast<uint8_t*>(w), static_cast<int32_t*>(fi),
        static_cast<int32_t*>(fj), B, S, band, Lq, L, K, CH, DEL);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
