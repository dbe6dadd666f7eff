// Traceback walk emitting the aligner's packed op stream, for Hopper.
//
// Replaces racon_tpu/ops/pallas_nw.py:643 (_walk_kernel, K2), launched from
// pallas_walk_ops at racon_tpu/ops/pallas_nw.py:720. Output layout is the
// sequential one of the XLA twin racon_tpu/ops/nw.py:_traceback_kernel: op t
// of the backward walk from (n, m) lands in byte t / 4 at shift 2 * (t % 4)
// (0 = M, 1 = I, 2 = D, 3 = inactive), every step after the walk ends is 3,
// and the final (fi, fj) is returned ((0, 0) unless the walk escaped).
//
// Bound on this card: latency. Each step reads one direction byte that the
// previous step chose, so a walk is a chain of dependent steps, and the
// aligner's launches on long reads hold 128-2048 pairs, far too few chains
// to keep device memory busy. The bytes a walk must move (one 32 B sector a row it
// crosses, plus S/4 bytes of output) take a few percent of the time its
// chain takes.
//
// Design: one warp walks one pair (blocks of WARPS warps). All 32 lanes
// carry the same (i, j, t) and decode the same op, so the step never
// diverges; the lanes share the work around the chain:
// - staging. A step lowers a = i + j by 1 or 2 and the walk's lane u moves
//   little within a few dozen rows. Window w covers the direction rows
//   R_w - WIN + 1 .. R_w, R_w = n + m - 1 - WIN * w; lane k stages rows
//   R_w - k, R_w - 32 - k, ... with 16 B cp.async copies of the sectors
//   staged_span names around the lane predicted from the diagonal j - i
//   at the time the copy is issued (rows at or past S, the truncated
//   sweep's clipped read, never). Each warp keeps a ring of NBUF window
//   buffers in shared memory; on entering window w it issues window
//   w + NBUF - 1 and waits for window w, so the device-memory latency is
//   paid once a window and overlaps the walk of the windows before it. A
//   step reads its byte from the buffer when it was staged and from device
//   memory otherwise, as walk_decode does: a wrong prediction costs time,
//   never a byte;
// - the step. With the byte in shared memory the chain is the step's own
//   arithmetic, so the step is one straight line: walk_locate divides by a
//   multiply-high, both reads are predicated, and the warp walks in chunks
//   that stay inside one window and one 512-step line (a read step lowers
//   the row by at most 2), so the step tests neither;
// - output. Lane (t >> 4) & 31 keeps the 32-bit word of steps 16k .. 16k+15
//   in a register, so the warp holds 512 steps, and stores them as one
//   128 B line each time t crosses a multiple of 512 (as bytes where S % 16
//   != 0 leaves the row unaligned). When the walk ends, the word holding its
//   last step is topped up with code 3 and the lanes fill the rest of the
//   row with 0xFF words.
// Launches of more pairs than cuda_nw.walk_ops_body gives this body (of
// the aligner's power-of-two chunks, more than 4096, or 2048 at band 128)
// run walk_ops_thread_kernel, one thread a pair, instead (see there).

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

constexpr int WARPS = 4;
// direction rows (anti-diagonals) a window covers: WIN / 32 rows a lane
// (64 measured 6-9% faster than 32 on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md)
constexpr int WIN = 64;
// window buffers a warp: the walk reads one while NBUF - 1 are in flight
constexpr int NBUF = 2;
// bytes from a sector's edge at which the neighbouring sector is staged too
constexpr int EDGE = 4;
constexpr int SECTOR = 32;
constexpr int SLOT = 2 * SECTOR;   // shared bytes a staged row
constexpr int LINE = 512;          // steps the warp's 32 words hold
constexpr unsigned FULL = 0xffffffffu;
static_assert(WIN % 32 == 0, "a lane stages WIN / 32 rows");
static_assert(NBUF >= 2, "the ring fills one buffer while the walk reads one");

// The sectors staged of a direction row (32 B each, counted from the row's
// start; the last one is 16 B when RB % 32 == 16), for a row whose parity
// term is p = (row + 1 + c) & 1 and a walk predicted on diagonal d: s0
// holds the byte of lane u = clamp((d + c - p) / 2, 0, U - 1); s1 is the
// sector of the lanes across s0's edge when that byte lies within EDGE
// bytes of it, else -1. Neighbours go in lane order: lane u - 1 of byte 0
// is byte RB - 1 of the plane below, so the first sector's neighbour is
// the last (a walk near the band's centre, u ~ 2 RB, reads both ends of the
// row). Both -1 when staging is off. One rule for the copy and the lookup.
struct Span {
    int s0, s1;
};

__device__ __forceinline__ Span staged_span(int p, int d, int c, int U,
                                            int RB, bool stage) {
    if (!stage) return {-1, -1};
    int u = (d + c - p) / 2;
    u = u < 0 ? 0 : (u > U - 1 ? U - 1 : u);
    const int bu = u % RB;
    const int nsec = (RB + SECTOR - 1) / SECTOR;
    const int s = bu / SECTOR;
    const int off = bu - s * SECTOR;
    const int len = RB - s * SECTOR < SECTOR ? RB - s * SECTOR : SECTOR;
    int s1 = -1;
    if (off < EDGE)
        s1 = s == 0 ? nsec - 1 : s - 1;
    else if (off >= len - EDGE)
        s1 = s + 1 == nsec ? 0 : s + 1;
    return {s, s1 == s ? -1 : s1};
}

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = the shared byte at addr, when on (one predicated load, no branch)
__device__ __forceinline__ void lds_u8_if(unsigned& v, unsigned addr,
                                          bool on) {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
        "@q ld.shared.u8 %0, [%1];\n\t}"
        : "+r"(v)
        : "r"(addr), "r"(static_cast<int>(on)));
}

// Sector s (16 or 32 B) of the row at src into dst.
__device__ __forceinline__ void stage_sector(uint8_t* dst, const uint8_t* src,
                                             int s, int RB) {
    if (s < 0) return;
    cp_async16(dst, src + s * SECTOR);
    if (RB - s * SECTOR > 16) cp_async16(dst + 16, src + s * SECTOR + 16);
}

// This lane's rows of the window whose top row is R, predicted on diagonal
// d, into buf (row R - k at byte k * SLOT: s0 first, s1 after it); commits
// them as one group.
__device__ __forceinline__ void stage_window(uint8_t* buf,
                                             const uint8_t* __restrict__ pk,
                                             int R, int d, int lane, int S,
                                             int c, int U, int RB,
                                             bool stage) {
#pragma unroll
    for (int r = 0; r < WIN / 32; ++r) {
        const int k = lane + 32 * r;
        const int row = R - k;
        if (row >= 0 && row < S) {
            const Span sp = staged_span((row + 1 + c) & 1, d, c, U, RB, stage);
            const uint8_t* src = pk + static_cast<size_t>(row) * RB;
            stage_sector(buf + k * SLOT, src, sp.s0, RB);
            stage_sector(buf + k * SLOT + SECTOR, src, sp.s1, RB);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Word k of the pair's row (steps 16k .. 16k+15), clipped to the row's S/4
// bytes: one 32-bit store where S % 16 == 0, else byte by byte.
__device__ __forceinline__ void store_word(uint8_t* __restrict__ out, int k,
                                           unsigned word, int S) {
    if (S % 16 == 0) {
        if (k < S / 16) reinterpret_cast<unsigned*>(out)[k] = word;
        return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
        if (4 * k + q < S / 4)
            out[4 * k + q] = static_cast<uint8_t>(word >> (8 * q));
}

__global__ void __launch_bounds__(WARPS * 32)
walk_ops_kernel(const uint8_t* __restrict__ dirs,
                const int32_t* __restrict__ n_arr,
                const int32_t* __restrict__ m_arr, uint8_t* __restrict__ ops,
                int32_t* __restrict__ fi_out, int32_t* __restrict__ fj_out,
                int B, int S, int band, int stage_ok) {
    __shared__ __align__(16) uint8_t ring_all[WARPS][NBUF][WIN * SLOT];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;
    uint8_t(*ring)[WIN * SLOT] = ring_all[warp];
    const int c = band / 2, U = band / 2, RB = U / 4;
    const bool stage = stage_ok != 0;
    const long long cells = static_cast<long long>(S) * RB;
    const uint8_t* pk = dirs + static_cast<size_t>(b) * cells;
    uint8_t* out = ops + static_cast<size_t>(b) * (S / 4);
    int i = n_arr[b], j = m_arr[b];
    // window w sits in ring[w % NBUF]; cur is the window the walk reads,
    // top its top row, dq[k] the diagonal window cur + k was predicted on
    int top = i + j - 1;
    int dq[NBUF];
#pragma unroll
    for (int k = 0; k < NBUF; ++k) {
        dq[k] = j - i;
        stage_window(ring[k], pk, top - k * WIN, j - i, lane, S, c, U, RB,
                     stage);
    }
    cp_async_wait<NBUF - 1>();
    __syncwarp();
    int cur = 0;
    Span sp0 = staged_span(0, dq[0], c, U, RB, stage);
    Span sp1 = staged_span(1, dq[0], c, U, RB, stage);
    // the shared address of the window the walk reads
    const unsigned ring_s =
        static_cast<unsigned>(__cvta_generic_to_shared(ring[0]));
    unsigned win = ring_s;
    const unsigned inv = walk_inv(RB);
    unsigned word = 0;
    int t = 0;
    int op = 0;
    // chunks of steps that stay in one window and one line, so that the
    // step itself tests neither: a read step lowers the row by at most 2
    while (t < S) {
        const WalkLoc l = walk_locate(i, j, c, U, RB, inv);
        if (l.op < 0 && l.row < top - (WIN - 1)) {   // into the next window
            top -= WIN;
            const int fill = cur;
            cur = cur + 1 == NBUF ? 0 : cur + 1;
            win = ring_s + cur * (WIN * SLOT);
#pragma unroll
            for (int k = 0; k < NBUF - 1; ++k) dq[k] = dq[k + 1];
            dq[NBUF - 1] = j - i;
            __syncwarp();   // every lane is done with the buffer to fill
            stage_window(ring[fill], pk, top - (NBUF - 1) * WIN, j - i, lane,
                         S, c, U, RB, stage);
            cp_async_wait<NBUF - 1>();
            __syncwarp();
            sp0 = staged_span(0, dq[0], c, U, RB, stage);
            sp1 = staged_span(1, dq[0], c, U, RB, stage);
        }
        int end = (t | (LINE - 1)) + 1;
        end = end < S ? end : S;
        if (l.op < 0) {   // the steps before the row can leave the window
            const int stay = t + (l.row - (top - WIN + 1)) / 2 + 1;
            end = end < stay ? end : stay;
        }
        for (; t < end; ++t) {
            const WalkLoc s = walk_locate(i, j, c, U, RB, inv);
            // the byte, from the window when it was staged, else from
            // device memory as walk_decode reads it
            const Span sp = ((s.row + 1 + c) & 1) ? sp1 : sp0;
            const int sec = static_cast<unsigned>(s.byte) / SECTOR;
            const bool hit = s.row < S && (sec == sp.s0 || sec == sp.s1);
            unsigned v = 0;
            lds_u8_if(v, win + (top - s.row) * SLOT
                             + (sec == sp.s0 ? 0 : SECTOR)
                             + (s.byte & (SECTOR - 1)),
                      s.op < 0 && hit);
            if (s.op < 0 && !hit) v = pk[walk_pos(s.row, s.byte, RB, cells)];
            op = s.op >= 0 ? s.op : (v >> (2 * s.plane)) & 3;
            if (op == 3) break;
            if (lane == ((t >> 4) & 31))
                word |= static_cast<unsigned>(op) << (2 * (t & 15));
            i -= op != 2;
            j -= op != 1;
        }
        if (op == 3) break;
        if ((t & (LINE - 1)) == 0) {   // steps t - 512 .. t - 1 are known
            store_word(out, (t - LINE) / 16 + lane, word, S);
            word = 0;
        }
    }
    // the walk ended at step t (t == S: it ran the whole row): code 3 from
    // slot t on, the line that holds t, then 0xFF to the row's end
    const int line0 = t & ~(LINE - 1);
    if (t < S) {
        const int owner = (t >> 4) & 31;
        if (lane == owner)
            word |= FULL << (2 * (t & 15));
        else if (lane > owner)
            word = FULL;
    }
    store_word(out, line0 / 16 + lane, word, S);
    for (int k = line0 / 16 + 32 + lane; 16 * k < S; k += 32)
        store_word(out, k, FULL, S);
    cp_async_wait<0>();   // no copy outlives the warp
    if (lane == 0) {
        fi_out[b] = i;
        fj_out[b] = j;
    }
}

// The thread body, one thread per pair, for launches of many pairs: there
// the warp body's 32 lanes a walk exhaust the card's issue slots (its time
// grows with B from ~2048 pairs on), while a thread's chain of
// device-memory reads overlaps with thousands of others (cuda_nw.
// walk_ops_body picks the body by B and band). Stores byte t / 4 once its
// four steps are known, then fills the rest of the row with 0xFF.
__global__ void walk_ops_thread_kernel(const uint8_t* __restrict__ dirs,
                                       const int32_t* __restrict__ n_arr,
                                       const int32_t* __restrict__ m_arr,
                                       uint8_t* __restrict__ ops,
                                       int32_t* __restrict__ fi_out,
                                       int32_t* __restrict__ fj_out, int B,
                                       int S, int band) {
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
    // 16 B copies need rows of whole 16 B pieces (the Python wrapper
    // requires dirs on a 16 B boundary)
    const int stage = (band / 8) % 16 == 0;
    walk_ops_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(m), static_cast<uint8_t*>(ops),
        static_cast<int32_t*>(fi), static_cast<int32_t*>(fj), B, S, band,
        stage);
    return static_cast<int>(cudaGetLastError());
}

// The thread-per-pair body; returns the cudaError_t of the launch.
int rt_walk_ops_thread(const void* dirs, const void* n, const void* m,
                       void* ops, void* fi, void* fj, int B, int S, int band,
                       void* stream) {
    if (B <= 0) return 0;
    const int threads = 64;
    walk_ops_thread_kernel<<<(B + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(m), static_cast<uint8_t*>(ops),
        static_cast<int32_t*>(fi), static_cast<int32_t*>(fj), B, S, band);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
