// Banded anti-diagonal Needleman-Wunsch forward pass for Hopper (sm_90a).
//
// Replaces racon_tpu/ops/pallas_nw.py:117 (_fwd_kernel, K1) and
// racon_tpu/ops/pallas_nw.py:307 (_fwd_kernel_swar, K4), launched from
// pallas_nw_fwd at racon_tpu/ops/pallas_nw.py:501. Same inputs and the same
// planar 2-bit direction rows and scores as the XLA twin
// racon_tpu/ops/nw.py:_nw_wavefront_kernel (swar=False / swar=True).
//
// Coordinate frame: wavefront a = i + j, U = band/2 lanes holding every
// other diagonal, lane u <-> (i, j) = (I0 - u, J0 + u). Direction row a-1
// holds lane u in byte u % RB at shift 2*(u / RB), RB = band/8.
//
// K1 has three bodies; racon_tpu_torch/ops/cuda_nw.py fwd_i32_body picks one
// per band.
//
// - Warp body (nw_fwd_i32_warp_kernel<LPT>), bands 128..512 that are
//   multiples of 64 (the consensus engine's 512, the aligner's 128 and
//   384): one warp per pair, thread t owns the LPT = band/64 contiguous
//   lanes LPT*t .. LPT*t + LPT-1 in registers, the +-1 lane shifts cross a
//   thread's edge by one shuffle, and the direction bytes are assembled by
//   two shuffle-xor ORs and stored by threads 0-7. No block barrier: a warp
//   stops at its own n + m.
// - Wide body (nw_fwd_i32_wide_kernel<NW>), bands 1024, 4096 and 8192 (the
//   aligner's wide buckets but 2048, where its 128-pair chunk puts 2 warps
//   on an SM and the block body measured faster): one pair per block of
//   NW = band/1024 warps; thread tg owns the direction bytes 4*tg ..
//   4*tg+3, i.e. for each plane q the four contiguous lanes q*RB + 4*tg +
//   k, in registers, and stores its 32-bit share of the row with no
//   exchange. The +-1 lane shifts cross a run's edge by one shuffle a plane
//   inside a warp and through a small ring in shared memory between warps,
//   one barrier over the NW warps per wavefront.
// - Block body (nw_fwd_i32_kernel), every other band (on the main path
//   only band 2048 would reach it, and there the engines take K4): one
//   block per pair, RB threads; thread t owns the four
//   lanes t, t+RB, t+2RB, t+3RB, i.e. exactly the lanes of direction byte
//   t, so a thread packs its byte with no exchange and the block writes one
//   coalesced RB-byte row per wavefront. The +-1 lane shifts read the
//   neighbours' values from a double-buffered shared array, one barrier
//   across all RB threads per anti-diagonal.
// All three stage the pair's query/target rows in shared memory once, keep
// the wavefronts on chip and stop at the pair's own n + m (rows past it
// are never read by any walk and are left unwritten). The warp and wide
// bodies' lane, byte and edge maps are mirrored in numpy, whole loops
// included, and held against the plain version on the CPU in
// tests/test_torch_fwd_lanes.py (K4's wide body in
// tests/test_torch_fwd_packed.py).
//
// K4 (nw_fwd_i16x2) has two bodies; racon_tpu_torch/ops/cuda_nw.py
// fwd_i16x2_body picks one per band. Both hold two int16 scores per 32-bit
// word with the saturation value BIG16 = 0x4800 of racon_tpu/ops/swar.py:
// every real cell value is < max_len + 2 < BIG16 and the {real, BIG, BIG+1}
// classes compare the same, so the direction rows are byte-identical to
// K1's and the score maps BIG16 back to 1 << 28.
//
// - Wide body (nw_fwd_i16x2_wide_kernel<NW, BPT>), bands 256 * BPT * NW
//   (rt_nw_fwd_i16x2_wide lists them): K1's wide layout on int16x2 words,
//   thread tg owning BPT whole direction bytes, stepped with Hopper's DPX
//   min-with-predicate (__vibmin_s16x2, one VIMNMX.S16x2 with two
//   predicate outputs); described at the body.
// - Block body (nw_fwd_i16x2_kernel), every other band: K1's block body on
//   words (lanes t|t+RB and t+2RB|t+3RB), with __vadd2/__vminu2/__vcmpeq2/
//   __vcmpgeu2.
//
// Bound on this card: integer ALU work, 8 operations per DP cell for the
// function (chip_smoke.py OPS_PER_CELL, shared by K1 and K4), against 64
// INT32 lanes per SM per clock. Bytes are small by comparison: two input
// rows per pair and RB bytes out per wavefront. What holds each body above
// that bound: the block body's one barrier across 4-32 warps and its
// shared-memory round trip of every lane per wavefront; the warp and wide
// bodies' per-cell instruction count (byte loads of the two characters,
// the three-way min and direction select, the interior and boundary
// tests), the warp body's three shuffles per wavefront (the edge lane and
// two for the direction row), and the wide body's four edge shuffles, two
// ring accesses and one barrier over NW warps per wavefront.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kBig32 = 1 << 28;
constexpr int kBig16 = 0x4800;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// stage the pair's rows; returns the wavefront exchange buffer base
__device__ __forceinline__ void stage_rows(uint8_t* sq, uint8_t* st,
                                           const uint8_t* qrp,
                                           const uint8_t* tp, int width,
                                           int b, int nthreads) {
    const uint8_t* q = qrp + static_cast<size_t>(b) * width;
    const uint8_t* t = tp + static_cast<size_t>(b) * width;
    for (int x = threadIdx.x; x < width; x += nthreads) {
        sq[x] = q[x];
        st[x] = t[x];
    }
}

__global__ void nw_fwd_i32_kernel(const uint8_t* __restrict__ qrp,
                                  const uint8_t* __restrict__ tp,
                                  const int32_t* __restrict__ n_arr,
                                  const int32_t* __restrict__ m_arr,
                                  uint8_t* __restrict__ dirs,
                                  int32_t* __restrict__ score_out,
                                  int max_len, int band, int width,
                                  int steps) {
    extern __shared__ unsigned char smem[];
    const int c = band / 2, U = band / 2, RB = U / 4, L = max_len;
    const int S = steps;
    const int b = blockIdx.x, t = threadIdx.x;
    uint8_t* sq = smem;
    uint8_t* st = smem + round16(width);
    int32_t* sv = reinterpret_cast<int32_t*>(smem + 2 * round16(width));
    stage_rows(sq, st, qrp, tp, width, b, RB);

    const int n = n_arr[b], m = m_arr[b];
    const int nm = n + m;
    const int last = nm < S ? nm : S;
    const int p0 = c & 1, u0 = (c - p0) / 2;
    int v1[4], v2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int u = t + q * RB;
        v1[q] = (u == u0) ? 0 : kBig32;   // wavefront 0: only (0, 0)
        v2[q] = kBig32;                   // "wavefront -1"
        sv[u] = v1[q];                    // buffer (0 & 1)
    }
    if (t == 0 && (nm == 0 || nm > S))
        score_out[b] = nm == 0 ? 0 : kBig32;
    __syncthreads();

    uint8_t* drow = dirs + static_cast<size_t>(b) * S * RB + t;
    for (int a = 1; a <= last; ++a) {
        const int p = (a + c) & 1;
        const int I0 = (a + c - p) / 2;   // even numerators: exact
        const int J0 = (a - c + p) / 2;
        const int32_t* prev = sv + ((a - 1) & 1) * U;
        const int qs = clampi(c + L - I0, 0, width - U);
        const int ts = clampi(c + J0 - 1, 0, width - U);
        int vn[4];
        unsigned byte = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int u = t + q * RB;
            const int i = I0 - u, j = J0 + u;
            int dsrc, isrc;
            if (p == 0) {
                dsrc = u == 0 ? kBig32 : prev[u - 1];
                isrc = v1[q];
            } else {
                dsrc = v1[q];
                isrc = u == U - 1 ? kBig32 : prev[u + 1];
            }
            const int sub = sq[qs + u] != st[ts + u];
            const int cd = v2[q] + sub;    // diagonal (i-1, j-1)
            const int ci = isrc + 1;       // consume query (i-1, j)
            const int cdel = dsrc + 1;     // consume target (i, j-1)
            const int best = min(cd, min(ci, cdel));
            const unsigned d = cd == best ? 0u : (ci == best ? 1u : 2u);
            const bool interior = i >= 1 && i <= n && j >= 1 && j <= m;
            int v = interior ? min(best, kBig32) : kBig32;
            if (a <= c) {   // DP boundary rows/columns only exist here
                if (i == 0 && j >= 0 && j <= m) v = j;
                if (j == 0 && i >= 1 && i <= n) v = i;
            }
            byte |= d << (2 * q);
            vn[q] = v;
        }
        if (a == nm) {
            // final cell (n, m): u_fin = (m - n + c - p) / 2, clipped
            const int uf = clampi((m - n + c - p) / 2, 0, U - 1);
            if (uf % RB == t) {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (q == uf / RB) score_out[b] = vn[q];
            }
        }
        drow[static_cast<size_t>(a - 1) * RB] = static_cast<uint8_t>(byte);
        int32_t* cur = sv + (a & 1) * U;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            cur[t + q * RB] = vn[q];
            v2[q] = v1[q];
            v1[q] = vn[q];
        }
        __syncthreads();
    }
}

// ------------------------------------------------------ K1, warp body
// Bands 64 * LPT for LPT = 2..8 (128..512): one warp per pair, kWarps pairs
// per block. Thread t owns the LPT contiguous lanes u = LPT * t + k in
// registers; U = 32 * LPT, so no lane is padding. The +-1 lane shifts are
// the thread's own registers but at its edge, where one shuffle brings the
// neighbour's. RB = 8 * LPT, so thread t's lanes all sit in plane t / 8, at
// bytes LPT * (t % 8) + k: an OR over the shuffle-xor partners t ^ 8 and
// t ^ 16 leaves threads 0-7 holding the whole row, LPT bytes each. Warps
// stop at their own n + m; nothing after the staging waits on another warp.

constexpr int kWarps = 4;   // pairs (warps) per block

// store the LPT low bytes of w at dst (aligned to LPT's largest power-of-two
// factor G) as LPT / G stores of G bytes
template <int LPT, typename Word>
__device__ __forceinline__ void store_row_bytes(uint8_t* dst, Word w) {
    constexpr int G = LPT & -LPT;
    using Chunk = std::conditional_t<G == 8, unsigned long long,
                  std::conditional_t<G == 4, unsigned,
                  std::conditional_t<G == 2, unsigned short,
                                     unsigned char>>>;
#pragma unroll
    for (int j = 0; j < LPT / G; ++j)
        reinterpret_cast<Chunk*>(dst)[j] =
            static_cast<Chunk>(w >> (8 * G * j));
}

// one wavefront of one thread's LPT cells, in place: cur[k] holds wavefront
// a - 2 on entry (read only at its own lane, as the diagonal) and wavefront
// a on return; prev holds a - 1. Returns the LPT direction codes, code k in
// byte k. P = wavefront parity; edge = prev's value across the thread's edge
// (lane LPT*t - 1 for P == 0, lane LPT*t + LPT for P == 1); bit k of inner
// marks an interior lane; in the first c wavefronts (Border) lanes kI/kJ
// are the DP boundary cells (i == 0 / j == 0), which take the value a.
template <int LPT, int P, bool Border, typename Word>
__device__ __forceinline__ Word wave_cells(const int (&prev)[LPT],
                                           int (&cur)[LPT], int edge,
                                           const uint8_t* sq,
                                           const uint8_t* st, unsigned inner,
                                           int kI, int kJ, int a) {
    Word dw = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
        int dsrc, isrc;
        if (P == 0) {
            dsrc = k == 0 ? edge : prev[k > 0 ? k - 1 : 0];
            isrc = prev[k];
        } else {
            dsrc = prev[k];
            isrc = k == LPT - 1 ? edge : prev[k < LPT - 1 ? k + 1 : k];
        }
        const int sub = sq[k] != st[k];
        const int cd = cur[k] + sub;   // diagonal (i-1, j-1)
        const int ci = isrc + 1;       // consume query (i-1, j)
        const int cdel = dsrc + 1;     // consume target (i, j-1)
        const int best = __vimin3_s32(cd, ci, cdel);   // DPX: one VIMNMX3
        const unsigned d = cd == best ? 0u : (ci == best ? 1u : 2u);
        int v = (inner >> k) & 1u ? min(best, kBig32) : kBig32;
        if (Border && (k == kI || k == kJ)) v = a;
        dw |= static_cast<Word>(d) << (8 * k);
        cur[k] = v;
    }
    return dw;
}

// one thread's constants for its pair
struct WarpPair {
    const uint8_t* sq;   // the pair's staged rows
    const uint8_t* st;
    uint8_t* drow;       // direction matrix of the pair + the thread's bytes
    int32_t* score;
    int n, m, nm, L, width, t;
};

// wavefront a (parity P) of one thread: cur <- wavefront a from prev = a-1
// and cur = a-2; writes its direction row and, at a == n + m, the score
template <int LPT, int P>
__device__ __forceinline__ void warp_wavefront(const WarpPair& w,
                                               const int (&prev)[LPT],
                                               int (&cur)[LPT], int a) {
    constexpr int U = 32 * LPT, RB = U / 4, c = U;
    constexpr unsigned kFull = 0xffffffffu;
    using Word = std::conditional_t<(LPT > 4), unsigned long long, unsigned>;
    const int u_t = LPT * w.t;   // the thread's first lane
    const int I0 = (a + c - P) / 2;
    const int J0 = (a - c + P) / 2;
    const int qs = clampi(c + w.L - I0, 0, w.width - U) + u_t;
    const int ts = clampi(c + J0 - 1, 0, w.width - U) + u_t;
    // interior lanes form one range [lo, hi1) in u
    const int lo = clampi(max(I0 - w.n, 1 - J0) - u_t, 0, LPT);
    const int hi1 = clampi(min(w.m - J0, I0 - 1) + 1 - u_t, 0, LPT);
    const unsigned inner = ((1u << hi1) - 1u) & ~((1u << lo) - 1u);
    int edge;
    if (P == 0) {
        edge = __shfl_up_sync(kFull, prev[LPT - 1], 1);
        if (w.t == 0) edge = kBig32;
    } else {
        edge = __shfl_down_sync(kFull, prev[0], 1);
        if (w.t == 31) edge = kBig32;
    }
    Word dw;
    if (a <= c) {
        // DP boundary: (0, a) at u == I0 if a <= m, (a, 0) at u == -J0 if
        // a <= n; both lanes leave [0, U) once a > c
        const int kI = a <= w.m ? I0 - u_t : -1;
        const int kJ = a <= w.n ? -J0 - u_t : -1;
        dw = wave_cells<LPT, P, true, Word>(prev, cur, edge, w.sq + qs,
                                            w.st + ts, inner, kI, kJ, a);
    } else {
        dw = wave_cells<LPT, P, false, Word>(prev, cur, edge, w.sq + qs,
                                             w.st + ts, inner, -1, -1, a);
    }
    dw <<= 2 * (w.t >> 3);   // plane t / 8
    dw |= __shfl_xor_sync(kFull, dw, 8);
    dw |= __shfl_xor_sync(kFull, dw, 16);
    if (a == w.nm) {
        // final cell (n, m): u_fin = (m - n + c - p) / 2, clipped
        const int uf = clampi((w.m - w.n + c - P) / 2, 0, U - 1);
        if (uf / LPT == w.t) {
            int s = cur[0];
#pragma unroll
            for (int k = 1; k < LPT; ++k)
                if (uf - u_t == k) s = cur[k];
            *w.score = s;
        }
    }
    if (w.t < 8)
        store_row_bytes<LPT>(w.drow + static_cast<size_t>(a - 1) * RB, dw);
}

template <int LPT>
__global__ void __launch_bounds__(32 * kWarps)
nw_fwd_i32_warp_kernel(const uint8_t* __restrict__ qrp,
                       const uint8_t* __restrict__ tp,
                       const int32_t* __restrict__ n_arr,
                       const int32_t* __restrict__ m_arr,
                       uint8_t* __restrict__ dirs,
                       int32_t* __restrict__ score_out, int B, int max_len,
                       int width, int steps) {
    constexpr int U = 32 * LPT, RB = U / 4, c = U;   // band = 2 * U
    extern __shared__ unsigned char smem[];
    const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * kWarps + w;
    if (b >= B) return;
    const int S = steps;
    uint8_t* sq = smem + 2 * w * round16(width);
    uint8_t* st = sq + round16(width);
    const uint8_t* gq = qrp + static_cast<size_t>(b) * width;
    const uint8_t* gt = tp + static_cast<size_t>(b) * width;
    for (int x = t; x < width; x += 32) {
        sq[x] = gq[x];
        st[x] = gt[x];
    }
    __syncwarp();

    const int n = n_arr[b], m = m_arr[b];
    const int nm = n + m;
    const int last = nm < S ? nm : S;
    int v1[LPT], v2[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
        v1[k] = (LPT * t + k == c / 2) ? 0 : kBig32;   // wavefront 0: (0, 0)
        v2[k] = kBig32;                                 // "wavefront -1"
    }
    if (t == 0 && (nm == 0 || nm > S))
        score_out[b] = nm == 0 ? 0 : kBig32;

    const WarpPair pair{sq, st,
                        dirs + static_cast<size_t>(b) * S * RB + LPT * t,
                        score_out + b, n, m, nm, max_len, width, t};
    // two wavefronts a turn, so each has a fixed parity (p = a & 1, c even)
    // and the wavefronts rotate through v1/v2 in place with no copies
    int a = 1;
    for (; a + 1 <= last; a += 2) {
        warp_wavefront<LPT, 1>(pair, v1, v2, a);       // v2 <- wavefront a
        warp_wavefront<LPT, 0>(pair, v2, v1, a + 1);   // v1 <- a + 1
    }
    if (a == last) warp_wavefront<LPT, 1>(pair, v1, v2, a);
}

// ------------------------------------------------------ K1, wide body
// Bands 1024 * NW for NW = 1, 4, 8 (1024, 4096, 8192): one pair per block of
// NW warps, T = 32 * NW = RB / 4 threads, so every warp of a block stops at
// the same n + m and a barrier inside the loop is legal. Thread tg (warp w
// = tg / 32, t = tg % 32) owns the direction bytes 4*tg .. 4*tg + 3 of every
// row: for plane q = 0..3 the four contiguous lanes u = q*RB + 4*tg + k,
// k = 0..3, kept as one 4-lane run per plane in v[q][k]. No lane is
// padding. Each run goes through wave_cells<4> (the warp body's cells),
// and the four planes' codes, one to a byte, OR into the thread's 32-bit
// word of the row: byte k = code(q=0, k) | code(1, k) << 2 | ... .
//
// The +-1 lane shifts cross a run's edge. Inside a warp one shuffle a plane
// brings the neighbour's edge lane. Thread 0 and thread 31 of a warp read
// the neighbouring warp's from a ring in shared memory: the runs follow one
// another plane-major over the warps (plane q of warp w after plane q of
// warp w-1 and, at w = 0, after plane q-1 of warp NW-1), so the ring holds
// run (q, w)'s edge at q*NW + w, thread 0's left neighbour is the entry
// before its own and thread 31's right neighbour the entry after; one BIG
// sentinel at each end stands for lanes -1 and U. A wavefront of parity P
// reads one side only (P == 0: ring_r, the runs' last lanes; P == 1:
// ring_l, their first lanes), so each wavefront writes only the side the
// next one reads and ends with one barrier: each write comes one barrier
// after the last read of its side.

// one thread's constants for its pair
struct WidePair {
    const uint8_t* sq;   // the pair's staged rows
    const uint8_t* st;
    unsigned* drow;      // direction matrix of the pair + the thread's word
    int32_t* score;
    int* ring_r;         // run (q, w)'s last lane at q*NW + w, BIG at -1
    int* ring_l;         // run (q, w)'s first lane at q*NW + w, BIG at 4*NW
    int n, m, nm, L, width, tg, t, w;
};

// wavefront a (parity P) of one thread's four runs: cur <- wavefront a from
// prev = a-1 and cur = a-2; returns the thread's word of direction row a-1
template <int NW, int P, bool Border>
__device__ __forceinline__ unsigned wide_row(const WidePair& w,
                                             const int (&prev)[4][4],
                                             int (&cur)[4][4], int a) {
    constexpr int RB = 128 * NW, U = 4 * RB, c = U;
    constexpr unsigned kFull = 0xffffffffu;
    const int u_t = 4 * w.tg;   // the thread's first lane in plane 0
    const int I0 = (a + c - P) / 2;
    const int J0 = (a - c + P) / 2;
    const int qs = clampi(c + w.L - I0, 0, w.width - U) + u_t;
    const int ts = clampi(c + J0 - 1, 0, w.width - U) + u_t;
    // interior lanes form one range [lo, hi1) in u, here relative to u_t
    const int lo = max(I0 - w.n, 1 - J0) - u_t;
    const int hi1 = min(w.m - J0, I0 - 1) + 1 - u_t;
    unsigned row = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int uq = q * RB;   // the run's first lane is u_t + uq
        const int lq = clampi(lo - uq, 0, 4);
        const int hq = clampi(hi1 - uq, 0, 4);
        const unsigned inner = ((1u << hq) - 1u) & ~((1u << lq) - 1u);
        int edge;
        if (P == 0) {
            edge = __shfl_up_sync(kFull, prev[q][3], 1);
            if (w.t == 0) edge = w.ring_r[q * NW + w.w - 1];
        } else {
            edge = __shfl_down_sync(kFull, prev[q][0], 1);
            if (w.t == 31) edge = w.ring_l[q * NW + w.w + 1];
        }
        // DP boundary: (0, a) at u == I0 if a <= m, (a, 0) at u == -J0 if
        // a <= n; both lanes leave [0, U) once a > c
        const int kI = Border && a <= w.m ? I0 - u_t - uq : -1;
        const int kJ = Border && a <= w.n ? -J0 - u_t - uq : -1;
        const unsigned d = wave_cells<4, P, Border, unsigned>(
            prev[q], cur[q], edge, w.sq + qs + uq, w.st + ts + uq, inner,
            kI, kJ, a);
        row |= d << (2 * q);
    }
    return row;
}

// wavefront a (parity P) of one thread: its row word, the score at
// a == n + m, the ring side the next wavefront reads, one barrier
template <int NW, int P>
__device__ __forceinline__ void wide_wavefront(const WidePair& w,
                                               const int (&prev)[4][4],
                                               int (&cur)[4][4], int a) {
    constexpr int RB = 128 * NW, U = 4 * RB, c = U;
    const unsigned row = a <= c ? wide_row<NW, P, true>(w, prev, cur, a)
                                : wide_row<NW, P, false>(w, prev, cur, a);
    w.drow[static_cast<size_t>(a - 1) * (RB / 4)] = row;
    if (a == w.nm) {
        // final cell (n, m): u_fin = (m - n + c - p) / 2, clipped; it sits
        // in plane uf / RB, byte uf % RB, so thread (uf % RB) / 4
        const int uf = clampi((w.m - w.n + c - P) / 2, 0, U - 1);
        if ((uf % RB) / 4 == w.tg) {
            const int qf = uf / RB, kf = uf % 4;
            int s = cur[0][0];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (q == qf && k == kf) s = cur[q][k];
            *w.score = s;
        }
    }
    if (P == 1) {   // the next wavefront (P == 0) reads the last lanes
        if (w.t == 31) {
#pragma unroll
            for (int q = 0; q < 4; ++q) w.ring_r[q * NW + w.w] = cur[q][3];
        }
    } else {        // the next wavefront (P == 1) reads the first lanes
        if (w.t == 0) {
#pragma unroll
            for (int q = 0; q < 4; ++q) w.ring_l[q * NW + w.w] = cur[q][0];
        }
    }
    if (NW == 1)
        __syncwarp();
    else
        __syncthreads();
}

template <int NW>
__global__ void __launch_bounds__(32 * NW)
nw_fwd_i32_wide_kernel(const uint8_t* __restrict__ qrp,
                       const uint8_t* __restrict__ tp,
                       const int32_t* __restrict__ n_arr,
                       const int32_t* __restrict__ m_arr,
                       uint8_t* __restrict__ dirs,
                       int32_t* __restrict__ score_out, int max_len,
                       int width, int steps) {
    constexpr int T = 32 * NW, RB = 4 * T, c = 4 * RB;   // band = 2 * U
    extern __shared__ unsigned char smem[];
    const int tg = threadIdx.x, t = tg & 31, w = tg >> 5;
    const int b = blockIdx.x;
    const int S = steps;
    uint8_t* sq = smem;
    uint8_t* st = smem + round16(width);
    // [BIG, ring_r (4*NW), ring_l (4*NW), BIG]
    int* ring = reinterpret_cast<int*>(smem + 2 * round16(width));
    int* ring_r = ring + 1;
    int* ring_l = ring + 1 + 4 * NW;
    stage_rows(sq, st, qrp, tp, width, b, T);

    const int n = n_arr[b], m = m_arr[b];
    const int nm = n + m;
    const int last = nm < S ? nm : S;
    int v1[4][4], v2[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            // wavefront 0: only (0, 0), at lane c/2 = 2*RB (thread 0,
            // plane 2, slot 0)
            v1[q][k] = q * RB + 4 * tg + k == c / 2 ? 0 : kBig32;
            v2[q][k] = kBig32;   // "wavefront -1"
        }
    if (tg == 0) {
        ring[0] = kBig32;
        ring_l[4 * NW] = kBig32;
        if (nm == 0 || nm > S) score_out[b] = nm == 0 ? 0 : kBig32;
    }
    if (t == 0) {   // wavefront 1 (P == 1) reads wavefront 0's first lanes
#pragma unroll
        for (int q = 0; q < 4; ++q) ring_l[q * NW + w] = v1[q][0];
    }
    __syncthreads();

    const WidePair pair{
        sq, st,
        reinterpret_cast<unsigned*>(dirs + static_cast<size_t>(b) * S * RB)
            + tg,
        score_out + b, ring_r, ring_l, n, m, nm, max_len, width, tg, t, w};
    // two wavefronts a turn (fixed parity, in-place rotation), as the warp
    // body; `last` is the block's, so every thread meets every barrier
    int a = 1;
    for (; a + 1 <= last; a += 2) {
        wide_wavefront<NW, 1>(pair, v1, v2, a);       // v2 <- wavefront a
        wide_wavefront<NW, 0>(pair, v2, v1, a + 1);   // v1 <- a + 1
    }
    if (a == last) wide_wavefront<NW, 1>(pair, v1, v2, a);
}

// halfword helpers: word = lo | hi << 16
__device__ __forceinline__ unsigned pack2(unsigned lo, unsigned hi) {
    return (lo & 0xFFFFu) | (hi << 16);
}

__device__ __forceinline__ unsigned sel2(unsigned a, unsigned b,
                                         unsigned mask) {
    return (a & mask) | (b & ~mask);
}

__global__ void nw_fwd_i16x2_kernel(const uint8_t* __restrict__ qrp,
                                    const uint8_t* __restrict__ tp,
                                    const int32_t* __restrict__ n_arr,
                                    const int32_t* __restrict__ m_arr,
                                    uint8_t* __restrict__ dirs,
                                    int32_t* __restrict__ score_out,
                                    int max_len, int band, int width,
                                    int steps) {
    extern __shared__ unsigned char smem[];
    const int c = band / 2, U = band / 2, RB = U / 4, L = max_len;
    const int S = steps;
    const int b = blockIdx.x, t = threadIdx.x;
    uint8_t* sq = smem;
    uint8_t* st = smem + round16(width);
    uint16_t* sv = reinterpret_cast<uint16_t*>(smem + 2 * round16(width));
    stage_rows(sq, st, qrp, tp, width, b, RB);

    const int n = n_arr[b], m = m_arr[b];
    const int nm = n + m;
    const int last = nm < S ? nm : S;
    const int p0 = c & 1, u0 = (c - p0) / 2;
    const unsigned ONES = 0x00010001u, TWOS = 0x00020002u;
    const unsigned BIGW = kBig16 * ONES;
    // word 0 = lanes (t, t+RB), word 1 = lanes (t+2RB, t+3RB)
    const int ul[2] = {t, t + 2 * RB};
    const int uh[2] = {t + RB, t + 3 * RB};
    unsigned v1[2], v2[2], uw[2], uw1[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
        v1[w] = pack2(ul[w] == u0 ? 0u : kBig16, uh[w] == u0 ? 0u : kBig16);
        v2[w] = BIGW;
        uw[w] = pack2(ul[w], uh[w]);      // packed lane index
        uw1[w] = __vadd2(uw[w], ONES);    // u + 1
        sv[ul[w]] = v1[w] & 0xFFFFu;
        sv[uh[w]] = v1[w] >> 16;
    }
    if (t == 0 && (nm == 0 || nm > S))
        score_out[b] = nm == 0 ? 0 : kBig32;
    __syncthreads();

    uint8_t* drow = dirs + static_cast<size_t>(b) * S * RB + t;
    for (int a = 1; a <= last; ++a) {
        const int p = (a + c) & 1;
        const int I0 = (a + c - p) / 2;
        const int J0 = (a - c + p) / 2;
        const uint16_t* prev = sv + ((a - 1) & 1) * U;
        const int qs = clampi(c + L - I0, 0, width - U);
        const int ts = clampi(c + J0 - 1, 0, width - U);
        // interior lanes form one contiguous range [lo, hi] in u
        const int lo = max(max(I0 - n, 1 - J0), 0);
        const int hi1 = clampi(min(m - J0, I0 - 1) + 1, 0, U);
        const unsigned LOW = static_cast<unsigned>(lo) * ONES;
        const unsigned HIW = static_cast<unsigned>(hi1) * ONES;
        unsigned vn[2], dw[2];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
            const int a0 = ul[w], a1 = uh[w];
            unsigned dsrc, isrc;
            if (p == 0) {
                dsrc = pack2(a0 == 0 ? kBig16 : prev[a0 - 1], prev[a1 - 1]);
                isrc = v1[w];
            } else {
                dsrc = v1[w];
                isrc = pack2(prev[a0 + 1],
                             a1 == U - 1 ? kBig16 : prev[a1 + 1]);
            }
            const unsigned sub = pack2(sq[qs + a0] != st[ts + a0],
                                       sq[qs + a1] != st[ts + a1]);
            const unsigned cd = __vadd2(v2[w], sub);
            const unsigned ci = __vadd2(isrc, ONES);
            const unsigned cdel = __vadd2(dsrc, ONES);
            const unsigned best = __vminu2(cd, __vminu2(ci, cdel));
            const unsigned eqcd = __vcmpeq2(cd, best);
            const unsigned eqci = __vcmpeq2(ci, best);
            dw[w] = sel2(ONES, TWOS, eqci) & ~eqcd;
            const unsigned inr = __vcmpgeu2(uw[w], LOW)
                                 & __vcmpgeu2(HIW, uw1[w]);
            unsigned v = sel2(__vminu2(best, BIGW), BIGW, inr);
            if (a <= c) {   // boundary cells: i == 0 (u == I0), j == 0
                unsigned vl = v & 0xFFFFu, vh = v >> 16;
                if (a0 == I0 && a <= m) vl = a;
                if (a1 == I0 && a <= m) vh = a;
                if (a0 == -J0 && a <= n) vl = a;
                if (a1 == -J0 && a <= n) vh = a;
                v = pack2(vl, vh);
            }
            vn[w] = v;
        }
        if (a == nm) {
            const int uf = clampi((m - n + c - p) / 2, 0, U - 1);
            if (uf % RB == t) {
                const int plane = uf / RB;   // 0: w0.lo 1: w0.hi 2: w1.lo
                const unsigned word = vn[plane >> 1];
                const unsigned s16 = (plane & 1) ? (word >> 16)
                                                 : (word & 0xFFFFu);
                score_out[b] = s16 == kBig16 ? kBig32 : static_cast<int>(s16);
            }
        }
        const unsigned byte = (dw[0] & 3u) | (((dw[0] >> 16) & 3u) << 2)
                              | ((dw[1] & 3u) << 4)
                              | (((dw[1] >> 16) & 3u) << 6);
        drow[static_cast<size_t>(a - 1) * RB] = static_cast<uint8_t>(byte);
        uint16_t* cur = sv + (a & 1) * U;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
            cur[ul[w]] = static_cast<uint16_t>(vn[w] & 0xFFFFu);
            cur[uh[w]] = static_cast<uint16_t>(vn[w] >> 16);
            v2[w] = v1[w];
            v1[w] = vn[w];
        }
        __syncthreads();
    }
}

// ------------------------------------------------------ K4, wide body
// Bands 256 * BPT * NW (the (band, BPT) pairs rt_nw_fwd_i16x2_wide lists):
// K1's wide layout on int16x2 words. One pair per block of NW warps (at
// NW = 1, kWarps pairs a block, one a warp, as K1's warp body), T = 32 * NW
// threads, RB = BPT * T bytes a row. Thread tg owns the direction bytes
// BPT*tg .. BPT*tg + BPT-1 of every row: for plane q = 0..3 the BPT
// contiguous lanes u = q*RB + BPT*tg + k, held as W = BPT/2 words, slots k
// (low half) and k+1 (high half) in word k/2. Two wavefronts stay in
// registers and rotate by parity, as K1's wide body.
//
// The +-1 lane shifts: inside a run one __byte_perm of neighbouring words
// (selector 0x5432: the high half of the first, the low half of the
// second); across a run's edge inside a warp one shuffle of a word a plane;
// across a warp's edge K1 wide's ring of words in shared memory (run (q, w)
// at q*NW + w, a BIG sentinel at each end, one side written a wavefront, one
// barrier over the NW warps). At NW = 1 there is no ring and no barrier:
// the shuffle rotates over the warp and thread 31 (0) hands thread 0 (31)
// the last (first) word of the plane before (after), so lane q*RB - 1
// reaches lane q*RB; the sentinels are constants.
//
// The cell step, per word: cd = v2 + sub, ci = isrc + 1, cdel = dsrc + 1
// as 32-bit adds (each half stays below 0x8000, so no carry crosses); two
// DPX min-with-predicate steps give the best of three and K4's tie order:
// m0 = __vibmin_s16x2(isrc, dsrc) with pred = isrc <= dsrc (consume query
// before consume target on a tie), then best = __vibmin_s16x2(cd, m0 + 1)
// with pred = cd <= min(ci, cdel) (the diagonal first). Each value stays in
// [0, BIG16 + 1] < 0x8000, so the signed s16 forms return the unsigned
// (__vminu2) answers of the block body. The predicates select the code
// bits straight into the thread's direction word, slot k at byte k, plane
// q at bit 2q: one BPT-byte store a row, no exchange.
//
// Wavefronts come in two kinds, uniform over the pair: those whose range
// [lo, hi1) of computed lanes covers every lane (Full: only the saturation
// clamp, one DPX min), and the rest (Edge: the mask). The range holds the
// DP boundary (i == 0 or j == 0) too: the step itself gives (0, j) = j and
// (i, 0) = i from their one finite predecessor, so no lane is set apart.
// The mask is two whole-word adds against packed lane indices, biased by
// 0x8000 so that a lane outside [lo, hi1) gets a word half >= 0x7000 >
// BIG16 and a lane inside a negative one; one __vimax3_s16x2 with best and
// one min with BIG16 give the clamped, masked value.
//
// Characters: a run's BPT query and target bytes are loaded as aligned
// words (one base and one shift serve the four planes, whose runs lie
// q*RB bytes apart) and aligned with __funnelshift_r; the two wavefronts
// of a turn share J0 and so their target words. Query and target words
// are xor-ed and tested four bytes at a time (bit 7 of each byte: the
// byte differs), then spread into half-words with __byte_perm.
//
// Bound and what holds it: the same integer work as K1 (OPS_PER_CELL); per
// word the body issues about a dozen instructions (one byte_perm, the
// adds, two VIMNMX with predicates, four selects, the clamp), against
// about 15 an int32 cell in K1's wide body. On an H100 (chip_smoke.py) it
// runs within 1.1-1.2x of the bound on the aligner's large launches; at
// the consensus groups (BPT 2) a wavefront's fixed work (edge shuffles,
// the lane range, the row store) falls on four words a thread, and with
// one pair a SM (the aligner's 128-pair chunks) the wavefront's latency
// sets the time: the shuffles and, at NW > 1, the ring and the barrier.
// BPT trades those against the words one warp issues a wavefront.

constexpr unsigned kOnes = 0x00010001u;
constexpr unsigned kBigW = kBig16 * kOnes;
// wavefront kinds of the wide int16x2 body
constexpr int kEdge = 0, kFull = 1;

// stage a pair's two rows into shared memory, 16 bytes a copy where the
// rows allow it
__device__ __forceinline__ void stage_rows16(uint8_t* sq, uint8_t* st,
                                             const uint8_t* qrp,
                                             const uint8_t* tp, int width,
                                             int b, int tid, int nthreads) {
    const uint8_t* q = qrp + static_cast<size_t>(b) * width;
    const uint8_t* t = tp + static_cast<size_t>(b) * width;
    if (((width | reinterpret_cast<uintptr_t>(qrp)
          | reinterpret_cast<uintptr_t>(tp)) & 15) == 0) {
        for (int x = tid; x < width / 16; x += nthreads) {
            reinterpret_cast<uint4*>(sq)[x] =
                reinterpret_cast<const uint4*>(q)[x];
            reinterpret_cast<uint4*>(st)[x] =
                reinterpret_cast<const uint4*>(t)[x];
        }
    } else {
        for (int x = tid; x < width; x += nthreads) {
            sq[x] = q[x];
            st[x] = t[x];
        }
    }
}

// words of characters a run's BPT bytes take (BPT 2: the low half of one)
template <int BPT>
__host__ __device__ constexpr int run_words() {
    return BPT < 4 ? 1 : BPT / 4;
}

// the BPT bytes of a run, sh/8 bytes into the aligned words w[0..]: the
// words are loaded (at most 8 bytes past the run) and aligned with
// __funnelshift_r
template <int BPT>
__device__ __forceinline__ void run_chars(const unsigned* w, unsigned sh,
                                          unsigned (&x)[run_words<BPT>()]) {
#pragma unroll
    for (int i = 0; i < run_words<BPT>(); ++i)
        x[i] = __funnelshift_r(w[i], w[i + 1], sh);
}

// the mismatch words of one run: sub[j] holds 1 in the half of each of
// slots 2j, 2j+1 whose query byte differs from its target byte; the
// characters are tested four bytes at a time
template <int BPT>
__device__ __forceinline__ void run_mismatch(
    const unsigned (&qx)[run_words<BPT>()],
    const unsigned (&tx)[run_words<BPT>()], unsigned (&sub)[BPT / 2]) {
#pragma unroll
    for (int i = 0; i < run_words<BPT>(); ++i) {
        const unsigned x = qx[i] ^ tx[i];
        // bit 7 of each byte: the byte of x is not 0
        const unsigned f = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x)
                           & 0x80808080u;
        sub[2 * i] = __byte_perm(f, 0, 0x4140) >> 7;
        if (2 * i + 1 < BPT / 2)
            sub[2 * i + 1 < BPT / 2 ? 2 * i + 1 : 0] =
                __byte_perm(f, 0, 0x4342) >> 7;
    }
}

// one thread's constants for its pair
struct I16Pair {
    const uint8_t* sq;   // the pair's staged rows
    const uint8_t* st;
    uint8_t* drow;       // direction matrix of the pair + the thread's bytes
    int32_t* score;
    unsigned* ring_r;    // run (q, w)'s last word at q*NW + w, BIG at -1
    unsigned* ring_l;    // run (q, w)'s first word at q*NW + w, BIG at 4*NW
    int n, m, nm, L, width, tg, t, w;
};

// the half of slot k (0..BPT-1) of plane q's run. Masks, not a select
// under a runtime index: that would move the wavefronts into local memory
template <int BPT>
__device__ __forceinline__ unsigned get_slot(const unsigned (&v)[4][BPT / 2],
                                             int q, int k) {
    const int at = q * (BPT / 2) + (k >> 1);
    unsigned s = 0;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
#pragma unroll
        for (int j = 0; j < BPT / 2; ++j)
            s |= v[qq][j] & (qq * (BPT / 2) + j == at ? ~0u : 0u);
    return (k & 1) ? s >> 16 : s & 0xFFFFu;
}

// wavefront a (parity P, kind Kind) of one thread: cur <- wavefront a from
// prev = a-1 and cur = a-2; its direction bytes of row a-1, the score at
// a == n + m, the ring side the next wavefront reads, one barrier
template <int NW, int BPT, int P, int Kind>
__device__ __forceinline__ void i16_wavefront(
    const I16Pair& w, const unsigned (&prev)[4][BPT / 2],
    unsigned (&cur)[4][BPT / 2],
    const unsigned (&tx)[4][run_words<BPT>()], int a, int lo, int hi1) {
    constexpr int W = BPT / 2, RB = 32 * NW * BPT, U = 4 * RB, c = U;
    constexpr unsigned kFull32 = 0xffffffffu;
    const int u_t = BPT * w.tg;   // the thread's first lane in plane 0
    const int I0 = (a + c - P) / 2;
    const int qs = clampi(c + w.L - I0, 0, w.width - U) + u_t;
    // the edge word of each plane: P == 0, lane u-1 of the run's first lane
    // in its high half; P == 1, lane u+1 of its last lane in its low half
    unsigned edge[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (P == 0) {
            unsigned src = prev[q][W - 1];
            if (NW == 1) {
                if (q > 0 && w.t == 31) src = prev[q > 0 ? q - 1 : 0][W - 1];
                edge[q] = __shfl_sync(kFull32, src, (w.t + 31) & 31);
                if (q == 0 && w.t == 0) edge[q] = kBigW;
            } else {
                edge[q] = __shfl_up_sync(kFull32, src, 1);
                if (w.t == 0) edge[q] = w.ring_r[q * NW + w.w - 1];
            }
        } else {
            unsigned src = prev[q][0];
            if (NW == 1) {
                if (q < 3 && w.t == 0) src = prev[q < 3 ? q + 1 : 3][0];
                edge[q] = __shfl_sync(kFull32, src, (w.t + 1) & 31);
                if (q == 3 && w.t == 31) edge[q] = kBigW;
            } else {
                edge[q] = __shfl_down_sync(kFull32, src, 1);
                if (w.t == 31) edge[q] = w.ring_l[q * NW + w.w + 1];
            }
        }
    }
    // the mask's biased lane words (Edge): lane u's half
    // of el is 0x8000 + u - lo, of eh 0x8000 + hi1 - 1 - u
    const unsigned ut = static_cast<unsigned>(u_t) * kOnes + 0x10000u;
    const unsigned el = ut + static_cast<unsigned>(0x8000 - lo) * kOnes;
    const unsigned eh = static_cast<unsigned>(0x8000 + hi1 - 1) * kOnes - ut;
    // the query runs' characters: plane q's run starts q*RB bytes (a
    // multiple of 4) after plane 0's, so one aligned base and one shift
    // serve all four
    const unsigned* wq = reinterpret_cast<const unsigned*>(w.sq + (qs & ~3));
    const unsigned shq = 8 * (qs & 3);
    unsigned dir[(BPT + 3) / 4] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        unsigned qx[run_words<BPT>()], sub[W];
        run_chars<BPT>(wq + q * (RB / 4), shq, qx);
        run_mismatch<BPT>(qx, tx[q], sub);
#pragma unroll
        for (int j = 0; j < W; ++j) {
            unsigned isrc, dsrc;
            if (P == 0) {
                isrc = prev[q][j];
                dsrc = __byte_perm(
                    j == 0 ? edge[q] : prev[q][j > 0 ? j - 1 : 0], prev[q][j],
                    0x5432);
            } else {
                dsrc = prev[q][j];
                isrc = __byte_perm(prev[q][j],
                                   j == W - 1 ? edge[q]
                                              : prev[q][j < W - 1 ? j + 1 : j],
                                   0x5432);
            }
            const unsigned cd = cur[q][j] + sub[j];   // diagonal (i-1, j-1)
            bool ih, il, mh, ml;
            // ci <= cdel: consume query (I) before consume target (D)
            const unsigned m0 = __vibmin_s16x2(isrc, dsrc, &ih, &il);
            // cd <= min(ci, cdel): the diagonal (M) first
            const unsigned best = __vibmin_s16x2(cd, m0 + kOnes, &mh, &ml);
            const int sh = 8 * ((2 * j) % 4) + 2 * q;
            dir[(2 * j) / 4] |= (ml ? 0u : (il ? 1u : 2u)) << sh
                                | (mh ? 0u : (ih ? 1u : 2u)) << (sh + 8);
            unsigned v;
            if (Kind == kFull) {
                v = __vmins2(best, kBigW);
            } else {
                const unsigned kq = static_cast<unsigned>(q * RB + 2 * j)
                                    * kOnes;
                v = __vmins2(__vimax3_s16x2(best, el + kq, eh - kq), kBigW);
            }
            cur[q][j] = v;
        }
    }
    uint8_t* dst = w.drow + static_cast<size_t>(a - 1) * RB;
    if (BPT == 2)
        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(dir[0]);
    else if (BPT == 4)
        *reinterpret_cast<unsigned*>(dst) = dir[0];
    else
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(dir[0], dir[(BPT + 3) / 4 - 1]);
    if (a == w.nm) {
        // final cell (n, m): u_fin = (m - n + c - p) / 2, clipped; plane
        // uf / RB, byte uf % RB, so thread (uf % RB) / BPT, slot uf % BPT
        const int uf = clampi((w.m - w.n + c - P) / 2, 0, U - 1);
        if ((uf % RB) / BPT == w.tg) {
            const unsigned s = get_slot<BPT>(cur, uf / RB, uf % BPT);
            *w.score = s == kBig16 ? kBig32 : static_cast<int>(s);
        }
    }
    if (NW > 1) {
        if (P == 1) {   // the next wavefront (P == 0) reads the last words
            if (w.t == 31) {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    w.ring_r[q * NW + w.w] = cur[q][W - 1];
            }
        } else {        // the next wavefront (P == 1) reads the first words
            if (w.t == 0) {
#pragma unroll
                for (int q = 0; q < 4; ++q) w.ring_l[q * NW + w.w] = cur[q][0];
            }
        }
        __syncthreads();
    }
}

// wavefront a (parity P): picks its kind from (a, n, m), uniform over the
// pair's threads
template <int NW, int BPT, int P>
__device__ __forceinline__ void i16_step(
    const I16Pair& w, const unsigned (&prev)[4][BPT / 2],
    unsigned (&cur)[4][BPT / 2],
    const unsigned (&tx)[4][run_words<BPT>()], int a) {
    constexpr int U = 128 * NW * BPT, c = U;
    const int I0 = (a + c - P) / 2;
    const int J0 = (a - c + P) / 2;
    // the lanes the DP computes form one range [lo, hi1) in u: the
    // interior 1 <= i <= n, 1 <= j <= m and the DP boundary i == 0 or
    // j == 0, whose cells (0, j) = j and (i, 0) = i the same step yields
    // from their one finite predecessor (i, j-1) or (i-1, j)
    const int lo = max(I0 - w.n, -J0);
    const int hi1 = min(w.m - J0, I0) + 1;
    if (lo <= 0 && hi1 >= U)
        i16_wavefront<NW, BPT, P, kFull>(w, prev, cur, tx, a, 0, U);
    else
        i16_wavefront<NW, BPT, P, kEdge>(w, prev, cur, tx, a,
                                         clampi(lo, 0, U), clampi(hi1, 0, U));
}

// the target runs' characters of a turn, wavefronts a (odd) and a + 1:
// J0 = (a + 1 - c) / 2 in both, so both read the same target bytes
template <int NW, int BPT>
__device__ __forceinline__ void turn_target(
    const I16Pair& w, int a, unsigned (&tx)[4][run_words<BPT>()]) {
    constexpr int RB = 32 * NW * BPT, U = 4 * RB, c = U;
    const int ts = clampi(c + (a + 1 - c) / 2 - 1, 0, w.width - U)
                   + BPT * w.tg;
    const unsigned* wt = reinterpret_cast<const unsigned*>(w.st + (ts & ~3));
#pragma unroll
    for (int q = 0; q < 4; ++q)
        run_chars<BPT>(wt + q * (RB / 4), 8 * (ts & 3), tx[q]);
}

template <int NW, int BPT>
__global__ void __launch_bounds__(NW == 1 ? 32 * kWarps : 32 * NW)
nw_fwd_i16x2_wide_kernel(const uint8_t* __restrict__ qrp,
                         const uint8_t* __restrict__ tp,
                         const int32_t* __restrict__ n_arr,
                         const int32_t* __restrict__ m_arr,
                         uint8_t* __restrict__ dirs,
                         int32_t* __restrict__ score_out, int B, int max_len,
                         int width, int steps) {
    constexpr int W = BPT / 2, T = 32 * NW, RB = BPT * T;
    constexpr int PB = NW == 1 ? kWarps : 1;   // pairs a block
    extern __shared__ unsigned char smem[];
    const int t = threadIdx.x & 31;
    // NW == 1: warp = the pair's slot in the block; NW > 1: warp in the pair
    const int warp = threadIdx.x >> 5;
    const int slot = NW == 1 ? warp : 0, w = NW == 1 ? 0 : warp;
    const int tg = NW == 1 ? t : threadIdx.x;
    const int b = blockIdx.x * PB + slot;
    if (b >= B) return;   // whole warps, at NW == 1 only (B blocks else)
    const int S = steps;
    const int row = round16(width) + 16;   // the run loads read 8 B past
    uint8_t* sq = smem + 2 * slot * row;
    uint8_t* st = sq + row;
    // NW > 1: [BIG, ring_r (4*NW), ring_l (4*NW), BIG]
    unsigned* ring = reinterpret_cast<unsigned*>(smem + 2 * PB * row);
    unsigned* ring_r = ring + 1;
    unsigned* ring_l = ring + 1 + 4 * NW;
    stage_rows16(sq, st, qrp, tp, width, b, tg, T);

    const int n = n_arr[b], m = m_arr[b];
    const int nm = n + m;
    const int last = nm < S ? nm : S;
    unsigned v1[4][W], v2[4][W];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < W; ++j) {
            v1[q][j] = kBigW;
            v2[q][j] = kBigW;   // "wavefront -1"
        }
    // wavefront 0: only (0, 0), at lane c/2 = 2*RB (thread 0, plane 2,
    // slot 0)
    if (tg == 0) v1[2][0] = kBigW & 0xFFFF0000u;
    if (tg == 0 && (nm == 0 || nm > S)) score_out[b] = nm == 0 ? 0 : kBig32;
    if (NW == 1) {
        __syncwarp();
    } else {
        if (tg == 0) {
            ring[0] = kBigW;
            ring_l[4 * NW] = kBigW;
        }
        if (t == 0) {   // wavefront 1 (P == 1) reads wavefront 0's first words
#pragma unroll
            for (int q = 0; q < 4; ++q) ring_l[q * NW + w] = v1[q][0];
        }
        __syncthreads();
    }

    const I16Pair pair{sq, st,
                       dirs + static_cast<size_t>(b) * S * RB + BPT * tg,
                       score_out + b, ring_r, ring_l, n, m, nm, max_len,
                       width, tg, t, w};
    // two wavefronts a turn (fixed parity, in-place rotation), as K1's wide
    // body; `last` is the pair's, so every thread of a pair meets every
    // barrier
    unsigned tx[4][run_words<BPT>()];
    int a = 1;
    for (; a + 1 <= last; a += 2) {
        turn_target<NW, BPT>(pair, a, tx);
        i16_step<NW, BPT, 1>(pair, v1, v2, tx, a);       // v2 <- wavefront a
        i16_step<NW, BPT, 0>(pair, v2, v1, tx, a + 1);   // v1 <- a + 1
    }
    if (a == last) {
        turn_target<NW, BPT>(pair, a, tx);
        i16_step<NW, BPT, 1>(pair, v1, v2, tx, a);
    }
}

template <typename Kernel>
int launch(Kernel kernel, size_t value_bytes, const void* qrp,
           const void* tp, const void* n, const void* m, void* dirs,
           void* score, int B, int max_len, int band, int width, int steps,
           void* stream) {
    if (B <= 0) return 0;
    const int U = band / 2, RB = U / 4;
    const size_t rows = 2 * static_cast<size_t>((width + 15) & ~15);
    const size_t smem = rows + 2 * static_cast<size_t>(U) * value_bytes;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<B, RB, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(qrp), static_cast<const uint8_t*>(tp),
        static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
        static_cast<uint8_t*>(dirs), static_cast<int32_t*>(score), max_len,
        band, width, steps);
    return static_cast<int>(cudaGetLastError());
}

template <int LPT>
int launch_warp(const void* qrp, const void* tp, const void* n,
                const void* m, void* dirs, void* score, int B, int max_len,
                int width, int steps, void* stream) {
    // each warp stages its own pair's two rows
    const size_t smem = 2 * kWarps * static_cast<size_t>((width + 15) & ~15);
    auto kernel = nw_fwd_i32_warp_kernel<LPT>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(qrp), static_cast<const uint8_t*>(tp),
        static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
        static_cast<uint8_t*>(dirs), static_cast<int32_t*>(score), B,
        max_len, width, steps);
    return static_cast<int>(cudaGetLastError());
}

template <int NW, int BPT>
int launch_i16x2_wide(const void* qrp, const void* tp, const void* n,
                      const void* m, void* dirs, void* score, int B,
                      int max_len, int width, int steps, void* stream) {
    constexpr int PB = NW == 1 ? kWarps : 1;   // pairs a block
    // each pair's two rows (16 B of slack each), then at NW > 1 the edge
    // ring with its two sentinels
    const size_t smem =
        2 * PB * (static_cast<size_t>((width + 15) & ~15) + 16)
        + (NW == 1 ? 0 : (8 * NW + 2) * sizeof(unsigned));
    auto kernel = nw_fwd_i16x2_wide_kernel<NW, BPT>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(B + PB - 1) / PB, 32 * NW * PB, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(qrp), static_cast<const uint8_t*>(tp),
        static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
        static_cast<uint8_t*>(dirs), static_cast<int32_t*>(score), B,
        max_len, width, steps);
    return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_wide(const void* qrp, const void* tp, const void* n,
                const void* m, void* dirs, void* score, int B, int max_len,
                int width, int steps, void* stream) {
    // the pair's two rows, then the edge ring with its two sentinels
    const size_t smem = 2 * static_cast<size_t>((width + 15) & ~15)
                        + (8 * NW + 2) * sizeof(int);
    auto kernel = nw_fwd_i32_wide_kernel<NW>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<B, 32 * NW, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(qrp), static_cast<const uint8_t*>(tp),
        static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
        static_cast<uint8_t*>(dirs), static_cast<int32_t*>(score), max_len,
        width, steps);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int rt_nw_fwd_i32(const void* qrp, const void* tp, const void* n,
                  const void* m, void* dirs, void* score, int B, int max_len,
                  int band, int width, int steps, void* stream) {
    return launch(nw_fwd_i32_kernel, sizeof(int32_t), qrp, tp, n, m, dirs,
                  score, B, max_len, band, width, steps, stream);
}

// K1's warp body, for band % 64 == 0 and 128 <= band <= 512 (the caller,
// racon_tpu_torch/ops/cuda_nw.py fwd_i32_body, picks it).
int rt_nw_fwd_i32_warp(const void* qrp, const void* tp, const void* n,
                       const void* m, void* dirs, void* score, int B,
                       int max_len, int band, int width, int steps,
                       void* stream) {
    if (B <= 0) return 0;
    switch (band) {
        case 128: return launch_warp<2>(qrp, tp, n, m, dirs, score, B,
                                        max_len, width, steps, stream);
        case 192: return launch_warp<3>(qrp, tp, n, m, dirs, score, B,
                                        max_len, width, steps, stream);
        case 256: return launch_warp<4>(qrp, tp, n, m, dirs, score, B,
                                        max_len, width, steps, stream);
        case 320: return launch_warp<5>(qrp, tp, n, m, dirs, score, B,
                                        max_len, width, steps, stream);
        case 384: return launch_warp<6>(qrp, tp, n, m, dirs, score, B,
                                        max_len, width, steps, stream);
        case 448: return launch_warp<7>(qrp, tp, n, m, dirs, score, B,
                                        max_len, width, steps, stream);
        case 512: return launch_warp<8>(qrp, tp, n, m, dirs, score, B,
                                        max_len, width, steps, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// K1's wide body, for band = 1024 * NW, NW = 1, 4, 8 (the caller,
// racon_tpu_torch/ops/cuda_nw.py fwd_i32_body, picks it; at band 2048 the
// block body measured faster).
int rt_nw_fwd_i32_wide(const void* qrp, const void* tp, const void* n,
                       const void* m, void* dirs, void* score, int B,
                       int max_len, int band, int width, int steps,
                       void* stream) {
    if (B <= 0) return 0;
    switch (band) {
        case 1024: return launch_wide<1>(qrp, tp, n, m, dirs, score, B,
                                         max_len, width, steps, stream);
        case 4096: return launch_wide<4>(qrp, tp, n, m, dirs, score, B,
                                         max_len, width, steps, stream);
        case 8192: return launch_wide<8>(qrp, tp, n, m, dirs, score, B,
                                         max_len, width, steps, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int rt_nw_fwd_i16x2(const void* qrp, const void* tp, const void* n,
                    const void* m, void* dirs, void* score, int B,
                    int max_len, int band, int width, int steps,
                    void* stream) {
    return launch(nw_fwd_i16x2_kernel, sizeof(uint16_t), qrp, tp, n, m, dirs,
                  score, B, max_len, band, width, steps, stream);
}

// K4's wide body at band = 256 * bpt * NW, for the (band, bpt) pairs below
// (the caller, racon_tpu_torch/ops/cuda_nw.py fwd_i16x2_body, picks bpt).
int rt_nw_fwd_i16x2_wide(const void* qrp, const void* tp, const void* n,
                         const void* m, void* dirs, void* score, int B,
                         int max_len, int band, int bpt, int width,
                         int steps, void* stream) {
    if (B <= 0) return 0;
#define RT_I16X2_WIDE(BAND, BPT)                                             \
    if (band == BAND && bpt == BPT)                                          \
        return launch_i16x2_wide<BAND / (256 * BPT), BPT>(                   \
            qrp, tp, n, m, dirs, score, B, max_len, width, steps, stream);
    RT_I16X2_WIDE(512, 2)
    RT_I16X2_WIDE(1024, 2)
    RT_I16X2_WIDE(1024, 4)
    RT_I16X2_WIDE(1536, 2)
    RT_I16X2_WIDE(2048, 2)
    RT_I16X2_WIDE(2048, 4)
    RT_I16X2_WIDE(2048, 8)
    RT_I16X2_WIDE(3072, 4)
    RT_I16X2_WIDE(4096, 2)
    RT_I16X2_WIDE(4096, 4)
    RT_I16X2_WIDE(4096, 8)
    RT_I16X2_WIDE(8192, 4)
    RT_I16X2_WIDE(8192, 8)
#undef RT_I16X2_WIDE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
