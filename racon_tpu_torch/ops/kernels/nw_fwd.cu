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
// Design: one block per pair, RB threads; thread t owns the four lanes
// t, t+RB, t+2RB, t+3RB, i.e. exactly the lanes of direction byte t, so a
// thread packs its byte with no exchange and the block writes one coalesced
// RB-byte row per wavefront. The previous wavefront lives in registers; the
// +-1 lane shifts read the neighbours' values from a double-buffered shared
// array, one barrier per anti-diagonal. The pair's query/target rows are
// staged in shared memory once. A block stops at its own pair's n + m
// (rows past it are never read by any walk and are left unwritten).
//
// K4 (nw_fwd_i16x2) is the same kernel on two int16 scores per 32-bit word
// (lanes t|t+RB and t+2RB|t+3RB), with the SIMD-in-word intrinsics
// __vadd2/__vminu2/__vcmpeq2/__vcmpgeu2 and the saturation value BIG16 =
// 0x4800 of racon_tpu/ops/swar.py: every real cell value is < max_len + 2
// < BIG16 and the {real, BIG, BIG+1} classes compare the same, so the
// direction rows are byte-identical to K1's and the score maps BIG16 back
// to 1 << 28.
//
// Bound on this card: integer ALU work, about 16 int32 operations per DP
// cell for K1 and about 8 per cell for K4 (two cells per word operation),
// against 64 INT32 lanes per SM per clock. Bytes are small by comparison:
// two input rows per pair and RB bytes out per wavefront. The design keeps
// the wavefronts on chip (registers + a 2*U-entry shared buffer) and writes
// only the direction bytes and the score to device memory; the one barrier
// per wavefront is its remaining cost.

#include <cstdint>
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

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int rt_nw_fwd_i32(const void* qrp, const void* tp, const void* n,
                  const void* m, void* dirs, void* score, int B, int max_len,
                  int band, int width, int steps, void* stream) {
    return launch(nw_fwd_i32_kernel, sizeof(int32_t), qrp, tp, n, m, dirs,
                  score, B, max_len, band, width, steps, stream);
}

int rt_nw_fwd_i16x2(const void* qrp, const void* tp, const void* n,
                    const void* m, void* dirs, void* score, int B,
                    int max_len, int band, int width, int steps,
                    void* stream) {
    return launch(nw_fwd_i16x2_kernel, sizeof(uint16_t), qrp, tp, n, m, dirs,
                  score, B, max_len, band, width, steps, stream);
}

}  // extern "C"
