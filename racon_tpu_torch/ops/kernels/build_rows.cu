// The banded NW rows of an aligner chunk, unpacked from its upload blocks,
// for Hopper.
//
// Replaces three XLA functions, not a Pallas kernel: racon_tpu/ops/nw.py:355
// (_build_rows, raw byte blocks), :372 (_build_rows_packed, nibble blocks)
// and :391 (_build_rows_packed2, 2-bit blocks). Each is a gather of [B,
// width] int32 indices, a shift and mask, and a select. The plain version
// (racon_tpu_torch/ops/nw.py build_rows_plain) does the same in PyTorch
// with [B, width] int64 index tensors; this kernel reads the packed block
// and writes the two rows, nothing else.
//
// Inputs: qblk, tblk uint8 [B * max_len * BITS / 8] (pair k's codes from
// code k * max_len; BITS 2: four codes a byte, the first in the low bits;
// 4: two a byte, low nibble first; 8: one a byte), n, m int32 [B]. Outputs:
// qrp, tp uint8 [B, width], width = band/2 + max_len + band, c = band/2.
// Column x of qrp holds query code c + max_len - 1 - x (the reversed query
// ends at column c + max_len), column x of tp target code x - c; a code
// counts when its index lies in [0, n) (qrp) or [0, m) (tp), and reads
// index min(index, max_len - 1), as the JAX functions clip it; every other
// byte is 0. So the rows are the JAX functions' bytes for any block.
//
// Bound on this card: bytes. A launch reads the packed blocks and writes
// both rows once: at the aligner's (16384, 4096) chunk of 2048 pairs that
// is 16.8 MB read at 2 bits and 92.3 MB written, about 0.033 ms at
// 3.35 TB/s (chip_smoke.py computes it per launch).
//
// Design: blockIdx.x is the pair, blockIdx.y a range of blockDim.x
// 16-byte chunks of its rows; a thread writes chunk x0..x0+15 of both rows
// with one 16 B store each. Where c, max_len and width are multiples of
// 16 and every pointer is 16 B aligned (every aligner bucket and band rung:
// the fast flag, uniform over the launch), a chunk's 16 codes are one
// aligned group of the block (codes 16 g .. 16 g + 15: one 4 B load at
// BITS 2, 8 B at 4, 16 B at 8), spread to bytes by shifts and masks and,
// for the query, byte-reversed. A chunk wholly outside [0, n) or [0, m) is
// stored as zeros without a load; a chunk across a boundary (two a row),
// or any chunk without the fast flag, takes the byte loop. The output
// keeps the plain version's width and pitch, so the forward bodies' 16 B
// row staging (nw_fwd.cu stage_rows16) applies as before.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int BITS>
__device__ __forceinline__ uint8_t code_at(const uint8_t* __restrict__ s,
                                           int i) {
    if (BITS == 8) return s[i];
    constexpr int per = 8 / BITS;
    return static_cast<uint8_t>((s[i / per] >> ((i % per) * BITS))
                                & ((1 << BITS) - 1));
}

// codes 4j..4j+3 of a 2-bit byte b as four bytes, the first lowest
__device__ __forceinline__ unsigned spread2(unsigned b) {
    b = (b | (b << 12)) & 0x000F000Fu;
    return (b | (b << 6)) & 0x03030303u;
}

// four nibble codes of 16 bits h as four bytes, the first lowest
__device__ __forceinline__ unsigned spread4(unsigned h) {
    h = (h | (h << 8)) & 0x00FF00FFu;
    return (h | (h << 4)) & 0x0F0F0F0Fu;
}

// the 16 codes 16 g .. 16 g + 15 of a pair's block as four words of bytes,
// the first code lowest (the block's group g starts 2 BITS g bytes in)
template <int BITS>
__device__ __forceinline__ uint4 group16(const uint8_t* __restrict__ s,
                                         int g) {
    if (BITS == 2) {
        const unsigned w = *reinterpret_cast<const unsigned*>(s + 4 * g);
        return make_uint4(spread2(w & 0xFF), spread2((w >> 8) & 0xFF),
                          spread2((w >> 16) & 0xFF), spread2(w >> 24));
    } else if (BITS == 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(s + 8 * g);
        return make_uint4(spread4(w.x & 0xFFFF), spread4(w.x >> 16),
                          spread4(w.y & 0xFFFF), spread4(w.y >> 16));
    } else {
        return *reinterpret_cast<const uint4*>(s + 16 * g);
    }
}

// the 16 bytes in reverse order
__device__ __forceinline__ uint4 reversed(uint4 v) {
    return make_uint4(__byte_perm(v.w, 0, 0x0123), __byte_perm(v.z, 0, 0x0123),
                      __byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
}

// chunk x0 of one row, byte by byte: column x holds code (dir > 0 ? x - base
// : base - x) when that index lies in [0, len)
template <int BITS>
__device__ __forceinline__ void row_bytes(const uint8_t* __restrict__ s,
                                          uint8_t* __restrict__ row, int x0,
                                          int width, int base, int dir,
                                          int len, int max_len) {
    for (int k = 0; k < 16 && x0 + k < width; ++k) {
        const int i = dir > 0 ? x0 + k - base : base - x0 - k;
        row[x0 + k] = (i >= 0 && i < len)
                          ? code_at<BITS>(s, min(i, max_len - 1))
                          : static_cast<uint8_t>(0);
    }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
build_rows_kernel(const uint8_t* __restrict__ qblk,
                  const uint8_t* __restrict__ tblk,
                  const int32_t* __restrict__ n_arr,
                  const int32_t* __restrict__ m_arr,
                  uint8_t* __restrict__ qrp, uint8_t* __restrict__ tp,
                  int max_len, int c, int width, int fast) {
    const int b = blockIdx.x;
    const int x0 = 16 * (blockIdx.y * blockDim.x + threadIdx.x);
    if (x0 >= width) return;
    const int n = n_arr[b], m = m_arr[b];
    const size_t slot = static_cast<size_t>(b) * max_len * BITS / 8;
    const uint8_t* qs = qblk + slot;
    const uint8_t* ts = tblk + slot;
    uint8_t* qrow = qrp + static_cast<size_t>(b) * width;
    uint8_t* trow = tp + static_cast<size_t>(b) * width;
    const int qtop = c + max_len - 1;   // query index of column 0
    if (!fast) {
        row_bytes<BITS>(qs, qrow, x0, width, qtop, -1, n, max_len);
        row_bytes<BITS>(ts, trow, x0, width, c, 1, m, max_len);
        return;
    }
    const int qn = min(n, max_len), tm = min(m, max_len);
    // query: indices qtop - x0 - 15 .. qtop - x0, one group reversed
    const int qhi = qtop - x0;
    if (qhi < 0 || qhi - 15 >= n) {
        *reinterpret_cast<uint4*>(qrow + x0) = make_uint4(0, 0, 0, 0);
    } else if (qhi - 15 >= 0 && qhi < qn) {
        *reinterpret_cast<uint4*>(qrow + x0) =
            reversed(group16<BITS>(qs, (qhi - 15) / 16));
    } else {
        row_bytes<BITS>(qs, qrow, x0, width, qtop, -1, n, max_len);
    }
    // target: indices x0 - c .. x0 - c + 15, one group in order
    const int tlo = x0 - c;
    if (tlo + 15 < 0 || tlo >= m) {
        *reinterpret_cast<uint4*>(trow + x0) = make_uint4(0, 0, 0, 0);
    } else if (tlo >= 0 && tlo + 15 < tm) {
        *reinterpret_cast<uint4*>(trow + x0) = group16<BITS>(ts, tlo / 16);
    } else {
        row_bytes<BITS>(ts, trow, x0, width, c, 1, m, max_len);
    }
}

template <int BITS>
cudaError_t launch(const void* qblk, const void* tblk, const void* n,
                   const void* m, void* qrp, void* tp, int B, int max_len,
                   int c, int width, int fast, cudaStream_t stream) {
    const int chunks = (width + 15) / 16;
    const int threads = std::min(kThreads, (chunks + 31) / 32 * 32);
    const dim3 grid(B, (chunks + threads - 1) / threads);
    build_rows_kernel<BITS><<<grid, threads, 0, stream>>>(
        static_cast<const uint8_t*>(qblk), static_cast<const uint8_t*>(tblk),
        static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
        static_cast<uint8_t*>(qrp), static_cast<uint8_t*>(tp), max_len, c,
        width, fast);
    return cudaGetLastError();
}

}  // namespace

// qblk, tblk, n, m, qrp, tp, B, max_len, band, bits, stream; returns the
// launch's cudaError_t (cudaErrorInvalidValue for a bits other than 2, 4,
// 8 or a max_len that is not whole bytes a pair)
extern "C" int rt_build_rows(const void* qblk, const void* tblk,
                             const void* n, const void* m, void* qrp,
                             void* tp, int B, int max_len, int band, int bits,
                             void* stream) {
    if (B <= 0) return 0;
    if (max_len <= 0 || (max_len * bits) % 8 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int c = band / 2;
    const int width = c + max_len + band;
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qblk)
                           | reinterpret_cast<uintptr_t>(tblk)
                           | reinterpret_cast<uintptr_t>(qrp)
                           | reinterpret_cast<uintptr_t>(tp);
    const int fast = ((c | max_len | width) % 16 == 0 && ptrs % 16 == 0)
                         ? 1 : 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (bits) {
        case 2:
            return static_cast<int>(launch<2>(qblk, tblk, n, m, qrp, tp, B,
                                              max_len, c, width, fast, s));
        case 4:
            return static_cast<int>(launch<4>(qblk, tblk, n, m, qrp, tp, B,
                                              max_len, c, width, fast, s));
        case 8:
            return static_cast<int>(launch<8>(qblk, tblk, n, m, qrp, tp, B,
                                              max_len, c, width, fast, s));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
