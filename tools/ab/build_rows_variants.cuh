// Other bodies of build_rows for an A/B against the kernel in
// racon_tpu_torch/ops/kernels/build_rows.cu, on the same C entry:
//
//   python3 chip_smoke.py --ab build_rows tools/ab/build_rows_t64.cu \
//       tools/ab/build_rows_stride.cu tools/ab/build_rows_quad.cu
//
// Each build_rows_<name>.cu defines VARIANT and includes this file, which
// includes the kernel's source with its C entry renamed rt_build_rows_base
// and reuses its helpers (group16, reversed, row_bytes). Where the fast
// flag holds (every aligner bucket) the variant's body runs; otherwise the
// entry calls rt_build_rows_base. Every body writes the same bytes:
// - VARIANT 1 (t64): a block of 128 threads a pair; a thread writes 64 B
//   of each row, four 16 B chunks in a row, and strides over the row by
//   64 B x 128.
// - VARIANT 2 (stride): a block of 256 threads a pair; a thread writes one
//   16 B chunk of each row and strides by 16 B x 256 (a warp's stores are
//   contiguous).
// - VARIANT 3 (quad): blocks of 128 threads, blockIdx.x the pair and
//   blockIdx.y a range of 512 chunks; a thread writes four chunks 128
//   apart (a warp's stores are contiguous).

#define rt_build_rows rt_build_rows_base
#include "../../racon_tpu_torch/ops/kernels/build_rows.cu"
#undef rt_build_rows

namespace {

// chunk x0 of both rows as build_rows_kernel's fast path writes it
template <int BITS>
__device__ __forceinline__ void chunk16(const uint8_t* __restrict__ qs,
                                        const uint8_t* __restrict__ ts,
                                        uint8_t* __restrict__ qrow,
                                        uint8_t* __restrict__ trow, int x0,
                                        int width, int c, int n, int m,
                                        int max_len) {
    const int qtop = c + max_len - 1;
    const int qn = min(n, max_len), tm = min(m, max_len);
    const int qhi = qtop - x0;
    if (qhi < 0 || qhi - 15 >= n) {
        *reinterpret_cast<uint4*>(qrow + x0) = make_uint4(0, 0, 0, 0);
    } else if (qhi - 15 >= 0 && qhi < qn) {
        *reinterpret_cast<uint4*>(qrow + x0) =
            reversed(group16<BITS>(qs, (qhi - 15) / 16));
    } else {
        row_bytes<BITS>(qs, qrow, x0, width, qtop, -1, n, max_len);
    }
    const int tlo = x0 - c;
    if (tlo + 15 < 0 || tlo >= m) {
        *reinterpret_cast<uint4*>(trow + x0) = make_uint4(0, 0, 0, 0);
    } else if (tlo >= 0 && tlo + 15 < tm) {
        *reinterpret_cast<uint4*>(trow + x0) = group16<BITS>(ts, tlo / 16);
    } else {
        row_bytes<BITS>(ts, trow, x0, width, c, 1, m, max_len);
    }
}

#if VARIANT == 1
constexpr int kVarThreads = 128;
#elif VARIANT == 2
constexpr int kVarThreads = 256;
#else
constexpr int kVarThreads = 128;
#endif

template <int BITS>
__global__ void __launch_bounds__(kVarThreads)
variant_kernel(const uint8_t* __restrict__ qblk,
               const uint8_t* __restrict__ tblk,
               const int32_t* __restrict__ n_arr,
               const int32_t* __restrict__ m_arr, uint8_t* __restrict__ qrp,
               uint8_t* __restrict__ tp, int max_len, int c, int width) {
    const int b = blockIdx.x;
    const int n = n_arr[b], m = m_arr[b];
    const size_t slot = static_cast<size_t>(b) * max_len * BITS / 8;
    const uint8_t* qs = qblk + slot;
    const uint8_t* ts = tblk + slot;
    uint8_t* qrow = qrp + static_cast<size_t>(b) * width;
    uint8_t* trow = tp + static_cast<size_t>(b) * width;
#if VARIANT == 1
    for (int x = 64 * threadIdx.x; x < width; x += 64 * kVarThreads) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (x + 16 * j < width) {
                chunk16<BITS>(qs, ts, qrow, trow, x + 16 * j, width, c, n, m,
                              max_len);
            }
        }
    }
#elif VARIANT == 2
    for (int x = 16 * threadIdx.x; x < width; x += 16 * kVarThreads) {
        chunk16<BITS>(qs, ts, qrow, trow, x, width, c, n, m, max_len);
    }
#else
    const int base = blockIdx.y * 4 * kVarThreads + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int x = 16 * (base + j * kVarThreads);
        if (x < width) {
            chunk16<BITS>(qs, ts, qrow, trow, x, width, c, n, m, max_len);
        }
    }
#endif
}

template <int BITS>
cudaError_t variant_launch(const void* qblk, const void* tblk, const void* n,
                           const void* m, void* qrp, void* tp, int B,
                           int max_len, int c, int width,
                           cudaStream_t stream) {
#if VARIANT == 3
    const int chunks = width / 16;
    const dim3 grid(B, (chunks + 4 * kVarThreads - 1) / (4 * kVarThreads));
#else
    const dim3 grid(B);
#endif
    variant_kernel<BITS><<<grid, kVarThreads, 0, stream>>>(
        static_cast<const uint8_t*>(qblk), static_cast<const uint8_t*>(tblk),
        static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
        static_cast<uint8_t*>(qrp), static_cast<uint8_t*>(tp), max_len, c,
        width);
    return cudaGetLastError();
}

}  // namespace

extern "C" int rt_build_rows(const void* qblk, const void* tblk,
                             const void* n, const void* m, void* qrp,
                             void* tp, int B, int max_len, int band, int bits,
                             void* stream) {
    const int c = band / 2;
    const int width = c + max_len + band;
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qblk)
                           | reinterpret_cast<uintptr_t>(tblk)
                           | reinterpret_cast<uintptr_t>(qrp)
                           | reinterpret_cast<uintptr_t>(tp);
    const bool fast = B > 0 && max_len > 0 && (max_len * bits) % 8 == 0
                      && (c | max_len | width) % 16 == 0 && ptrs % 16 == 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fast && bits == 2)
        return static_cast<int>(variant_launch<2>(qblk, tblk, n, m, qrp, tp,
                                                  B, max_len, c, width, s));
    if (fast && bits == 4)
        return static_cast<int>(variant_launch<4>(qblk, tblk, n, m, qrp, tp,
                                                  B, max_len, c, width, s));
    if (fast && bits == 8)
        return static_cast<int>(variant_launch<8>(qblk, tblk, n, m, qrp, tp,
                                                  B, max_len, c, width, s));
    return rt_build_rows_base(qblk, tblk, n, m, qrp, tp, B, max_len, band,
                              bits, stream);
}
