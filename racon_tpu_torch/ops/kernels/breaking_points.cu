// Per-window breaking points from the aligner walk's packed op stream, for
// Hopper.
//
// Replaces racon_tpu/ops/nw.py:430 (_breaking_points_kernel), an XLA
// function: NW masked min/max reduces over a pair's S walk steps. The plain
// version (racon_tpu_torch/ops/nw.py breaking_points_plain) makes about
// fifteen passes over [B, S] int32 temporaries; this kernel reads the op
// stream once and writes only the two [B, NW] tables.
//
// Inputs: ops [B, S4] uint8 (step 4j + k at bits 2k of byte j; 0 = M, 1 = I,
// 2 = D, 3 = pad), n, m, first_rel, nb [B] int32. Output: bp_first, bp_last
// [B, NW] int32, the plain version's ints. A step's query and target
// positions are qpos = n - 1 - (M/I steps before it), tpos = m - 1 - (M/D
// steps before it); a match (code 0) with tpos >= 0 falls in interval widx
// = clip(ceil((tpos - first_rel) / w), 0, nb - 1) and counts when widx <
// NW. bp_first[k] is the least tpos << 14 | max(qpos, 0) over interval k's
// matches (BP_BIG with none), bp_last[k] the largest (-1 with none), then
// a running max over k.
//
// Bound on this card: bytes or operations, both small. The op stream is
// S/4 bytes a pair (8 KB at S = 32768) and a step needs ten integer
// operations (OPS_PER_BP_STEP in chip_smoke.py), so a launch of 2048 pairs
// of 16384 steps is bound near 0.020 ms by its operations.
//
// Design: one warp a pair, blocks of WARPS warps.
// - Tiles. A tile is 2048 steps: lane l takes the 16 bytes (64 steps) at
//   byte 16 l of the tile in one vector load (bytes where the row is not
//   16 B aligned or ends inside the tile, pad code past its end); the next
//   tile's bytes are loaded before the current one is walked. The step
//   loop is unrolled four steps deep only: fully unrolled it ran slower.
// - Positions. A lane's counts of query and target steps are popcounts of
//   its codes' bit planes (M/I: high bit clear; M/D: low bit clear; pad
//   counts in neither), one warp scan of the two counts gives every lane
//   its first step's (qpos, tpos), and a carry links the tiles.
// - Intervals. tpos never grows along a row, so neither does the interval
//   index: a lane divides once at its first step and again only when tpos
//   falls past the current interval's lower boundary.
// - Reduction. A lane keeps the current interval's least and largest
//   packed value in registers and flushes them to its warp's [2, NW] rows
//   in shared memory with atomicMin/atomicMax when the interval changes and
//   at the end of its 64 steps. The atomics make the result independent of
//   the order of the flushes.
// - Epilogue. The warp writes bp_first as it stands and bp_last through a
//   32-lane running max, carried from one 32-entry chunk to the next, both
//   coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int TILE_BYTES = 32 * 16;      // a warp's bytes a tile
constexpr int BP_BIG = 1 << 30;          // nw.BP_BIG
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floor_div(int a, int b) {
  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ceil((tpos - first_rel) / w): the number of boundaries below tpos
__device__ __forceinline__ int interval_of(int tpos, int first_rel, int w) {
  return -floor_div(first_rel - tpos, w);
}

// the 16 bytes of one lane's 64 steps; pad code (0xFF bytes) past the row
__device__ __forceinline__ uint4 load_steps(const uint8_t* row, int S4,
                                            int byte0, bool vec) {
  if (vec && byte0 + 16 <= S4) {
    return __ldg(reinterpret_cast<const uint4*>(row + byte0));
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int at = byte0 + 4 * i + b;
      const uint32_t byte = at < S4 ? __ldg(row + at) : 0xFFu;
      v |= byte << (8 * b);
    }
    w[i] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(WARPS * 32)
breaking_points_kernel(const uint8_t* __restrict__ ops,
                       const int32_t* __restrict__ n_in,
                       const int32_t* __restrict__ m_in,
                       const int32_t* __restrict__ first_rel_in,
                       const int32_t* __restrict__ nb_in,
                       int32_t* __restrict__ bp_first,
                       int32_t* __restrict__ bp_last, int B, int S4, int w,
                       int NW) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // a whole warp: no shuffle below is left partial
  int* s_first = smem + warp * 2 * NW;
  int* s_last = s_first + NW;
  for (int k = lane; k < NW; k += 32) {
    s_first[k] = BP_BIG;
    s_last[k] = -1;
  }
  __syncwarp();

  const uint8_t* row = ops + (size_t)b * S4;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const int n = n_in[b];
  const int m = m_in[b];
  const int first_rel = first_rel_in[b];
  const int last_k = nb_in[b] - 1;
  // M/I and M/D steps before the current tile
  int q_before = 0, t_before = 0;
  const int tiles = (S4 + TILE_BYTES - 1) / TILE_BYTES;
  uint4 next = load_steps(row, S4, lane * 16, vec);
  for (int tile = 0; tile < tiles; ++tile) {
    const uint4 cur = next;
    if (tile + 1 < tiles) {
      next = load_steps(row, S4, (tile + 1) * TILE_BYTES + lane * 16, vec);
    }
    uint32_t w0 = cur.x, w1 = cur.y, w2 = cur.z, w3 = cur.w;
    const int hi = __popc((w0 >> 1) & 0x55555555u) +
                   __popc((w1 >> 1) & 0x55555555u) +
                   __popc((w2 >> 1) & 0x55555555u) +
                   __popc((w3 >> 1) & 0x55555555u);
    const int lo = __popc(w0 & 0x55555555u) + __popc(w1 & 0x55555555u) +
                   __popc(w2 & 0x55555555u) + __popc(w3 & 0x55555555u);
    // this lane's M/I (query) and M/D (target) steps, packed 16:16
    const int mine = ((64 - hi) << 16) | (64 - lo);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int excl = incl - mine;
    const int total = __shfl_sync(FULL, incl, 31);
    int qpos = n - 1 - (q_before + (excl >> 16));
    int tpos = m - 1 - (t_before + (excl & 0xFFFF));
    q_before += total >> 16;
    t_before += total & 0xFFFF;

    // the interval of this lane's first step, and its lower boundary
    int kraw = interval_of(tpos, first_rel, w);
    int lower = first_rel + (kraw - 1) * w;
    int run_k = -1, run_min = BP_BIG, run_max = -1;
    // the words rotate through w0 (an indexed array would go to local
    // memory); four steps unrolled, not 64: the full unroll ran slower
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const uint32_t word = w0;
      w0 = w1;
      w1 = w2;
      w2 = w3;
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const uint32_t code = (word >> (2 * j)) & 3u;
        if (code == 0 && tpos >= 0) {
          if (tpos <= lower) {
            kraw = interval_of(tpos, first_rel, w);
            lower = first_rel + (kraw - 1) * w;
          }
          const int k = min(max(kraw, 0), last_k);
          if (k >= 0 && k < NW) {
            const int packed = static_cast<int>(
                (static_cast<uint32_t>(tpos) << 14) |
                static_cast<uint32_t>(max(qpos, 0)));
            if (k != run_k) {
              if (run_k >= 0) {
                atomicMin(&s_first[run_k], run_min);
                atomicMax(&s_last[run_k], run_max);
              }
              run_k = k;
              run_min = packed;
              run_max = packed;
            } else {
              run_min = min(run_min, packed);
              run_max = max(run_max, packed);
            }
          }
        }
        qpos -= code <= 1u;
        tpos -= (code & 1u) == 0u;
      }
    }
    if (run_k >= 0) {
      atomicMin(&s_first[run_k], run_min);
      atomicMax(&s_last[run_k], run_max);
    }
  }
  __syncwarp();

  int32_t* out_first = bp_first + (size_t)b * NW;
  int32_t* out_last = bp_last + (size_t)b * NW;
  int carry = -1;
  for (int k0 = 0; k0 < NW; k0 += 32) {
    const int k = k0 + lane;
    int v = k < NW ? s_last[k] : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v = max(v, u);
    }
    v = max(v, carry);
    carry = __shfl_sync(FULL, v, 31);
    if (k < NW) {
      out_first[k] = s_first[k];
      out_last[k] = v;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int rt_breaking_points(const void* ops, const void* n,
                                  const void* m, const void* first_rel,
                                  const void* nb, void* bp_first,
                                  void* bp_last, int B, int S4, int w, int NW,
                                  void* stream) {
  if (B <= 0 || NW <= 0) return 0;
  const size_t smem = (size_t)WARPS * 2 * NW * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        breaking_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  breaking_points_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ops), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(m), static_cast<const int32_t*>(first_rel),
      static_cast<const int32_t*>(nb), static_cast<int32_t*>(bp_first),
      static_cast<int32_t*>(bp_last), B, S4, w, NW);
  return static_cast<int>(cudaGetLastError());
}
