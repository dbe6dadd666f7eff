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
// of 16384 steps is bound near 0.020 ms by its operations. The steps of one
// pair are a serial walk only in their positions, which a prefix sum gives,
// so the design spreads a pair over a whole block.
//
// Design: one block of THREADS = 256 threads (8 warps) a pair.
// - Passes. A pass is 1024 bytes of the row (4096 steps): thread t takes
//   the aligned 4-byte word at byte 4 t of the pass, its 16 steps (bytes
//   past the row's end, or a row not 4 B aligned, by byte loads with the
//   pad code past the end). The next pass's word is loaded before the
//   current one is walked. At S = 16384 a thread walks 4 x 16 steps.
// - Positions. A thread's counts of query and target steps are popcounts
//   of its codes' bit planes (M/I: high bit clear; M/D: low bit clear; pad
//   counts in neither), packed 16:16 (a pass has at most 4096 of each); a
//   warp shuffle scan, the 8 warp totals in shared memory and a carry from
//   pass to pass give every thread its first step's (qpos, tpos). The next
//   pass's counts are scanned at the end of the current pass, so one
//   barrier a pass serves both scans (their shared words alternate by the
//   pass's parity).
// - Intervals. tpos never grows along a row, so neither does the interval
//   index: a thread divides once for its first step's interval (kraw) and
//   its lower boundary. At w >= 16 its 16 steps cross at most one
//   boundary, so it takes its runs from its word's bit planes without a
//   loop (runs_from_masks): the boundary falls after the d-th target step,
//   d = tpos - lower, found by a binary search over popcounts; each side's
//   first and last match, and their positions, are a find-first-set, a
//   count-leading-zeros and popcounts. Where tpos falls below 0 among one
//   side's matches (a walk past (0, 0)), or at w < 16, the thread walks
//   its steps (walk_steps), dividing again only when tpos falls past the
//   current lower boundary. The bit planes are what make a block a pair
//   pay: with every thread walking its 16 steps (BP_RUNS_FROM_MASKS 0,
//   tools/ab/breaking_points_walk.cu; time both with chip_smoke.py --ab)
//   the kernel is bound by its instructions.
// - Reduction. The packed value falls strictly from one match to the next
//   (tpos falls at every match), so interval k's least value is its last
//   match and its largest its first: a run of matches in one interval needs
//   only its first and last value. A run that ends before the thread's 16
//   steps do ends its interval, so its bp_first entry is stored at once; a
//   run that starts after the thread's first starts its interval, so its
//   bp_last entry is stored at once. The thread's first run may continue
//   an interval of earlier threads, and its last run one of later threads:
//   a warp scan of the threads' last-run intervals (a prefix min) and of
//   their first-run intervals (a suffix max), with the warps' totals in
//   shared memory, says whether an earlier thread of the pass ends in the
//   interval of this thread's first run, or a later one starts in the
//   interval of its last run. Only the first run of an interval in a pass
//   writes its bp_last entry (a max with an earlier pass's, which is
//   larger), and only the last run its bp_first entry (a later pass
//   overwrites it with a smaller value), so every shared word has one
//   writer a pass and no atomics are needed. The stores between two
//   barriers (one pass's after its barrier, the next pass's before its
//   own) are unordered across threads, so before its barrier a pass
//   stores only entries of intervals that begin in it (those opened and
//   closed inside a thread, and a thread's last run's bp_last); the entry
//   of an interval that may have begun in an earlier pass (a thread's
//   first run's bp_first) waits for the barrier.
// - Epilogue. bp_first as it stands; bp_last through warp 0's 32-lane
//   running max, carried from one 32-entry chunk to the next, both
//   coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PASS_BYTES = THREADS * 4;  // 4096 steps a pass
constexpr int BP_BIG = 1 << 30;          // nw.BP_BIG
constexpr int NO_RUN = 1 << 30;          // above any interval index
constexpr unsigned FULL = 0xffffffffu;

// 0: every thread walks its steps (the A/B variant named above)
#ifndef BP_RUNS_FROM_MASKS
#define BP_RUNS_FROM_MASKS 1
#endif

__device__ __forceinline__ int floor_div(int a, int b) {
  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ceil((tpos - first_rel) / w): the number of boundaries below tpos
__device__ __forceinline__ int interval_of(int tpos, int first_rel, int w) {
  return -floor_div(first_rel - tpos, w);
}

// the 4 bytes of one thread's 16 steps; pad code (0xFF bytes) past the row
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int S4,
                                              int byte0, bool vec) {
  if (vec && byte0 + 4 <= S4) {
    return __ldg(reinterpret_cast<const uint32_t*>(row + byte0));
  }
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int at = byte0 + b;
    const uint32_t byte = at < S4 ? __ldg(row + at) : 0xFFu;
    v |= byte << (8 * b);
  }
  return v;
}

// this thread's M/I (query) and M/D (target) steps, packed 16:16
__device__ __forceinline__ int step_counts(uint32_t word) {
  const int hi = __popc((word >> 1) & 0x55555555u);
  const int lo = __popc(word & 0x55555555u);
  return ((16 - hi) << 16) | (16 - lo);
}

__device__ __forceinline__ int warp_sum_incl(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// the packed value of a match at (tpos, qpos), tpos >= 0
__device__ __forceinline__ int packed_at(int tpos, int qpos) {
  return static_cast<int>((static_cast<uint32_t>(tpos) << 14) |
                          static_cast<uint32_t>(max(qpos, 0)));
}

// A thread's runs of valid matches over its 16 steps, in order: the run
// being walked (r_*) and, once a second run opens, the first (f_*; f_k -1
// before). A run between the two opened and closed inside the steps is a
// whole interval: it is stored at once.
struct Runs {
  int f_k, f_first, f_last;
  int r_k, r_first, r_last;
};

// step by step, at any w: the interval index is divided once at the first
// step (kraw, lower) and again only when tpos falls to the lower boundary
__device__ __forceinline__ void walk_steps(uint32_t word, int qpos, int tpos,
                                           int kraw, int lower,
                                           int first_rel, int w, int last_k,
                                           int NW, int* s_first, int* s_last,
                                           Runs& r) {
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
        const int packed = packed_at(tpos, qpos);
        if (k != r.r_k) {
          if (r.r_k >= 0) {
            if (r.f_k < 0) {
              r.f_k = r.r_k;
              r.f_first = r.r_first;
              r.f_last = r.r_last;
            } else {
              s_first[r.r_k] = r.r_last;
              s_last[r.r_k] = r.r_first;
            }
          }
          r.r_k = k;
          r.r_first = packed;
        }
        r.r_last = packed;
      }
    }
    qpos -= code <= 1u;
    tpos -= (code & 1u) == 0u;
  }
}

// the bits below bit b (b < 32)
__device__ __forceinline__ uint32_t below(int b) { return (1u << b) - 1u; }

// The same runs from the word's bit planes, without a loop over the steps,
// where w >= 16: 16 steps consume at most 16 target positions, so they
// cross at most one interval boundary. Bit 2j of tmask (qmask) is set
// where step j consumes a target (query) base, of mmask where it is a
// match; a step's position is its first step's less the popcount of the
// plane below it. The boundary falls after the d-th target step, d = tpos
// - lower (a binary search over the popcounts): the matches before it lie
// in interval kraw, those after in kraw - 1. A segment's valid matches
// are all or none of it, unless tpos falls below 0 inside it: then this
// returns false and the caller walks the steps.
__device__ __forceinline__ bool runs_from_masks(uint32_t word, int qpos,
                                                int tpos, int kraw,
                                                int lower, int last_k,
                                                int NW, Runs& r) {
  const uint32_t tmask = ~word & 0x55555555u;
  const uint32_t qmask = ~(word >> 1) & 0x55555555u;
  const uint32_t mmask = tmask & qmask;
  const int d = tpos - lower;  // >= 1
  uint32_t seg_a = mmask;      // matches in interval kraw
  if (__popc(tmask) >= d) {
    // the least j in [1, 16] with d target steps below step j (j = 16
    // only once lo meets hi there, which the count below 32 bits holds)
    int lo = 1, hi = 16;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int mid = (lo + hi) >> 1;
      if (__popc(mid < 16 ? tmask & below(2 * mid) : tmask) >= d) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    seg_a = hi < 16 ? mmask & below(2 * hi) : mmask;
  }
  const uint32_t segs[2] = {seg_a, mmask & ~seg_a};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t seg = segs[i];
    const int k = min(max(kraw - i, 0), last_k);
    if (seg == 0 || k < 0 || k >= NW) continue;
    const int b0 = __ffs(seg) - 1;
    const int b1 = 31 - __clz(seg);
    const int t0 = tpos - __popc(tmask & below(b0));
    const int t1 = tpos - __popc(tmask & below(b1));
    if (t0 < 0) continue;      // tpos only falls: none valid
    if (t1 < 0) return false;  // valid up to tpos 0 inside the segment
    const int v0 = packed_at(t0, qpos - __popc(qmask & below(b0)));
    const int v1 = packed_at(t1, qpos - __popc(qmask & below(b1)));
    if (k == r.r_k) {  // both segments clamped into one interval
      r.r_last = v1;
    } else {
      if (r.r_k >= 0) {
        r.f_k = r.r_k;
        r.f_first = r.r_first;
        r.f_last = r.r_last;
      }
      r.r_k = k;
      r.r_first = v0;
      r.r_last = v1;
    }
  }
  return true;
}

__global__ void __launch_bounds__(THREADS)
breaking_points_kernel(const uint8_t* __restrict__ ops,
                       const int32_t* __restrict__ n_in,
                       const int32_t* __restrict__ m_in,
                       const int32_t* __restrict__ first_rel_in,
                       const int32_t* __restrict__ nb_in,
                       int32_t* __restrict__ bp_first,
                       int32_t* __restrict__ bp_last, int S4, int w,
                       int NW) {
  extern __shared__ int smem[];
  int* s_first = smem;
  int* s_last = smem + NW;
  // by the pass's parity: each warp's packed counts (inclusive), the least
  // last-run interval of its threads (NO_RUN with none) and the largest
  // first-run interval (-1 with none)
  __shared__ int s_count[2][WARPS];
  __shared__ int s_lastk[2][WARPS];
  __shared__ int s_firstk[2][WARPS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  for (int k = tid; k < NW; k += THREADS) {
    s_first[k] = BP_BIG;
    s_last[k] = -1;
  }

  const uint8_t* row = ops + (size_t)b * S4;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 3) == 0;
  const int n = n_in[b];
  const int m = m_in[b];
  const int first_rel = first_rel_in[b];
  const int last_k = nb_in[b] - 1;
  const int passes = (S4 + PASS_BYTES - 1) / PASS_BYTES;
  uint32_t word = load_word(row, S4, 4 * tid, vec);
  int mine = step_counts(word);
  int incl = warp_sum_incl(mine, lane);
  if (lane == 31) s_count[0][warp] = incl;
  __syncthreads();
  // M/I and M/D steps before the current pass
  int q_before = 0, t_before = 0;
  for (int p = 0; p < passes; ++p) {
    const int buf = p & 1;
    const bool more = p + 1 < passes;  // uniform over the block
    const uint32_t next =
        more ? load_word(row, S4, (p + 1) * PASS_BYTES + 4 * tid, vec)
             : 0xFFFFFFFFu;
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      const int c = s_count[buf][i];
      before += i < warp ? c : 0;
      total += c;
    }
    const int excl = before + incl - mine;
    int qpos = n - 1 - (q_before + (excl >> 16));
    int tpos = m - 1 - (t_before + (excl & 0xFFFF));
    q_before += total >> 16;
    t_before += total & 0xFFFF;

    // the interval of this thread's first step, and its lower boundary
    const int kraw = interval_of(tpos, first_rel, w);
    const int lower = first_rel + (kraw - 1) * w;
    Runs r = {-1, 0, 0, -1, 0, 0};
    if ((~(word | (word >> 1)) & 0x55555555u) != 0) {  // a match
      if (!BP_RUNS_FROM_MASKS || w < 16 ||
          !runs_from_masks(word, qpos, tpos, kraw, lower, last_k, NW, r)) {
        r = {-1, 0, 0, -1, 0, 0};
        walk_steps(word, qpos, tpos, kraw, lower, first_rel, w, last_k, NW,
                   s_first, s_last, r);
      }
    }
    const bool two = r.f_k >= 0;
    int f_k = r.f_k, f_first = r.f_first;
    const int f_last = r.f_last;
    const int r_k = r.r_k, r_first = r.r_first, r_last = r.r_last;
    if (two) {
      // two runs or more: the last run's interval starts here, so no
      // earlier pass wrote its entry
      s_last[r_k] = r_first;
    } else {  // one run (or none): it is the first and the last
      f_k = r_k;
      f_first = r_first;
    }

    // the next pass's counts, scanned now so one barrier serves both
    if (more) {
      word = next;
      mine = step_counts(word);
      incl = warp_sum_incl(mine, lane);
      if (lane == 31) s_count[buf ^ 1][warp] = incl;
    }
    // prefix min of the last-run intervals, suffix max of the first-run
    // ones (inclusive within the warp)
    int pmin = r_k >= 0 ? r_k : NO_RUN;
    int smax = f_k;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, pmin, d);
      const int v = __shfl_down_sync(FULL, smax, d);
      if (lane >= d) pmin = min(pmin, u);
      if (lane + d < 32) smax = max(smax, v);
    }
    if (lane == 31) s_lastk[buf][warp] = pmin;
    if (lane == 0) s_firstk[buf][warp] = smax;
    int prev_k = __shfl_up_sync(FULL, pmin, 1);
    int next_k = __shfl_down_sync(FULL, smax, 1);
    if (lane == 0) prev_k = NO_RUN;
    if (lane == 31) next_k = -1;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      if (i < warp) prev_k = min(prev_k, s_lastk[buf][i]);
      if (i > warp) next_k = max(next_k, s_firstk[buf][i]);
    }
    // the first run's interval ends here and may have begun in an earlier
    // pass, whose last thread in it stored bp_first after that pass's
    // barrier: this store waits for the current pass's barrier
    if (two) s_first[f_k] = f_last;
    if (r_k >= 0) {
      // the last run of its interval in this pass (a later pass's matches
      // overwrite it)
      if (next_k != r_k) s_first[r_k] = r_last;
      // the first run of its interval in this pass; an earlier pass's
      // first match of the interval is larger
      if (prev_k != f_k) s_last[f_k] = max(s_last[f_k], f_first);
    }
  }
  __syncthreads();

  int32_t* out_first = bp_first + (size_t)b * NW;
  for (int k = tid; k < NW; k += THREADS) out_first[k] = s_first[k];
  if (warp == 0) {
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
      if (k < NW) out_last[k] = v;
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
  const size_t smem = (size_t)2 * NW * sizeof(int);
  // the static scan words take the rest of the default 48 KB
  if (smem > 47 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        breaking_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  breaking_points_kernel<<<B, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ops), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(m), static_cast<const int32_t*>(first_rel),
      static_cast<const int32_t*>(nb), static_cast<int32_t*>(bp_first),
      static_cast<int32_t*>(bp_last), S4, w, NW);
  return static_cast<int>(cudaGetLastError());
}
