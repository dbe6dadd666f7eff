// Gap-scored colinear chaining DP of the first-party overlapper, for Hopper.
//
// Replaces racon_tpu/ops/chain.py:129 (_chain_kernel), an XLA function: a
// lax.scan over a pair's S seed slots, each slot scored against the
// CHAIN_LOOKBACK previous ones, then a second scan of length S that walks
// the best chain back. PyTorch has no vectorised scan, so the plain version
// (racon_tpu_torch/ops/chain.py chain_dp_plain) is a Python loop of about
// twenty tensor operations a step over 2 S steps; this kernel runs the whole
// scan in one launch.
//
// Inputs: ts, qs [B, S] int32 (a pair's seed coordinates, sorted by (t,
// q)), ns [B] int32 (live seeds a lane). Output: out [B, 6] int32 rows
// (score, n_chained, q_lo, q_hi, t_lo, t_hi), byte-equal to _chain_kernel's.
// parent [S, B] uint8 is scratch for S > smem_slots: the predecessor offset
// of every live slot (up to smem_slots the offsets stay in shared memory
// and parent may be null).
//
// Bound on this card: latency. A lane's slots form one dependent chain (slot
// i needs f of slots i-16 .. i-1); bytes (8 a live slot) and operations (21
// a predecessor, itemised at OPS_PER_CHAIN_PRED in chip_smoke.py) take a
// small share of the chain's time. So the design shortens the chain's step
// and puts more threads on the card.
//
// Design: a half-warp (a group of LOOKBACK threads) a lane, GROUPS lanes a
// block. Thread h of a group holds the ring entry of slot i-1-h: its t, q
// and f. The slots go in chunks of LOOKBACK: thread h loads slot base + h
// of the chunk after the current one (one coalesced 64 B read of each of
// ts and qs a group), so the loads are in flight while the current chunk
// runs. A slot's step is then
// - the ring's shift for the next slot, issued first since it needs only
//   the entries of this one: one __shfl_up_sync of each of t, q and f;
// - the slot's coordinates, from thread i % LOOKBACK by one __shfl_sync
//   each;
// - every thread's candidate, under the XLA scan's conditions (h < i,
//   dt and dq in [1, MAX_GAP], |dq - dt| <= BAND_DIAG);
// - the largest key 16 cand + 15 - h over the group, which picks the
//   largest candidate and, among equal ones, the nearest predecessor, as
//   the XLA argmax does: two full-warp __reduce_max_sync (REDUX), one for
//   each group of the warp, while the keys fit 32 bits (a score is at most
//   (S + 1) k GAP_UNIT, which rt_chain_dp checks), else a 4-step shuffle
//   max of 64-bit keys;
// - f = max(start, best), the parent offset (thread 0 stores it), the
//   running (best f, end) with the lowest slot winning ties (every thread
//   keeps it, so it needs no broadcast), and thread 0 takes slot i into
//   the ring.
// The 32-bit keys carry the tie-break, so one REDUX picks both the best
// and its offset; one body of 32-bit scores that found the nearest tie by
// a __ballot_sync after the REDUX ran 1.26x slower at (S, B) = (256, 4096)
// and 1.17x at (4096, 512) on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py --ab chain_dp, PERF.md), hence the second, 64-bit body for
// the scores past 2^26. The slot loop is not unrolled: unrolled it ran
// slower. Both groups of a warp
// run to the larger of their two counts, so every shuffle has the whole
// warp; a group past its own count changes nothing. The walk back follows
// the parent offsets from end on thread 0 and reads the coordinates of the
// chain's first seed only. Slots at or past ns are never read by the DP;
// an empty lane writes the _NEG row with slot 0's coordinates, as the XLA
// function and the plain version do.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LOOKBACK = 16;        // chain.CHAIN_LOOKBACK
constexpr int GROUPS = 16;          // lanes a block (chain.CHAIN_BLOCK_LANES)
constexpr int THREADS = GROUPS * LOOKBACK;
constexpr int MAX_GAP = 10000;      // chain.MAX_GAP
constexpr int BAND_DIAG = 512;      // chain.BAND_DIAG
constexpr int GAP_UNIT = 16;        // chain.GAP_UNIT
constexpr int NEG = -(1 << 30);     // chain._NEG
constexpr unsigned FULL = 0xffffffffu;

// A key's type: 32 bits (reduced by REDUX) while every score stays below
// 2^26, else 64 bits (a shuffle max); NONE, the key of a predecessor that
// does not qualify, lies below every real key.
template <bool WIDE>
struct KeyOf {
  using T = int;
  static constexpr int NONE = INT_MIN;
};
template <>
struct KeyOf<true> {
  using T = long long;
  static constexpr long long NONE = static_cast<long long>(NEG) * 16;
};

// The max of the keys of each group of the warp, on each of its threads
// (``half``: the thread's group). Two full-warp reductions ran faster than
// one on each group's half mask and than a shuffle max.
__device__ __forceinline__ int group_max(int key, int half) {
  const int lo = __reduce_max_sync(FULL, half ? INT_MIN : key);
  const int hi = __reduce_max_sync(FULL, half ? key : INT_MIN);
  return half ? hi : lo;
}

__device__ __forceinline__ long long group_max(long long key, int) {
#pragma unroll
  for (int d = LOOKBACK / 2; d > 0; d >>= 1) {
    const long long other = __shfl_xor_sync(FULL, key, d, LOOKBACK);
    key = other > key ? other : key;
  }
  return key;
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
chain_dp_kernel(const int32_t* __restrict__ ts,
                const int32_t* __restrict__ qs,
                const int32_t* __restrict__ ns,
                uint8_t* __restrict__ parent_g,
                int32_t* __restrict__ out, int B, int S, int k,
                int smem_parents) {
  using Key = typename KeyOf<WIDE>::T;
  constexpr Key NONE = KeyOf<WIDE>::NONE;
  extern __shared__ uint8_t parent_s[];
  const int g = threadIdx.x / LOOKBACK;         // group (lane) in the block
  const int h = threadIdx.x % LOOKBACK;         // predecessor slot
  const int half = g & 1;                       // the group's half of its warp
  const int b = blockIdx.x * GROUPS + g;
  const int n = b < B ? min(ns[b], S) : 0;
  // the warp's two groups run to the larger of their counts
  const int n_warp = max(n, __shfl_xor_sync(FULL, n, LOOKBACK));
  const int start = k * GAP_UNIT;
  const int32_t* trow = ts + (size_t)b * S;
  const int32_t* qrow = qs + (size_t)b * S;
  // parent offset of slot i: shared memory [S, GROUPS], or global [S, B]
  uint8_t* parent = smem_parents ? parent_s + g : parent_g + b;
  const size_t pstride = smem_parents ? GROUPS : (size_t)B;

  int rt = 0, rq = 0, rf = NEG;      // ring entry of slot i - 1 - h
  int best_f = NEG, end = 0;
  // this thread's slot of the next chunk
  int nxt_t = 0, nxt_q = 0;
  if (h < n) {
    nxt_t = __ldg(trow + h);
    nxt_q = __ldg(qrow + h);
  }
  for (int base = 0; base < n_warp; base += LOOKBACK) {
    const int cur_t = nxt_t, cur_q = nxt_q;
    if (base + LOOKBACK + h < n) {
      nxt_t = __ldg(trow + base + LOOKBACK + h);
      nxt_q = __ldg(qrow + base + LOOKBACK + h);
    }
    const int stop = min(LOOKBACK, n_warp - base);
#pragma unroll 1
    for (int j = 0; j < stop; ++j) {
      const int i = base + j;
      const int nt = __shfl_up_sync(FULL, rt, 1, LOOKBACK);
      const int nq = __shfl_up_sync(FULL, rq, 1, LOOKBACK);
      const int nf = __shfl_up_sync(FULL, rf, 1, LOOKBACK);
      const int tc = __shfl_sync(FULL, cur_t, j, LOOKBACK);
      const int qc = __shfl_sync(FULL, cur_q, j, LOOKBACK);
      const int dt = tc - rt;
      const int dq = qc - rq;
      const int gap = abs(dq - dt);
      const bool ok = h < i && dt >= 1 && dq >= 1 && dt <= MAX_GAP &&
                      dq <= MAX_GAP && gap <= BAND_DIAG;
      const int span = min(k, min(dq, dt));
      const Key top = group_max(
          ok ? static_cast<Key>(rf + span * GAP_UNIT - gap) * 16 +
                   (LOOKBACK - 1 - h)
             : NONE,
          half);
      // with no predecessor, top >> 4 lies below start, as NEG does
      const int best = static_cast<int>(top >> 4);
      const int f = max(start, best);
      if (i < n) {
        if (h == 0) {
          parent[(size_t)i * pstride] =
              best > start
                  ? static_cast<uint8_t>(LOOKBACK - static_cast<int>(top & 15))
                  : uint8_t{0};
        }
        if (f > best_f) {
          best_f = f;
          end = i;
        }
        rt = h == 0 ? tc : nt;
        rq = h == 0 ? qc : nq;
        rf = h == 0 ? f : nf;
      }
    }
  }
  if (h != 0 || b >= B) return;
  // thread 0 stored every offset it reads back here
  const int q_hi = __ldg(qrow + end);
  const int t_hi = __ldg(trow + end);
  int q_lo = 0, t_lo = 0, cnt = 0;
  if (n > 0) {
    int cur = end;
    while (true) {
      ++cnt;
      const int off = parent[(size_t)cur * pstride];
      if (off == 0) break;
      cur -= off;
    }
    q_lo = __ldg(qrow + cur);
    t_lo = __ldg(trow + cur);
  }
  int32_t* o = out + (size_t)b * 6;
  o[0] = n > 0 ? best_f : NEG;
  o[1] = cnt;
  o[2] = q_lo;
  o[3] = q_hi;
  o[4] = t_lo;
  o[5] = t_hi;
}

template <bool WIDE>
int launch(const void* ts, const void* qs, const void* ns, void* parent,
           void* out, int B, int S, int k, int smem_slots, void* stream) {
  const int smem_parents = S <= smem_slots;
  const size_t smem = smem_parents ? (size_t)S * GROUPS : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_dp_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + GROUPS - 1) / GROUPS;
  chain_dp_kernel<WIDE><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ts, (const int32_t*)qs, (const int32_t*)ns,
      (uint8_t*)parent, (int32_t*)out, B, S, k, smem_parents);
  return (int)cudaGetLastError();
}

}  // namespace

// ts, qs [B, S]; parent may be null when S <= smem_slots (the offsets then
// stay in shared memory, S * GROUPS bytes a block). A score is at most
// (S + 1) k GAP_UNIT, so the 32-bit keys (16 cand + 15 - h) serve while
// that stays below 2^26; the 64-bit body takes the rest. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rt_chain_dp(const void* ts, const void* qs, const void* ns,
                           void* parent, void* out, int B, int S, int k,
                           int smem_slots, void* stream) {
  if (B <= 0) return 0;
  const long long top =
      (static_cast<long long>(S) + 1) * (k > 0 ? k : 1) * GAP_UNIT;
  return top < (1LL << 26)
             ? launch<false>(ts, qs, ns, parent, out, B, S, k, smem_slots,
                             stream)
             : launch<true>(ts, qs, ns, parent, out, B, S, k, smem_slots,
                            stream);
}
