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
// Inputs: ts_t, qs_t [S, B] int32 (a pair's seed coordinates, sorted by
// (t, q), transposed so that the lanes of a warp read neighbouring words),
// ns [B] int32 (live seeds a lane). Output: out [B, 6] int32 rows (score,
// n_chained, q_lo, q_hi, t_lo, t_hi), byte-equal to _chain_kernel's. parent
// [S, B] uint8 is scratch: the predecessor offset of every live slot.
//
// Bound on this card: latency. A lane's slots form one dependent chain (slot
// i needs f of slots i-16 .. i-1), and a launch holds a few thousand lanes,
// so the chain's length, not bytes (8 a live slot) or operations (21 a
// predecessor, itemised at OPS_PER_CHAIN_PRED in chip_smoke.py), sets the
// time.
//
// Design: one thread a lane, blocks of THREADS lanes. The last LOOKBACK (t,
// q, f) triples live in registers as a ring that shifts by one each slot
// (fully unrolled, so no local memory). The predecessors are scanned nearest
// first with a strict > so ties keep the nearer one, as the XLA argmax does.
// end is the lowest slot with the largest f (strict >), tracked during the
// scan; the walk back follows parent from there. Slots at or past ns are
// never read: their f would be the sentinel, which never wins.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int LOOKBACK = 16;        // chain.CHAIN_LOOKBACK
constexpr int MAX_GAP = 10000;      // chain.MAX_GAP
constexpr int BAND_DIAG = 512;      // chain.BAND_DIAG
constexpr int GAP_UNIT = 16;        // chain.GAP_UNIT
constexpr int NEG = -(1 << 30);     // chain._NEG

__global__ void __launch_bounds__(THREADS)
chain_dp_kernel(const int32_t* __restrict__ ts_t,
                const int32_t* __restrict__ qs_t,
                const int32_t* __restrict__ ns,
                uint8_t* __restrict__ parent,
                int32_t* __restrict__ out, int B, int S, int k) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int n = min(ns[b], S);
  const int start = k * GAP_UNIT;
  int rt[LOOKBACK], rq[LOOKBACK], rf[LOOKBACK];
#pragma unroll
  for (int h = 0; h < LOOKBACK; ++h) {
    rt[h] = 0;
    rq[h] = 0;
    rf[h] = NEG;
  }
  int best_f = NEG, end = 0;
  for (int i = 0; i < n; ++i) {
    const int tc = ts_t[(size_t)i * B + b];
    const int qc = qs_t[(size_t)i * B + b];
    int best = NEG, arg = 0;
#pragma unroll
    for (int h = 0; h < LOOKBACK; ++h) {
      // ring slot h holds slot i - 1 - h
      const int dt = tc - rt[h];
      const int dq = qc - rq[h];
      const int gap = abs(dq - dt);
      const bool ok = h < i && dt >= 1 && dq >= 1 && dt <= MAX_GAP &&
                      dq <= MAX_GAP && gap <= BAND_DIAG;
      const int cand = rf[h] + min(k, min(dq, dt)) * GAP_UNIT - gap;
      if (ok && cand > best) {
        best = cand;
        arg = h + 1;
      }
    }
    const int f = max(start, best);
    parent[(size_t)i * B + b] = best > start ? (uint8_t)arg : (uint8_t)0;
    if (f > best_f) {
      best_f = f;
      end = i;
    }
#pragma unroll
    for (int h = LOOKBACK - 1; h > 0; --h) {
      rt[h] = rt[h - 1];
      rq[h] = rq[h - 1];
      rf[h] = rf[h - 1];
    }
    rt[0] = tc;
    rq[0] = qc;
    rf[0] = f;
  }
  const int q_hi = qs_t[(size_t)end * B + b];
  const int t_hi = ts_t[(size_t)end * B + b];
  int q_lo = 0, t_lo = 0, cnt = 0;
  if (n > 0) {
    int cur = end;
    while (true) {
      ++cnt;
      q_lo = qs_t[(size_t)cur * B + b];
      t_lo = ts_t[(size_t)cur * B + b];
      const int off = parent[(size_t)cur * B + b];
      if (off == 0) break;
      cur -= off;
    }
  }
  int32_t* o = out + (size_t)b * 6;
  o[0] = n > 0 ? best_f : NEG;
  o[1] = cnt;
  o[2] = q_lo;
  o[3] = q_hi;
  o[4] = t_lo;
  o[5] = t_hi;
}

}  // namespace

extern "C" int rt_chain_dp(const void* ts_t, const void* qs_t,
                           const void* ns, void* parent, void* out, int B,
                           int S, int k, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + THREADS - 1) / THREADS;
  chain_dp_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ts_t, (const int32_t*)qs_t, (const int32_t*)ns,
      (uint8_t*)parent, (int32_t*)out, B, S, k);
  return (int)cudaGetLastError();
}
