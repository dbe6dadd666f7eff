"""Seed join and chaining DP, stage two of the first-party overlapper
(``--overlaps auto``), the port of ``racon_tpu/ops/chain.py``.

Consumes the minimizer tables of :mod:`.overlap_seed` and emits
``Overlap``-shaped rows:

- **the seed join**, plain PyTorch on the device (:func:`join_seeds`):
  both tables sort by hash, per-hash totals over both tables come from
  searchsorted run bounds, buckets over ``max_occ`` drop whole (counted
  in ``freq_capped_buckets``), the kept entries compact to a sorted
  prefix, and the read->target join expands along a searchsorted ramp
  into hits, with self hits dropped, reverse-strand query coordinates
  flipped, and a 5-key sort. Only two scalars (the hit total and the
  capped count) come to the host before the expansion. Empty tables and
  tables or hit counts past the arena bounds bail out to the numpy
  :func:`match_seeds` (counted in ``join_bailouts``), which is also the
  tests' oracle. Hits are unique 5-tuples, so any correct sort gives the
  oracle's order. Under the resident dataflow (``resident=True``) only
  ``q``, ``t`` and ``rel`` come to the host; the seed coordinates ``tp``
  and ``qc`` stay on the device for the chain arenas.
- **chaining** (:class:`_ChainStream`): pairs pack by pow2 seed-count
  bucket into ``[B, S]`` arenas, on the host or, from the resident join,
  on the device (:func:`gather_pairs`), and :func:`chain_dp` scores
  gap-bounded colinear chains against the :data:`CHAIN_LOOKBACK` previous
  seeds and walks the best one back, returning one ``[6]`` row a pair.
  On a CUDA tensor it launches the CUDA kernel ``chain_dp``
  (``kernels/chain_dp.cu``) or raises; on a CPU tensor it runs
  :func:`chain_dp_plain`. A full arena launches as soon as its bucket
  fills, and up to :data:`CHAIN_INFLIGHT` chunks stay in flight before
  the oldest is fetched; partial arenas launch at :meth:`_ChainStream.
  finish`.
- **streaming** (:func:`iter_overlap_groups`): the rows of each query
  group are yielded as soon as its pairs' chains are fetched. Their
  concatenation is :func:`find_overlaps`'s canonical order. Chaining
  runs ahead of emission only once an arena fills (``2^21 / S`` pairs of
  one seed bucket); on fewer pairs, as on a 1 Mbp genome at 30x, every
  launch happens at ``finish`` and the groups are yielded after all
  chaining is done.

Scoring is all-integer (a matched base is worth :data:`GAP_UNIT`, a gap
base 1), so the kernel, the plain version and :func:`chain_np` agree bit
for bit. Reverse-strand query coordinates flip to ``qlen - pos - k``
before chaining and back on emission.

The parameters left None are read from the flags as in the JAX package
(:func:`resolve_params`: ``RACON_TPU_OVERLAP_K``, ``_W``, ``_MAX_OCC``,
``_MIN_SEEDS``, ``_DEVICE_JOIN``, ``_CACHE`` and ``RACON_TPU_RESIDENT``),
with its defaults and clipping. ``RACON_TPU_OVERLAP_RAGGED`` is not
read: it selects the JAX package's phase-barriered chaining, which the
port does not have (the ragged stream is its one path). The
``dataflow.*`` counters are the JAX package's: the join's 8-byte count
fetch on every device join, and under the resident dataflow the
compacted tables' and the join's bytes. ``STATS`` holds the counters the
JAX package keeps under ``overlap.*``; each also goes to the metrics
registry under that name (``overlap_seed.count``). The spans are the JAX
package's: seeding ``overlap.seed``, the join ``overlap.match`` with its
device halves ``overlap.join.dispatch``/``.fetch``, each chain launch
and fetch ``overlap.chain.dispatch``/``.fetch``, and the chain stream's
final drain ``overlap.chain``.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from .. import flags, obs
from ..device import resolve
from ..obs import metrics
from . import _build, cuda_nw, overlap_seed
from .overlap_seed import STATS, count, reset_stats  # noqa: F401

CHAIN_LOOKBACK = 16       # predecessors each seed is scored against
MAX_GAP = 10_000          # largest per-axis seed gap inside one chain
BAND_DIAG = 512           # largest |dq - dt| drift
GAP_UNIT = 16             # a matched base; a gap base costs 1
_NEG = -(1 << 30)         # the score of a dead lane or slot
# cells of one chain arena (B * S)
CHAIN_ARENA_CELLS = 1 << 21
# device-join bounds: padded table entries or hits past these bail out to
# match_seeds (counted), so one pathological input cannot demand an
# unbounded device sort
JOIN_TABLE_CELLS = 1 << 25
JOIN_MAX_HITS = 1 << 26
# chain chunks in flight before the oldest is fetched
CHAIN_INFLIGHT = 2
_I32_MAX = 0x7FFFFFFF


# -------------------------------------------------------------- geometry

def _seed_bucket(n: int) -> int:
    """pow2 seed-list bucket of one candidate pair (floor 16): the S axis
    of its chain arena."""
    b = 16
    while b < n:
        b *= 2
    return b


def _pair_batch(S: int, n: int) -> int:
    """pow2 pair batch of one chain launch against
    :data:`CHAIN_ARENA_CELLS`."""
    want = min(max(1, n), max(1, CHAIN_ARENA_CELLS // max(1, S)))
    b = 1
    while b < want:
        b *= 2
    return b


def _table_pad(n: int) -> int:
    """pow2 padded length of one minimizer table in the join (floor 64)."""
    b = 64
    while b < n:
        b *= 2
    return b


def _hits_pad(n: int) -> int:
    """pow2 padded length of the expanded hit arena (floor 256)."""
    b = 256
    while b < n:
        b *= 2
    return b


# ----------------------------------------------------------- chain DP

def chain_dp(ts: torch.Tensor, qs: torch.Tensor, ns: torch.Tensor, *,
             k: int) -> torch.Tensor:
    """Chain DP over a ``[B, S]`` arena (``racon_tpu.ops.chain.
    _chain_kernel``): ``ts``/``qs`` int32 seed coordinates sorted by ``(t,
    q)``, ``ns [B]`` int32 live seeds a lane. Returns ``[B, 6]`` int32
    rows ``(score, n_chained, q_lo, q_hi, t_lo, t_hi)``. On CUDA tensors it
    launches ``chain_dp`` (``kernels/chain_dp.cu``) or raises."""
    B, S = ts.shape
    cuda_nw._require(qs.shape == (B, S) and ns.shape == (B,),
                     "chain_dp: ts, qs [B, S] and ns [B]")
    cuda_nw._require(all(x.dtype == torch.int32 for x in (ts, qs, ns)),
                     "chain_dp: inputs must be int32")
    if ts.device.type != "cuda":
        return chain_dp_plain(ts, qs, ns, k=k)
    cuda_nw._check_cuda_inputs("chain_dp", ts, qs, ns)
    dev = ts.device
    # [S, B]: the lanes of a warp read neighbouring words
    ts_t = ts.t().contiguous()
    qs_t = qs.t().contiguous()
    parent = torch.empty((S, B), dtype=torch.uint8, device=dev)
    out = torch.empty((B, 6), dtype=torch.int32, device=dev)
    fn = _build.function("rt_chain_dp")
    err = fn(ts_t.data_ptr(), qs_t.data_ptr(), ns.data_ptr(),
             parent.data_ptr(), out.data_ptr(), B, S, k, cuda_nw._stream(ts))
    cuda_nw.count_launch("chain_dp")
    cuda_nw._check_launch("chain_dp", err)
    return out


def chain_dp_plain(ts: torch.Tensor, qs: torch.Tensor, ns: torch.Tensor, *,
                   k: int) -> torch.Tensor:
    """Plain PyTorch chain DP, step for step the XLA scan: a history of the
    last :data:`CHAIN_LOOKBACK` ``(t, q, f)`` triples (newest first), the
    nearest predecessor winning ties (first argmax), then a walk back of
    S steps from the lowest slot with the largest score."""
    B, S = ts.shape
    dev = ts.device
    i32 = torch.int32
    H = CHAIN_LOOKBACK
    start = k * GAP_UNIT
    ht = torch.zeros((B, H), dtype=i32, device=dev)
    hq = torch.zeros((B, H), dtype=i32, device=dev)
    hf = torch.full((B, H), _NEG, dtype=i32, device=dev)
    f_all = torch.empty((B, S), dtype=i32, device=dev)
    p_all = torch.empty((B, S), dtype=i32, device=dev)
    neg = torch.tensor(_NEG, dtype=i32, device=dev)
    for i in range(S):
        tc = ts[:, i:i + 1]
        qc = qs[:, i:i + 1]
        live = i < ns
        dt = tc - ht
        dq = qc - hq
        gap = (dq - dt).abs()
        ok = ((dt >= 1) & (dq >= 1) & (dt <= MAX_GAP) & (dq <= MAX_GAP)
              & (gap <= BAND_DIAG) & (hf > _NEG // 2))
        span = torch.clamp(torch.minimum(dq, dt), max=k)
        cand = torch.where(ok, hf + span * GAP_UNIT - gap, neg)
        best = cand.max(dim=1).values
        arg = torch.argmax(cand, dim=1).to(i32)
        f_i = torch.where(live, torch.clamp(best, min=start), neg)
        p_all[:, i] = torch.where(live & (best > start), arg + 1, 0)
        f_all[:, i] = f_i
        ht = torch.cat([tc, ht[:, :-1]], dim=1)
        hq = torch.cat([qc, hq[:, :-1]], dim=1)
        hf = torch.cat([f_i[:, None], hf[:, :-1]], dim=1)
    lanes = torch.arange(B, device=dev)
    end = torch.argmax(f_all, dim=1)        # ties: the lowest slot
    score = f_all[lanes, end]
    live0 = ns > 0
    cur = end.clone()
    active = live0.clone()
    n = torch.zeros(B, dtype=i32, device=dev)
    q_lo = torch.zeros(B, dtype=i32, device=dev)
    t_lo = torch.zeros(B, dtype=i32, device=dev)
    for _ in range(S):
        q_lo = torch.where(active, qs[lanes, cur], q_lo)
        t_lo = torch.where(active, ts[lanes, cur], t_lo)
        n = n + active.to(i32)
        off = p_all[lanes, cur]
        active = active & (off > 0)
        cur = torch.where(active, cur - off, cur)
    return torch.stack([torch.where(live0, score, neg), n, q_lo,
                        qs[lanes, end], t_lo, ts[lanes, end]], dim=1)


# --------------------------------------------------------- device join

def _sort_by(keys: torch.Tensor, *cols: torch.Tensor):
    keys, order = torch.sort(keys, stable=True)
    return (keys, *(c[order] for c in cols))


def _run_count(sorted_h: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """How often each value of ``h`` occurs in ``sorted_h``."""
    return (torch.searchsorted(sorted_h, h, right=True)
            - torch.searchsorted(sorted_h, h))


def _compact_sorted(h, a, b, c, keep):
    """Order-preserving compaction of the kept entries to a prefix (the
    cumsum-rank scatter): dropped entries all land on one spill slot past
    the end, which is sliced off; the tail keeps the :data:`_HASH_MAX`
    fill, so the whole array stays ascending. Returns the arrays and the
    kept count (a device scalar)."""
    n = h.shape[0]
    rank = torch.cumsum(keep.to(torch.int64), 0)
    idx = torch.where(keep, rank - 1, n)
    out_h = torch.full((n + 1,), overlap_seed._HASH_MAX, dtype=h.dtype,
                       device=h.device).scatter_(0, idx, h)
    outs = [torch.zeros(n + 1, dtype=x.dtype, device=x.device)
            .scatter_(0, idx, x)[:n] for x in (a, b, c)]
    return (out_h[:n], *outs, rank[-1])


def _join_sort(rh, rid, rpos, rstr, th, tid, tpos, tstr, max_occ: int):
    """Device half one of the join (``racon_tpu.ops.chain.
    _join_sort_kernel``): sort both padded tables by hash, count each
    hash over both tables, drop hot buckets whole, compact the survivors
    and build the read->target ramp (``lo``, ``cnt``, inclusive
    ``offs``). Pad slots hold :data:`_HASH_MAX`, which no real entry
    does. Returns the compacted tables, the ramp, the hit total and the
    count of hot hashes (device scalars)."""
    hmax = overlap_seed._HASH_MAX
    rh, rid, rpos, rstr = _sort_by(rh, rid, rpos, rstr)
    th, tid, tpos, tstr = _sort_by(th, tid, tpos, tstr)
    tr = _run_count(rh, th)
    valid_r = rh != hmax
    valid_t = th != hmax
    hot_r = (_run_count(rh, rh) + _run_count(th, rh)) > max_occ
    hot_t = (_run_count(th, th) + tr) > max_occ
    # hot hashes of the union, once each: the first of a run in the reads,
    # and the first in the targets of a hash the reads lack
    first_r = valid_r.clone()
    first_r[1:] &= rh[1:] != rh[:-1]
    first_t = valid_t.clone()
    first_t[1:] &= th[1:] != th[:-1]
    capped = ((first_r & hot_r).sum()
              + (first_t & hot_t & (tr == 0)).sum())
    rh, rid, rpos, rstr, nr = _compact_sorted(rh, rid, rpos, rstr,
                                              valid_r & ~hot_r)
    th, tid, tpos, tstr, _ = _compact_sorted(th, tid, tpos, tstr,
                                             valid_t & ~hot_t)
    lo = torch.searchsorted(th, rh)
    live = torch.arange(rh.shape[0], device=rh.device) < nr
    cnt = torch.where(live, torch.searchsorted(th, rh, right=True) - lo, 0)
    offs = torch.cumsum(cnt, 0)
    return (rid, rpos, rstr, tid, tpos, tstr, lo, cnt, offs, offs[-1],
            capped)


def _join_expand(rid, rpos, rstr, tid, tpos, tstr, lo, cnt, offs,
                 total: int, read_self_t, qlens, *, E: int, k: int):
    """Device half two (``racon_tpu.ops.chain._join_expand_kernel``):
    expand the ramp into ``E`` hit slots, drop self hits and the pad, flip
    reverse-strand query coordinates and sort by ``(q, t, rel, tp, qc)``.
    Dropped slots take :data:`_I32_MAX` in every key but the last and sort
    past the kept ones. Returns the five sorted key columns and the kept
    count (a device scalar)."""
    dev = rid.device
    e = torch.arange(E, dtype=torch.int64, device=dev)
    live = e < total
    # hit e belongs to the read entry whose inclusive cumsum first
    # exceeds e, at target offset lo + (e - run begin)
    ridx = torch.clamp(torch.searchsorted(offs, e, right=True), 0,
                       rid.shape[0] - 1)
    begin = offs[ridx] - cnt[ridx]
    tix = torch.clamp(lo[ridx] + (e - begin), 0, tid.shape[0] - 1)
    q = rid[ridx]
    qp = rpos[ridx]
    t = tid[tix]
    tp = tpos[tix]
    rel = (rstr[ridx] != tstr[tix]).to(torch.int64)
    qsafe = torch.clamp(q, 0, read_self_t.shape[0] - 1)
    keep = live & (t != read_self_t[qsafe])
    qc = torch.where(rel == 1, qlens[qsafe] - qp - k, qp)
    s = torch.where(keep, 0, _I32_MAX)
    # least significant key first, each pass stable; (q, t) and (rel, tp)
    # pack into one int64 key each (every key is in [0, 2^31))
    qc = qc | s
    _, order = torch.sort(qc, stable=True)
    for key in (((rel | s) << 31) | (tp | s), ((q | s) << 31) | (t | s)):
        _, o2 = torch.sort(key[order], stable=True)
        order = order[o2]
    cols = [(x | s)[order] for x in (q, t, rel, tp)] + [qc[order]]
    return (*cols, keep.sum())


def _pad_table(table, n_pad: int, dev):
    """One ``(hash, id, pos, strand)`` table padded to ``n_pad`` entries
    with :data:`_HASH_MAX` hashes, as int64 tensors on ``dev``."""
    out = []
    for x, fill in zip(table, (overlap_seed._HASH_MAX, 0, 0, 0)):
        col = np.full(n_pad, fill, np.int64)
        col[:x.size] = x
        out.append(torch.from_numpy(col).to(dev))
    return out


def _empty_hits() -> Dict[str, np.ndarray]:
    return {key: np.zeros(0, np.int64) for key in
            ("q", "t", "rel", "tp", "qc")}


def join_seeds(read_table, target_table, read_self_t: np.ndarray,
               qlens: np.ndarray, *, k: int, max_occ: int,
               device_join: bool = True, resident: bool = False,
               device="cuda") -> Tuple[Dict[str, object], int]:
    """The seed join: the device path when it is eligible, the numpy
    :func:`match_seeds` otherwise (always with ``device_join=False``).
    Returns ``(hits, freq_capped)``, the hits as host int64 arrays ``q``,
    ``t``, ``rel``, ``tp``, ``qc`` in the oracle's order. With
    ``resident`` on the device path, ``tp`` and ``qc`` stay on the device
    as int32 tensors ``tp_dev`` and ``qc_dev`` (the chain arenas gather
    from them, :func:`gather_pairs`), and only ``q``, ``t``, ``rel`` are
    fetched: ``dataflow.bytes_fetched`` counts their 12 bytes a hit and
    the hit count's 4, ``dataflow.bytes_avoided`` the 8 bytes a hit left
    on the device. Every device join counts its 8-byte fetch of the hit
    total and the capped count.

    The bail-out ladder (each counted in ``join_bailouts``; the hits then
    come from :func:`match_seeds` on the host): an empty table; padded
    tables over :data:`JOIN_TABLE_CELLS` or an int32 ramp that could
    overflow; more hits than :data:`JOIN_MAX_HITS`."""
    rh, th = read_table[0], target_table[0]

    def _bail():
        count("join_bailouts")
        return match_seeds(read_table, target_table, read_self_t, qlens,
                           k=k, max_occ=max_occ)

    if not device_join:
        return match_seeds(read_table, target_table, read_self_t, qlens,
                           k=k, max_occ=max_occ)
    if rh.size == 0 or th.size == 0:
        return _bail()
    R2, T2 = _table_pad(rh.size), _table_pad(th.size)
    if R2 + T2 > JOIN_TABLE_CELLS or R2 * max(1, max_occ) >= (1 << 31):
        return _bail()
    dev = resolve(device)
    with obs.span("overlap.join.dispatch", reads=int(rh.size),
                  targets=int(th.size)):
        (rid, rpos, rstr, tid, tpos, tstr, lo, cnt, offs, total_d,
         capped_d) = _join_sort(*_pad_table(read_table, R2, dev),
                                *_pad_table(target_table, T2, dev), max_occ)
    with obs.span("overlap.join.fetch"):
        # the join's one host read before the expansion
        total, capped = (int(x) for x in
                         torch.stack([total_d, capped_d]).cpu())
    metrics.inc("dataflow.bytes_fetched", 8)
    if total > JOIN_MAX_HITS:
        return _bail()
    if total == 0:
        return _empty_hits(), capped
    with obs.span("overlap.join.dispatch", hits=total):
        cols = _join_expand(
            rid, rpos, rstr, tid, tpos, tstr, lo, cnt, offs, total,
            torch.from_numpy(np.asarray(read_self_t, np.int64)).to(dev),
            torch.from_numpy(np.asarray(qlens, np.int64)).to(dev),
            E=_hits_pad(total), k=k)
    with obs.span("overlap.join.fetch"):
        n = int(cols[5])
        keys = ("q", "t", "rel") + (() if resident else ("tp", "qc"))
        hits: Dict[str, object] = {key: col[:n].cpu().numpy()
                                   for key, col in zip(keys, cols)}
    if resident:
        hits["tp_dev"] = cols[3][:n].to(torch.int32)
        hits["qc_dev"] = cols[4][:n].to(torch.int32)
        metrics.inc("dataflow.bytes_fetched", 12 * n + 4)
        metrics.inc("dataflow.bytes_avoided", 8 * n)
    return hits, capped


def match_seeds(read_table, target_table, read_self_t: np.ndarray,
                qlens: np.ndarray, *, k: int, max_occ: int
                ) -> Tuple[Dict[str, np.ndarray], int]:
    """Sorted-hash intersection of the two tables in numpy: hits ``q``
    (read ordinal), ``t`` (target), ``rel`` (relative strand), ``tp``
    (target seed position), ``qc`` (query seed position, flipped on the
    reverse strand), lexsorted by ``(q, t, rel, tp, qc)``. Buckets whose
    total count over both tables exceeds ``max_occ`` drop whole;
    ``freq_capped`` counts them."""
    rh, rid, rpos, rstr = read_table
    th, tid, tpos, tstr = target_table
    if rh.size == 0 or th.size == 0:
        return _empty_hits(), 0

    ro = np.argsort(rh, kind="stable")
    rh, rid, rpos, rstr = rh[ro], rid[ro], rpos[ro], rstr[ro]
    to = np.argsort(th, kind="stable")
    th, tid, tpos, tstr = th[to], tid[to], tpos[to], tstr[to]

    uh, uc = np.unique(np.concatenate([rh, th]), return_counts=True)
    hot = uc > max_occ
    freq_capped = int(hot.sum())
    keep_r = ~hot[np.searchsorted(uh, rh)]
    keep_t = ~hot[np.searchsorted(uh, th)]
    rh, rid, rpos, rstr = rh[keep_r], rid[keep_r], rpos[keep_r], rstr[keep_r]
    th, tid, tpos, tstr = th[keep_t], tid[keep_t], tpos[keep_t], tstr[keep_t]
    if rh.size == 0 or th.size == 0:
        return _empty_hits(), freq_capped

    lo = np.searchsorted(th, rh, "left")
    hi = np.searchsorted(th, rh, "right")
    cnt = (hi - lo).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return _empty_hits(), freq_capped
    ridx = np.repeat(np.arange(rh.size, dtype=np.int64), cnt)
    ramp = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(cnt) - cnt, cnt)
    tidx = np.repeat(lo.astype(np.int64), cnt) + ramp

    q = rid[ridx].astype(np.int64)
    t = tid[tidx].astype(np.int64)
    rel = (rstr[ridx] != tstr[tidx]).astype(np.int64)
    tp = tpos[tidx].astype(np.int64)
    qp = rpos[ridx].astype(np.int64)
    notself = t != read_self_t[q]
    q, t, rel, tp, qp = (q[notself], t[notself], rel[notself],
                         tp[notself], qp[notself])
    qc = np.where(rel == 1, qlens[q] - qp - k, qp)
    order = np.lexsort((qc, tp, rel, t, q))
    return ({"q": q[order], "t": t[order], "rel": rel[order],
             "tp": tp[order], "qc": qc[order]}, freq_capped)


# ---------------------------------------------------------- numpy oracle

def chain_np(ts: np.ndarray, qs: np.ndarray, k: int
             ) -> Tuple[int, int, int, int, int, int]:
    """Pure-Python chain oracle with the kernel's semantics: integer
    scoring, bounded lookback, the nearest predecessor on ties (strict
    >), the lowest best end. Returns ``(score, n_chained, q_lo, q_hi,
    t_lo, t_hi)``."""
    n = len(ts)
    if n == 0:
        return (_NEG, 0, 0, 0, 0, 0)
    start = k * GAP_UNIT
    f = [0] * n
    par = [0] * n
    for i in range(n):
        best, arg = _NEG, -1
        for off in range(1, CHAIN_LOOKBACK + 1):  # nearest first
            j = i - off
            if j < 0:
                break
            dt, dq = ts[i] - ts[j], qs[i] - qs[j]
            gap = abs(dq - dt)
            if dt < 1 or dq < 1 or dt > MAX_GAP or dq > MAX_GAP \
                    or gap > BAND_DIAG:
                continue
            cand = f[j] + min(k, dq, dt) * GAP_UNIT - gap
            if cand > best:
                best, arg = cand, off
        f[i] = max(start, best)
        par[i] = arg if best > start else 0
    end = int(np.argmax(np.asarray(f)))
    cur, cnt = end, 0
    while True:
        cnt += 1
        if par[cur] == 0:
            break
        cur -= par[cur]
    return (f[end], cnt, int(qs[cur]), int(qs[end]),
            int(ts[cur]), int(ts[end]))


# -------------------------------------------------------------- chaining

def _pair_runs(hits: Dict[str, np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run boundaries of the (q, t, rel) pair key over sorted hits:
    ``(starts, ends, counts)``."""
    nhits = hits["q"].size
    if nhits == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    key_change = np.zeros(nhits, bool)
    key_change[0] = True
    for col in ("q", "t", "rel"):
        key_change[1:] |= hits[col][1:] != hits[col][:-1]
    starts = np.flatnonzero(key_change)
    ends = np.append(starts[1:], nhits)
    return starts, ends, ends - starts


def _pack_lanes(tp: np.ndarray, qc: np.ndarray, starts: np.ndarray,
                counts: np.ndarray, S: int, B: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One ``[B, S]`` chain arena from the flat hit arrays in one masked
    gather (``starts``/``counts`` have length B, zero past the live
    lanes)."""
    lane_starts = starts[:, None] + np.arange(S, dtype=np.int64)[None, :]
    mask = np.arange(S, dtype=np.int64)[None, :] < counts[:, None]
    np.clip(lane_starts, 0, max(0, tp.size - 1), out=lane_starts)
    if tp.size == 0:
        return np.zeros((B, S), np.int32), np.zeros((B, S), np.int32)
    ts = np.where(mask, tp[lane_starts], 0).astype(np.int32)
    qs = np.where(mask, qc[lane_starts], 0).astype(np.int32)
    return ts, qs


def gather_pairs(tp_dev: torch.Tensor, qc_dev: torch.Tensor,
                 starts: torch.Tensor, counts: torch.Tensor, S: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``[B, S]`` chain arena gathered on the device from the
    resident join's seed coordinates (``racon_tpu.ops.chain.
    _gather_pairs_kernel``; plain PyTorch on their device): lane ``b``
    holds hits ``starts[b] ..`` up to ``counts[b]`` and zeros past them,
    with :func:`_pack_lanes`' clip and mask, so the arena is the host
    pack's bit for bit. Returns int32 ``(ts, qs)``. Bound: ``8 * B * S``
    bytes written, the lanes' live hits and 16 bytes a lane read."""
    dev = tp_dev.device
    B = starts.shape[0]
    if tp_dev.shape[0] == 0:
        z = torch.zeros((B, S), dtype=torch.int32, device=dev)
        return z, z.clone()
    j = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    idx = torch.clamp(starts.to(torch.int64)[:, None] + j, 0,
                      tp_dev.shape[0] - 1)
    mask = j < counts.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (torch.where(mask, tp_dev[idx].to(torch.int32), zero),
            torch.where(mask, qc_dev[idx].to(torch.int32), zero))


class _ChainStream:
    """Ragged streaming chain session (``racon_tpu.ops.chain.
    _ChainStream``). ``tp``/``qc`` are the join's host arrays, packed
    into each arena on the host (:func:`_pack_lanes`), or with
    ``device_src`` the resident join's device tensors, gathered into each
    arena on the device (:func:`gather_pairs`) and handed straight to
    :func:`chain_dp`: the seed coordinates never visit the host.

    :meth:`add` queues a candidate pair in its pow2 seed-count bucket;
    :meth:`pump` launches every full ``[B, S]`` arena, without waiting for
    the device unless more than :data:`CHAIN_INFLIGHT` chunks are in
    flight; :meth:`finish` launches the partial arenas and fetches the
    rest. A pair always lands in the same bucket and lanes are
    independent, so its row does not depend on how the stream was fed.
    ``on_row(pid, row)`` fires as each pair's ``[6]`` row is fetched."""

    def __init__(self, *, k: int, tp, qc, device_src: bool = False,
                 on_row: Optional[Callable] = None, device="cuda"):
        self.k = k
        self.tp = tp
        self.qc = qc
        self.device_src = device_src
        self.on_row = on_row
        self.device = resolve(device)
        self.rows: Dict[int, np.ndarray] = {}
        self.pending: Dict[int, List[Tuple[int, int, int]]] = {}
        self.inflight: List[tuple] = []
        self.inflight_cells = 0
        self._done = False

    def add(self, pid: int, start: int, count: int) -> None:
        """Queue pair ``pid`` (``count`` seeds at hit offset ``start``)."""
        assert not self._done, "chain stream already finished"
        self.pending.setdefault(_seed_bucket(count), []).append(
            (count, pid, start))

    def pump(self) -> None:
        """Launch every arena that is full."""
        self._drain(final=False)

    def _drain(self, final: bool) -> None:
        for S in sorted(self.pending):
            entries = self.pending.pop(S)
            # the largest seed lists first: a bucket's chunks are its full
            # arena, and the tail chunk stays dense
            entries.sort(key=lambda e: (-e[0], e[1]))
            cap = _pair_batch(S, CHAIN_ARENA_CELLS)
            while entries:
                if not final and len(entries) < cap:
                    break
                chunk = entries[:cap]
                del entries[:cap]
                self._launch(chunk, S)
            if entries:
                self.pending[S] = entries

    def _launch(self, chunk: List[Tuple[int, int, int]], S: int) -> None:
        B = _pair_batch(S, len(chunk))
        starts = np.zeros(B, np.int64)
        counts = np.zeros(B, np.int64)
        for lane, (c, _, s0) in enumerate(chunk):
            starts[lane] = s0
            counts[lane] = c
        with obs.span("overlap.chain.dispatch", pairs=len(chunk)):
            # fill the arena (on the device from the resident join, else
            # on the host and uploaded) and launch (asynchronous on a card)
            ns = torch.from_numpy(counts.astype(np.int32)).to(self.device)
            if self.device_src:
                ts, qs = gather_pairs(
                    self.tp, self.qc,
                    torch.from_numpy(starts).to(self.device), ns, S)
            else:
                ts, qs = (torch.from_numpy(a).to(self.device) for a in
                          _pack_lanes(self.tp, self.qc, starts, counts, S,
                                      B))
            out = chain_dp(ts, qs, ns, k=self.k)
        count("lanes_total", B * S)
        count("lanes_occupied", int(counts.sum()))
        count("chunks")
        STATS["chunk_shapes"].append((S, B))
        self.inflight.append((chunk, out, B * S))
        self.inflight_cells += B * S
        while (len(self.inflight) > CHAIN_INFLIGHT
               or self.inflight_cells > 2 * CHAIN_ARENA_CELLS):
            self._fetch_oldest()

    def _fetch_oldest(self) -> None:
        chunk, out, cells = self.inflight.pop(0)
        self.inflight_cells -= cells
        with obs.span("overlap.chain.fetch", pairs=len(chunk)):
            out_np = out.cpu().numpy()
        for lane, (_, pid, _) in enumerate(chunk):
            row = out_np[lane].astype(np.int64)
            self.rows[pid] = row
            if self.on_row is not None:
                self.on_row(pid, row)

    def finish(self) -> Dict[int, np.ndarray]:
        """Launch the partial arenas, fetch everything, and return the
        ``[6]`` rows by pair id."""
        assert not self._done, "chain stream already finished"
        self._done = True
        self._drain(final=True)
        while self.inflight:
            self._fetch_oldest()
        return self.rows


# ---------------------------------------------------------------- driver

_ROW_KEYS = ("q_ord", "t_idx", "strand", "q_begin", "q_end",
             "t_begin", "t_end", "n_seeds", "score")


def _empty_rows() -> Dict[str, np.ndarray]:
    return {key: np.zeros(0, np.int64) for key in _ROW_KEYS}


class OverlapParams(NamedTuple):
    k: int
    w: int
    max_occ: int
    min_seeds: int
    resident: bool
    device_join: bool
    cache: bool


def resolve_params(k=None, w=None, max_occ=None, min_seeds=None,
                   resident=None, device_join=None, cache=None
                   ) -> OverlapParams:
    """The overlapper's parameters: each one given, or else its flag
    (``RACON_TPU_OVERLAP_K``, ``_W``, ``_MAX_OCC``, ``_MIN_SEEDS``,
    ``RACON_TPU_RESIDENT``, ``RACON_TPU_OVERLAP_DEVICE_JOIN``, ``_CACHE``);
    k clipped to 4..16 (the scan's canonical codes hold 2k bits of 32)
    and w to at least 1 (``racon_tpu.ops.chain._resolve_params``)."""
    def pick(value, name, get):
        return get(name) if value is None else value

    k = pick(k, "RACON_TPU_OVERLAP_K", flags.get_int)
    w = pick(w, "RACON_TPU_OVERLAP_W", flags.get_int)
    return OverlapParams(
        k=max(4, min(16, k)), w=max(1, w),
        max_occ=pick(max_occ, "RACON_TPU_OVERLAP_MAX_OCC", flags.get_int),
        min_seeds=pick(min_seeds, "RACON_TPU_OVERLAP_MIN_SEEDS",
                       flags.get_int),
        resident=pick(resident, "RACON_TPU_RESIDENT", flags.get_bool),
        device_join=pick(device_join, "RACON_TPU_OVERLAP_DEVICE_JOIN",
                         flags.get_bool),
        cache=pick(cache, "RACON_TPU_OVERLAP_CACHE", flags.get_bool))


def _seed_and_join(read_seqs, target_seqs, read_self_t, qlens,
                   prm: OverlapParams, device):
    """Seed both pools (the targets through the table cache) and join;
    under the resident dataflow the tables are compacted on the device,
    and a device join keeps the seed coordinates there."""
    with obs.span("overlap.seed", reads=len(read_seqs),
                  targets=len(target_seqs)):
        rt = overlap_seed.build_seed_table(
            read_seqs, k=prm.k, w=prm.w, resident=prm.resident,
            device=device)
        tt = overlap_seed.build_seed_table(
            target_seqs, k=prm.k, w=prm.w, resident=prm.resident,
            cache=prm.cache, device=device)
    with obs.span("overlap.match"):
        hits, capped = join_seeds(
            rt, tt, read_self_t, qlens, k=prm.k, max_occ=prm.max_occ,
            device_join=prm.device_join,
            resident=prm.resident and prm.device_join, device=device)
        count("freq_capped_buckets", capped)
    return hits


def _group_rows(q, t, rel, rows6, qlens, k) -> Dict[str, np.ndarray]:
    """One query group's kept chains as overlap rows: reverse-strand chain
    coordinates flipped back to the forward query, sorted by ``(t, rel,
    t_begin, q_begin)`` (the canonical order within one query)."""
    ql = qlens[q]
    q_begin = np.where(rel == 1, ql - (rows6[:, 3] + k), rows6[:, 2])
    q_end = np.where(rel == 1, ql - rows6[:, 2], rows6[:, 3] + k)
    t_begin = rows6[:, 4]
    t_end = rows6[:, 5] + k
    order = np.lexsort((q_begin, t_begin, rel, t))
    return {"q_ord": q[order], "t_idx": t[order], "strand": rel[order],
            "q_begin": q_begin[order], "q_end": q_end[order],
            "t_begin": t_begin[order], "t_end": t_end[order],
            "n_seeds": rows6[order, 1], "score": rows6[order, 0]}


def iter_overlap_groups(read_seqs: List[bytes], target_seqs: List[bytes],
                        read_self_t: np.ndarray, *,
                        k: Optional[int] = None, w: Optional[int] = None,
                        max_occ: Optional[int] = None,
                        min_seeds: Optional[int] = None,
                        resident: Optional[bool] = None,
                        device_join: Optional[bool] = None,
                        cache: Optional[bool] = None,
                        device="cuda") -> Iterator[Dict[str, np.ndarray]]:
    """The streaming overlapper: yield each query group's overlap rows
    (ascending query ordinal) as soon as its chains are fetched (see the
    module docstring for when that is before all chaining is done).
    ``read_self_t[i]`` is the target read ``i`` is, or -1 (its self hits
    are dropped). The parameters left None come from the flags
    (:func:`resolve_params`). Concatenated, the yields are
    :func:`find_overlaps`."""
    prm = resolve_params(k, w, max_occ, min_seeds, resident, device_join,
                         cache)
    k, min_seeds = prm.k, prm.min_seeds
    qlens = np.fromiter((len(s) for s in read_seqs), np.int64,
                        len(read_seqs))
    hits = _seed_and_join(read_seqs, target_seqs, read_self_t, qlens, prm,
                          device)
    starts, _, counts = _pair_runs(hits)
    count("candidate_pairs", int(starts.size))
    if starts.size == 0:
        return
    q_of = hits["q"][starts]
    t_of = hits["t"][starts]
    rel_of = hits["rel"][starts]
    eligible = counts >= min_seeds
    kept_total = 0
    dropped_total = int((~eligible).sum())

    # query groups are consecutive runs of q over the sorted pairs
    gchange = np.ones(q_of.size, bool)
    gchange[1:] = q_of[1:] != q_of[:-1]
    gstart = np.flatnonzero(gchange)
    gend = np.append(gstart[1:], q_of.size)
    ngroups = gstart.size
    group_of = np.searchsorted(gstart, np.arange(q_of.size), "right") - 1
    # eligible pairs of each group still unchained: the emission gate
    rem = np.zeros(ngroups, np.int64)
    np.add.at(rem, group_of[eligible], 1)

    def on_row(pid, _row):
        rem[group_of[pid]] -= 1

    device_src = "tp_dev" in hits
    key = "_dev" if device_src else ""
    stream = _ChainStream(k=k, tp=hits["tp" + key], qc=hits["qc" + key],
                          device_src=device_src, on_row=on_row,
                          device=device)

    def emit(g: int) -> Optional[Dict[str, np.ndarray]]:
        nonlocal kept_total, dropped_total
        pids = np.arange(gstart[g], gend[g])[eligible[gstart[g]:gend[g]]]
        if pids.size == 0:
            return None
        rows6 = np.stack([stream.rows.pop(int(p)) for p in pids])
        good = rows6[:, 1] >= min_seeds
        kept_total += int(good.sum())
        dropped_total += int((~good).sum())
        if not good.any():
            return None
        sel = pids[good]
        return _group_rows(q_of[sel], t_of[sel], rel_of[sel], rows6[good],
                           qlens, k)

    emit_at = 0
    for g in range(ngroups):
        for p in range(int(gstart[g]), int(gend[g])):
            if eligible[p]:
                stream.add(p, int(starts[p]), int(counts[p]))
        stream.pump()
        while emit_at <= g and rem[emit_at] == 0:
            rows = emit(emit_at)
            emit_at += 1
            if rows is not None:
                yield rows
    with obs.span("overlap.chain"):
        stream.finish()
    while emit_at < ngroups:
        rows = emit(emit_at)
        emit_at += 1
        if rows is not None:
            yield rows
    count("stream_groups", ngroups)
    count("chains_kept", kept_total)
    count("chains_dropped", dropped_total)


def find_overlaps(read_seqs: List[bytes], target_seqs: List[bytes],
                  read_self_t: np.ndarray, *,
                  k: Optional[int] = None, w: Optional[int] = None,
                  max_occ: Optional[int] = None,
                  min_seeds: Optional[int] = None,
                  resident: Optional[bool] = None,
                  device_join: Optional[bool] = None,
                  cache: Optional[bool] = None, device="cuda"
                  ) -> Dict[str, np.ndarray]:
    """The whole overlapper, :func:`iter_overlap_groups` collected: arrays
    ``q_ord``, ``t_idx``, ``strand``, ``q_begin``, ``q_end``, ``t_begin``,
    ``t_end``, ``n_seeds``, ``score``, sorted by ``(q_ord, t_idx, strand,
    t_begin, q_begin)`` (the JAX ``find_overlaps`` on its default, ragged
    path)."""
    parts = list(iter_overlap_groups(
        read_seqs, target_seqs, read_self_t, k=k, w=w, max_occ=max_occ,
        min_seeds=min_seeds, resident=resident, device_join=device_join,
        cache=cache, device=device))
    if not parts:
        return _empty_rows()
    return {key: np.concatenate([p[key] for p in parts])
            for key in _ROW_KEYS}


def paf_bytes_rowwise(rows: Dict[str, np.ndarray],
                      read_names: List[bytes], read_lens: np.ndarray,
                      target_names: List[bytes],
                      target_lens: np.ndarray, *, k: int
                      ) -> List[bytes]:
    """One row at a time, the oracle of :func:`paf_bytes`."""
    out: List[bytes] = []
    for i in range(rows["q_ord"].size):
        q = int(rows["q_ord"][i])
        t = int(rows["t_idx"][i])
        qb, qe = int(rows["q_begin"][i]), int(rows["q_end"][i])
        tb, te = int(rows["t_begin"][i]), int(rows["t_end"][i])
        matches = min(int(rows["n_seeds"][i]) * k, qe - qb, te - tb)
        alen = max(qe - qb, te - tb)
        out.append(b"\t".join((
            read_names[q], str(int(read_lens[q])).encode(),
            str(qb).encode(), str(qe).encode(),
            b"-" if int(rows["strand"][i]) else b"+",
            target_names[t], str(int(target_lens[t])).encode(),
            str(tb).encode(), str(te).encode(),
            str(matches).encode(), str(alen).encode(), b"255"))
            + b"\n")
    return out


def paf_bytes(rows: Dict[str, np.ndarray], read_names: List[bytes],
              read_lens: np.ndarray, target_names: List[bytes],
              target_lens: np.ndarray, *, k: int) -> List[bytes]:
    """The overlapper's rows as 12-column PAF lines (newline included;
    matches ``min(n_seeds * k, query span, target span)``, block length
    the longer span, quality 255): the shard runner's ``--overlaps auto``
    file, the same bytes on every run. Each column is formatted as one
    numpy array and the columns joined once per row."""
    n = int(rows["q_ord"].size)
    if n == 0:
        return []
    q = rows["q_ord"]
    t = rows["t_idx"]
    qb, qe = rows["q_begin"], rows["q_end"]
    tb, te = rows["t_begin"], rows["t_end"]
    matches = np.minimum(np.minimum(rows["n_seeds"] * k, qe - qb),
                         te - tb)
    alen = np.maximum(qe - qb, te - tb)

    def fmt(col):
        return np.char.mod(b"%d", np.asarray(col, np.int64)
                           ).astype(object)

    qn = np.asarray(read_names, object)[q]
    tn = np.asarray(target_names, object)[t]
    strand = np.where(rows["strand"] != 0, b"-", b"+").astype(object)
    tab = np.full(n, b"\t", object)
    line = qn
    for col in (fmt(np.asarray(read_lens)[q]), fmt(qb), fmt(qe),
                strand, tn, fmt(np.asarray(target_lens)[t]),
                fmt(tb), fmt(te), fmt(matches), fmt(alen)):
        line = np.char.add(np.char.add(line, tab), col)
    line = np.char.add(line, np.full(n, b"\t255\n", object))
    return list(line)
