"""Batched banded Needleman-Wunsch on the card (counterpart of
``racon_tpu.ops.nw.TpuAligner`` on its default path: the ragged align
stream, the band ladder and breaking points on the device).

Pairs are seeded a ``(bucket, band)`` geometry: the bucket by length from
``BUCKETS`` (max length, band), the band from ``BAND_RUNGS`` by the run's
divergence estimate (the band ladder; the bucket's band with it off). Each
geometry class fills chunks longest-first under a direction-matrix byte
budget, and each chunk runs the forward kernel (the one
``swar.use_packed16`` picks) and the walk kernel on the device. In
breaking-points mode :func:`breaking_points` then reduces the walk's op
stream to per-window tables on the device, and only those tables and the
gate scalars (score, fi, fj) come back; in CIGAR mode the op stream comes
back and the host run-length-encodes it. A pair is accepted when its walk
completes inside the band and its score certifies optimality (``score <=
band/2 - |n - m| - 2``), which makes a narrow rung's alignment the wide
band's; band escapes retry batched at a wider rung, then at the next
bucket, and pairs no bucket takes go to the host aligner. So every path
gives the same bytes.

``CudaAligner(use_ragged=True)`` (the default) drives pairs through
:class:`_AlignStream` (greedy chunk fill by each chunk's own head, a
cold-start probe, chunks in flight while the host packs the next);
``use_ragged=False`` takes the bucketed wave driver.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_nw
from .swar import use_packed16
from ..device import resolve
from ..params import PARAMS

BUCKETS: Tuple[Tuple[int, int], ...] = PARAMS.buckets
# expected divergence used to pick the starting bucket band, and the band
# ladder's seed while no pair has resolved
TYPICAL_DIVERGENCE = 0.25
# the band ladder's rungs: a pair's starting band is the narrowest rung its
# divergence estimate admits, below its bucket's band (the terminal rung,
# so the accept/reject set is the fixed band's)
BAND_RUNGS = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
              3072, 4096)
# seeds use the run's observed divergence once this many pairs resolved
ADAPT_MIN_PAIRS = 256
# the align stream seeds, dispatches and fetches this many leading pairs
# first, so later seeds use observed divergence
ALIGN_PROBE_PAIRS = 1024
# pairs per device chunk, at most
MAX_CHUNK_PAIRS = 65536
# unresolved pairs the align stream keeps in flight, at most
MAX_INFLIGHT_PAIRS = 4 * MAX_CHUNK_PAIRS
# direction-matrix bytes in flight: 16 GiB of the card's 80 GB, which
# holds ~2000 ONT read pairs of the (16384, 4096) bucket per launch
MAX_DIRS_BYTES = 16 * 1024 ** 3
# breaking_points' value for a boundary interval without a match
BP_BIG = 1 << 30


def build_rows(qcat: torch.Tensor, tcat: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor, *, max_len: int, band: int):
    """Banded NW row layout from dense byte blocks (pair k's query and
    target at ``k * max_len``): the reversed query ending at column
    ``band/2 + max_len``, the target from column ``band/2``, zero padding
    (``racon_tpu.ops.nw._build_rows``)."""
    B = n.shape[0]
    dev = qcat.device
    c = band // 2
    width = c + max_len + band
    pos = torch.arange(width, device=dev)[None, :]
    row0 = (torch.arange(B, device=dev) * max_len)[:, None]
    qoff = c + max_len - 1 - pos
    toff = pos - c
    qvalid = (qoff >= 0) & (qoff < n[:, None])
    tvalid = (toff >= 0) & (toff < m[:, None])
    qrp = torch.where(qvalid, qcat[row0 + qoff.clamp(0, max_len - 1)], 0)
    tp = torch.where(tvalid, tcat[row0 + toff.clamp(0, max_len - 1)], 0)
    return (qrp.to(torch.uint8).contiguous(),
            tp.to(torch.uint8).contiguous())


def sweep_bound(max_nm: int, max_len: int) -> int:
    """Anti-diagonal sweep bound of a chunk, a multiple of 512 (long
    buckets quantize to 2048), as ``racon_tpu.ops.nw._sweep_bound``."""
    quant = 512 if max_len <= 1024 else 2048
    steps = min(-(-max_nm // quant) * quant, 2 * max_len)
    return -(-steps // 512) * 512


def breaking_points(ops_packed: torch.Tensor, n: torch.Tensor,
                    m: torch.Tensor, first_rel: torch.Tensor,
                    nb: torch.Tensor, *, w: int, NW: int):
    """Per-window breaking points straight from the walk's packed op
    stream (``racon_tpu.ops.nw._breaking_points_kernel``), on the device
    the inputs lie on: ``ops_packed`` uint8 ``[B, S/4]``, ``n``, ``m``,
    ``first_rel``, ``nb`` int32 ``[B]``. Returns ``(bp_first, bp_last)``
    int32 ``[B, NW]``.

    Coordinates are span-relative and packed ``tpos << 14 | qpos`` (both
    below 16384, the longest bucket). For boundary interval k (boundaries
    at ``first_rel + j*w`` for j < nb-1, plus ``m-1``): ``bp_first[b, k]``
    is the first match of interval k (``BP_BIG`` when it has none),
    ``bp_last[b, k]`` the last match at or before boundary k (a running
    max).

    The JAX function takes a min and a max over each interval's steps.
    Along a row the target position never grows (every step consumes a
    target base or none), so the interval index never grows either, each
    interval's matches are one run of the walk, and the packed value falls
    strictly from one match to the next. So the min is the run's last
    match and the max its first: both found by ``searchsorted`` in the
    running minimum of the interval index (one pass over ``[B, S]``, no
    atomics), which gives the same ints as the masked reduces."""
    B, S4 = ops_packed.shape
    S = 4 * S4
    dev = ops_packed.device
    i32 = torch.int32
    with torch.profiler.record_function("breaking_points"):
        ops = cuda_nw.unpack_ops(ops_packed)
        di = (ops <= 1).to(i32)               # M or I: consumes the query
        dj = ((ops & 1) == 0).to(i32)         # M or D: consumes the target
        # 0-based span-relative positions of each step's cell
        qpos = n[:, None] - torch.cumsum(di, 1, dtype=i32) + di - 1
        tpos = m[:, None] - torch.cumsum(dj, 1, dtype=i32) + dj - 1
        del di, dj
        # boundary-interval index: the number of boundaries < tpos,
        # clipped to [0, nb - 1] as jnp.clip does
        widx = -torch.div(first_rel[:, None] - tpos, w,
                          rounding_mode="floor")
        widx = torch.minimum(torch.clamp(widx, min=0), nb[:, None] - 1)
        valid = (ops == 0) & (tpos >= 0) & (widx >= 0) & (widx < NW)
        del ops
        packed = (tpos << 14) | torch.clamp(qpos, min=0)
        del qpos, tpos
        # run[t]: the interval of the last match at or before step t (NW
        # before the first), non-increasing along the row; last[t]: that
        # match's step (-1 before the first)
        run = torch.cummin(torch.where(valid, widx, NW), dim=1).values
        steps = torch.arange(S, dtype=i32, device=dev)
        last = torch.cummax(torch.where(valid, steps, -1), dim=1).values
        del widx, valid
        ks = torch.arange(NW, dtype=i32, device=dev).expand(B, NW)
        desc = (-run).contiguous()
        # steps whose run is >= k (a prefix) and > k (a shorter prefix)
        ge = torch.searchsorted(desc, (-ks).contiguous(), right=True)
        gt = torch.searchsorted(desc, (-ks).contiguous())
        # interval k's last match: the last match of the >= k prefix, when
        # that prefix ends in interval k
        end = (ge - 1).clamp(min=0)
        at = last.gather(1, end).long()
        has = (ge > 0) & (run.gather(1, end) == ks) & (at >= 0)
        bp_first = torch.where(has, packed.gather(1, at.clamp(min=0)),
                               BP_BIG)
        # interval k's first match: the step right after the > k prefix,
        # when interval k starts there
        beg = gt.clamp(max=S - 1)
        has = (gt < S) & (run.gather(1, beg) == ks)
        first_match = torch.where(has, packed.gather(1, beg), -1)
        bp_last = torch.cummax(first_match, dim=1).values
        return bp_first, bp_last


def window_geometry(t_begin: np.ndarray, m: np.ndarray, w: int):
    """``(first_rel, nb)`` int32 ``[B]`` of a chunk for
    :func:`breaking_points`: each pair's first window boundary relative to
    its target span (``m - 1`` when the span lies in one window) and its
    window regions, from the pairs' global target starts ``t_begin [C]``
    and the chunk's target lengths ``m [B]``; padding pairs past ``C``
    get one region at 0."""
    C = len(t_begin)
    tb = np.asarray(t_begin, dtype=np.int64)
    n_reg = (tb + m[:C] - 1) // w - tb // w
    first_rel = np.zeros(len(m), dtype=np.int32)
    nb = np.ones(len(m), dtype=np.int32)
    nb[:C] = n_reg + 1
    first_rel[:C] = np.where(n_reg != 0, (tb // w + 1) * w - 1 - tb,
                             m[:C] - 1)
    return first_rel, nb


def ops_to_cigar(path: np.ndarray) -> str:
    """Run-length encode a backward-order op path (codes < 3) into a CIGAR
    string."""
    if len(path) == 0:
        return ""
    arr = path[::-1]
    change = np.flatnonzero(np.diff(arr)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(arr)]))
    sym = {0: "M", 1: "I", 2: "D"}
    return "".join(f"{e - s}{sym[int(arr[s])]}" for s, e in zip(starts, ends))


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < max(1, x):
        p *= 2
    return p


def _dense_block(seqs, lens: np.ndarray, B: int, max_len: int) -> np.ndarray:
    """``B * max_len`` bytes holding ``seqs[k]`` at ``k * max_len``, zeros
    elsewhere: one join and one scatter, no loop over pairs."""
    out = np.zeros(B * max_len, dtype=np.uint8)
    flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    if flat.size:
        lens = lens.astype(np.int64)
        start = (np.arange(len(seqs), dtype=np.int64) * max_len
                 - np.cumsum(lens) + lens)
        out[np.repeat(start, lens) + np.arange(flat.size)] = flat
    return out


class CudaAligner:
    """Batched device aligner with on-device traceback and breaking points,
    and a host fallback for the pairs it rejects."""

    # the polisher hands this backend the whole overlap stream at once
    wants_full_stream = True

    def __init__(self, fallback=None, buckets=BUCKETS,
                 max_dirs_bytes=MAX_DIRS_BYTES, num_batches: int = 1,
                 device="cuda", use_ragged: bool = True,
                 use_ladder: bool = True):
        self.device = resolve(device)
        self.fallback = fallback
        self.buckets = buckets
        self.max_dirs_bytes = max_dirs_bytes
        # the pipeline depth: chunks kept in flight, each capped at
        # 1/num_batches of the direction-matrix budget
        self.num_batches = max(1, num_batches)
        # ragged pair packing through _AlignStream (False: the bucketed
        # wave driver)
        self.use_ragged = use_ragged
        # seed each pair's band from the divergence estimate (BAND_RUNGS)
        self.use_ladder = use_ladder
        # [count, sum, sum_sq] of the realized divergence (score / longer
        # span) of every clean walk
        self._div_obs = [0, 0.0, 0.0]
        # lanes_occupied / lanes_total: the real pairs' n + m
        # anti-diagonals / B x steps of every launch; steps_wasted their
        # gap; wavefront_work lanes_total x band summed over launches;
        # chunk_shapes (max_len, band, pairs, padded batch, sweep steps)
        # of each launch; fetched_bytes the bytes copied off the device
        self.stats = {"device": 0, "fallback_length": 0, "fallback_band": 0,
                      "band_escalated": 0, "chunks": 0, "swar_chunks": 0,
                      "lanes_occupied": 0, "lanes_total": 0,
                      "steps_wasted": 0, "wavefront_work": 0,
                      "ladder_narrow": 0, "fetched_bytes": 0,
                      "chunk_shapes": []}

    # ----------------------------------------------------------- geometry

    @property
    def dirs_budget_cap(self) -> int:
        """Direction-matrix bytes in flight, at most."""
        return max(1, self.max_dirs_bytes)

    def chunk_dirs_budget(self) -> int:
        """Direction-matrix bytes of one chunk: the in-flight budget split
        over the pipeline depth."""
        return max(1, self.dirs_budget_cap // self.num_batches)

    def _bucket_index(self, qlen: int, tlen: int, start: int = 0):
        need = abs(qlen - tlen) + 16
        want = need + int(TYPICAL_DIVERGENCE * max(qlen, tlen))
        fallback_bi = None
        for bi in range(start, len(self.buckets)):
            max_len, band = self.buckets[bi]
            if qlen <= max_len and tlen <= max_len and need <= band // 2:
                if want <= band // 2:
                    return bi
                if fallback_bi is None:
                    fallback_bi = bi
        return fallback_bi

    def _observe_divergence(self, scores, maxlens) -> None:
        """Feed clean walks' realized divergence (score over the longer
        span) into the run's running estimate."""
        cnt, s, s2 = self._div_obs
        d = np.asarray(scores, dtype=np.float64) / np.maximum(
            np.asarray(maxlens, dtype=np.float64), 1.0)
        self._div_obs = [cnt + d.size, s + float(d.sum()),
                         s2 + float((d * d).sum())]

    def _adaptive_divergence(self):
        """Observed divergence, mean + 2 sigma, once ``ADAPT_MIN_PAIRS``
        pairs resolved; None before."""
        cnt, s, s2 = self._div_obs
        if cnt < ADAPT_MIN_PAIRS:
            return None
        mean = s / cnt
        var = max(0.0, s2 / cnt - mean * mean)
        return mean + 2.0 * var ** 0.5

    def _est_divergence(self, err) -> float:
        """The ladder's divergence estimate: ``TYPICAL_DIVERGENCE`` while
        cold; once warm the observed divergence, raised per pair by the
        overlap's span proxy (2x its error + 5%), at most TYPICAL."""
        ad = self._adaptive_divergence()
        if ad is None:
            return TYPICAL_DIVERGENCE
        proxy = 0.0 if err is None else 2.0 * float(err) + 0.05
        return min(TYPICAL_DIVERGENCE, max(proxy, ad))

    def _seed_geometry(self, qlen: int, tlen: int, err=None,
                       record: bool = True):
        """Starting ``(bucket_index, band)`` of a pair: its bucket, at the
        narrowest rung the divergence estimate admits (the bucket's band
        with the ladder off, or when no rung below it is wide enough).
        None sends the pair to the host. ``record`` counts a narrow seed
        in ``ladder_narrow``."""
        bi = self._bucket_index(qlen, tlen)
        if bi is None:
            return None
        bucket_band = self.buckets[bi][1]
        if not self.use_ladder:
            return (bi, bucket_band)
        need = abs(qlen - tlen) + 16
        want = need + int(self._est_divergence(err) * max(qlen, tlen))
        for rung in BAND_RUNGS:
            if rung >= bucket_band:
                break
            if want <= rung // 2:
                if record:
                    self.stats["ladder_narrow"] += 1
                return (bi, rung)
        return (bi, bucket_band)

    def _chunk_cap(self, steps: int, band: int, base: int = 1) -> int:
        """Pairs per chunk of one sweep geometry: the largest ``base * 2^k``
        batch whose direction matrix fits the per-chunk budget, at most
        ``MAX_CHUNK_PAIRS``."""
        raw = self.chunk_dirs_budget() // (steps * (band // 8))
        cap = base
        while cap * 2 <= raw and cap * 2 <= MAX_CHUNK_PAIRS:
            cap *= 2
        return cap

    def _next_geometry(self, qlen: int, tlen: int, bi: int, band: int):
        """Geometry after a band escape: below the bucket's band, the
        first rung at least twice the failed one that the current estimate
        admits (else the bucket's band); at the bucket's band, the next
        bucket. None sends the pair to the host."""
        bucket_band = self.buckets[bi][1]
        if band < bucket_band:
            need = abs(qlen - tlen) + 16
            want = need + int(self._est_divergence(None)
                              * max(qlen, tlen))
            nb = bucket_band
            for rung in BAND_RUNGS:
                if rung >= 2 * band and rung < bucket_band \
                        and want <= rung // 2:
                    nb = rung
                    break
            return (bi, nb)
        nbi = self._bucket_index(qlen, tlen, bi + 1)
        if nbi is None:
            return None
        return (nbi, self.buckets[nbi][1])

    # ------------------------------------------------------- entry points

    def align_batch(self, pairs: Sequence[Tuple[bytes, bytes]],
                    progress=None, errors=None) -> List[str]:
        """CIGAR strings (M/I/D, I consumes the query) for every (query,
        target) pair. ``errors`` optionally carries per-pair divergence
        estimates (overlap ``error`` values) for the ladder."""
        return self._drive(pairs, progress, None, errors)

    def breaking_points_batch(self, pairs, metas, window_length: int,
                              progress=None, errors=None):
        """Per-window breaking points of every (query span, target span)
        pair; ``metas[i]`` is the overlap's ``(t_begin, q_off)`` (global
        target start, strand-aware query offset). One ``(k, 4)`` int32
        array a pair, rows ``(t_first, q_first, t_end_excl, q_end_excl)``,
        row-identical to the CIGAR walk's; the op stream stays on the
        device."""
        return self._drive(pairs, progress, (window_length, metas), errors)

    def bp_stream(self, window_length: int, progress=None, total: int = 0):
        """A streaming breaking-points session (:class:`_AlignStream`):
        ``feed()`` slices, then ``finish()`` for the rows of every fed pair
        in feed order. None with ``use_ragged=False``."""
        if not self.use_ragged:
            return None
        return _AlignStream(self, window_length=window_length,
                            progress=progress, total_hint=total)

    def _drive(self, pairs, progress, bp_meta, errors=None):
        if self.use_ragged:
            sess = _AlignStream(
                self, window_length=bp_meta[0] if bp_meta else None,
                progress=progress, total_hint=len(pairs))
            sess.feed(pairs, metas=bp_meta[1] if bp_meta else None,
                      errors=errors)
            return sess.finish()
        return self._drive_bucketed(pairs, progress, bp_meta, errors)

    def _drive_bucketed(self, pairs, progress, bp_meta, errors=None):
        """The wave driver: every geometry class chunked longest-first,
        ``num_batches`` chunks in flight, escapes re-dispatched batched
        per wave."""
        done_pairs = 0
        empty_bp = np.zeros((0, 4), dtype=np.int32)
        results: List = [("" if bp_meta is None else empty_bp)
                         for _ in range(len(pairs))]
        by_class = {}  # (bucket_index, band) -> indices
        reject: List[int] = []
        for idx, (q, t) in enumerate(pairs):
            if len(q) == 0 or len(t) == 0:
                if bp_meta is None:
                    results[idx] = (f"{len(t)}D" if len(t) else
                                    (f"{len(q)}I" if len(q) else ""))
                done_pairs += 1
                continue
            g = self._seed_geometry(len(q), len(t),
                                    None if errors is None else errors[idx])
            if g is None:
                reject.append(idx)
            else:
                by_class.setdefault(g, []).append(idx)
        self.stats["fallback_length"] += len(reject)
        # with the ladder cold, the first chunk is fetched at once so the
        # divergence estimate seeds the rest from real scores
        eager = self.use_ladder and self._adaptive_divergence() is None
        while by_class:
            inflight = []
            escaped = {}  # class -> indices that escaped its band
            for cls in sorted(by_class):
                bi, band = cls
                # longest first, so a chunk holds pairs of similar length
                indices = sorted(
                    by_class[cls],
                    key=lambda i: -(len(pairs[i][0]) + len(pairs[i][1])))
                max_len = self.buckets[bi][0]
                max_nm = (len(pairs[indices[0]][0])
                          + len(pairs[indices[0]][1]))
                cap = self._chunk_cap(sweep_bound(max_nm, max_len), band)
                esc = escaped.setdefault(cls, [])
                for start in range(0, len(indices), cap):
                    chunk = indices[start:start + cap]
                    inflight.append((band, esc, self._launch_chunk(
                        pairs, chunk, max_len, band, bp_meta)))
                    if len(inflight) >= (1 if eager else self.num_batches):
                        eager = False
                        done_pairs += self._finish_wave_chunk(
                            inflight.pop(0), results, bp_meta)
                        if progress is not None:
                            progress(done_pairs, len(pairs))
            while inflight:
                done_pairs += self._finish_wave_chunk(inflight.pop(0),
                                                      results, bp_meta)
                if progress is not None:
                    progress(done_pairs, len(pairs))
            by_class = {}
            for (bi, band), idxs in escaped.items():
                for idx in idxs:
                    q, t = pairs[idx]
                    ng = self._next_geometry(len(q), len(t), bi, band)
                    if ng is None:
                        self.stats["fallback_band"] += 1
                        reject.append(idx)
                    else:
                        self.stats["band_escalated"] += 1
                        by_class.setdefault(ng, []).append(idx)
        self._resolve_rejects(pairs, reject, results, bp_meta)
        if progress is not None and done_pairs < len(pairs):
            progress(len(pairs), len(pairs))
        return results

    def _finish_wave_chunk(self, entry, results, bp_meta) -> int:
        """Finish one in-flight chunk of the wave driver; returns the pairs
        it resolved (those that did not escape)."""
        band, esc, launched = entry
        before = len(esc)
        self._finish_chunk(launched, band, results, esc, bp_meta)
        return len(launched[0]) - (len(esc) - before)

    def _resolve_rejects(self, pairs, reject, results, bp_meta) -> None:
        """Host-fallback results for length and band rejects (``pairs``
        only needs ``pairs[i]``: a list or the stream's slot dict)."""
        if not reject:
            return
        if self.fallback is None:
            raise RuntimeError(
                f"{len(reject)} pairs rejected and no fallback aligner")
        fb = self.fallback.align_batch([pairs[i] for i in reject])
        if bp_meta is None:
            for i, cig in zip(reject, fb):
                results[i] = cig
            return
        from ..core.overlap import decode_breaking_points_batch
        w, metas = bp_meta
        arrs = decode_breaking_points_batch(
            fb, [metas[i][1] for i in reject], [metas[i][0] for i in reject],
            [metas[i][0] + len(pairs[i][1]) for i in reject], w)
        for i, arr in zip(reject, arrs):
            results[i] = arr

    # ------------------------------------------------------------- chunks

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the aligner's device; to the card through
        pinned memory, so the copy does not wait for the chunks in
        flight."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _launch_chunk(self, pairs, chunk, max_len: int, band: int,
                      bp_meta=None):
        """Pack a chunk and launch its kernels: the forward pass, the walk
        and, in breaking-points mode, :func:`breaking_points`. Returns the
        in-flight handle ``_finish_chunk`` takes; its outputs are device
        tensors the device is still computing."""
        C = len(chunk)
        B = _pow2_at_least(C)
        qs = [pairs[i][0] for i in chunk]
        ts = [pairs[i][1] for i in chunk]
        n = np.ones(B, dtype=np.int32)
        m = np.ones(B, dtype=np.int32)
        n[:C] = np.fromiter(map(len, qs), np.int32, C)
        m[:C] = np.fromiter(map(len, ts), np.int32, C)
        steps = sweep_bound(int((n + m).max()), max_len)
        # occupancy: the launch is B x steps band-wide DP rows, of which
        # each real pair uses its own n + m
        occ = int(n[:C].sum()) + int(m[:C].sum())
        total = B * steps
        st = self.stats
        st["chunks"] += 1
        st["lanes_occupied"] += occ
        st["lanes_total"] += total
        st["steps_wasted"] += total - occ
        st["wavefront_work"] += total * band
        st["chunk_shapes"].append((max_len, band, C, B, steps))
        nd, md = self._upload(n), self._upload(m)
        qcat = self._upload(_dense_block(qs, n[:C], B, max_len))
        tcat = self._upload(_dense_block(ts, m[:C], B, max_len))
        qrp, tp = build_rows(qcat, tcat, nd, md, max_len=max_len, band=band)
        del qcat, tcat
        packed16 = use_packed16(max_len, band)
        st["swar_chunks"] += int(packed16)
        dirs, score = cuda_nw.nw_fwd(qrp, tp, nd, md, max_len=max_len,
                                     band=band, steps=steps,
                                     packed16=packed16)
        del qrp, tp
        ops, fi, fj = cuda_nw.walk_ops(dirs, nd, md, band=band)
        del dirs
        if bp_meta is None:
            return chunk, pairs, n, m, (ops, score, fi, fj)
        w, metas = bp_meta
        tb = np.fromiter((metas[i][0] for i in chunk), np.int64, C)
        first_rel, nb = window_geometry(tb, m, w)
        bp_first, bp_last = breaking_points(
            ops, nd, md, self._upload(first_rel), self._upload(nb), w=w,
            NW=max_len // max(w, 1) + 2)
        return chunk, pairs, n, m, (bp_first, bp_last, score, fi, fj)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host, counted in ``fetched_bytes``."""
        out = t.cpu().numpy()
        self.stats["fetched_bytes"] += out.nbytes
        return out

    def _finish_chunk(self, launched, band, results, reject,
                      bp_meta=None) -> None:
        """Fetch a launched chunk and resolve its pairs into ``results``
        (CIGARs, or breaking-point rows with ``bp_meta``); the pairs that
        fail the accept gate go to ``reject``."""
        if bp_meta is not None:
            self._finish_chunk_bp(launched, band, results, reject, bp_meta)
            return
        chunk, pairs, n, m, (ops_d, score_d, fi_d, fj_d) = launched
        C = len(chunk)
        ops_packed = self._fetch(ops_d[:C])
        score, fi, fj = self._fetch(torch.stack([score_d[:C], fi_d[:C],
                                                 fj_d[:C]]))
        shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
        ops = ((ops_packed[:, :, None] >> shifts) & 3).reshape(C, -1)
        obs_scores: List[int] = []
        obs_maxlens: List[int] = []
        for k, idx in enumerate(chunk):
            diff = abs(int(n[k]) - int(m[k]))
            path = ops[k][ops[k] < 3]
            clean = len(path) > 0 and int(fi[k]) == 0 and int(fj[k]) == 0
            # the ladder's signal: every clean walk's finite score (the
            # banded distance of a gate failure is an upper bound)
            if clean and int(score[k]) < (1 << 28):
                obs_scores.append(int(score[k]))
                obs_maxlens.append(max(int(n[k]), int(m[k])))
            # optimality certificate: an optimal path's diagonal wander is
            # bounded by its edit count; require it inside the half band
            if int(score[k]) <= band // 2 - diff - 2 and clean:
                results[idx] = ops_to_cigar(path)
                self.stats["device"] += 1
            else:
                reject.append(idx)
        if obs_scores:
            self._observe_divergence(obs_scores, obs_maxlens)

    def _finish_chunk_bp(self, launched, band, results, reject,
                         bp_meta) -> None:
        """Breaking-points finish: fetch the chunk's two ``[C, NW]`` tables
        and its gate scalars in one copy, apply the accept gate, and decode
        every accepted pair's rows in one vectorized pass."""
        chunk, _, n, m, (bp_first, bp_last, score, fi, fj) = launched
        w, metas = bp_meta
        C = len(chunk)
        NW = bp_first.shape[1]
        host = self._fetch(torch.cat(
            [bp_first[:C], bp_last[:C],
             torch.stack([score[:C], fi[:C], fj[:C]], 1)], 1))
        n_h = n[:C].astype(np.int64)
        m_h = m[:C].astype(np.int64)
        score_h = host[:, 2 * NW].astype(np.int64)
        clean = (host[:, 2 * NW + 1] == 0) & (host[:, 2 * NW + 2] == 0)
        accept = (score_h <= band // 2 - np.abs(n_h - m_h) - 2) & clean
        # the ladder's signal: every clean walk's finite score (a gate
        # failure's banded score is an upper bound)
        seen = clean & (score_h < (1 << 28))
        if seen.any():
            self._observe_divergence(score_h[seen],
                                     np.maximum(n_h, m_h)[seen])
        tb = np.fromiter((metas[idx][0] for idx in chunk), np.int64, C)
        qo = np.fromiter((metas[idx][1] for idx in chunk), np.int64, C)
        n_reg = (tb + m_h - 1) // w - tb // w
        fp = host[:, :NW].astype(np.int64)
        lp = host[:, NW:2 * NW].astype(np.int64)
        # rows (t_first, q_first, t_end_excl, q_end_excl) of every region
        # with a match, of every accepted pair: one buffer, split per pair
        col = np.arange(NW, dtype=np.int64)
        valid = ((col[None, :] <= n_reg[:, None]) & (fp < BP_BIG)
                 & accept[:, None])
        rows = np.stack(
            [tb[:, None] + (fp >> 14), qo[:, None] + (fp & 0x3FFF),
             tb[:, None] + (lp >> 14) + 1, qo[:, None] + (lp & 0x3FFF) + 1],
            axis=-1)
        parts = np.split(rows[valid].astype(np.int32),
                         np.cumsum(valid.sum(axis=1))[:-1])
        for k, idx in enumerate(chunk):
            if accept[k]:
                results[idx] = parts[k]
                self.stats["device"] += 1
            else:
                reject.append(idx)


class _AlignStream:
    """Ragged streaming align session (``racon_tpu.ops.nw._AlignStream``
    without its resident mode).

    Pairs arrive through :meth:`feed` in any number of slices; each is
    seeded a ``(bucket, band)`` class when buffered pairs flush, and each
    class greedy-fills chunks against the per-chunk direction-matrix budget
    by its pairs' own sweep cost: pairs sort longest-first and every
    chunk's cap comes from its own head's sweep bound. Full chunks launch
    as they close; fetches happen when the in-flight bytes or pairs force
    one, and at :meth:`finish`. Band escapes re-enter the pending classes
    at their escalated geometry and launch batched; geometry only
    escalates, so the drain ends. With the ladder cold, the first
    ``ALIGN_PROBE_PAIRS`` pairs are seeded, launched and fetched first, so
    later seeds use observed divergence. Resolved pairs release their span
    bytes at once."""

    def __init__(self, eng: CudaAligner, window_length=None, progress=None,
                 total_hint: int = 0):
        self.eng = eng
        self.w = window_length             # None -> CIGAR mode
        self.progress = progress
        self.total_hint = total_hint
        self.results: List = []            # per fed pair, feed order
        self.pairs: dict = {}              # slot -> (q, t), until resolved
        self.metas: dict = {}              # slot -> (t_begin, q_off)
        self.buffer: List = []             # (slot, err) awaiting a seed
        self.pending: dict = {}            # (bucket, band) -> [slot]
        self.reject: List[int] = []        # host-fallback slots
        self.inflight: List[dict] = []
        self.inflight_bytes = 0
        self.inflight_pairs = 0
        self.done_pairs = 0
        self._done = False
        self._est_warmed = False           # the first chunk was fetched
        self._empty_bp = np.zeros((0, 4), dtype=np.int32)

    def _bp_meta(self):
        return None if self.w is None else (self.w, self.metas)

    def _tick(self) -> None:
        if self.progress is not None:
            self.progress(self.done_pairs,
                          max(self.total_hint, len(self.results)))

    def feed(self, pairs, metas=None, errors=None) -> None:
        """Add a slice of pairs (with their ``metas`` in breaking-points
        mode, and optional ``errors``); launches every chunk that fills."""
        if self._done:
            raise RuntimeError("align stream already finished")
        for k, (q, t) in enumerate(pairs):
            slot = len(self.results)
            if len(q) == 0 or len(t) == 0:
                if self.w is None:
                    self.results.append(f"{len(t)}D" if len(t) else
                                        (f"{len(q)}I" if len(q) else ""))
                else:
                    self.results.append(self._empty_bp)
                self.done_pairs += 1
                continue
            if self.w is not None:
                self.metas[slot] = metas[k]
            self.results.append("" if self.w is None else self._empty_bp)
            self.pairs[slot] = (q, t)
            # seeded at flush time, so pairs behind the probe are seeded
            # from observed divergence
            self.buffer.append((slot,
                                None if errors is None else errors[k]))
        self._flush(final=False)
        self._tick()

    def _classify(self, buffered) -> None:
        eng = self.eng
        for slot, err in buffered:
            q, t = self.pairs[slot]
            g = eng._seed_geometry(len(q), len(t), err)
            if g is None:
                eng.stats["fallback_length"] += 1
                self.reject.append(slot)
            else:
                self.pending.setdefault(g, []).append(slot)

    def _flush(self, final: bool) -> None:
        eng = self.eng
        if (eng.use_ladder and self.buffer and not self._est_warmed
                and eng._adaptive_divergence() is None):
            if not final and len(self.buffer) < ALIGN_PROBE_PAIRS:
                return                     # wait for a probe's worth
            probe = self.buffer[:ALIGN_PROBE_PAIRS]
            self.buffer = self.buffer[ALIGN_PROBE_PAIRS:]
            self._classify(probe)
            self._drain(final=True)        # partial probe chunks too
        if self.buffer:
            self._classify(self.buffer)
            self.buffer = []
        self._drain(final)

    def _drain(self, final: bool) -> None:
        eng = self.eng
        for cls in sorted(self.pending):
            # a detached list: a fetch forced by _launch may escalate pairs
            # into this class, and they must land in a fresh entry
            slots = self.pending.pop(cls)
            bi, band = cls
            max_len = eng.buckets[bi][0]
            slots.sort(key=lambda s: -(len(self.pairs[s][0])
                                       + len(self.pairs[s][1])))
            while slots:
                q0, t0 = self.pairs[slots[0]]
                steps = sweep_bound(len(q0) + len(t0), max_len)
                cap = eng._chunk_cap(steps, band)
                if not final and len(slots) < cap:
                    break                  # wait for more pairs
                chunk = slots[:cap]
                del slots[:cap]
                self._launch(cls, chunk, max_len, band)
            if slots:
                self.pending.setdefault(cls, []).extend(slots)

    def _launch(self, cls, chunk, max_len: int, band: int) -> None:
        eng = self.eng
        launched = eng._launch_chunk(self.pairs, chunk, max_len, band,
                                     self._bp_meta())
        q0, t0 = self.pairs[chunk[0]]     # head = the chunk's longest pair
        steps = sweep_bound(len(q0) + len(t0), max_len)
        entry = {"cls": cls, "chunk": chunk, "launched": launched,
                 "bytes": _pow2_at_least(len(chunk)) * steps * (band // 8)}
        self.inflight.append(entry)
        self.inflight_bytes += entry["bytes"]
        self.inflight_pairs += len(chunk)
        # with the ladder cold, the first chunk is fetched at once
        if (eng.use_ladder and not self._est_warmed
                and eng._adaptive_divergence() is None):
            self._finish_oldest()
        self._est_warmed = True
        while (len(self.inflight) > max(eng.num_batches, 1)
               and (self.inflight_bytes > eng.dirs_budget_cap
                    or self.inflight_pairs > MAX_INFLIGHT_PAIRS)):
            self._finish_oldest()

    def _finish_oldest(self) -> None:
        eng = self.eng
        la = self.inflight.pop(0)
        self.inflight_bytes -= la["bytes"]
        self.inflight_pairs -= len(la["chunk"])
        esc: List[int] = []
        eng._finish_chunk(la["launched"], la["cls"][1], self.results, esc,
                          self._bp_meta())
        esc_set = set(esc)
        for slot in la["chunk"]:
            if slot not in esc_set:
                # resolved: release the span bytes and the meta tuple
                self.pairs.pop(slot, None)
                self.metas.pop(slot, None)
                self.done_pairs += 1
        bi, band = la["cls"]
        for slot in esc:
            q, t = self.pairs[slot]
            ng = eng._next_geometry(len(q), len(t), bi, band)
            if ng is None:
                eng.stats["fallback_band"] += 1
                self.reject.append(slot)
            else:
                eng.stats["band_escalated"] += 1
                self.pending.setdefault(ng, []).append(slot)
        self._tick()

    def finish(self) -> List:
        """Launch the partial chunks, drain the pipeline (escapes launch
        batched at their wider geometry until none remain), run the host
        fallback; results for every fed pair in feed order."""
        if self._done:
            raise RuntimeError("align stream already finished")
        self._done = True
        self._flush(final=True)
        while self.inflight or self.pending:
            while self.inflight:
                self._finish_oldest()
            self._flush(final=True)
        self.done_pairs += len(self.reject)
        self.eng._resolve_rejects(self.pairs, self.reject, self.results,
                                  self._bp_meta())
        for slot in self.reject:
            self.pairs.pop(slot, None)
            self.metas.pop(slot, None)
        if self.progress is not None:
            total = max(self.total_hint, len(self.results))
            self.progress(total, total)
        return self.results
