"""Minimizer seeding, stage one of the first-party overlapper
(``--overlaps auto``), the port of ``racon_tpu/ops/overlap_seed.py``.

- Sequences pack on the host into code arrays (A/C/G/T -> 0..3, anything
  else -> 4, which invalidates every k-mer covering it) and bucket by pow2
  length into ``[B, L]`` batches against the fixed
  :data:`SEED_ARENA_CELLS` arena.
- One :func:`minimizer_scan` per batch, plain PyTorch on the batch's
  device: forward and reverse-complement k-mer codes from k shifted
  slices, the strand-canonical minimum (``fwd == rc`` palindromes are
  skipped), scrambled through the invertible murmur3 finalizer, and each
  w-window's leftmost strict-< minimum scattered into a selection mask.
- The host fetches the batch's hashes, strands and mask and compacts them
  with ``np.nonzero`` into one flat ``(hash, seq_id, pos, strand)`` table;
  under the resident dataflow (``resident=True``, ``RACON_TPU_RESIDENT=1``
  in the overlapper) :func:`compact_selected` packs the selected entries
  on the device in the same order and only they are fetched, 10 bytes
  each (counted in ``dataflow.bytes_fetched`` and, against the three
  full arrays, ``dataflow.bytes_avoided``).

Hashes are uint32 in the JAX package. On the device they are int64: a
uint32 value of 2^31 or more would sort first as int32, and PyTorch's
uint32 lacks sort and searchsorted on CUDA. Every multiply of
:func:`_mix32` is split so that no product leaves int64's range. The tables
this module returns are numpy ``uint32`` hashes, as the JAX package's are.

Long sequences (contigs) are cut into spans of :data:`SEED_SLICE` window
starts that overlap by ``k + w - 2`` bases; each window belongs to one
span, and positions picked on both sides of a cut are deduplicated, so
the table equals the whole-sequence scan of :func:`minimizers_np`.

A batch's scan is the span ``overlap.seed.dispatch``, its copy to the host
``overlap.seed.fetch``; the ``overlap.*`` counters go to the metrics
registry, and those the JAX package's tests hold also to ``STATS``
(:func:`count`).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Iterator, List, Tuple

import numpy as np
import torch

from .. import obs
from ..device import resolve
from ..obs import metrics

# k = 15, w = 5: ONT read-vs-draft seeding (about a third of the positions
# carry a minimizer); the JAX package's RACON_TPU_OVERLAP_K/W defaults
DEFAULT_K = 15
DEFAULT_W = 5
# cells of one minimizer batch: every per-position array is B * L
SEED_ARENA_CELLS = 1 << 22
# window starts per batch row of one long sequence
SEED_SLICE = 1 << 17
# invalid k-mer slots (ambiguous base, palindrome, past the end) and the
# padding of the seed join's tables
_HASH_MAX = 0xFFFFFFFF

_BASE_LUT = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_LUT[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _BASE_LUT[_b] = _i

# The overlapper's counters, as the JAX package's tests read them; each is
# also the metric ``overlap.<key>`` (:func:`count`). ``chain.STATS`` is
# this dict; this module counts ``cache_hits``, ``chain`` the rest.
# ``chunk_shapes`` lists the (S, B) of every chain launch.
STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(freq_capped_buckets=0, join_bailouts=0, candidate_pairs=0,
                 chains_kept=0, chains_dropped=0, lanes_occupied=0,
                 lanes_total=0, chunks=0, stream_groups=0, cache_hits=0,
                 chunk_shapes=[])


reset_stats()


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``STATS[key]`` and to the metric ``overlap.<key>``."""
    STATS[key] += n
    metrics.inc(f"overlap.{key}", n)


# -------------------------------------------------------------- geometry

def _len_bucket(n: int) -> int:
    """pow2 length bucket of one code chunk (floor 64, so every bucket
    holds a full k + w window)."""
    b = 64
    while b < n:
        b *= 2
    return b


def _seed_batch(L: int, n: int) -> int:
    """pow2 batch of one minimizer launch against
    :data:`SEED_ARENA_CELLS`."""
    want = min(max(1, n), max(1, SEED_ARENA_CELLS // max(1, L)))
    b = 1
    while b < want:
        b *= 2
    return b


# ------------------------------------------------------------ the scan

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32): the constant's two
    16-bit halves keep every product under 2^49."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values: bijective on
    the 32-bit domain, so distinct canonical codes never collide."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def minimizer_scan(codes: torch.Tensor, lens: torch.Tensor,
                   nwin: torch.Tensor, *, k: int, w: int):
    """One minimizer pass over a ``[B, L]`` uint8 code batch
    (``racon_tpu.ops.overlap_seed._minimizer_kernel``). ``lens`` bounds
    each row's bases, ``nwin`` its own window starts. Returns ``(hash [B,
    P] int64, strand [B, P] bool, selected [B, P] bool)``, ``P = L - k +
    1``; invalid slots hash to :data:`_HASH_MAX`."""
    B, L = codes.shape
    dev = codes.device
    P = L - k + 1
    base = codes.to(torch.int64)
    f = torch.zeros((B, P), dtype=torch.int64, device=dev)
    r = torch.zeros((B, P), dtype=torch.int64, device=dev)
    bad = torch.zeros((B, P), dtype=torch.bool, device=dev)
    for j in range(k):
        c = base[:, j:j + P]
        bad |= c > 3
        cc = c & 3
        f = (f << 2) | cc
        r = (r >> 2) | ((3 - cc) << (2 * (k - 1)))
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    lens64 = lens.to(torch.int64)
    in_seq = pos[None, :] + k <= lens64[:, None]
    strand = r < f   # the canonical k-mer is the reverse complement
    h = _mix32(torch.minimum(f, r))
    h = torch.where(bad | (f == r) | ~in_seq, _HASH_MAX, h)

    # leftmost strict-< minimum over w consecutive slots
    W = P - w + 1
    minv = h[:, 0:W]
    minp = torch.zeros((B, W), dtype=torch.int64, device=dev)
    for j in range(1, w):
        cand = h[:, j:j + W]
        take = cand < minv
        minv = torch.where(take, cand, minv)
        minp = torch.where(take, j, minp)
    minp = minp + pos[None, :W]
    wpos = pos[None, :W]
    wvalid = ((wpos < nwin.to(torch.int64)[:, None])
              & (wpos + (w + k - 1) <= lens64[:, None])
              & (minv != _HASH_MAX))
    # each window's pick; invalid windows park on slot P, sliced off
    tgt = torch.where(wvalid, minp, P)
    sel = torch.zeros((B, P + 1), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand(B, W)
    sel.index_put_((rows, tgt), torch.ones((), dtype=torch.bool,
                                            device=dev))
    return h, strand, sel[:, :P]


def compact_selected(h: torch.Tensor, strand: torch.Tensor,
                     sel: torch.Tensor):
    """The selected entries of a ``[B, P]`` batch packed to the front in
    row-major order, which is ``np.nonzero``'s (``racon_tpu.ops.
    overlap_seed._compact_kernel``; plain PyTorch on the batch's device).
    Returns ``(hash, row, col, strand, total)``: flat ``[B * P]`` arrays
    whose first ``total`` entries are the selected ones and the rest
    zeros (``hash`` in ``h``'s dtype, ``row``/``col`` int32, ``strand``
    bool), and ``total`` a device scalar. A cumsum rank and one scatter
    each: every unselected entry goes to one dump slot past the end,
    which is sliced off unread (the winner of duplicate scatter indices is
    undefined on CUDA). Bound: the three ``[B, P]`` inputs read once, the
    outputs written once."""
    B, P = h.shape
    dev = h.device
    n = B * P
    flat = sel.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int64), 0)
    idx = torch.where(flat, rank - 1, n)
    lin = torch.arange(n, dtype=torch.int64, device=dev)

    def packed(vals, dtype):
        out = torch.zeros(n + 1, dtype=dtype, device=dev)
        return out.scatter_(0, idx, vals.to(dtype))[:n]

    return (packed(h.reshape(-1), h.dtype), packed(lin // P, torch.int32),
            packed(lin % P, torch.int32),
            packed(strand.reshape(-1), torch.bool), rank[-1])


# ------------------------------------------------------------ host driver

def _iter_chunks(seqs: List[bytes], k: int, w: int
                 ) -> Iterator[Tuple[int, int, bytes, int]]:
    """``(seq_id, window_start_offset, byte_slice, n_windows)``: whole
    short sequences, bounded overlapping spans of long ones."""
    for sid, s in enumerate(seqs):
        L = len(s)
        if L < k + w - 1:
            continue  # no complete window fits
        n_total = L - (k + w - 1) + 1
        for s0 in range(0, n_total, SEED_SLICE):
            n_here = min(SEED_SLICE, n_total - s0)
            end = min(L, s0 + n_here + (k + w - 2))
            yield sid, s0, s[s0:end], n_here


# the target tables of recent runs, keyed by the targets' content and
# (k, w): a polisher run over the same draft seeds it once. Entries are
# never written to by a consumer.
_TABLE_CACHE: "OrderedDict[Tuple[bytes, int, int], tuple]" = OrderedDict()
_TABLE_CACHE_CAP = 4
_TABLE_CACHE_LOCK = threading.Lock()


def _fingerprint(seqs: List[bytes], k: int, w: int
                 ) -> Tuple[bytes, int, int]:
    """blake2b over the count, each length and each byte string, beside
    (k, w)."""
    hsh = hashlib.blake2b(digest_size=16)
    hsh.update(len(seqs).to_bytes(8, "little"))
    for s in seqs:
        hsh.update(len(s).to_bytes(8, "little"))
        hsh.update(s)
    return hsh.digest(), k, w


def clear_table_cache() -> None:
    with _TABLE_CACHE_LOCK:
        _TABLE_CACHE.clear()


def _table_cache_put(ckey, table) -> None:
    with _TABLE_CACHE_LOCK:
        _TABLE_CACHE[ckey] = table
        _TABLE_CACHE.move_to_end(ckey)
        while len(_TABLE_CACHE) > _TABLE_CACHE_CAP:
            _TABLE_CACHE.popitem(last=False)


def build_seed_table(seqs: List[bytes], *, k: int = DEFAULT_K,
                     w: int = DEFAULT_W, resident: bool = False,
                     cache: bool = False, device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """The flat minimizer table of a sequence set: numpy ``(hash uint32,
    seq_id int32, pos int32, strand bool)`` sorted by ``(seq_id, pos)``.
    :func:`minimizer_scan` runs on ``device``. ``resident=True`` compacts
    each batch there (:func:`compact_selected`) and fetches its selected
    entries only; the host path fetches the whole batch and compacts with
    ``np.nonzero``; both give the same table. ``cache=True`` looks the
    set up in the table cache first: a hit counts ``cache_hits`` and, at
    the table's resident wire size, ``dataflow.bytes_avoided``."""
    ckey = None
    if cache:
        ckey = _fingerprint(seqs, k, w)
        with _TABLE_CACHE_LOCK:
            hit = _TABLE_CACHE.get(ckey)
            if hit is not None:
                _TABLE_CACHE.move_to_end(ckey)
        if hit is not None:
            count("cache_hits")
            metrics.inc("overlap.minimizers", int(hit[0].size))
            metrics.inc("dataflow.bytes_avoided", int(hit[0].size) * 10)
            return hit
        metrics.inc("overlap.cache_misses")
    dev = resolve(device)
    by_bucket: dict = {}
    for chunk in _iter_chunks(seqs, k, w):
        by_bucket.setdefault(_len_bucket(len(chunk[2])), []).append(chunk)

    hs: List[np.ndarray] = []
    ids: List[np.ndarray] = []
    ps: List[np.ndarray] = []
    ss: List[np.ndarray] = []
    for L in sorted(by_bucket):
        chunks = by_bucket[L]
        B_cap = _seed_batch(L, len(chunks))
        for begin in range(0, len(chunks), B_cap):
            part = chunks[begin:begin + B_cap]
            B = _seed_batch(L, len(part))
            codes = np.full((B, L), 4, np.uint8)
            lens = np.zeros(B, np.int32)
            nwin = np.zeros(B, np.int32)
            for i, (_, _, blob, n_here) in enumerate(part):
                arr = _BASE_LUT[np.frombuffer(blob, np.uint8)]
                codes[i, :arr.size] = arr
                lens[i] = arr.size
                nwin[i] = n_here
            with obs.span("overlap.seed.dispatch", rows=len(part)):
                h, strand, sel = minimizer_scan(
                    torch.from_numpy(codes).to(dev),
                    torch.from_numpy(lens).to(dev),
                    torch.from_numpy(nwin).to(dev), k=k, w=w)
                # the hashes cross as int32 words (the same 32 bits),
                # read back as uint32
                h32 = torch.where(h >= 1 << 31, h - (1 << 32),
                                  h).to(torch.int32)
                if resident:
                    packed = compact_selected(h32, strand, sel)
            if resident:
                with obs.span("overlap.seed.fetch", rows=len(part)):
                    n = int(packed[4])
                    h_np, rows, cols, s_np = (x[:n].cpu().numpy()
                                              for x in packed[:4])
                    h_np = h_np.view(np.uint32)
                fetched = n * 10   # 4 + 4 + 1 + 1 bytes an entry
                metrics.inc("dataflow.bytes_fetched", fetched)
                metrics.inc("dataflow.bytes_avoided",
                            max(0, B * (L - k + 1) * 6 - fetched))
            else:
                with obs.span("overlap.seed.fetch", rows=len(part)):
                    h_full = h32.cpu().numpy().view(np.uint32)
                    sel_np = sel.cpu().numpy()
                    s_full = strand.cpu().numpy()
                rows, cols = np.nonzero(sel_np)
                h_np = h_full[rows, cols]
                s_np = s_full[rows, cols]
            keep = h_np != np.uint32(_HASH_MAX)
            rows, cols = rows[keep], cols[keep]
            chunk_ids = np.fromiter((c[0] for c in part), np.int32,
                                    len(part))
            chunk_off = np.fromiter((c[1] for c in part), np.int32,
                                    len(part))
            hs.append(h_np[keep])
            ids.append(chunk_ids[rows])
            ps.append(chunk_off[rows] + cols.astype(np.int32))
            ss.append(s_np[keep])
            metrics.inc("overlap.seed_lanes_total", B * L)
            metrics.inc("overlap.seed_lanes_occupied", int(lens.sum()))
    if not hs:
        z = np.zeros(0, np.int32)
        table = (np.zeros(0, np.uint32), z, z, np.zeros(0, bool))
    else:
        h_all = np.concatenate(hs)
        id_all = np.concatenate(ids)
        p_all = np.concatenate(ps)
        s_all = np.concatenate(ss)
        # (seq_id, pos) order; a position picked by windows on both sides
        # of a span cut is emitted once per span
        order = np.lexsort((p_all, id_all))
        h_all, id_all, p_all, s_all = (h_all[order], id_all[order],
                                       p_all[order], s_all[order])
        uniq = np.ones(h_all.size, bool)
        uniq[1:] = (id_all[1:] != id_all[:-1]) | (p_all[1:] != p_all[:-1])
        table = (h_all[uniq], id_all[uniq], p_all[uniq], s_all[uniq])
        metrics.inc("overlap.minimizers", int(table[0].size))
    if ckey is not None:
        _table_cache_put(ckey, table)
    return table


# --------------------------------------------------------- numpy oracle

def minimizers_np(seq: bytes, k: int = DEFAULT_K, w: int = DEFAULT_W
                  ) -> List[Tuple[int, int, int]]:
    """Single-sequence numpy oracle: ``(hash, pos, strand)`` triples by
    position, with the scan's semantics (canonical min, fmix32,
    palindrome and ambiguity skips, leftmost strict-< window minimum)."""
    codes = _BASE_LUT[np.frombuffer(seq, np.uint8)]
    L = codes.size
    if L < k + w - 1:
        return []
    P = L - k + 1
    f = np.zeros(P, np.uint32)
    r = np.zeros(P, np.uint32)
    bad = np.zeros(P, bool)
    for j in range(k):
        c = codes[j:j + P].astype(np.uint32)
        bad |= c > 3
        cc = c & np.uint32(3)
        f = (f << np.uint32(2)) | cc
        r = (r >> np.uint32(2)) | ((np.uint32(3) - cc)
                                   << np.uint32(2 * (k - 1)))
    strand = r < f
    h = np.minimum(f, r)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    h = np.where(bad | (f == r), np.uint32(_HASH_MAX), h)
    sel = np.zeros(P, bool)
    for s in range(P - w + 1):
        win = h[s:s + w]
        m = int(win.min())
        if m != _HASH_MAX:
            sel[s + int(np.argmax(win == m))] = True
    return [(int(h[p]), int(p), int(strand[p]))
            for p in np.flatnonzero(sel)]
