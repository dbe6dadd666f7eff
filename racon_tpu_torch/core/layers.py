"""Columnar layer storage: windows reference their read layers as
(offset, length) views into one concatenated read pool.

The round-7 columnar init left ONE per-layer Python loop standing: the
slice-and-append that copied every layer's bytes/quality into its
``Window`` (``layer_append_s`` in ``pipeline_init_breakdown``). This
module removes it. ``Polisher._assemble_layers`` builds a single
:class:`LayerStore` — a deduplicated byte pool of every referenced read
orientation plus flat per-layer ``(src, length, begin, end, win_id)``
arrays — and attaches each covered window an O(1) ``(store, row range)``
view. Window assembly becomes pure index arithmetic, and the consensus
packers build their device buffers with **one vectorized gather per
group** (:meth:`LayerStore.gather_qpw`) straight from the precomputed
packed ``weight << 3 | code`` pool, instead of re-deriving codes and
weights from thousands of small bytes objects per pack.

The CPU engines (and any direct ``window.sequences`` consumer) see the
exact bytes they always did: :class:`~racon_tpu_torch.core.window.Window`
materializes its layers lazily from the store on first access, so the
reference-semantics POA path and all recorded goldens are unchanged.
With ``evict_reads`` the original read payloads can be released as soon
as the store is built — the pool (raw bytes + qualities + packed lanes)
is the only copy the rest of the pipeline needs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_CODE_LUT = np.full(256, 4, dtype=np.uint8)  # non-ACGT -> N code (4)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i


class LayerStore:
    """One run's layers, columnar. Per-layer arrays are window-major
    (sorted by ``win_id``, stable in overlap-stream order within a
    window — the POA tie-break contract); ``pool``/``qpool`` hold each
    referenced read orientation once, ``qpw_pool`` the device lane
    packing ``weight << 3 | code`` per pooled base (weights are
    phred-33 clipped at 0, or 1 for no-quality reads)."""

    __slots__ = ("pool", "qpool", "qpw_pool", "src", "length", "begin",
                 "end", "win_id", "has_qual", "row_bounds")

    def __init__(self, pool, qpool, qpw_pool, src, length, begin, end,
                 win_id, has_qual, row_bounds):
        self.pool = pool
        self.qpool = qpool
        self.qpw_pool = qpw_pool
        self.src = src
        self.length = length
        self.begin = begin
        self.end = end
        self.win_id = win_id
        self.has_qual = has_qual
        self.row_bounds = row_bounds

    @classmethod
    def build(cls, data_refs: Sequence[bytes],
              qual_refs: Sequence[Optional[bytes]],
              ov: np.ndarray, qb: np.ndarray, qe: np.ndarray,
              win_id: np.ndarray, begin: np.ndarray, end: np.ndarray,
              n_windows: int) -> "LayerStore":
        """Vectorized store build from the per-layer columnar arrays of
        ``_assemble_layers`` (already window-major sorted).

        ``data_refs``/``qual_refs`` are per-overlap references into the
        read set (forward or reverse-complement orientation); the pool
        deduplicates them by object identity, so a read orientation
        referenced by many overlaps is pooled once."""
        ov = np.asarray(ov, np.int64)
        used = np.unique(ov) if len(ov) else np.zeros(0, np.int64)
        (pool, qpool, qpw_pool, ov_off, hq_ov,
         _has_q_base) = cls._build_pool(data_refs, qual_refs, used)

        src = ov_off[ov] + np.asarray(qb, np.int64)
        length = (np.asarray(qe, np.int64)
                  - np.asarray(qb, np.int64)).astype(np.int64)
        row_bounds = np.searchsorted(
            np.asarray(win_id, np.int64), np.arange(n_windows + 1))
        return cls(pool, qpool, qpw_pool, src, length,
                   np.asarray(begin, np.int64), np.asarray(end, np.int64),
                   np.asarray(win_id, np.int64), hq_ov[ov], row_bounds)

    @classmethod
    def _build_pool(cls, data_refs: Sequence[bytes],
                    qual_refs: Sequence[Optional[bytes]],
                    used: np.ndarray):
        """Identity-deduplicated byte/quality/packed-lane pool over the
        overlap indices in ``used`` — the shared core of :meth:`build`
        (kept as a separate step, as in the JAX package).
        Returns ``(pool, qpool, qpw_pool, ov_off, hq_ov, has_q_base)``."""
        n_ov = len(data_refs)
        off_of_obj = {}
        parts: List[bytes] = []
        qparts: List[bytes] = []
        pos = 0
        ov_off = np.full(n_ov, -1, np.int64)
        for oi in used:
            d = data_refs[oi]
            key = id(d)
            off = off_of_obj.get(key)
            if off is None:
                off = pos
                off_of_obj[key] = off
                parts.append(d)
                q = qual_refs[oi]
                qparts.append(q if q is not None else b"\x00" * len(d))
                pos += len(d)
            ov_off[oi] = off
        pool = (np.frombuffer(b"".join(parts), np.uint8)
                if parts else np.zeros(0, np.uint8))
        qpool = (np.frombuffer(b"".join(qparts), np.uint8)
                 if qparts else np.zeros(0, np.uint8))
        # packed device lanes for the WHOLE pool, once: the per-group
        # packer gather then reads finished uint16 lanes
        hq_ov = np.fromiter((q is not None for q in qual_refs),
                            bool, n_ov) if n_ov else np.zeros(0, bool)
        has_q_base = np.zeros(len(pool), bool)
        for oi in used:
            if qual_refs[oi] is not None:
                o = ov_off[oi]
                has_q_base[o:o + len(data_refs[oi])] = True
        weights = np.where(
            has_q_base,
            np.maximum(qpool.astype(np.int16) - 33, 0), 1)
        qpw_pool = ((weights.astype(np.uint16) << 3)
                    | _CODE_LUT[pool]).astype(np.uint16)
        return pool, qpool, qpw_pool, ov_off, hq_ov, has_q_base

    # ------------------------------------------------------ device packing

    def gather_qpw(self, rows: np.ndarray, Lq: int) -> np.ndarray:
        """One vectorized gather: the packed ``weight << 3 | code``
        uint16 lane block [len(rows), Lq] for the given layer rows —
        exactly the array ``ops.poa.pack_group`` ships to the
        device (rows shorter than ``Lq`` zero-padded)."""
        lens = self.length[rows]
        pos = np.arange(Lq, dtype=np.int64)[None, :]
        valid = pos < lens[:, None]
        srcs = (self.src[rows][:, None]
                + np.minimum(pos, np.maximum(lens[:, None] - 1, 0)))
        return np.where(valid, self.qpw_pool[srcs], 0).astype(np.uint16)

    # ---------------------------------------------------- materialization

    def materialize_into(self, win, r0: int, r1: int) -> None:
        """Append rows [r0, r1) to ``win``'s layer lists as real bytes —
        the lazy CPU-path escape hatch (fallback engines, direct
        ``window.sequences`` consumers). Byte-exact: the pool stores the
        raw read bytes, so non-ACGT characters survive untouched."""
        for r in range(r0, r1):
            s = int(self.src[r])
            ln = int(self.length[r])
            win._seqs.append(self.pool[s:s + ln].tobytes())
            win._quals.append(self.qpool[s:s + ln].tobytes()
                              if self.has_qual[r] else None)
            win._pos.append((int(self.begin[r]), int(self.end[r])))
