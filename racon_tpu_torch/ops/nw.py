"""Batched banded Needleman-Wunsch on the card (counterpart of the batch
path of ``racon_tpu.ops.nw.TpuAligner``: fixed bucket bands, no ragged
stream, no band ladder — the JAX package's bucketed path, byte-identical to
its default one).

Pairs are bucketed by length into ``BUCKETS`` (max length, band), packed
longest-first into chunks under a direction-matrix byte budget, and each
chunk runs the forward kernel (the one ``swar.use_packed16`` picks) and the
walk kernel on the device. The host unpacks the op stream into CIGARs. A pair is
accepted when its walk completes inside the band and its score certifies
optimality (``score <= band/2 - |n - m| - 2``); band escapes retry at the
next bucket, and pairs no bucket takes go to the host aligner.
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
# expected divergence used to pick the starting bucket band
TYPICAL_DIVERGENCE = 0.25
# pairs per device chunk, at most
MAX_CHUNK_PAIRS = 65536
# direction-matrix bytes per chunk: 16 GiB of the card's 80 GB, which
# holds ~2000 ONT read pairs of the (16384, 4096) bucket per launch
MAX_DIRS_BYTES = 16 * 1024 ** 3


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


class CudaAligner:
    """Batched device aligner with host fallback for rejected pairs."""

    # the polisher hands this backend the whole overlap stream at once
    wants_full_stream = True

    def __init__(self, fallback=None, buckets=BUCKETS, num_batches: int = 1,
                 device="cuda"):
        self.device = resolve(device)
        self.fallback = fallback
        self.buckets = buckets
        self.num_batches = max(1, num_batches)
        self.stats = {"device": 0, "fallback_length": 0, "fallback_band": 0,
                      "band_escalated": 0, "chunks": 0, "swar_chunks": 0,
                      "chunk_shapes": []}

    def _chunk_cap(self, steps: int, band: int) -> int:
        """Pairs per chunk: the largest power of two whose direction
        matrix fits the per-chunk share of ``MAX_DIRS_BYTES``."""
        raw = (MAX_DIRS_BYTES // self.num_batches) // (steps * (band // 8))
        cap = 1
        while cap * 2 <= raw and cap * 2 <= MAX_CHUNK_PAIRS:
            cap *= 2
        return cap

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

    def align_batch(self, pairs: Sequence[Tuple[bytes, bytes]]) -> List[str]:
        """CIGAR strings (M/I/D, I consumes the query) for every
        (query, target) pair."""
        cigars: List[str] = [""] * len(pairs)
        by_class = {}
        reject: List[int] = []
        for idx, (q, t) in enumerate(pairs):
            if len(q) == 0 or len(t) == 0:
                cigars[idx] = (f"{len(t)}D" if len(t) else
                               (f"{len(q)}I" if len(q) else ""))
                continue
            bi = self._bucket_index(len(q), len(t))
            if bi is None:
                reject.append(idx)
            else:
                by_class.setdefault(bi, []).append(idx)
        self.stats["fallback_length"] += len(reject)
        while by_class:
            escaped = {}
            for bi in sorted(by_class):
                max_len, band = self.buckets[bi]
                # longest first, so a chunk holds pairs of similar length
                indices = sorted(
                    by_class[bi],
                    key=lambda i: -(len(pairs[i][0]) + len(pairs[i][1])))
                max_nm = len(pairs[indices[0]][0]) + len(pairs[indices[0]][1])
                cap = self._chunk_cap(sweep_bound(max_nm, max_len), band)
                esc = escaped.setdefault(bi, [])
                for start in range(0, len(indices), cap):
                    chunk = indices[start:start + cap]
                    self._finish_chunk(chunk, pairs, band,
                                       self._run_chunk(pairs, chunk,
                                                       max_len, band),
                                       cigars, esc)
            by_class = {}
            for bi, idxs in escaped.items():
                for idx in idxs:
                    q, t = pairs[idx]
                    nbi = self._bucket_index(len(q), len(t), bi + 1)
                    if nbi is None:
                        self.stats["fallback_band"] += 1
                        reject.append(idx)
                    else:
                        self.stats["band_escalated"] += 1
                        by_class.setdefault(nbi, []).append(idx)
        if reject:
            if self.fallback is None:
                raise RuntimeError(
                    f"{len(reject)} pairs rejected and no fallback aligner")
            for i, cig in zip(reject, self.fallback.align_batch(
                    [pairs[i] for i in reject])):
                cigars[i] = cig
        return cigars

    def _run_chunk(self, pairs, chunk, max_len: int, band: int):
        """Pack one chunk, run the forward and walk kernels, and fetch
        ``(ops_packed, score, fi, fj, n, m)`` for its real pairs."""
        B = _pow2_at_least(len(chunk))
        qcat = np.zeros(B * max_len, dtype=np.uint8)
        tcat = np.zeros(B * max_len, dtype=np.uint8)
        n = np.ones(B, dtype=np.int32)
        m = np.ones(B, dtype=np.int32)
        for k, idx in enumerate(chunk):
            qb, tb = pairs[idx]
            qcat[k * max_len: k * max_len + len(qb)] = \
                np.frombuffer(qb, dtype=np.uint8)
            tcat[k * max_len: k * max_len + len(tb)] = \
                np.frombuffer(tb, dtype=np.uint8)
            n[k], m[k] = len(qb), len(tb)
        steps = sweep_bound(int((n + m).max()), max_len)
        dev = self.device
        nd = torch.from_numpy(n).to(dev)
        md = torch.from_numpy(m).to(dev)
        qrp, tp = build_rows(torch.from_numpy(qcat).to(dev),
                             torch.from_numpy(tcat).to(dev), nd, md,
                             max_len=max_len, band=band)
        packed16 = use_packed16(max_len, band)
        dirs, score = cuda_nw.nw_fwd(qrp, tp, nd, md, max_len=max_len,
                                     band=band, steps=steps,
                                     packed16=packed16)
        ops, fi, fj = cuda_nw.walk_ops(dirs, nd, md, band=band)
        del dirs
        self.stats["chunks"] += 1
        self.stats["swar_chunks"] += int(packed16)
        # (max_len, band, pairs, padded batch, sweep steps) of each launch
        self.stats["chunk_shapes"].append((max_len, band, len(chunk), B,
                                           steps))
        C = len(chunk)
        return (ops[:C].cpu().numpy(), score[:C].cpu().numpy(),
                fi[:C].cpu().numpy(), fj[:C].cpu().numpy(), n[:C], m[:C])

    def _finish_chunk(self, chunk, pairs, band, out, cigars, reject):
        ops_packed, score, fi, fj, n, m = out
        shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
        ops = ((ops_packed[:, :, None] >> shifts) & 3).reshape(
            ops_packed.shape[0], -1)
        for k, idx in enumerate(chunk):
            diff = abs(int(n[k]) - int(m[k]))
            path = ops[k][ops[k] < 3]
            clean = len(path) > 0 and int(fi[k]) == 0 and int(fj[k]) == 0
            # optimality certificate: an optimal path's diagonal wander is
            # bounded by its edit count; require it inside the half band
            if int(score[k]) <= band // 2 - diff - 2 and clean:
                cigars[idx] = ops_to_cigar(path)
                self.stats["device"] += 1
            else:
                reject.append(idx)
