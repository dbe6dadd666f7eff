"""Batched banded Needleman-Wunsch on the card (counterpart of
``racon_tpu.ops.nw.TpuAligner`` on its default path: the ragged align
stream, the band ladder and breaking points on the device).

Pairs are seeded a ``(bucket, band)`` geometry: the bucket by length from
``BUCKETS`` (max length, band), the band from ``BAND_RUNGS`` by the run's
divergence estimate (the band ladder; the bucket's band with it off). Each
geometry class fills chunks longest-first under a direction-matrix byte
budget. Each chunk goes to the device packed (:func:`pack_chunk`: 2-bit
codes, nibbles or raw bytes, as the JAX launcher picks), the kernel
:func:`build_rows` unpacks its banded rows there, and it runs the forward
kernel (the one ``swar.use_packed16`` picks) and the walk kernel. In
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

Every chunk launch is the span ``align.dispatch`` and the fault site of the
same name, every fetch ``align.fetch``; the launch publishes the ``align.*``
occupancy counters. Under the sanitizer a sampled chunk whose forward pass
took K4 runs again through K1 and the same walk (``_shadow_chunk``), and
every fetched chunk passes the aligner canaries.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build, cuda_nw
from .swar import swar_choice, use_packed16
from .. import faults, flags, native, obs, sanitize
from ..device import resolve
from ..obs import metrics
from ..parallel import gather_shards, mesh_size, sharded_align, to_global
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


def build_rows(qblk: torch.Tensor, tblk: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor, *, max_len: int, band: int, bits: int):
    """Banded NW row layout of a chunk from its upload blocks: ``qblk``,
    ``tblk`` uint8 ``[B * max_len * bits / 8]`` (pair k's codes from code
    ``k * max_len``; ``bits`` 2: four codes a byte, the first in the low
    bits; 4: two a byte, low nibble first; 8: raw bytes), ``n``, ``m`` int32
    ``[B]``. Returns ``(qrp, tp)`` uint8 ``[B, band/2 + max_len + band]``:
    the reversed query ending at column ``band/2 + max_len``, the target
    from column ``band/2``, zero elsewhere, the bytes of
    ``racon_tpu.ops.nw._build_rows`` / ``_build_rows_packed`` /
    ``_build_rows_packed2``. On CUDA tensors it launches the CUDA kernel
    ``build_rows`` (``kernels/build_rows.cu``) or raises, and the rows are
    two views of one ``[2, B, width]`` tensor; on CPU tensors it runs
    :func:`build_rows_plain`."""
    B = n.shape[0]
    # each message is formatted only when its check fails
    if bits not in (2, 4, 8):
        raise ValueError(f"build_rows: bits {bits} is not 2, 4 or 8")
    if max_len <= 0 or (max_len * bits) % 8:
        raise ValueError(f"build_rows: max_len {max_len} is not whole "
                         f"bytes a pair at {bits} bits")
    if band <= 0 or band % 2:
        raise ValueError(f"build_rows: band {band} must be even")
    size = B * max_len * bits // 8
    if not (qblk.dtype == tblk.dtype == torch.uint8
            and qblk.shape == tblk.shape == (size,)):
        raise ValueError(f"build_rows: blocks must be uint8 [{size}]")
    cuda_nw._require(n.dtype == m.dtype == torch.int32
                     and n.shape == m.shape == (B,),
                     "build_rows: n, m must be int32 [B]")
    if qblk.device.type != "cuda":
        return build_rows_plain(qblk, tblk, n, m, max_len=max_len,
                                band=band, bits=bits)
    cuda_nw._check_cuda_inputs("build_rows", qblk, tblk, n, m)
    width = band // 2 + max_len + band
    with obs.profile_range("build_rows"):
        # both rows in one allocation
        rows = torch.empty((2, B, width), dtype=torch.uint8,
                           device=qblk.device)
        qrp, tp = rows[0], rows[1]
        fn = _build.function("rt_build_rows")
        with cuda_nw.launch_device(qblk):
            err = fn(qblk.data_ptr(), tblk.data_ptr(), n.data_ptr(),
                     m.data_ptr(), qrp.data_ptr(), tp.data_ptr(), B,
                     max_len, band, bits, cuda_nw._stream(qblk))
        cuda_nw.count_launch("build_rows", f"rt_build_rows:{bits}")
        cuda_nw._check_launch("build_rows", err)
    return qrp, tp


def build_rows_plain(qblk: torch.Tensor, tblk: torch.Tensor,
                     n: torch.Tensor, m: torch.Tensor, *, max_len: int,
                     band: int, bits: int):
    """Plain PyTorch :func:`build_rows`, on the device the inputs lie on
    (the CPU path and the kernel's yardstick on the card): each column's
    code index, clipped to the pair's slot, gathers its byte, and a shift
    and mask unpack it, as the JAX functions do."""
    B = n.shape[0]
    dev = qblk.device
    c = band // 2
    width = c + max_len + band
    per = 8 // bits
    pos = torch.arange(width, device=dev)[None, :]
    row0 = (torch.arange(B, device=dev) * max_len)[:, None]

    def fill(blk, off, length):
        valid = (off >= 0) & (off < length[:, None])
        src = row0 + off.clamp(0, max_len - 1)
        code = ((blk[src // per].to(torch.int32) >> ((src % per) * bits))
                & ((1 << bits) - 1))
        return torch.where(valid, code, 0).to(torch.uint8).contiguous()

    return fill(qblk, c + max_len - 1 - pos, n), fill(tblk, pos - c, m)


def align_chain(qrp: torch.Tensor, tp: torch.Tensor, n: torch.Tensor,
                m: torch.Tensor, *, max_len: int, band: int, steps: int = 0,
                packed16: bool = False):
    """The forward pass and its walk over one batch of rows
    (``racon_tpu.ops.nw.align_chain``): K4 with ``packed16``, else K1,
    then K2. Returns ``(ops_packed, score, fi, fj)``; the direction matrix
    is released before this returns. The single-device chunk and every
    shard of :func:`racon_tpu_torch.parallel.sharded_align` run it."""
    dirs, score = cuda_nw.nw_fwd(qrp, tp, n, m, max_len=max_len, band=band,
                                 steps=steps, packed16=packed16)
    ops, fi, fj = cuda_nw.walk_ops(dirs, n, m, band=band)
    return ops, score, fi, fj


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
    stream (``racon_tpu.ops.nw._breaking_points_kernel``): ``ops_packed``
    uint8 ``[B, S/4]``, ``n``, ``m``, ``first_rel``, ``nb`` int32 ``[B]``.
    Returns ``(bp_first, bp_last)`` int32 ``[B, NW]`` (the tables of
    :func:`breaking_points_plain`; on the card two views of one ``[2, B,
    NW]`` tensor). On CUDA tensors it launches the CUDA kernel
    ``breaking_points`` (``kernels/breaking_points.cu``: a block of 256
    threads a pair, one pass over the op stream, no ``[B, S]``
    temporaries) or raises; on CPU tensors it runs
    :func:`breaking_points_plain`."""
    B, S4 = ops_packed.shape
    cuda_nw._require(n.shape == m.shape == first_rel.shape == nb.shape
                     == (B,),
                     "breaking_points: ops_packed [B, S/4], n, m, "
                     "first_rel, nb [B]")
    cuda_nw._require(ops_packed.dtype == torch.uint8,
                     "breaking_points: ops_packed must be uint8")
    cuda_nw._require(n.dtype == m.dtype == first_rel.dtype == nb.dtype
                     == torch.int32,
                     "breaking_points: n, m, first_rel, nb must be int32")
    cuda_nw._require(w >= 1 and NW >= 1, "breaking_points: w, NW >= 1")
    if ops_packed.device.type != "cuda":
        return breaking_points_plain(ops_packed, n, m, first_rel, nb, w=w,
                                     NW=NW)
    cuda_nw._check_cuda_inputs("breaking_points", ops_packed, n, m,
                               first_rel, nb)
    with obs.profile_range("breaking_points"):
        # both tables in one allocation
        tables = torch.empty((2, B, NW), dtype=torch.int32,
                             device=ops_packed.device)
        bp_first, bp_last = tables[0], tables[1]
        fn = _build.function("rt_breaking_points")
        with cuda_nw.launch_device(ops_packed):
            err = fn(ops_packed.data_ptr(), n.data_ptr(), m.data_ptr(),
                     first_rel.data_ptr(), nb.data_ptr(),
                     bp_first.data_ptr(), bp_last.data_ptr(), B, S4, w, NW,
                     cuda_nw._stream(ops_packed))
        cuda_nw.count_launch("breaking_points")
        cuda_nw._check_launch("breaking_points", err)
    return bp_first, bp_last


def breaking_points_plain(ops_packed: torch.Tensor, n: torch.Tensor,
                          m: torch.Tensor, first_rel: torch.Tensor,
                          nb: torch.Tensor, *, w: int, NW: int):
    """Plain PyTorch :func:`breaking_points`, on the device the inputs lie
    on (the CPU path and the kernel's yardstick on the card): ``ops_packed``
    uint8 ``[B, S/4]``, ``n``, ``m``, ``first_rel``, ``nb`` int32 ``[B]``.
    Returns ``(bp_first, bp_last)`` int32 ``[B, NW]``.

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


# win_id of a dropped derive row: sorts after every real window
_ROW_SENTINEL = (1 << 31) - 1


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's complement (XLA's int32
    arithmetic wraps), kept as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def derive_layer_rows(bp_first, bp_last, qpw_pool, live, tb, qo_read,
                      qo_pool, n_reg, win_base, ov_idx, has_q, qlen,
                      s_min: int, q_need: int, *, w: int, NW: int, Lq: int):
    """Layer rows of one align chunk from its device breaking-point tables
    (``racon_tpu.ops.nw._derive_layer_rows``), on the device the tables
    lie on: the window assignment and the filters of
    ``Polisher._filter_layer_rows`` in their integer forms.

    ``bp_first``/``bp_last`` are the chunk's ``[B, NW]`` int32 tables
    (:func:`breaking_points`), ``qpw_pool`` the run's ``weight << 3 |
    code`` pool (:func:`upload_qpw_pool`), the rest ``[B]`` per-lane
    values: ``live`` the accepted lanes, ``tb``/``qo_read`` the overlap's
    global target start and oriented query offset, ``qo_pool`` the span's
    start in the pool, ``win_base`` the target's first window, ``ov_idx``
    the overlap, ``has_q`` whether its read has qualities, ``qlen`` its
    query span's length (at most ``Lq``, the chunk's bucket length).

    The keeps: min-span ``span >= s_min`` (``s_min = ceil(0.02 * w)``),
    mean PHRED ``sum(q - 33) >= q_need * span`` with the product wrapped to
    int32 as XLA computes it, and the empty-layer drop ``begin != end``.
    Returns ``[B * NW, 6]`` int32 rows ``(win_id, overlap, q_first,
    q_end_excl, layer_begin, layer_end)``; a dropped row's win_id is
    ``_ROW_SENTINEL``."""
    i32 = torch.int32
    dev = bp_first.device
    B = bp_first.shape[0]
    with torch.profiler.record_function("derive_layer_rows"):
        col = torch.arange(NW, dtype=i32, device=dev)[None, :]
        fp, lp = bp_first, bp_last
        valid = (col <= n_reg[:, None]) & (fp < BP_BIG) & live[:, None]
        t_first = tb[:, None] + (fp >> 14)
        qf = fp & 0x3FFF
        qe = (lp & 0x3FFF) + 1
        t_endx = tb[:, None] + (lp >> 14) + 1
        span = qe - qf
        keep = valid & (span >= s_min)
        # each lane's quality weights over its own query span, [B, Lq],
        # and their prefix sums (at most 222 * 16384 a lane: int32 holds
        # them, as in the JAX function)
        pos = torch.arange(Lq, dtype=i32, device=dev)[None, :]
        src = qo_pool[:, None] + torch.minimum(
            pos, torch.clamp(qlen[:, None] - 1, min=0))
        wrow = qpw_pool.index_select(0, src.reshape(-1)).reshape(B, Lq)
        wrow = torch.where(pos < qlen[:, None], (wrow >> 3).to(i32), 0)
        del src
        csum = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                          torch.cumsum(wrow, 1, dtype=i32)], 1)
        del wrow
        sum_w = (csum.gather(1, torch.clamp(qe, 0, Lq).long())
                 - csum.gather(1, torch.clamp(qf, 0, Lq).long()))
        del csum
        need = _wrap_i32(span.long() * int(q_need))
        keep &= ~has_q[:, None] | (sum_w.long() >= need)
        rank = torch.div(t_first, w, rounding_mode="floor")
        lb = t_first - rank * w
        le = t_endx - rank * w - 1
        keep &= lb != le
        out = torch.stack(
            [torch.where(keep, win_base[:, None] + rank, _ROW_SENTINEL),
             ov_idx[:, None].expand(B, NW), qo_read[:, None] + qf,
             qo_read[:, None] + qe, lb, le], -1)
        return out.to(i32).reshape(B * NW, 6)


def finalize_layer_table(parts, host_flat: np.ndarray,
                         src: np.ndarray) -> np.ndarray:
    """The resident layer table (``racon_tpu.ops.nw.finalize_layer_table``):
    the per-chunk :func:`derive_layer_rows` blocks and the host-fallback
    rows concatenated on their device, gathered by ``src`` into
    overlap-stream order, stable-sorted by window id (dropped rows, the
    sentinel, sort last), and fetched in one device-to-host copy.
    ``parts`` is not empty: its first block names the device."""
    dev = parts[0].device
    with torch.profiler.record_function("finalize_layer_table"):
        host = torch.from_numpy(np.ascontiguousarray(
            host_flat, dtype=np.int32).reshape(-1, 6)).to(dev)
        flat = torch.cat([*parts, host], 0)
        g = flat.index_select(0, torch.from_numpy(
            np.ascontiguousarray(src, dtype=np.int64)).to(dev))
        order = torch.sort(g[:, 0], stable=True).indices
        return g.index_select(0, order).cpu().numpy()


def upload_qpw_pool(qpw_pool: np.ndarray, device) -> torch.Tensor:
    """The run's ``weight << 3 | code`` pool on ``device``, uploaded once
    and synchronously (the caller times it). The values are below 2^11, so
    the pool goes as int16; it is padded to one element at least, so a
    dead lane's gather at index 0 stays in range."""
    pool = np.ascontiguousarray(qpw_pool, dtype=np.uint16).view(np.int16)
    if pool.size == 0:
        pool = np.zeros(1, np.int16)
    dev = torch.device(device)
    out = torch.from_numpy(pool).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


class _DevChunkBp:
    """The breaking-point tables of one align chunk, kept on its device
    (``racon_tpu.ops.nw._DevChunkBp``): the resident ``_finish_chunk_bp``
    fetches only the chunk's gate scalars, its accepted lanes hold
    :class:`_DevBp` handles into this object, and the polisher's resident
    assembly calls :meth:`derive` once per chunk. :meth:`fetch` is the
    host decode's way back: one copy of both tables, shared by every
    handle."""

    __slots__ = ("bp_first", "bp_last", "w", "NW", "B", "max_len", "_host")

    def __init__(self, bp_first: torch.Tensor, bp_last: torch.Tensor,
                 w: int, max_len: int):
        # own [B, NW] storage only, so a retained chunk keeps nothing else
        # of its launch alive
        self.bp_first = bp_first.contiguous()
        self.bp_last = bp_last.contiguous()
        self.w = w
        self.B = int(bp_first.shape[0])
        self.NW = int(bp_first.shape[1])
        self.max_len = max_len
        self._host = None

    def fetch(self):
        """Host int64 copies of the two tables (cached: one copy a
        chunk)."""
        if self._host is None:
            both = torch.cat([self.bp_first, self.bp_last], 1).cpu().numpy()
            self._host = (both[:, :self.NW].astype(np.int64),
                          both[:, self.NW:].astype(np.int64))
        return self._host

    def derive(self, dev_pool, live, tb, qo_read, qo_pool, n_reg, win_base,
               ov_idx, has_q, qlen, s_min: int, q_need: int) -> torch.Tensor:
        """:func:`derive_layer_rows` over this chunk's lanes. The per-lane
        arrays are host ``[B]`` arrays (dead lanes zeroed); they go to the
        device in one copy."""
        lanes = torch.from_numpy(np.stack(
            [live, tb, qo_read, qo_pool, n_reg, win_base, ov_idx, has_q,
             qlen]).astype(np.int32)).to(self.bp_first.device)
        live_d, tb_d, qo_d, qp_d, nr_d, wb_d, ov_d, hq_d, ql_d = lanes
        return derive_layer_rows(
            self.bp_first, self.bp_last, dev_pool, live_d != 0, tb_d, qo_d,
            qp_d, nr_d, wb_d, ov_d, hq_d != 0, ql_d, s_min, q_need,
            w=self.w, NW=self.NW, Lq=self.max_len)


class _DevBp:
    """One accepted pair's breaking points on the device
    (``racon_tpu.ops.nw._DevBp``): its chunk and lane, and the host values
    its rows need. It stands in ``overlap.breaking_points`` while the
    resident dataflow is on; :meth:`decode_host` gives the rows the
    non-resident path would have."""

    __slots__ = ("chunk", "lane", "t_begin", "q_off", "n_reg", "qlen")

    is_device_resident = True

    def __init__(self, chunk: _DevChunkBp, lane: int, t_begin: int,
                 q_off: int, n_reg: int, qlen: int):
        self.chunk = chunk
        self.lane = lane
        self.t_begin = t_begin
        self.q_off = q_off
        self.n_reg = n_reg
        self.qlen = qlen

    def __len__(self) -> int:
        # the row count at most (n_reg + 1 window regions): Polisher.run()
        # sizes its window ranges from it
        return self.n_reg + 1

    def decode_host(self) -> np.ndarray:
        """The non-resident ``_finish_chunk_bp`` rows of this lane, from
        the chunk's cached fetch."""
        fp_all, lp_all = self.chunk.fetch()
        fp = fp_all[self.lane]
        lp = lp_all[self.lane]
        col = np.arange(fp.shape[0], dtype=np.int64)
        valid = (col <= self.n_reg) & (fp < BP_BIG)
        rows = np.stack(
            [self.t_begin + (fp >> 14), self.q_off + (fp & 0x3FFF),
             self.t_begin + (lp >> 14) + 1,
             self.q_off + (lp & 0x3FFF) + 1], axis=-1)
        return rows[valid].astype(np.int32)


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


def upload_form(seen: np.ndarray, swar: bool, bits=None):
    """A chunk's upload form, ``(bits, lut)``, from the byte values present
    in its sequences (``seen``, ``bool [256]``), as the JAX chunk launcher
    picks it: the alphabet is the non-zero values present (0 is padding);
    with ``swar`` (:func:`~.swar.swar_choice`) and at most 4 symbols, 2-bit
    codes 0..3 in ascending byte order; else, up to 15 symbols, nibble
    codes 1..15; else the raw bytes. ``bits`` forces a form the alphabet
    fits (raises ``ValueError`` otherwise)."""
    alphabet = np.flatnonzero(seen[1:]) + 1
    if bits is None:
        bits = (2 if swar and len(alphabet) <= 4
                else 4 if len(alphabet) <= 15 else 8)
    if bits == 8:
        return 8, np.arange(256, dtype=np.uint8)
    if len(alphabet) > (4 if bits == 2 else 15):
        raise ValueError(f"{len(alphabet)} symbols do not fit {bits}-bit "
                         f"codes")
    lut = np.zeros(256, np.uint8)
    lut[alphabet] = np.arange(len(alphabet), dtype=np.uint8) + (bits == 4)
    return bits, lut


def pack_chunk(qs, ts, qlens: np.ndarray, tlens: np.ndarray, B: int,
               max_len: int, *, swar: bool, bits=None, pin: bool = False):
    """A chunk's two upload blocks, byte for byte the arrays the JAX chunk
    launcher uploads (``pack_bases_2bit`` of its 2-bit codes, its nibble
    bytes or its dense byte block): the query spans ``qs`` and target spans
    ``ts`` (bytes, lengths ``qlens``, ``tlens``) in ``B`` slots of
    ``max_len`` codes, in the form :func:`upload_form` picks (``swar``,
    ``bits``). One read-only scan of the spans finds the alphabet, and
    ``native.pack_block`` writes each block, padding included, in one pass
    over them: no ``B * max_len`` byte block is made first. Returns
    ``(qblk, tblk, bits)``, uint8 CPU tensors of ``B * max_len * bits / 8``
    bytes, pinned with ``pin``."""
    qflat, tflat = b"".join(qs), b"".join(ts)
    bits, lut = upload_form(native.byte_presence(qflat, tflat), swar, bits)
    blocks = []
    for flat, lens in ((qflat, qlens), (tflat, tlens)):
        out = torch.empty(B * max_len * bits // 8, dtype=torch.uint8,
                          pin_memory=pin)
        native.pack_block(flat, lens, B, max_len, lut, bits, out.data_ptr())
        blocks.append(out)
    return blocks[0], blocks[1], bits


class CudaAligner:
    """Batched device aligner with on-device traceback and breaking points,
    and a host fallback for the pairs it rejects.

    ``mesh``: an optional 1-D :class:`racon_tpu_torch.parallel.Mesh`; every
    chunk's batch is then split over it (:func:`racon_tpu_torch.parallel.
    sharded_align`, the analog of the reference's per-GPU batch binning,
    ``src/cuda/cudapolisher.cpp:163-171``) on the bucketed wave driver.
    ``device`` pins the engine to one device instead (``cuda``, the
    default, is the current card); a mesh and a pin exclude each other.
    ``use_ragged`` and ``use_ladder`` default to ``RACON_TPU_ALIGN_RAGGED``
    and ``RACON_TPU_BAND_LADDER``."""

    # the polisher hands this backend the whole overlap stream at once
    wants_full_stream = True

    def __init__(self, fallback=None, buckets=BUCKETS,
                 max_dirs_bytes=MAX_DIRS_BYTES, num_batches: int = 1,
                 device=None, use_ragged=None, use_ladder=None, mesh=None):
        if mesh is not None and device is not None:
            raise ValueError("an aligner takes a mesh or a device pin, not "
                             "both")
        self.mesh = mesh
        # the home device: host uploads land here, and a mesh chunk's
        # merged outputs come back here (to the host in a process group)
        self.device = resolve(mesh.home if mesh is not None
                              else "cuda" if device is None else device)
        self.fallback = fallback
        self.buckets = buckets
        self.max_dirs_bytes = max_dirs_bytes
        # the pipeline depth: chunks kept in flight, each capped at
        # 1/num_batches of the direction-matrix budget
        self.num_batches = max(1, num_batches)
        # ragged pair packing through _AlignStream (False, or a mesh: the
        # bucketed wave driver)
        self.use_ragged = (flags.get_bool("RACON_TPU_ALIGN_RAGGED")
                           if use_ragged is None else use_ragged)
        # seed each pair's band from the divergence estimate (BAND_RUNGS)
        self.use_ladder = (flags.get_bool("RACON_TPU_BAND_LADDER")
                           if use_ladder is None else use_ladder)
        # [count, sum, sum_sq] of the realized divergence (score / longer
        # span) of every clean walk
        self._div_obs = [0, 0.0, 0.0]
        # lanes_occupied / lanes_total: the real pairs' n + m
        # anti-diagonals / B x steps of every launch; steps_wasted their
        # gap; wavefront_work lanes_total x band summed over launches;
        # chunk_shapes (max_len, band, pairs, padded batch, sweep steps)
        # of each launch; fetched_bytes the bytes copied off the device;
        # swar_guard_int32 the chunks the int16 overflow guard kept from
        # the 2-bit upload; upload_forms and upload_bytes the chunks and
        # their two blocks' bytes by code width (2, 4, 8 bits)
        self.stats = {"device": 0, "fallback_length": 0, "fallback_band": 0,
                      "band_escalated": 0, "chunks": 0, "swar_chunks": 0,
                      "swar_guard_int32": 0,
                      "lanes_occupied": 0, "lanes_total": 0,
                      "steps_wasted": 0, "wavefront_work": 0,
                      "ladder_narrow": 0, "fetched_bytes": 0,
                      "chunk_shapes": [],
                      "upload_forms": {2: 0, 4: 0, 8: 0},
                      "upload_bytes": {2: 0, 4: 0, 8: 0}}
        # the sanitizer's pick of the K4 chunks it shadows with K1
        self._shadow = sanitize.ShadowSampler()
        # device-OOM backpressure: the shard runner's ladder doubles this
        # (reduce_capacity) and re-dispatches; 1 is full capacity
        self.capacity_scale = 1

    # ----------------------------------------------------------- geometry

    # chunks stop shrinking here: past a 16x cut the per-chunk fixed costs
    # dominate (the consensus engine keeps the same limit)
    _MAX_CAPACITY_SCALE = 16

    @property
    def dirs_budget_cap(self) -> int:
        """Direction-matrix bytes in flight, at most: ``max_dirs_bytes``
        over the backpressure scale."""
        return max(1, self.max_dirs_bytes // self.capacity_scale)

    def reduce_capacity(self) -> bool:
        """Halve the direction-matrix budget (device-OOM backpressure, the
        shard runner's ``reduce-capacity`` rung): every later chunk is cut
        against half the bytes. False once at ``_MAX_CAPACITY_SCALE``.
        Pairs are independent, so the bytes a run polishes do not
        change."""
        if self.capacity_scale >= self._MAX_CAPACITY_SCALE:
            return False
        self.capacity_scale *= 2
        metrics.set_gauge("aligner.capacity_scale", self.capacity_scale)
        metrics.inc("faults.backpressure_halvings")
        return True

    def chunk_dirs_budget(self) -> int:
        """Direction-matrix bytes of one chunk: the in-flight budget split
        over the pipeline depth."""
        return max(1, self.dirs_budget_cap // self.num_batches)

    def _pad_batch(self, count: int) -> int:
        """A chunk's padded batch: ``mesh_size * 2^k`` (the mesh splits it
        evenly), a plain power of two without a mesh."""
        B = mesh_size(self.mesh)
        while B < count:
            B *= 2
        return B

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

    def bp_stream(self, window_length: int, progress=None, total: int = 0,
                  resident: bool = False):
        """A streaming breaking-points session (:class:`_AlignStream`):
        ``feed()`` slices, then ``finish()`` for the rows of every fed pair
        in feed order. None with ``use_ragged=False`` or a mesh (callers
        then make one :meth:`breaking_points_batch` call a slice). With
        ``resident`` an accepted pair's result is a :class:`_DevBp` handle:
        its chunk's tables stay on the device."""
        if not self.use_ragged or self.mesh is not None:
            return None
        return _AlignStream(self, window_length=window_length,
                            progress=progress, total_hint=total,
                            resident=resident)

    def _drive(self, pairs, progress, bp_meta, errors=None):
        if self.use_ragged and self.mesh is None:
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
                steps_est = sweep_bound(max_nm, max_len)
                # chunks pad to mesh_size * 2^k, so the mesh size is the
                # smallest chunk
                base = mesh_size(self.mesh)
                raw_cap = self.chunk_dirs_budget() // (steps_est
                                                       * (band // 8))
                if base > max(1, raw_cap):
                    warnings.warn(
                        f"mesh size {base} exceeds the direction-"
                        f"matrix memory budget ({raw_cap} pairs of bucket "
                        f"({max_len},{band}) fit in "
                        f"{self.chunk_dirs_budget()} "
                        f"bytes); lower num_batches or use a smaller mesh",
                        RuntimeWarning)
                cap = self._chunk_cap(steps_est, band, base=base)
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

    def _launch_chunk(self, pairs, chunk, max_len: int, band: int,
                      bp_meta=None):
        """:meth:`_launch_chunk_impl` as the fault site and span
        ``align.dispatch`` (host packing and the asynchronous launches)."""
        faults.check("align.dispatch")
        with obs.span("align.dispatch", pairs=len(chunk), max_len=max_len,
                      band=band):
            return self._launch_chunk_impl(pairs, chunk, max_len, band,
                                           bp_meta)

    def _launch_chunk_impl(self, pairs, chunk, max_len: int, band: int,
                           bp_meta=None):
        """Pack a chunk and launch its kernels: the forward pass, the walk
        and, in breaking-points mode, :func:`breaking_points`. Returns the
        in-flight handle ``_finish_chunk`` takes, ``(chunk, pairs, n, m,
        outputs, max_len)``; its outputs are device tensors the device is
        still computing."""
        C = len(chunk)
        B = self._pad_batch(C)
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
        metrics.inc("align.chunks")
        metrics.inc("align.lanes_occupied", occ)
        metrics.inc("align.lanes_total", total)
        metrics.inc("align.steps_wasted", total - occ)
        metrics.inc("align.wavefront_work", total * band)
        # the upload blocks, packed in the chunk's form (2-bit codes,
        # nibbles or raw bytes) straight into pinned memory where the
        # aligner runs on a card, so the copies do not wait for the chunks
        # in flight; every process of a group packs the whole chunk alike
        # and keeps it on the host; under a mesh each shard uploads its
        # slice of the blocks and builds its rows on its own device
        qblk, tblk, bits = pack_chunk(
            qs, ts, n[:C], m[:C], B, max_len,
            swar=swar_choice(max_len, st), pin=self.device.type == "cuda")
        st["upload_forms"][bits] += 1
        st["upload_bytes"][bits] += qblk.numel() + tblk.numel()

        def put(a):
            return to_global(self.mesh, a, self.device)
        nd, md = put(n), put(m)
        rows = (put(qblk), put(tblk))
        del qblk, tblk
        if self.mesh is None:
            rows = build_rows(*rows, nd, md, max_len=max_len, band=band,
                              bits=bits)
        packed16 = use_packed16(max_len, band)
        st["swar_chunks"] += int(packed16)
        metrics.inc("aligner.swar_chunks", int(packed16))
        shadow = packed16 and self._shadow.should_shadow()
        parts = self._dispatch(*rows, nd, md, max_len=max_len, band=band,
                               bits=bits, steps=steps, packed16=packed16)
        if shadow:
            self._shadow_chunk(*rows, nd, md, parts, max_len=max_len,
                               band=band, bits=bits, steps=steps)
        del rows
        if bp_meta is not None:
            parts = self._attach_bp(parts, chunk, n, m, nd, md, max_len,
                                    bp_meta)
        return chunk, pairs, n, m, self._merged(parts), max_len

    def _dispatch(self, qrp, tp, n, m, *, bits: int, **kw) -> list:
        """The chunk's forward pass and walk: one ``(ops_packed, score, fi,
        fj)`` tuple from its rows, or under a mesh one a slot through
        :func:`sharded_align` from the upload blocks of ``bits`` a code
        (``None`` for a slot another process owns)."""
        if self.mesh is not None:
            return sharded_align(self.mesh, qrp, tp, n, m, bits=bits, **kw)
        return [align_chain(qrp, tp, n, m, **kw)]

    def _merged(self, parts):
        """Per-shard outputs as one tuple on the home device (on the host,
        every slot's, in a process group)."""
        return parts[0] if len(parts) == 1 else gather_shards(
            parts, self.device, mesh=self.mesh)

    def _attach_bp(self, parts, chunk, n, m, nd, md, max_len: int,
                   bp_meta) -> list:
        """Breaking points of each shard on the shard's device, from its
        op stream: ``(bp_first, bp_last, score, fi, fj)`` a shard. ``n``,
        ``m`` are the chunk's host lengths, ``nd``, ``md`` their upload
        (the single-device chunk reuses it)."""
        w, metas = bp_meta
        C = len(chunk)
        tb = np.fromiter((metas[i][0] for i in chunk), np.int64, C)
        first_rel, nb = window_geometry(tb, m, w)
        NW = max_len // max(w, 1) + 2
        if len(parts) == 1:
            ops, score, fi, fj = parts[0]
            return [breaking_points(ops, nd, md,
                                    to_global(None, first_rel, self.device),
                                    to_global(None, nb, self.device),
                                    w=w, NW=NW)
                    + (score, fi, fj)]
        b = len(n) // len(parts)
        out: list = [None] * len(parts)
        for k, part in enumerate(parts):
            if part is None:   # another process's slot
                continue
            ops, score, fi, fj = part
            dev = ops.device
            sl = slice(k * b, (k + 1) * b)
            lanes = [to_global(None, a[sl], dev)
                     for a in (n, m, first_rel, nb)]
            out[k] = (breaking_points(ops, *lanes, w=w, NW=NW)
                      + (score, fi, fj))
        return out

    def _shadow_chunk(self, qrp, tp, n, m, parts, *, max_len: int,
                      band: int, bits: int, steps: int) -> None:
        """The sanitizer's K1 shadow of a K4 chunk: the same rows through
        the int32 forward pass and the same walk (sharded alike under a
        mesh, each shard building its rows again from the same blocks);
        the merged ``ops_packed``, ``score``, ``fi`` and ``fj`` must equal
        bit for bit. The K4 pass's direction rows are released before this
        runs, so the two passes never hold two chunks' rows at once."""
        shadow = self._dispatch(qrp, tp, n, m, max_len=max_len, band=band,
                                bits=bits, steps=steps, packed16=False)
        metrics.inc("align.shadow_chunks")
        sanitize.shadow_compare(
            self._merged(parts), self._merged(shadow),
            ("ops_packed", "score", "fi", "fj"),
            f"aligner K4 chunk (max_len={max_len}, band={band}, "
            f"steps={steps})")

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host, counted in ``fetched_bytes``."""
        out = t.cpu().numpy()
        self.stats["fetched_bytes"] += out.nbytes
        return out

    def _finish_chunk(self, launched, band, results, reject,
                      bp_meta=None, resident=False) -> None:
        """:meth:`_finish_chunk_impl` as the fault site and span
        ``align.fetch`` (it waits for the device)."""
        faults.check("align.fetch")
        with obs.span("align.fetch", pairs=len(launched[0]), band=band):
            self._finish_chunk_impl(launched, band, results, reject,
                                    bp_meta, resident)

    def _finish_chunk_impl(self, launched, band, results, reject,
                           bp_meta=None, resident=False) -> None:
        """Fetch a launched chunk and resolve its pairs into ``results``
        (CIGARs, or breaking-point rows with ``bp_meta``); the pairs that
        fail the accept gate go to ``reject``."""
        if bp_meta is not None:
            self._finish_chunk_bp(launched, band, results, reject, bp_meta,
                                  resident)
            return
        chunk, pairs, n, m, (ops_d, score_d, fi_d, fj_d), _ = launched
        C = len(chunk)
        ops_packed = self._fetch(ops_d[:C])
        score, fi, fj = self._fetch(torch.stack([score_d[:C], fi_d[:C],
                                                 fj_d[:C]]))
        if sanitize.enabled():
            sanitize.check_aligner_canaries(
                score, fi, fj, big=1 << 28,
                context=f"aligner chunk (band={band})")
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
                         bp_meta, resident=False) -> None:
        """Breaking-points finish: fetch the chunk's two ``[C, NW]`` tables
        and its gate scalars in one copy, apply the accept gate, and decode
        every accepted pair's rows in one vectorized pass.

        With ``resident`` the tables stay on the device: only the gate
        scalars (12 bytes a pair) are fetched, and each accepted pair
        resolves to a :class:`_DevBp` handle into one :class:`_DevChunkBp`
        of the chunk."""
        chunk, _, n, m, (bp_first, bp_last, score, fi, fj), max_len = \
            launched
        w, metas = bp_meta
        C = len(chunk)
        NW = bp_first.shape[1]
        gate = torch.stack([score[:C], fi[:C], fj[:C]], 1)
        host = self._fetch(gate if resident else torch.cat(
            [bp_first[:C], bp_last[:C], gate], 1))
        g0 = 0 if resident else 2 * NW
        if sanitize.enabled():
            sanitize.check_aligner_canaries(
                host[:, g0], host[:, g0 + 1], host[:, g0 + 2],
                big=1 << 28, context=f"aligner bp chunk (band={band})")
        n_h = n[:C].astype(np.int64)
        m_h = m[:C].astype(np.int64)
        score_h = host[:, g0].astype(np.int64)
        clean = (host[:, g0 + 1] == 0) & (host[:, g0 + 2] == 0)
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
        if resident:
            # a process group's merge leaves the tables on the host
            devc = _DevChunkBp(bp_first.to(self.device),
                               bp_last.to(self.device), w, max_len)
            # the gate scalars crossed the link, the two [B, NW] int32
            # tables of the padded batch did not
            metrics.inc("dataflow.bytes_fetched", 12 * C)
            metrics.inc("dataflow.bytes_avoided", 8 * devc.B * devc.NW)
            for k, idx in enumerate(chunk):
                if accept[k]:
                    results[idx] = _DevBp(devc, k, int(tb[k]), int(qo[k]),
                                          int(n_reg[k]), int(n[k]))
                    self.stats["device"] += 1
                else:
                    reject.append(idx)
            return
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
    """Ragged streaming align session (``racon_tpu.ops.nw._AlignStream``).

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
    bytes at once.

    In resident mode (breaking-points mode only) accepted chunks keep
    their tables on the device and resolve to :class:`_DevBp` handles; the
    host-fallback pairs are the dataflow's ``fallback_pairs``."""

    def __init__(self, eng: CudaAligner, window_length=None, progress=None,
                 total_hint: int = 0, resident: bool = False):
        self.eng = eng
        self.w = window_length             # None -> CIGAR mode
        self.resident = bool(resident) and window_length is not None
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
                          self._bp_meta(), self.resident)
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
        if self.resident and self.reject:
            # band and length escapes decode on the host
            metrics.inc("dataflow.fallback_pairs", len(self.reject))
        self.eng._resolve_rejects(self.pairs, self.reject, self.results,
                                  self._bp_meta())
        for slot in self.reject:
            self.pairs.pop(slot, None)
            self.metas.pop(slot, None)
        if self.progress is not None:
            total = max(self.total_hint, len(self.results))
            self.progress(total, total)
        return self.results
