"""Polisher: the two-phase pipeline driver (initialize -> polish), a lean
copy of ``racon_tpu.core.polisher`` for the port.

``initialize()`` loads the targets, loads the reads (name-deduplicated
against the targets), picks the NGS/TGS window type (mean read length
<= 1000 -> NGS), loads, transmutes and filters the overlaps (error above
the threshold and self overlaps dropped; for contig polishing only the
longest overlap of each query group kept), aligns the overlaps through the
aligner backend and takes their per-window breaking points (computed on the
device by a device aligner, decoded from CIGARs on the host otherwise), and
builds the windows and their columnar layers (min-span 2% of the window
length, mean PHRED quality >= threshold). ``polish()`` runs the consensus
backend over every window and stitches the windows per target with the
reference's ``LN:i/RC:i/XC:f`` tags. ``run()`` pipelines the two: a
producer thread assembles the layers and hands window ranges through a
bounded queue to the consensus engine's streaming session, so groups are
dispatched while later windows are still being built.

Left out of this slice (the JAX package keeps them): the exec/serve/fleet
runners, observability, fault injection, the sanitizer and the queue
watchdog, and the resident dataflow.

``--overlaps auto`` (the literal ``auto`` in place of an overlaps file)
runs the first-party overlapper (``ops/overlap_seed.py``, ``ops/chain.py``)
on the loaded reads and targets and streams its rows into the aligner:
each query group's overlaps are filtered as they arrive and fed to the
device aligner's session in batches, so the device aligns earlier groups
while the host builds later ones (and, once a seed bucket fills a chain
arena, while the device chains later groups; at 1 Mbp and 30x no bucket
fills one, and all chaining is done before the first group comes).
"""

from __future__ import annotations

import enum
import sys
import threading
import time
from queue import Empty, Queue
from typing import Dict, List, Optional

import numpy as np

from ..device import resolve
from ..io import parsers
from ..utils.logger import Logger
from .backends import make_aligner, make_consensus
from .layers import LayerStore
from .overlap import Overlap, decode_breaking_points_batch
from .sequence import Sequence
from .window import Window, WindowType

# fewest windows in a range that Polisher.run() hands the consensus engine
MIN_CHUNK_WINDOWS = 1024


class PolisherType(enum.Enum):
    C = 0  # contig polishing
    F = 1  # fragment (read) error correction


def create_polisher(sequences_path: str, overlaps_path: str, target_path: str,
                    type_: PolisherType = PolisherType.C,
                    window_length: int = 500, quality_threshold: float = 10.0,
                    error_threshold: float = 0.3, trim: bool = True,
                    match: int = 3, mismatch: int = -5, gap: int = -4,
                    num_threads: int = 1, aligner="native",
                    consensus="native",
                    aligner_batches: int = 1, consensus_batches: int = 1,
                    banded: bool = False, device="cuda") -> "Polisher":
    """Factory with the reference's validation rules. ``aligner`` and
    ``consensus`` name a backend (``cuda`` or ``native``) or pass a
    prebuilt engine; ``device`` is where the ``cuda``
    backends run (``cpu`` runs the kernels' plain PyTorch versions)."""
    if not isinstance(type_, PolisherType):
        raise ValueError("invalid polisher type")
    if window_length <= 0:
        raise ValueError("invalid window length")
    for path in (sequences_path, target_path):
        if parsers.sequence_parser_for(path) is None:
            raise ValueError(
                f"file {path} has unsupported format extension (valid: "
                f"{', '.join(parsers.SEQUENCE_EXTENSIONS)})")
    auto = parsers.overlaps_mode(overlaps_path) == "auto"
    if not auto and parsers.overlap_parser_for(overlaps_path) is None:
        raise ValueError(
            f"file {overlaps_path} has unsupported format extension (valid: "
            f"{', '.join(parsers.OVERLAP_EXTENSIONS)}, or the literal "
            f"'auto' for the first-party overlapper)")
    if isinstance(aligner, str):
        aligner = make_aligner(aligner, num_threads,
                               num_batches=aligner_batches, device=device)
    if isinstance(consensus, str):
        consensus = make_consensus(consensus, match, mismatch, gap,
                                   num_threads,
                                   num_batches=consensus_batches,
                                   banded=banded, device=device)
    return Polisher(sequences_path, overlaps_path, target_path, type_,
                    window_length, quality_threshold, error_threshold, trim,
                    num_threads, aligner, consensus,
                    device=resolve(device) if auto else device)


class Polisher:
    def __init__(self, sequences_path, overlaps_path, target_path, type_,
                 window_length, quality_threshold, error_threshold, trim,
                 num_threads, aligner, consensus, device="cuda"):
        self.sequences_path = sequences_path
        self.overlaps_path = overlaps_path
        self.target_path = target_path
        self.type = type_
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.trim = trim
        self.num_threads = num_threads
        self.aligner = aligner
        self.consensus = consensus
        # where the overlapper runs (``--overlaps auto`` only)
        self.device = device
        self.logger = Logger()
        self.sequences: List[Sequence] = []
        self.windows: List[Window] = []
        self.targets_size = 0
        self.targets_coverages: List[int] = []
        self._window_type = WindowType.TGS
        self._dummy_quality = b"!" * window_length
        self._id_to_first_window: Optional[np.ndarray] = None
        self._window_lengths: Optional[np.ndarray] = None
        self._backbone_s = 0.0
        # wall-clock stage times (seconds)
        self.timings: Dict[str, float] = {}

    # ---------------------------------------------------------- initialize

    def initialize(self) -> None:
        if self.windows:
            print("[racon_tpu::Polisher::initialize] warning: "
                  "object already initialized!", file=sys.stderr)
            return
        overlaps = self._initialize_core()
        self.logger.log()
        t0 = time.perf_counter()
        self._assemble_layers(overlaps)
        self.timings["build_windows_s"] = (
            self._backbone_s + time.perf_counter() - t0)
        self.logger.log("[racon_tpu::Polisher::initialize] "
                        "transformed data into windows")

    def _initialize_core(self) -> List[Overlap]:
        """Every initialize phase before the layer assembly: parse, filter
        and transmute, breaking points, backbone windows. Returns the
        overlaps the layers come from."""
        self.logger.log()
        t0 = time.perf_counter()
        if parsers.overlaps_mode(self.overlaps_path) == "auto":
            overlaps = self._generate_overlaps_stream(
                *self._load_sequences(), t0)
        else:
            overlaps = self._load()
            self.timings["parse_s"] = time.perf_counter() - t0
            self.find_overlap_breaking_points(overlaps)
        t0 = time.perf_counter()
        self._build_backbone_windows()
        self._backbone_s = time.perf_counter() - t0
        return overlaps

    def _load(self) -> List[Overlap]:
        """Parse targets, reads and overlaps; filter and transmute."""
        return self._load_overlaps(*self._load_sequences()[1:])

    def _load_sequences(self):
        """Parse the targets, then the reads (deduplicated by name against
        the targets). Returns ``(raw_index, name_to_id, id_to_id,
        has_name, has_data, has_reverse)``: the reads' count, the id maps
        an overlap transmutes through, and the per-sequence flags of the
        transmute."""
        log = self.logger
        t0 = time.perf_counter()
        tparse = parsers.sequence_parser_for(self.target_path)
        self.sequences = [Sequence(r.name, r.data, r.quality)
                          for r in tparse(self.target_path)]
        self.targets_size = len(self.sequences)
        if self.targets_size == 0:
            raise ValueError("empty target sequences set")

        name_to_id: Dict[bytes, int] = {}
        id_to_id: Dict[int, int] = {}
        for i, seq in enumerate(self.sequences):
            name_to_id[seq.name + b"t"] = i
            id_to_id[i << 1 | 1] = i
        has_name = [True] * self.targets_size
        has_data = [True] * self.targets_size
        has_reverse = [False] * self.targets_size
        log.log("[racon_tpu::Polisher::initialize] loaded target sequences")
        log.log()
        t1 = time.perf_counter()
        self.timings["load_targets_s"] = t1 - t0

        sparse = parsers.sequence_parser_for(self.sequences_path)
        raw_index = 0
        total_len = 0
        for rec in sparse(self.sequences_path):
            seq = Sequence(rec.name, rec.data, rec.quality)
            total_len += len(seq.data)
            tid = name_to_id.get(seq.name + b"t")
            if tid is not None:
                existing = self.sequences[tid]
                if (len(seq.data) != len(existing.data) or
                        len(seq.quality or b"")
                        != len(existing.quality or b"")):
                    raise ValueError(
                        f"duplicate sequence {seq.name!r} with unequal data")
                name_to_id[seq.name + b"q"] = tid
                id_to_id[raw_index << 1 | 0] = tid
            else:
                self.sequences.append(seq)
                pos = len(self.sequences) - 1
                name_to_id[seq.name + b"q"] = pos
                id_to_id[raw_index << 1 | 0] = pos
                has_name.append(False)
                has_data.append(False)
                has_reverse.append(False)
            raw_index += 1
        if raw_index == 0:
            raise ValueError("empty sequences set")
        self._window_type = (WindowType.NGS
                             if total_len / raw_index <= 1000
                             else WindowType.TGS)
        log.log("[racon_tpu::Polisher::initialize] loaded sequences")
        log.log()
        self.timings["load_reads_s"] = time.perf_counter() - t1
        return (raw_index, name_to_id, id_to_id, has_name, has_data,
                has_reverse)

    def _load_overlaps(self, name_to_id, id_to_id, has_name, has_data,
                       has_reverse) -> List[Overlap]:
        """Parse, transmute and filter the overlaps file; transmute the
        sequences."""
        log = self.logger
        t2 = time.perf_counter()
        oparse = parsers.overlap_parser_for(self.overlaps_path)
        overlaps = []
        for rec in oparse(self.overlaps_path):
            o = Overlap.from_record(rec)
            o.transmute(self.sequences, name_to_id, id_to_id)
            if o.is_valid:
                overlaps.append(o)
        t3 = time.perf_counter()
        self.timings["load_overlaps_s"] = t3 - t2
        overlaps = self._filter_overlaps(overlaps)
        if not overlaps:
            raise ValueError("empty overlap set")
        for o in overlaps:
            if o.strand:
                has_reverse[o.q_id] = True
            else:
                has_data[o.q_id] = True
        log.log("[racon_tpu::Polisher::initialize] loaded overlaps")
        log.log()
        t4 = time.perf_counter()
        self.timings["filter_s"] = t4 - t3
        self._transmute_all(has_name, has_data, has_reverse)
        self.timings["transmute_s"] = time.perf_counter() - t4
        return overlaps

    def _transmute_all(self, has_name, has_data, has_reverse) -> None:
        """Free what each sequence no longer needs and materialise the
        reverse complements, serially. Departure from the JAX package, on
        purpose: its chunked thread pool relies on numpy releasing the
        GIL, while the port's reverse complement is ``bytes.translate``
        (``sequence.py``), which holds it, and the pool measured slower
        than one thread (PERF.md §6, PR 13). Each sequence is filled in
        place; no torch tensor is touched."""
        for i, seq in enumerate(self.sequences):
            seq.transmute(has_name[i], has_data[i], has_reverse[i])

    def _generate_overlaps_stream(self, raw_index, name_to_id, id_to_id,
                                  has_name, has_data, has_reverse,
                                  t_parse: float) -> List[Overlap]:
        """``--overlaps auto``: the streaming overlap->align handoff
        (``racon_tpu.core.polisher.Polisher._generate_overlaps_stream``).
        The overlapper yields rows per query group; each consecutive
        same-query run goes through the :meth:`_filter_overlaps` sweep as
        it completes, and the kept overlaps feed the aligner in batches of
        512, so the device aligns earlier groups while later ones are
        built (see ``chain.iter_overlap_groups`` for when chaining runs
        ahead too). Kept overlaps accumulate in feed order, which is the
        order a phase barrier would give (the rows' first key is the
        query)."""
        from ..ops import chain
        read_pos = [id_to_id[i << 1] for i in range(raw_index)]
        read_seqs = [self.sequences[p].data for p in read_pos]
        target_seqs = [self.sequences[i].data
                       for i in range(self.targets_size)]
        # read i is target read_self_t[i] (its self hits are dropped), or -1
        read_self_t = np.fromiter(
            (p if p < self.targets_size else -1 for p in read_pos),
            np.int64, raw_index)

        def flush_run(run: List[Overlap]) -> List[Overlap]:
            # one query's run: the filter's sweep over one group
            kept = self._filter_overlaps(run)
            for o in kept:
                if o.strand:
                    has_reverse[o.q_id] = True
                    # the aligner reads the reverse complement before the
                    # transmute below runs
                    self.sequences[o.q_id].create_reverse_complement()
                else:
                    has_data[o.q_id] = True
            return kept

        def batches():
            buf: List[Overlap] = []
            run: List[Overlap] = []
            for rows in chain.iter_overlap_groups(
                    read_seqs, target_seqs, read_self_t,
                    device=self.device):
                for i in range(rows["q_ord"].size):
                    q = int(rows["q_ord"][i])
                    t = int(rows["t_idx"][i])
                    o = Overlap.from_paf(
                        self.sequences[read_pos[q]].name,
                        len(read_seqs[q]),
                        int(rows["q_begin"][i]), int(rows["q_end"][i]),
                        "-" if int(rows["strand"][i]) else "+",
                        self.sequences[t].name, len(target_seqs[t]),
                        int(rows["t_begin"][i]), int(rows["t_end"][i]))
                    o.transmute(self.sequences, name_to_id, id_to_id)
                    if not o.is_valid:
                        continue
                    if run and o.q_id != run[-1].q_id:
                        buf.extend(flush_run(run))
                        run.clear()
                    run.append(o)
                if len(buf) >= 512:
                    yield buf
                    buf = []
            buf.extend(flush_run(run))
            if buf:
                yield buf

        overlaps: List[Overlap] = []
        self.timings["parse_s"] = time.perf_counter() - t_parse
        self.find_overlap_breaking_points(overlaps, feed=batches())
        if not overlaps:
            raise ValueError("empty overlap set")
        self.logger.log("[racon_tpu::Polisher::initialize] generated "
                        "overlaps (first-party overlapper, streamed)")
        self.logger.log()
        t0 = time.perf_counter()
        self._transmute_all(has_name, has_data, has_reverse)
        self.timings["transmute_s"] = time.perf_counter() - t0
        return overlaps

    def _filter_overlaps(self, overlaps: List[Overlap]) -> List[Overlap]:
        """Per-query group filter: drop error > threshold and self
        overlaps; for contig polishing keep only the longest overlap per
        consecutive same-query group (the later one wins length ties)."""
        result: List[Overlap] = []
        i = 0
        while i < len(overlaps):
            j = i
            while j < len(overlaps) and overlaps[j].q_id == overlaps[i].q_id:
                j += 1
            group = [o for o in overlaps[i:j]
                     if o.error <= self.error_threshold and o.q_id != o.t_id]
            if group and self.type == PolisherType.C:
                best = group[0]
                for o in group[1:]:
                    if o.length >= best.length:
                        best = o
                group = [best]
            result.extend(group)
            i = j
        return result

    def find_overlap_breaking_points(self, overlaps: List[Overlap],
                                     feed=None) -> None:
        """Per-window breaking points of every overlap. A device aligner
        (``wants_full_stream``) returns them itself, computed on the
        device; a host aligner returns CIGARs, decoded here like the CIGARs
        of SAM input.

        ``feed`` (``--overlaps auto``) is an iterator of overlap batches
        still being produced: each batch is appended to ``overlaps`` and,
        on a device aligner, fed to its session as it arrives. A host
        aligner has no session, so it drains the feed first and takes the
        barrier path; the bytes are the same either way."""
        log = self.logger
        t0 = time.perf_counter()
        msg = "[racon_tpu::Polisher::initialize] aligning overlaps"
        device = getattr(self.aligner, "wants_full_stream", False)
        if feed is not None and not device:
            for batch in feed:
                overlaps.extend(batch)
            feed = None
        need = [o for o in overlaps
                if not o.cigar and o.breaking_points is None]
        if feed is not None:
            self._align_feed(feed, overlaps, need, log, msg)
        elif device:
            self._align_device(need, log, msg)
        else:
            # host path: bounded slices keep transient span copies small
            chunk = 1024
            for begin in range(0, len(need), chunk):
                part = need[begin:begin + chunk]
                pairs = [(o.query_span_bytes(self.sequences),
                          o.target_span_bytes(self.sequences))
                         for o in part]
                for o, cigar in zip(part, self.aligner.align_batch(pairs)):
                    o.cigar = cigar
                log.bar_to(msg, begin + len(part), len(need))
        self.timings["align_s"] = time.perf_counter() - t0

        # the host CIGARs only (host aligner, SAM input): the device path's
        # breaking points came off the card above
        t0 = time.perf_counter()
        todo = [o for o in overlaps if o.breaking_points is None]
        if todo:
            arrs = decode_breaking_points_batch(
                [o.cigar or "" for o in todo],
                [o.q_length - o.q_end if o.strand else o.q_begin
                 for o in todo],
                [o.t_begin for o in todo], [o.t_end for o in todo],
                self.window_length, self.num_threads)
            for o, arr in zip(todo, arrs):
                o.breaking_points = arr
                o.cigar = None
        self.timings["bp_decode_s"] = time.perf_counter() - t0
        log.log("[racon_tpu::Polisher::initialize] aligned overlaps")

    def _align_device(self, need: List[Overlap], log, msg) -> None:
        """Breaking points of ``need`` from a device aligner
        (``racon_tpu.core.polisher.Polisher._align_need``'s device branch):
        65536-overlap slices feed one ``bp_stream`` session, so chunks
        pipeline across slice boundaries; each pair carries its overlap's
        ``(t_begin, query offset)`` and its ``error`` (the band ladder's
        per-pair estimate). Without a session (``use_ragged=False``) each
        slice goes through ``breaking_points_batch``."""
        chunk = 65536
        sess = self.aligner.bp_stream(
            self.window_length, total=len(need),
            progress=lambda d, t: log.bar_to(msg, d, t))
        for begin in range(0, len(need), chunk):
            part = need[begin:begin + chunk]
            pairs = [(o.query_span_bytes(self.sequences),
                      o.target_span_bytes(self.sequences)) for o in part]
            metas = [(o.t_begin,
                      o.q_length - o.q_end if o.strand else o.q_begin)
                     for o in part]
            errs = [o.error for o in part]
            if sess is not None:
                sess.feed(pairs, metas, errs)
                continue
            bps = self.aligner.breaking_points_batch(
                pairs, metas, self.window_length,
                progress=lambda d, t, base=begin: log.bar_to(
                    msg, base + d, len(need)),
                errors=errs)
            for o, bp in zip(part, bps):
                o.breaking_points = bp
        if sess is not None:
            for o, bp in zip(need, sess.finish()):
                o.breaking_points = bp

    def _align_feed(self, feed, overlaps, need, log, msg) -> None:
        """The streaming half of the overlap->align handoff
        (``racon_tpu.core.polisher.Polisher._align_feed``): each batch off
        the overlapper is fed to the device aligner's session as it
        arrives. ``overlap_feed_s`` is the wall spent waiting on the
        producer (seeding, joining, chaining, filtering). Without a
        session (``use_ragged=False``) the feed is drained and the
        overlaps go through :meth:`_align_device`."""
        sess = self.aligner.bp_stream(
            self.window_length, total=len(need),
            progress=lambda d, t: log.bar_to(msg, d, t))
        feed_wall = 0.0
        t0 = time.perf_counter()
        for batch in feed:
            feed_wall += time.perf_counter() - t0
            overlaps.extend(batch)
            part = [o for o in batch
                    if not o.cigar and o.breaking_points is None]
            if part:
                need.extend(part)
                if sess is not None:
                    sess.feed([(o.query_span_bytes(self.sequences),
                                o.target_span_bytes(self.sequences))
                               for o in part],
                              [(o.t_begin, o.q_length - o.q_end
                                if o.strand else o.q_begin)
                               for o in part],
                              [o.error for o in part])
            t0 = time.perf_counter()
        if sess is not None:
            for o, bp in zip(need, sess.finish()):
                o.breaking_points = bp
        else:
            self._align_device(need, log, msg)
        self.timings["overlap_feed_s"] = feed_wall

    # ------------------------------------------------------- window build

    def _build_backbone_windows(self) -> None:
        """Slice every target into backbone windows (layer 0)."""
        window_length = self.window_length
        id_to_first = np.zeros(self.targets_size + 1, dtype=np.int64)
        win_lens: List[int] = []
        for i in range(self.targets_size):
            target = self.sequences[i]
            data = target.data
            quality = target.quality
            k = 0
            for j in range(0, len(data), window_length):
                length = min(j + window_length, len(data)) - j
                q = (self._dummy_quality[:length] if quality is None
                     else quality[j:j + length])
                self.windows.append(Window(i, k, self._window_type,
                                           data[j:j + length], q))
                win_lens.append(length)
                k += 1
            id_to_first[i + 1] = id_to_first[i] + k
        self._id_to_first_window = id_to_first
        self._window_lengths = np.asarray(win_lens, dtype=np.int64)

    def _layer_refs(self, overlaps: List[Overlap]):
        """Per-overlap oriented (data, quality) references into the reads."""
        data_refs: List[bytes] = []
        qual_refs: List[Optional[bytes]] = []
        for o in overlaps:
            seq = self.sequences[o.q_id]
            if o.strand:
                data_refs.append(seq.reverse_complement)
                qual_refs.append(seq.reverse_quality)
            else:
                data_refs.append(seq.data)
                qual_refs.append(seq.quality)
        return data_refs, qual_refs

    def _filter_layer_rows(self, qual_refs, counts, bp, pair_ov, t_ids):
        """Min-span, mean-PHRED and window arithmetic over the concatenated
        (P, 4) breaking-point matrix. Returns ``(keep, win_id,
        layer_begin, layer_end)`` aligned with ``bp``'s rows."""
        window_length = self.window_length
        n_ov = len(counts)
        t_first, q_first = bp[:, 0], bp[:, 1]
        t_endx, q_endx = bp[:, 2], bp[:, 3]
        span = q_endx - q_first
        keep = ~(span < 0.02 * window_length)
        # mean PHRED via per-read quality prefix sums (integer sums are
        # exact in float64, so sums/span - 33.0 is the per-layer mean)
        offs = np.zeros(n_ov + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        qthr = self.quality_threshold
        budget = 8 << 20  # quality bytes per slice
        i = 0
        while i < n_ov:
            j, total = i, 0
            while j < n_ov and (j == i or total < budget):
                if qual_refs[j] is not None:
                    total += len(qual_refs[j])
                j += 1
            if total:
                base = np.full(j - i, -1, dtype=np.int64)
                parts = []
                pos = 0
                for k in range(i, j):
                    qual = qual_refs[k]
                    if qual is None:
                        continue
                    base[k - i] = pos
                    parts.append(np.frombuffer(qual, dtype=np.uint8))
                    pos += len(qual)
                csum = np.zeros(pos + 1, dtype=np.int64)
                np.cumsum(np.concatenate(parts), dtype=np.int64,
                          out=csum[1:])
                pair_base = np.repeat(base, counts[i:j])
                sel = np.flatnonzero(pair_base >= 0) + int(offs[i])
                shift = pair_base[pair_base >= 0]
                sums = (csum[q_endx[sel] + shift]
                        - csum[q_first[sel] + shift])
                keep[sel] &= (sums / span[sel] - 33.0) >= qthr
            i = j
        rank = t_first // window_length
        win_id = self._id_to_first_window[t_ids[pair_ov]] + rank
        layer_begin = t_first - rank * window_length
        layer_end = t_endx - rank * window_length - 1
        keep &= layer_begin != layer_end
        return keep, win_id, layer_begin, layer_end

    def _assemble_layers(self, overlaps: List[Overlap], emit=None,
                         chunk_windows: int = 0) -> None:
        """Columnar layer assembly: one (P, 4) breaking-point matrix,
        vectorized filters, a stable argsort grouping layers by window
        (layers keep the overlap-stream order inside a window), and one
        :class:`LayerStore` the windows view. With ``emit``, the windows
        are attached ``chunk_windows`` at a time and ``emit(a, b)`` is
        called once windows ``[a, b)`` have their layers."""
        n_ov = len(overlaps)
        n_win = len(self.windows)
        t_ids = np.fromiter((o.t_id for o in overlaps), np.int64, n_ov)
        self.targets_coverages = np.bincount(
            t_ids, minlength=self.targets_size).tolist()
        counts = np.fromiter(
            (0 if o.breaking_points is None else len(o.breaking_points)
             for o in overlaps), np.int64, n_ov)
        if int(counts.sum()) == 0:
            if emit is not None:
                emit(0, n_win)
            return
        bp = np.concatenate(
            [o.breaking_points for o in overlaps
             if o.breaking_points is not None
             and len(o.breaking_points)]).astype(np.int64)
        pair_ov = np.repeat(np.arange(n_ov), counts)
        q_first, q_endx = bp[:, 1], bp[:, 3]
        data_refs, qual_refs = self._layer_refs(overlaps)
        keep, win_id, layer_begin, layer_end = self._filter_layer_rows(
            qual_refs, counts, bp, pair_ov, t_ids)
        kept = np.flatnonzero(keep)
        if kept.size:
            backbone_len = self._window_lengths[win_id[kept]]
            if ((layer_begin[kept] > layer_end[kept])
                    | (layer_end[kept] > backbone_len)).any():
                raise ValueError("layer begin and end positions are invalid")
        order = kept[np.argsort(win_id[kept], kind="stable")]
        store = LayerStore.build(
            data_refs, qual_refs, pair_ov[order], q_first[order],
            q_endx[order], win_id[order], layer_begin[order],
            layer_end[order], n_win)
        bounds = store.row_bounds
        chunk_windows = chunk_windows or max(1, n_win)
        for w0 in range(0, n_win, chunk_windows):
            w1 = min(w0 + chunk_windows, n_win)
            for wi in range(w0, w1):
                r0, r1 = int(bounds[wi]), int(bounds[wi + 1])
                if r1 > r0:
                    self.windows[wi].attach_layers(store, r0, r1)
            if emit is not None:
                emit(w0, w1)
        for o in overlaps:
            o.breaking_points = None

    # -------------------------------------------------------------- polish

    def polish(self, drop_unpolished_sequences: bool = True) -> List[Sequence]:
        log = self.logger
        log.log()
        msg = "[racon_tpu::Polisher::polish] generating consensus"
        t0 = time.perf_counter()
        flags = self.consensus.run(self.windows, self.trim,
                                   progress=lambda d, t: log.bar_to(msg, d, t))
        self.timings["consensus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = self._stitch(flags, drop_unpolished_sequences)
        self.timings["stitch_s"] = time.perf_counter() - t0
        return out

    def run(self, drop_unpolished_sequences: bool = True) -> List[Sequence]:
        """initialize() and polish() pipelined
        (``racon_tpu.core.polisher.Polisher.run``): a producer thread
        assembles the layers (numpy and Python only) and puts each window
        range that has its layers on a bounded queue; this thread feeds
        the ranges to the consensus engine's streaming session (opened at
        the first non-empty range, with the live windows' longest backbone
        as its band hint), or calls ``run`` a range on an engine without
        one. With ``num_threads <= 1``, or once initialized, it is
        initialize() then polish(). The bytes are the same either way.

        Timings besides initialize()'s and polish()'s: ``consensus_s``
        from the first queue read to the end of ``finish()``,
        ``consensus_feed_s`` (the ``feed``/``run`` calls),
        ``consensus_finish_s``, ``queue_wait_s`` and
        ``pipeline_overlap_saved_s`` (layer assembly that did not keep
        the consensus waiting); ``build_windows_s`` counts the producer's
        thread time."""
        if self.windows:
            return self.polish(drop_unpolished_sequences)
        if self.num_threads <= 1:
            self.initialize()
            return self.polish(drop_unpolished_sequences)
        overlaps = self._initialize_core()
        log = self.logger
        log.log()
        n_win = len(self.windows)
        # about one device group's worth of layer pairs a range
        rows = sum(0 if o.breaking_points is None
                   else len(o.breaking_points) for o in overlaps)
        depth = max(1.0, rows / max(1, n_win))
        chunk_windows = max(MIN_CHUNK_WINDOWS, int(
            getattr(self.consensus, "group_pairs_hint", 32768) / depth))
        ranges: Queue = Queue(maxsize=4)
        failure: List[BaseException] = []

        def produce():
            try:
                t_cpu = time.thread_time()
                self._assemble_layers(
                    overlaps, emit=lambda a, b: ranges.put((a, b)),
                    chunk_windows=chunk_windows)
                # thread time: the wall stretches while this thread waits
                # for the interpreter lock or on a full queue
                self.timings["build_windows_s"] = (
                    self._backbone_s + time.thread_time() - t_cpu)
            except BaseException as e:  # raised again on the consumer
                failure.append(e)
            finally:
                ranges.put(None)

        producer = threading.Thread(target=produce, name="racon-layers",
                                    daemon=True)
        producer.start()
        msg = "[racon_tpu::Polisher::polish] generating consensus"
        polished = [False] * n_win
        stream_f = getattr(self.consensus, "stream", None)
        sess, fed = None, []
        queue_wait = feed_s = 0.0
        t_start = time.perf_counter()
        try:
            while True:
                t0 = time.perf_counter()
                item = ranges.get()
                queue_wait += time.perf_counter() - t0
                if item is None:
                    if failure:
                        raise failure[0]
                    break
                a, b = item
                if b > a:
                    t0 = time.perf_counter()
                    if stream_f is not None and sess is None and not fed:
                        band_hint = max(
                            (len(w.backbone) for w in self.windows
                             if w.layer_count >= 2), default=0)
                        sess = stream_f(trim=self.trim, band_hint=band_hint)
                    if sess is not None:
                        sess.feed(self.windows[a:b])
                    else:
                        polished[a:b] = self.consensus.run(
                            self.windows[a:b], self.trim)
                    fed.append((a, b))
                    feed_s += time.perf_counter() - t0
                log.bar_to(msg, b, n_win)
            t0 = time.perf_counter()
            if sess is not None:
                flags = sess.finish()
                pos = 0
                for a, b in fed:
                    polished[a:b] = flags[pos:pos + b - a]
                    pos += b - a
            t_end = time.perf_counter()
        except BaseException:
            # a consensus fault must not leave the producer blocked on the
            # bounded queue: drain it (without blocking: the sentinel may
            # be gone already) and join the thread before raising
            while True:
                try:
                    if ranges.get_nowait() is None:
                        break
                except Empty:
                    if not producer.is_alive():
                        break
                    time.sleep(0.01)
            producer.join()
            raise
        producer.join()
        self.timings.update(
            consensus_s=t_end - t_start, consensus_feed_s=feed_s,
            consensus_finish_s=t_end - t0, queue_wait_s=queue_wait,
            pipeline_overlap_saved_s=max(
                0.0, self.timings["build_windows_s"] - queue_wait))
        log.log("[racon_tpu::Polisher::initialize] "
                "transformed data into windows")
        t0 = time.perf_counter()
        out = self._stitch(polished, drop_unpolished_sequences)
        self.timings["stitch_s"] = time.perf_counter() - t0
        return out

    def _stitch(self, polished_flags: List[bool],
                drop_unpolished_sequences: bool) -> List[Sequence]:
        log = self.logger
        dst: List[Sequence] = []
        polished_data: List[bytes] = []
        num_polished = 0
        for i, window in enumerate(self.windows):
            num_polished += 1 if polished_flags[i] else 0
            polished_data.append(window.consensus)
            last = (i == len(self.windows) - 1 or
                    self.windows[i + 1].rank == 0)
            if last:
                ratio = num_polished / float(window.rank + 1)
                if not drop_unpolished_sequences or ratio > 0:
                    data = b"".join(polished_data)
                    tags = b"r" if self.type == PolisherType.F else b""
                    tags += b" LN:i:%d" % len(data)
                    tags += b" RC:i:%d" % self.targets_coverages[window.id]
                    tags += b" XC:f:%.6f" % ratio
                    dst.append(Sequence(
                        self.sequences[window.id].name + tags, data))
                num_polished = 0
                polished_data = []
        log.log("[racon_tpu::Polisher::polish] generated consensus")
        log.total("[racon_tpu::Polisher::] total =")
        self.windows = []
        self.sequences = []
        return dst
