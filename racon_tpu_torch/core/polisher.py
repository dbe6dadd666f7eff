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

Every phase is a span of the JAX package's name (``parse.*``,
``overlap.filter``, ``transmute``, ``align``, ``bp.decode``, ``build.*``,
``queue.put``/``queue.get``, ``consensus*``, ``stitch``), the queue
publishes its depth and wait times, and under the sanitizer a watchdog
watches the queue; with ``stall_escalation`` (the shard runner's) a
persistent stall fails the run with a ``stall``-class fault. Left out
(the JAX package keeps them): the serve/fleet hooks.

With ``RACON_TPU_RESIDENT=1`` (the resident dataflow) a device aligner
keeps each accepted chunk's breaking-point tables on its device, the
layer rows of every chunk are derived there, one stable sort by window
runs there, and the layer store is built from the one table fetched
(:meth:`Polisher._assemble_layers_resident`). The store keeps the packed
lane pool uploaded for the derive (``LayerStore.dev_qpw``), so the device
consensus engine gathers each group's lanes from it on the card instead
of uploading host-gathered blocks (``timings["lane_upload_saved_s"]``
prices the uploads it skipped); on ``--overlaps auto`` the minimizer
tables are compacted on the device and the chain arenas are gathered
there from the resident join. The host path is the parity oracle, and
the two precondition bail-outs return to it.

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
from queue import Empty, Full, Queue
from typing import Dict, List, Optional

import numpy as np

from .. import faults, flags, obs, sanitize
from ..device import resolve
from ..io import parsers
from ..obs import metrics
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
                    banded: bool = False, device="cuda", *,
                    mesh=None, window_type=None,
                    prefiltered_overlaps: bool = False,
                    evict_reads: bool = False,
                    stall_escalation: bool = False) -> "Polisher":
    """Factory with the reference's validation rules. ``aligner`` and
    ``consensus`` name a backend (``cuda`` or ``native``) or pass a
    prebuilt engine; ``device`` is where the ``cuda`` backends run
    (``cpu`` runs the kernels' plain PyTorch versions);
    ``mesh`` splits their batches over a device mesh (by default every
    card of a multi-card host, ``backends._auto_mesh``).

    The keyword-only tail is the shard runner's (``racon_tpu_torch.exec``):
    ``window_type`` pins the NGS/TGS heuristic to the whole input's
    decision (a shard's read subset must not flip it);
    ``prefiltered_overlaps`` marks an overlaps file as already globally
    filtered (the runner's index replayed the per-query-group filter over
    the whole file; running it again on a shard's lines could merge groups
    the whole file keeps apart); ``evict_reads`` releases the read
    payloads once the window layers hold their copies; and
    ``stall_escalation`` lets the sanitizer's queue watchdog fail a
    persistently stalled ``run()`` with :class:`faults.StallError`, which
    the runner's ladder handles (a plain run only dumps the stacks)."""
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
                               num_batches=aligner_batches, device=device,
                               mesh=mesh)
    if isinstance(consensus, str):
        consensus = make_consensus(consensus, match, mismatch, gap,
                                   num_threads,
                                   num_batches=consensus_batches,
                                   banded=banded, device=device, mesh=mesh)
    return Polisher(sequences_path, overlaps_path, target_path, type_,
                    window_length, quality_threshold, error_threshold, trim,
                    num_threads, aligner, consensus,
                    device=resolve(device) if auto else device,
                    window_type=window_type,
                    prefiltered_overlaps=prefiltered_overlaps,
                    evict_reads=evict_reads,
                    stall_escalation=stall_escalation)


class Polisher:
    def __init__(self, sequences_path, overlaps_path, target_path, type_,
                 window_length, quality_threshold, error_threshold, trim,
                 num_threads, aligner, consensus, device="cuda",
                 window_type=None, prefiltered_overlaps=False,
                 evict_reads=False, stall_escalation=False):
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
        # the shard runner's hooks (see create_polisher)
        self._window_type_override = window_type
        self.prefiltered_overlaps = prefiltered_overlaps
        self.evict_reads = evict_reads
        self.stall_escalation = stall_escalation
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
        # the resident dataflow: accepted breaking points stay on the
        # aligner's device, layer rows derive there and the consensus
        # gathers its lanes there; _resident_info holds the pool upload's
        # bytes and seconds (they price the lane uploads skipped)
        self._resident = flags.get_bool("RACON_TPU_RESIDENT")
        self._resident_info: Dict[str, float] = {}

    # ---------------------------------------------------------- initialize

    def initialize(self) -> None:
        if self.windows:
            print("[racon_tpu::Polisher::initialize] warning: "
                  "object already initialized!", file=sys.stderr)
            return
        overlaps = self._initialize_core()
        self.logger.log()
        t0 = time.perf_counter()
        with obs.span("build.windows"):
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
        with obs.span("build.backbone"):
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
        with obs.span("parse.targets"):
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

        with obs.span("parse.reads"):
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
                        raise ValueError(f"duplicate sequence "
                                         f"{seq.name!r} with unequal data")
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
        if self._window_type_override is not None:
            self._window_type = self._window_type_override
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
        with obs.span("parse.overlaps"):
            oparse = parsers.overlap_parser_for(self.overlaps_path)
            overlaps = []
            for rec in oparse(self.overlaps_path):
                o = Overlap.from_record(rec)
                o.transmute(self.sequences, name_to_id, id_to_id)
                if o.is_valid:
                    overlaps.append(o)
        t3 = time.perf_counter()
        self.timings["load_overlaps_s"] = t3 - t2
        with obs.span("overlap.filter"):
            if not self.prefiltered_overlaps:
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
        with obs.span("transmute"):
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
        metrics.set_gauge("overlap.mode_auto", 1)
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
            with obs.span("overlap.filter"):
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
                    resident=self._resident, device=self.device):
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
        # the dispatch/fetch split of this run from the span timers: the
        # calling thread's metric scope (a service job's) and timer prefix
        # (a chip worker's device.<ordinal>.) keep concurrent runs of one
        # process apart
        scope = ((metrics.get_scope() or "")
                 + (obs.trace.get_timer_prefix() or ""))
        t_disp0 = metrics.timer_s(scope + "align.dispatch")
        t_fetch0 = metrics.timer_s(scope + "align.fetch")
        with obs.span("align", pairs=len(need)):
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
                    for o, cigar in zip(part,
                                        self.aligner.align_batch(pairs)):
                        o.cigar = cigar
                    log.bar_to(msg, begin + len(part), len(need))
        self.timings["align_s"] = time.perf_counter() - t0
        self.timings["align_dispatch_s"] = round(
            metrics.timer_s(scope + "align.dispatch") - t_disp0, 3)
        self.timings["align_fetch_s"] = round(
            metrics.timer_s(scope + "align.fetch") - t_fetch0, 3)

        # the host CIGARs only (host aligner, SAM input): the device path's
        # breaking points came off the card above
        t0 = time.perf_counter()
        with obs.span("bp.decode"):
            todo = [o for o in overlaps if o.breaking_points is None]
            if todo and self._resident:
                # SAM CIGARs and a host aligner's: the resident dataflow's
                # host-decoded share
                metrics.inc("dataflow.fallback_pairs", len(todo))
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
            progress=lambda d, t: log.bar_to(msg, d, t),
            resident=self._resident)
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
            progress=lambda d, t: log.bar_to(msg, d, t),
            resident=self._resident)
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
        if self._resident and self._assemble_layers_resident(
                overlaps, emit, chunk_windows):
            return
        n_ov = len(overlaps)
        n_win = len(self.windows)
        t_ids = np.fromiter((o.t_id for o in overlaps), np.int64, n_ov)
        self.targets_coverages = np.bincount(
            t_ids, minlength=self.targets_size).tolist()
        counts = np.fromiter(
            (0 if o.breaking_points is None else len(o.breaking_points)
             for o in overlaps), np.int64, n_ov)
        if int(counts.sum()) == 0:
            self._evict_reads()
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
        with obs.span("build.store", rows=int(order.size)):
            store = LayerStore.build(
                data_refs, qual_refs, pair_ov[order], q_first[order],
                q_endx[order], win_id[order], layer_begin[order],
                layer_end[order], n_win)
        self._attach_layers(store, overlaps, emit, chunk_windows)

    def _attach_layers(self, store: LayerStore, overlaps: List[Overlap],
                       emit, chunk_windows: int) -> None:
        """Give every window its rows of ``store``, ``chunk_windows`` at a
        time, calling ``emit(a, b)`` once windows ``[a, b)`` have theirs;
        then drop the overlaps' breaking points and, with ``evict_reads``,
        the reads."""
        n_win = len(self.windows)
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
        self._evict_reads()

    def _assemble_layers_resident(self, overlaps: List[Overlap], emit,
                                  chunk_windows: int) -> bool:
        """The resident layer assembly
        (``racon_tpu.core.polisher.Polisher._assemble_layers_resident``):
        the layer rows of every align chunk are derived on the aligner's
        device from its resident tables (``nw.derive_layer_rows``), the
        host-fallback pairs' rows go through :meth:`_filter_layer_rows`,
        one stable sort by window runs on the device, and the one table
        fetched becomes the :class:`LayerStore`. The same bytes as the host
        path: the derive is that filter in integer form.

        Returns True when it built the layers. Returns False, after
        decoding every device handle on the host so that the host body
        sees plain rows, when there is no handle (a host aligner, SAM
        input) or a precondition of the integer forms fails: a quality
        threshold that is fractional or outside [0, 2^20), or a quality
        byte below 33. Each such bail-out is counted and logged."""
        from ..ops import nw
        dev = [(i, o.breaking_points) for i, o in enumerate(overlaps)
               if getattr(o.breaking_points, "is_device_resident", False)]
        if not dev:
            return False

        def bail(reason: str) -> bool:
            metrics.inc("dataflow.resident_bailouts")
            metrics.set_gauge("dataflow.resident", 0)
            self.logger.log(
                f"[racon_tpu::Polisher::initialize] resident dataflow "
                f"falling back to host assembly ({reason})")
            for i, h in dev:
                overlaps[i].breaking_points = h.decode_host()
            return False

        qthr = self.quality_threshold
        if not float(qthr).is_integer() or not 0 <= qthr < (1 << 20):
            return bail("non-integer quality threshold")
        n_ov = len(overlaps)
        n_win = len(self.windows)
        t_ids = np.fromiter((o.t_id for o in overlaps), np.int64, n_ov)
        self.targets_coverages = np.bincount(
            t_ids, minlength=self.targets_size).tolist()
        data_refs, qual_refs = self._layer_refs(overlaps)
        # every overlap pooled up front: a superset of the host path's
        # pool of kept rows, with the same bytes for every row
        t_store = time.thread_time()
        with obs.span("build.store", rows=n_ov):
            (pool, qpool, qpw_pool, ov_off, hq_ov,
             has_q_base) = LayerStore._build_pool(
                data_refs, qual_refs, np.arange(n_ov))
        self.timings["layer_store_s"] = time.thread_time() - t_store
        if has_q_base.any() and int(qpool[has_q_base].min()) < 33:
            return bail("quality bytes below phred+33")

        t_derive = time.perf_counter()
        device = dev[0][1].chunk.bp_first.device
        t_up = time.perf_counter()
        dev_pool = nw.upload_qpw_pool(qpw_pool, device)
        self._resident_info = {"pool_bytes": float(qpw_pool.nbytes),
                               "upload_s": time.perf_counter() - t_up}
        # an integer >= a real iff >= its ceiling: the host's
        # span < 0.02 * window_length, exactly
        s_min = int(np.ceil(0.02 * self.window_length))
        q_need = int(qthr)
        # one derive a chunk, on full-B lane arrays (dead lanes zeroed);
        # every live lane contributes its chunk's NW-row block
        by_chunk: Dict[int, list] = {}
        for i, h in dev:
            by_chunk.setdefault(id(h.chunk), []).append((i, h))
        parts = []
        starts = np.zeros(n_ov, np.int64)
        cnts = np.zeros(n_ov, np.int64)
        base = 0
        for items in by_chunk.values():
            ch = items[0][1].chunk
            B = ch.B
            live = np.zeros(B, bool)
            has_q = np.zeros(B, bool)
            tb, qo_read, qo_pool, n_reg, win_base, ov_idx, qlen = \
                np.zeros((7, B), np.int64)
            for i, h in items:
                k = h.lane
                live[k] = True
                tb[k] = h.t_begin
                qo_read[k] = h.q_off
                qo_pool[k] = ov_off[i] + h.q_off
                n_reg[k] = h.n_reg
                win_base[k] = self._id_to_first_window[t_ids[i]]
                ov_idx[k] = i
                has_q[k] = hq_ov[i]
                qlen[k] = h.qlen
                starts[i] = base + k * ch.NW
                cnts[i] = ch.NW
            parts.append(ch.derive(dev_pool, live, tb, qo_read, qo_pool,
                                   n_reg, win_base, ov_idx, has_q, qlen,
                                   s_min, q_need))
            base += B * ch.NW

        # the host-fallback pairs (band and length escapes, CIGARs): the
        # host filter over their rows alone
        dev_set = set(i for i, _ in dev)
        counts_host = np.fromiter(
            (0 if (i in dev_set or o.breaking_points is None)
             else len(o.breaking_points)
             for i, o in enumerate(overlaps)), np.int64, n_ov)
        if int(counts_host.sum()):
            bp_h = np.concatenate(
                [overlaps[i].breaking_points
                 for i in np.flatnonzero(counts_host)]).astype(np.int64)
            pair_ov_h = np.repeat(np.arange(n_ov), counts_host)
            keep_h, win_h, lb_h, le_h = self._filter_layer_rows(
                qual_refs, counts_host, bp_h, pair_ov_h, t_ids)
            kidx = np.flatnonzero(keep_h)
            host_flat = np.stack(
                [win_h[kidx], pair_ov_h[kidx], bp_h[kidx, 1],
                 bp_h[kidx, 3], lb_h[kidx], le_h[kidx]],
                axis=1).astype(np.int32)
            host_counts = np.bincount(pair_ov_h[kidx], minlength=n_ov)
        else:
            host_flat = np.zeros((0, 6), np.int32)
            host_counts = np.zeros(n_ov, np.int64)
        cum_host = np.zeros(n_ov + 1, np.int64)
        np.cumsum(host_counts, out=cum_host[1:])
        host_mask = np.ones(n_ov, bool)
        host_mask[list(dev_set)] = False
        starts[host_mask] = base + cum_host[:-1][host_mask]
        cnts[host_mask] = host_counts[host_mask]
        # gather in overlap-stream order (each lane's rows in boundary
        # order, the host rows in theirs), so the device's stable sort is
        # the host path's stable argsort
        total = int(cnts.sum())
        cum0 = np.zeros(n_ov + 1, np.int64)
        np.cumsum(cnts, out=cum0[1:])
        src = (np.repeat(starts, cnts)
               + (np.arange(total, dtype=np.int64)
                  - np.repeat(cum0[:-1], cnts)))
        table = nw.finalize_layer_table(parts, host_flat, src)
        del parts
        self.timings["window_derive_s"] = time.perf_counter() - t_derive
        metrics.set_gauge("dataflow.resident", 1)
        metrics.inc("dataflow.bytes_fetched", int(table.nbytes))

        nkept = int(np.searchsorted(table[:, 0], nw._ROW_SENTINEL))
        rows = table[:nkept].astype(np.int64)
        win_id, ov, q_first, q_endx, layer_begin, layer_end = \
            np.ascontiguousarray(rows.T)
        if nkept and ((layer_begin > layer_end)
                      | (layer_end > self._window_lengths[win_id])).any():
            raise ValueError("layer begin and end positions are invalid")
        store = LayerStore(
            pool, qpool, qpw_pool, ov_off[ov] + q_first, q_endx - q_first,
            layer_begin, layer_end, win_id, hq_ov[ov],
            np.searchsorted(win_id, np.arange(n_win + 1)), dev_qpw=dev_pool)
        self._attach_layers(store, overlaps, emit, chunk_windows)
        return True

    def _evict_reads(self) -> None:
        """With ``evict_reads``: release every read's payload. The layer
        store pooled its own copy of each read span a layer uses, and the
        stitch reads only the targets, so the read bytes are dead from
        here on."""
        if self.evict_reads:
            for seq in self.sequences[self.targets_size:]:
                seq.release()

    # -------------------------------------------------------------- polish

    def polish(self, drop_unpolished_sequences: bool = True) -> List[Sequence]:
        log = self.logger
        log.log()
        msg = "[racon_tpu::Polisher::polish] generating consensus"
        t0 = time.perf_counter()
        # RACON_TPU_TORCH_PROFILE brackets the polish phase in one
        # torch.profiler session (a no-op when unset)
        with obs.span("consensus", windows=len(self.windows)), \
                obs.profile():
            flags = self.consensus.run(
                self.windows, self.trim,
                progress=lambda d, t: log.bar_to(msg, d, t))
        self.timings["consensus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with obs.span("stitch"):
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
        stall_mark = object()

        def escalate():
            # the watchdog's second timeout (stall_escalation only): fail
            # the attempt with a stall-class fault and unblock both sides
            failure.append(faults.StallError(
                "init->polish queue made no progress past the "
                "escalation timeout — failing the attempt with a "
                "stall-class fault"))
            try:
                ranges.get_nowait()
            except Empty:  # graftlint: disable=swallowed-exception (best-effort unblock of a producer)
                pass
            try:
                ranges.put_nowait(stall_mark)
            except Full:  # graftlint: disable=swallowed-exception (best-effort unblock of a consumer)
                pass

        # the sanitizer's stall monitor over the queue: it dumps every
        # thread's stack when neither side moves for its timeout, and with
        # stall_escalation fails the run after a second one (None unless
        # RACON_TPU_SANITIZE)
        watchdog = sanitize.queue_watchdog(
            "init->polish queue",
            escalate_cb=escalate if self.stall_escalation else None)

        def emit_range(a, b):
            if watchdog is not None:
                watchdog.beat()
            t_put = time.perf_counter()
            with obs.span("queue.put"):
                ranges.put((a, b))
            metrics.add_time("queue.producer_wait_s",
                             time.perf_counter() - t_put)
            metrics.set_gauge("queue.depth", ranges.qsize())

        # the metric scope is thread-local: the producer re-applies the
        # caller's, so a service job's queue and layer telemetry lands in
        # the job's scope
        job_scope = metrics.get_scope()

        def produce():
            metrics.set_scope(job_scope)
            try:
                t_cpu = time.thread_time()
                with obs.span("build.windows"):
                    self._assemble_layers(overlaps, emit=emit_range,
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
            with obs.span("consensus", windows=n_win), obs.profile():
                while True:
                    t0 = time.perf_counter()
                    with obs.span("queue.get"):
                        item = ranges.get()
                    dt_get = time.perf_counter() - t0
                    queue_wait += dt_get
                    metrics.add_time("queue.consumer_wait_s", dt_get)
                    metrics.set_gauge("queue.depth", ranges.qsize())
                    if watchdog is not None:
                        watchdog.beat()
                    if item is stall_mark:
                        raise failure[0]
                    if item is None:
                        if failure:
                            raise failure[0]
                        break
                    a, b = item
                    if b > a:
                        t0 = time.perf_counter()
                        if stream_f is not None and sess is None \
                                and not fed:
                            band_hint = max(
                                (len(w.backbone) for w in self.windows
                                 if w.layer_count >= 2), default=0)
                            sess = stream_f(trim=self.trim,
                                            band_hint=band_hint)
                        if sess is not None:
                            with obs.span("consensus.feed", windows=b - a):
                                sess.feed(self.windows[a:b])
                        else:
                            with obs.span("consensus.run", windows=b - a):
                                polished[a:b] = self.consensus.run(
                                    self.windows[a:b], self.trim)
                        fed.append((a, b))
                        feed_s += time.perf_counter() - t0
                    log.bar_to(msg, b, n_win)
                t0 = time.perf_counter()
                if sess is not None:
                    with obs.span("consensus.finish"):
                        flags = sess.finish()
                    pos = 0
                    for a, b in fed:
                        polished[a:b] = flags[pos:pos + b - a]
                        pos += b - a
                t_end = time.perf_counter()
        except BaseException as e:
            # after a stall escalation the producer (or the queue) is
            # wedged: draining would hang again, so the daemon thread is
            # abandoned (it touches only this polisher) and the fault goes
            # to the runner's ladder
            if isinstance(e, faults.StallError):
                raise
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
        finally:
            if watchdog is not None:
                watchdog.stop()
        producer.join()
        self.timings.update(
            consensus_s=t_end - t_start, consensus_feed_s=feed_s,
            consensus_finish_s=t_end - t0, queue_wait_s=queue_wait,
            pipeline_overlap_saved_s=max(
                0.0, self.timings["build_windows_s"] - queue_wait))
        log.log("[racon_tpu::Polisher::initialize] "
                "transformed data into windows")
        t0 = time.perf_counter()
        with obs.span("stitch"):
            out = self._stitch(polished, drop_unpolished_sequences)
        self.timings["stitch_s"] = time.perf_counter() - t0
        return out

    def _stitch(self, polished_flags: List[bool],
                drop_unpolished_sequences: bool) -> List[Sequence]:
        log = self.logger
        # the lane uploads the consensus engine skipped (it gathered from
        # the resident pool), priced at the pool upload's bandwidth
        saved = getattr(self.consensus, "stats", {}).get(
            "lane_upload_saved_bytes", 0)
        if saved:
            info = self._resident_info
            up_s = info.get("upload_s", 0.0)
            bw = info.get("pool_bytes", 0.0) / up_s if up_s else 0.0
            self.timings["lane_upload_saved_s"] = saved / bw if bw else 0.0
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
