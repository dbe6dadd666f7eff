"""Contig -> overlap index: the first pass of a shard run (the port of
``racon_tpu/exec/index.py``).

One forward scan of each input records metadata only (names, byte spans in
the decompressed stream, base counts; never payloads), then walks the
overlaps file replaying the polisher's global filter, so that a shard later
sees exactly the overlaps a single-shot run keeps. The rules it replays,
with their single-shot sources:

- name resolution (``Polisher._load_sequences``): a read whose name matches
  a target collapses onto the target; MHAP queries resolve by file ordinal,
  PAF and SAM queries by name with later duplicates winning;
- validity (``Overlap.transmute``): an unresolvable query or target name
  drops the line before grouping, so invalid lines do not split a group;
- the per-group filter (``Polisher._filter_overlaps``): groups are maximal
  runs of consecutive valid lines of one query; lines with an error above
  the threshold and self overlaps drop inside the group; contig polishing
  keeps the group's longest line, the later one winning a tie.

A shard's polisher runs with ``prefiltered_overlaps=True``: filtering a
shard's subsequence again could merge groups that the whole file keeps
apart and change the best line of a group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import sanitize
from ..core.polisher import PolisherType
from ..core.window import WindowType
from ..io import parsers
from ..utils.cigar import parse_cigar


@dataclass
class OverlapLine:
    """What the global filter needs of one overlap line."""
    start: int
    end: int
    t_idx: int
    q_ord: int        # read-file ordinal of the record the query resolves to
    length: int
    error: float
    is_self: bool


@dataclass
class RunIndex:
    """Everything the planner and the runner need: O(records) metadata."""
    sequences_path: str
    overlaps_path: str
    target_path: str
    overlap_fmt: str                       # "paf" | "mhap" | "sam"
    targets: List[parsers.RecordSpan]
    read_spans: np.ndarray                 # (R, 3) int64: start, end, bases
    read_names: List[bytes]
    window_type: WindowType
    # the kept overlaps in file order (parallel int64 arrays)
    ov_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ov_end: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ov_target: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ov_read: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # a plan made before any overlap exists (``rampler plan`` of an
    # ``auto`` run): the read bases to charge the contigs by their size
    uniform_read_bases: int = 0
    _groups: Optional[dict] = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        self._groups_lock = sanitize.named_lock("exec.index")

    def _contig_groups(self) -> dict:
        """contig index -> kept-overlap indices, file order within each:
        one stable argsort of the whole run (a mask per contig would be
        O(contigs x overlaps), and ``-f`` makes every read a contig)."""
        with self._groups_lock:
            if self._groups is None:
                order = np.argsort(self.ov_target, kind="stable")
                st = self.ov_target[order]
                starts = np.flatnonzero(np.r_[True, np.diff(st) != 0]) \
                    if st.size else np.zeros(0, np.int64)
                bounds = list(starts) + [st.size]
                self._groups = {int(st[a]): order[a:b]
                                for a, b in zip(bounds, bounds[1:])}
            return self._groups

    def lines_of_contig(self, t_idx: int) -> np.ndarray:
        """One contig's kept-overlap indices, in file order."""
        return self._contig_groups().get(t_idx, np.zeros(0, np.int64))

    def contig_overlap_bytes(self) -> np.ndarray:
        """Kept-overlap bytes per contig (a planner cost term)."""
        out = np.zeros(len(self.targets), np.int64)
        np.add.at(out, self.ov_target, self.ov_end - self.ov_start)
        return out

    def contig_read_bytes(self) -> np.ndarray:
        """Bases of the distinct reads per contig (a planner cost term; a
        read two contigs share is charged to both)."""
        if self.uniform_read_bases and not self.ov_read.size:
            # no overlap indexed yet: the read bases in proportion to the
            # contigs' sizes
            tb = np.fromiter((t.bases for t in self.targets), np.int64,
                             len(self.targets))
            return tb * self.uniform_read_bases // max(1, int(tb.sum()))
        out = np.zeros(len(self.targets), np.int64)
        for t, g in self._contig_groups().items():
            out[t] = int(self.read_spans[np.unique(self.ov_read[g]),
                                         2].sum())
        return out


def _overlap_fmt(path: str) -> str:
    parser = parsers.overlap_parser_for(path)
    if parser is parsers.parse_paf:
        return "paf"
    if parser is parsers.parse_mhap:
        return "mhap"
    if parser is parsers.parse_sam:
        return "sam"
    raise ValueError(
        f"file {path} has unsupported format extension (valid: "
        f"{', '.join(parsers.OVERLAP_EXTENSIONS)})")


def _sam_stats(cigar: bytes) -> Tuple[int, int]:
    """(query span, target span) of a SAM CIGAR, as ``Overlap.from_sam``
    counts them."""
    q_aln = t_aln = 0
    for n, op in parse_cigar(cigar.decode()):
        if op in ("M", "=", "X"):
            q_aln += n
            t_aln += n
        elif op == "I":
            q_aln += n
        elif op in ("D", "N"):
            t_aln += n
    return q_aln, t_aln


def _span_error(q_span: int, t_span: int) -> Tuple[int, float]:
    """(length, error) as ``Overlap`` computes them."""
    length = max(q_span, t_span)
    error = 1 - min(q_span, t_span) / float(length) if length else 1.0
    return length, error


def build_index(sequences_path: str, overlaps_path: str, target_path: str,
                type_: PolisherType = PolisherType.C,
                error_threshold: float = 0.3) -> RunIndex:
    """One metadata pass over the three inputs; raises the empty-set
    errors a single-shot ``initialize()`` raises."""
    idx = _scan_sequences(sequences_path, overlaps_path, target_path, "")
    idx.overlap_fmt = _overlap_fmt(overlaps_path)
    targets, read_names = idx.targets, idx.read_names
    # later duplicate target names win, as in the polisher's name map
    target_ids: Dict[bytes, int] = {t.name: i for i, t in enumerate(targets)}
    read_ids: Dict[bytes, int] = {n: i for i, n in enumerate(read_names)}

    lines = _scan_overlaps(overlaps_path, idx.overlap_fmt, targets,
                           target_ids, read_names, read_ids)
    kept = _global_filter(lines, type_, error_threshold)
    if not kept:
        raise ValueError("empty overlap set")

    idx.ov_start = np.fromiter((ln.start for ln in kept), np.int64,
                               len(kept))
    idx.ov_end = np.fromiter((ln.end for ln in kept), np.int64, len(kept))
    idx.ov_target = np.fromiter((ln.t_idx for ln in kept), np.int64,
                                len(kept))
    idx.ov_read = np.fromiter((ln.q_ord for ln in kept), np.int64,
                              len(kept))
    return idx


def _scan_overlaps(path: str, fmt: str, targets, target_ids, read_names,
                   read_ids) -> List[Tuple[Tuple, OverlapLine]]:
    """The valid overlap lines in file order, each with the identity of
    the record its query resolves to (the group key)."""
    out: List[Tuple[Tuple, OverlapLine]] = []
    n_reads = len(read_names)
    for start, end, line in parsers.scan_line_spans(path):
        if not line:
            continue
        if fmt == "sam" and line.startswith(b"@"):
            continue
        if fmt == "mhap":
            f = line.split()
            a_ord, t_idx = int(f[0]) - 1, int(f[1]) - 1
            if not (0 <= a_ord < n_reads) or not (0 <= t_idx < len(targets)):
                continue
            q_name = read_names[a_ord]
            length, error = _span_error(int(f[6]) - int(f[5]),
                                        int(f[10]) - int(f[9]))
            q_ord = a_ord  # MHAP resolves by file ordinal
        else:
            f = line.split(b"\t")
            q_name = f[0]
            if fmt == "paf":
                t_name = f[5]
                length, error = _span_error(int(f[3]) - int(f[2]),
                                            int(f[8]) - int(f[7]))
            else:  # sam
                if int(f[1]) & 0x4:
                    continue  # unmapped: never valid
                t_name = f[2]
                if len(f[5]) < 2:
                    raise ValueError("missing alignment from SAM record")
                length, error = _span_error(*_sam_stats(f[5]))
            q_ord = read_ids.get(q_name, -1)
            t_idx = target_ids.get(t_name, -1)
            if q_ord < 0 or t_idx < 0:
                continue  # unresolvable: invalid before grouping
        # a read named like a target collapses onto the target's record
        tgt = target_ids.get(q_name)
        identity = (("t", tgt) if tgt is not None else ("r", q_ord))
        out.append((identity, OverlapLine(
            start, end, t_idx, q_ord, length, error,
            is_self=identity == ("t", t_idx))))
    return out


def _global_filter(lines, type_: PolisherType,
                   error_threshold: float) -> List[OverlapLine]:
    """``Polisher._filter_overlaps`` over the whole stream."""
    kept: List[OverlapLine] = []

    def flush(group: List[OverlapLine]) -> None:
        passing = [ln for ln in group
                   if ln.error <= error_threshold and not ln.is_self]
        if not passing:
            return
        if type_ == PolisherType.C:
            best = passing[0]
            for ln in passing[1:]:
                if ln.length >= best.length:  # the later line wins ties
                    best = ln
            kept.append(best)
        else:
            kept.extend(passing)

    cur_id: Optional[Tuple] = None
    group: List[OverlapLine] = []
    for identity, line in lines:
        if identity != cur_id:
            flush(group)
            cur_id, group = identity, []
        group.append(line)
    flush(group)
    kept.sort(key=lambda ln: ln.start)  # file order across groups
    return kept


# ------------------------------------------------ --overlaps auto shard runs

def write_auto_paf(sequences_path: str, target_path: str, paf_path: str,
                   device="cuda") -> None:
    """``--overlaps auto`` for a shard run: the first-party overlapper
    (``ops/chain.py``, on ``device``) over the whole input, its rows
    written as a 12-column PAF with an atomic replace. The bytes are the
    same on every run, so a resume's fingerprint (path and size) holds."""
    from ..ops import chain
    from .manifest import atomic_write
    tparse = parsers.sequence_parser_for(target_path)
    sparse = parsers.sequence_parser_for(sequences_path)
    if tparse is None or sparse is None:
        raise ValueError("unsupported sequence format extension")
    target_names: List[bytes] = []
    target_seqs: List[bytes] = []
    for rec in tparse(target_path):
        target_names.append(rec.name)
        target_seqs.append(rec.data)
    target_ids = {n: i for i, n in enumerate(target_names)}
    read_names: List[bytes] = []
    read_seqs: List[bytes] = []
    for rec in sparse(sequences_path):
        read_names.append(rec.name)
        read_seqs.append(rec.data)
    read_self_t = np.fromiter(
        (target_ids.get(n, -1) for n in read_names), np.int64,
        len(read_names))
    rows = chain.find_overlaps(read_seqs, target_seqs, read_self_t,
                               device=device)
    k = chain.resolve_params().k
    lines = chain.paf_bytes(
        rows, read_names,
        np.fromiter((len(s) for s in read_seqs), np.int64, len(read_seqs)),
        target_names,
        np.fromiter((len(s) for s in target_seqs), np.int64,
                    len(target_seqs)), k=k)
    atomic_write(paf_path, b"".join(lines))


def build_index_auto(sequences_path: str, target_path: str, paf_path: str,
                     type_: PolisherType = PolisherType.C,
                     error_threshold: float = 0.3,
                     device="cuda") -> RunIndex:
    """The ``--overlaps auto`` index: the overlapper's PAF written into
    the work dir (kept there for a resume), then indexed like any
    overlaps file, so the filter replay and every byte-span consumer work
    unchanged."""
    if not os.path.isfile(paf_path):
        write_auto_paf(sequences_path, target_path, paf_path, device=device)
    return build_index(sequences_path, paf_path, target_path, type_,
                       error_threshold)


def _scan_sequences(sequences_path: str, overlaps_path: str,
                    target_path: str, fmt: str) -> RunIndex:
    """The index of the targets and the reads (names, spans, bases, the
    window type), with no overlap yet."""
    tscan = parsers.scan_sequence_spans(target_path)
    if tscan is None:
        raise ValueError(f"file {target_path} has unsupported format "
                         f"extension")
    targets = list(tscan)
    if not targets:
        raise ValueError("empty target sequences set")
    rscan = parsers.scan_sequence_spans(sequences_path)
    if rscan is None:
        raise ValueError(f"file {sequences_path} has unsupported format "
                         f"extension")
    read_names: List[bytes] = []
    spans: List[Tuple[int, int, int]] = []
    total_len = 0
    for rec in rscan:
        read_names.append(rec.name)
        spans.append((rec.start, rec.end, rec.bases))
        total_len += rec.bases
    if not read_names:
        raise ValueError("empty sequences set")
    window_type = (WindowType.NGS
                   if total_len / len(read_names) <= 1000 else WindowType.TGS)
    return RunIndex(sequences_path, overlaps_path, target_path, fmt,
                    targets, np.asarray(spans, np.int64).reshape(-1, 3),
                    read_names, window_type)


def build_index_readsonly(sequences_path: str,
                          target_path: str) -> RunIndex:
    """An index of the targets and the reads alone, for planning an
    ``auto`` run before the overlapper has run: no overlap, and
    :attr:`RunIndex.uniform_read_bases` set, so the planner's cost model
    works from the read and target sizes."""
    idx = _scan_sequences(sequences_path, parsers.AUTO_OVERLAPS,
                          target_path, "paf")
    idx.uniform_read_bases = int(idx.read_spans[:, 2].sum())
    return idx
