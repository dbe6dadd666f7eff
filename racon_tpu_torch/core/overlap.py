"""Overlap domain object: one read <-> target mapping.

Behavioural spec from the reference's ``src/overlap.cpp``:
- three input formats with distinct constructors (MHAP ``overlap.cpp:15-27``,
  PAF ``overlap.cpp:29-42``, SAM incl. CIGAR clip handling and strand flip
  ``overlap.cpp:44-108``);
- ``error = 1 - min(qspan, tspan) / max(qspan, tspan)``;
- ``transmute`` resolves names/ids to indices in the loaded sequence set and
  validates lengths (``overlap.cpp:129-177``);
- breaking points: the CIGAR walk emitting per-window (first-match,
  last-match) coordinate pairs (``overlap.cpp:179-292``) runs in
  ``native/bp.cpp`` (:func:`decode_breaking_points_batch`).

Breaking points are carried **columnar**: ``Overlap.breaking_points`` is an
int32 ndarray of shape (k, 4) — one row ``(t_first, q_first, t_end_excl,
q_end_excl)`` per window region — or ``None`` before derivation. The
host decode batches whole CIGAR sets (from the device aligner, the host
aligner or SAM input) through the native extension
(``native.bp_from_cigar_batch``), and the polisher's window build consumes
the concatenated rows vectorized.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils.cigar import parse_cigar


def decode_breaking_points_batch(cigars, q_offs, t_begins, t_ends,
                                 window_length: int,
                                 num_threads: int = 1) -> List["np.ndarray"]:
    """CIGAR -> columnar breaking-point rows for a whole overlap batch, on
    the native thread-pool decoder (``native/bp.cpp``; row-identical to
    the reference's per-base walk)."""
    from .. import native

    return native.bp_from_cigar_batch(cigars, q_offs, t_begins, t_ends,
                                      window_length, num_threads)


class Overlap:
    __slots__ = (
        "q_name", "q_id", "q_begin", "q_end", "q_length",
        "t_name", "t_id", "t_begin", "t_end", "t_length",
        "strand", "length", "error", "cigar",
        "is_valid", "is_transmuted", "breaking_points",
    )

    def __init__(self):
        self.q_name: Optional[bytes] = None
        self.q_id: int = 0
        self.q_begin = self.q_end = self.q_length = 0
        self.t_name: Optional[bytes] = None
        self.t_id: int = 0
        self.t_begin = self.t_end = self.t_length = 0
        self.strand = False
        self.length = 0
        self.error = 0.0
        self.cigar: Optional[str] = None
        self.is_valid = True
        self.is_transmuted = False
        # columnar (k, 4) int32 rows of (t_first, q_first, t_end_excl,
        # q_end_excl), or None before derivation
        self.breaking_points: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ ctors

    @classmethod
    def from_paf(cls, q_name: bytes, q_length: int, q_begin: int, q_end: int,
                 orientation: str, t_name: bytes, t_length: int, t_begin: int,
                 t_end: int) -> "Overlap":
        o = cls()
        o.q_name, o.q_length, o.q_begin, o.q_end = q_name, q_length, q_begin, q_end
        o.t_name, o.t_length, o.t_begin, o.t_end = t_name, t_length, t_begin, t_end
        o.strand = orientation == "-"
        o._set_error(q_end - q_begin, t_end - t_begin)
        return o

    @classmethod
    def from_mhap(cls, a_id: int, b_id: int, a_rc: int, a_begin: int, a_end: int,
                  a_length: int, b_rc: int, b_begin: int, b_end: int,
                  b_length: int) -> "Overlap":
        o = cls()
        o.q_id, o.q_begin, o.q_end, o.q_length = a_id - 1, a_begin, a_end, a_length
        o.t_id, o.t_begin, o.t_end, o.t_length = b_id - 1, b_begin, b_end, b_length
        o.strand = bool(a_rc ^ b_rc)
        o._set_error(o.q_end - o.q_begin, o.t_end - o.t_begin)
        return o

    @classmethod
    def from_sam(cls, q_name: bytes, flag: int, t_name: bytes, pos: int,
                 cigar: bytes) -> "Overlap":
        o = cls()
        o.q_name, o.t_name = q_name, t_name
        o.t_begin = pos - 1
        o.strand = bool(flag & 0x10)
        o.is_valid = not (flag & 0x4)
        cig = cigar.decode() if isinstance(cigar, bytes) else cigar
        o.cigar = cig
        if len(cig) < 2:
            if o.is_valid:
                raise ValueError("missing alignment from SAM record")
            return o
        runs = parse_cigar(cig)
        # leading clip length gives q_begin (overlap.cpp:60-69)
        q_begin = 0
        for n, op in runs:
            if op in ("S", "H"):
                q_begin = n
                break
            if op in ("M", "=", "I", "D", "N", "P", "X"):
                break
        q_aln = q_clip = t_aln = 0
        for n, op in runs:
            if op in ("M", "=", "X"):
                q_aln += n
                t_aln += n
            elif op == "I":
                q_aln += n
            elif op in ("D", "N"):
                t_aln += n
            elif op in ("S", "H"):
                q_clip += n
        o.q_begin = q_begin
        o.q_end = q_begin + q_aln
        o.q_length = q_clip + q_aln
        if o.strand:
            o.q_begin, o.q_end = o.q_length - o.q_end, o.q_length - o.q_begin
        o.t_end = o.t_begin + t_aln
        o._set_error(q_aln, t_aln)
        return o

    @classmethod
    def from_record(cls, rec) -> "Overlap":
        if rec.fmt == "paf":
            qn, ql, qb, qe, strand, tn, tl, tb, te = rec.fields
            return cls.from_paf(qn, ql, qb, qe, strand, tn, tl, tb, te)
        if rec.fmt == "mhap":
            a_id, b_id, _err, _minmers, a_rc, ab, ae, al, b_rc, bb, be, bl = rec.fields
            return cls.from_mhap(a_id, b_id, a_rc, ab, ae, al, b_rc, bb, be, bl)
        if rec.fmt == "sam":
            qn, flag, tn, pos, cig = rec.fields
            return cls.from_sam(qn, flag, tn, pos, cig)
        raise ValueError(f"unknown overlap format {rec.fmt!r}")

    def _set_error(self, q_span: int, t_span: int) -> None:
        self.length = max(q_span, t_span)
        self.error = 1 - min(q_span, t_span) / float(self.length) if self.length else 1.0

    # ------------------------------------------------------------- transmute

    def transmute(self, sequences, name_to_id: Dict[bytes, int],
                  id_to_id: Dict[int, int]) -> None:
        """Resolve names/raw ids to indices into ``sequences``.

        Mirrors ``overlap.cpp:129-177``: queries looked up as name+'q' /
        (id<<1|0), targets as name+'t' / (id<<1|1); length mismatches are
        fatal; unknown names/ids just invalidate the overlap.
        """
        if not self.is_valid or self.is_transmuted:
            return

        if self.q_name is not None:
            key = self.q_name + b"q"
            if key not in name_to_id:
                self.is_valid = False
                return
            self.q_id = name_to_id[key]
            self.q_name = None
        else:
            key = self.q_id << 1 | 0
            if key not in id_to_id:
                self.is_valid = False
                return
            self.q_id = id_to_id[key]

        if self.q_length != len(sequences[self.q_id].data):
            raise ValueError(
                f"unequal lengths in sequence and overlap file for sequence "
                f"{sequences[self.q_id].name!r}")

        if self.t_name is not None:
            key = self.t_name + b"t"
            if key not in name_to_id:
                self.is_valid = False
                return
            self.t_id = name_to_id[key]
            self.t_name = None
        else:
            key = self.t_id << 1 | 1
            if key not in id_to_id:
                self.is_valid = False
                return
            self.t_id = id_to_id[key]

        if self.t_length != 0 and self.t_length != len(sequences[self.t_id].data):
            raise ValueError(
                f"unequal lengths in target and overlap file for target "
                f"{sequences[self.t_id].name!r}")
        self.t_length = len(sequences[self.t_id].data)
        self.is_transmuted = True

    # ------------------------------------------------- breaking points

    def query_span_bytes(self, sequences) -> bytes:
        """The query slice that participates in the alignment (strand-aware).

        Mirrors the pointer selection at ``overlap.cpp:193-197``."""
        seq = sequences[self.q_id]
        if self.strand:
            rc = seq.reverse_complement
            return rc[self.q_length - self.q_end: self.q_length - self.q_begin]
        return seq.data[self.q_begin: self.q_end]

    def target_span_bytes(self, sequences) -> bytes:
        return sequences[self.t_id].data[self.t_begin: self.t_end]
