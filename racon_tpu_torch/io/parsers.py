"""FASTA/FASTQ/PAF/MHAP/SAM parsers with transparent gzip (the port of
``racon_tpu.io.parsers``).

Every ``parse_*`` goes through the native streaming parser
(``native/parsers.cpp``: chunked inflate through a bounded rolling buffer)
and returns a materialised list. There is no Python fallback: a failed
native build raises ``native.NativeBuildError``. The Python loops
``_parse_*_py`` are the behavioural oracle the tests hold the native
records equal to, field for field, and are called only by name.

Matches bioparser's observable behaviour, as the reference package does:
names are truncated at the first whitespace character, FASTA/FASTQ records
may span multiple lines, gzip is detected by magic bytes, and the
extension lists below choose the format.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, Optional

from .. import native

SEQUENCE_EXTENSIONS = (
    ".fasta", ".fasta.gz", ".fna", ".fna.gz", ".fa", ".fa.gz",
    ".fastq", ".fastq.gz", ".fq", ".fq.gz",
)
FASTQ_EXTENSIONS = (".fastq", ".fastq.gz", ".fq", ".fq.gz")
OVERLAP_EXTENSIONS = (".mhap", ".mhap.gz", ".paf", ".paf.gz", ".sam", ".sam.gz")

# the overlaps argument that runs the first-party overlapper
# (ops/overlap_seed.py + ops/chain.py) instead of reading a file
AUTO_OVERLAPS = "auto"


def is_auto_overlaps(path: str) -> bool:
    """True when ``path`` is the ``auto`` sentinel (no overlaps file)."""
    return path == AUTO_OVERLAPS


def overlaps_mode(path: str) -> str:
    """``auto`` for the sentinel, else ``paf`` (an overlaps file). The
    JAX package's ``RACON_TPU_OVERLAP`` override is not ported."""
    return "auto" if is_auto_overlaps(path) else "paf"


class ParseError(ValueError):
    """A malformed input record, with its file and 1-based line."""

    def __init__(self, path: str, msg: str, line: Optional[int] = None):
        self.path = path
        self.line = line
        self.msg = msg
        loc = path if line is None else f"{path}:{line}"
        super().__init__(f"{loc}: {msg}")


@dataclass
class SequenceRecord:
    name: bytes
    data: bytes
    quality: Optional[bytes] = None  # None for FASTA


@dataclass
class OverlapRecord:
    """Raw fields of one overlap line; interpretation happens in
    ``core.overlap.Overlap``."""
    fmt: str  # "paf" | "mhap" | "sam"
    fields: tuple


def open_maybe_gzip(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        f.close()
        return io.BufferedReader(gzip.open(path))  # type: ignore[arg-type]
    return f


def _first_token(line: bytes) -> bytes:
    return line.split(None, 1)[0] if line else b""


def _native(parse, path: str, arg) -> list:
    """``parse(path, arg)`` of the native module; a malformed record, which
    it reports as a plain ValueError, becomes a ParseError (a failed build,
    NativeBuildError, passes through)."""
    try:
        return parse(path, arg)
    except ValueError as e:
        raise ParseError(path, str(e)) from e


def _sequences(path: str, is_fastq: bool) -> List[SequenceRecord]:
    return [SequenceRecord(n, d, q)
            for n, d, q in _native(native.parse_seqfile, path, is_fastq)]


_OVL_FORMATS = ("paf", "mhap", "sam")  # rt_parse_ovlfile's format codes


def _overlaps(path: str, fmt: str) -> List[OverlapRecord]:
    return [OverlapRecord(fmt, f) for f in
            _native(native.parse_ovlfile, path, _OVL_FORMATS.index(fmt))]


def parse_fasta(path: str) -> List[SequenceRecord]:
    return _sequences(path, False)


def parse_fastq(path: str) -> List[SequenceRecord]:
    """Multi-line-tolerant FASTQ: sequence lines until '+', then quality
    bytes until their length matches the sequence length."""
    return _sequences(path, True)


def parse_paf(path: str) -> List[OverlapRecord]:
    """PAF: qname qlen qstart qend strand tname tlen tstart tend ..."""
    return _overlaps(path, "paf")


def parse_mhap(path: str) -> List[OverlapRecord]:
    """MHAP: aid bid jaccard shared arc astart aend alen brc bstart bend
    blen (space-separated, 1-based ids)."""
    return _overlaps(path, "mhap")


def parse_sam(path: str) -> List[OverlapRecord]:
    """SAM: qname flag rname pos mapq cigar ... (header lines skipped)."""
    return _overlaps(path, "sam")


def _parse_fasta_py(path: str) -> Iterator[SequenceRecord]:
    name = None
    chunks: list = []
    with open_maybe_gzip(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield SequenceRecord(name, b"".join(chunks))
                name = _first_token(line[1:])
                if not name:
                    raise ParseError(path, "FASTA header with an empty "
                                           "sequence name", line=ln)
                chunks = []
            elif name is None:
                raise ParseError(
                    path, f"sequence data before the first FASTA "
                          f"header: {line[:40]!r}", line=ln)
            else:
                chunks.append(line)
        if name is not None:
            yield SequenceRecord(name, b"".join(chunks))


def _parse_fastq_py(path: str) -> Iterator[SequenceRecord]:
    """Multi-line-tolerant FASTQ: sequence lines until '+', then quality
    bytes until their length matches the sequence length."""
    with open_maybe_gzip(path) as f:
        it = iter(f)
        ln = 0

        def nxt():
            nonlocal ln
            line = next(it)
            ln += 1
            return line

        while True:
            try:
                raw = nxt()
            except StopIteration:
                return
            header = raw.rstrip()
            if not header:
                continue
            rec_line = ln
            if not header.startswith(b"@"):
                raise ParseError(
                    path, f"malformed FASTQ header: {header[:40]!r}",
                    line=ln)
            name = _first_token(header[1:])
            seq_chunks = []
            while True:
                try:
                    line = nxt().rstrip()
                except StopIteration:
                    raise ParseError(
                        path, f"truncated FASTQ record for {name!r} "
                              f"(no '+' separator)",
                        line=rec_line) from None
                if line.startswith(b"+"):
                    break
                seq_chunks.append(line)
            data = b"".join(seq_chunks)
            qual_chunks = []
            qlen = 0
            while qlen < len(data):
                try:
                    line = nxt().rstrip()
                except StopIteration:
                    raise ParseError(
                        path, f"truncated FASTQ record for {name!r}",
                        line=rec_line) from None
                qual_chunks.append(line)
                qlen += len(line)
            quality = b"".join(qual_chunks)
            if len(quality) != len(data):
                raise ParseError(
                    path, f"FASTQ quality/sequence length mismatch for "
                          f"{name!r} ({len(quality)} != {len(data)})",
                    line=rec_line)
            yield SequenceRecord(name, data, quality)


def _parse_paf_py(path: str) -> Iterator[OverlapRecord]:
    """PAF: qname qlen qstart qend strand tname tlen tstart tend ..."""
    with open_maybe_gzip(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.rstrip()
            if not line:
                continue
            t = line.split(b"\t")
            try:
                yield OverlapRecord("paf", (
                    t[0], int(t[1]), int(t[2]), int(t[3]),
                    t[4][:1].decode(),
                    t[5], int(t[6]), int(t[7]), int(t[8]),
                ))
            except (IndexError, ValueError, UnicodeDecodeError) as e:
                raise ParseError(
                    path, f"malformed PAF record ({type(e).__name__}): "
                          f"{line[:60]!r}", line=ln) from e


def _parse_mhap_py(path: str) -> Iterator[OverlapRecord]:
    """MHAP: aid bid jaccard shared arc astart aend alen brc bstart bend
    blen (space-separated, 1-based ids)."""
    with open_maybe_gzip(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.rstrip()
            if not line:
                continue
            t = line.split()
            try:
                yield OverlapRecord("mhap", (
                    int(t[0]), int(t[1]), float(t[2]), int(t[3]),
                    int(t[4]), int(t[5]), int(t[6]), int(t[7]),
                    int(t[8]), int(t[9]), int(t[10]), int(t[11]),
                ))
            except (IndexError, ValueError) as e:
                raise ParseError(
                    path, f"malformed MHAP record ({type(e).__name__}): "
                          f"{line[:60]!r}", line=ln) from e


def _parse_sam_py(path: str) -> Iterator[OverlapRecord]:
    """SAM: qname flag rname pos mapq cigar ... (header lines skipped)."""
    with open_maybe_gzip(path) as f:
        for ln, raw in enumerate(f, 1):
            if raw.startswith(b"@"):
                continue
            line = raw.rstrip()
            if not line:
                continue
            t = line.split(b"\t")
            try:
                yield OverlapRecord("sam", (
                    t[0], int(t[1]), t[2], int(t[3]), t[5],
                ))
            except (IndexError, ValueError) as e:
                raise ParseError(
                    path, f"malformed SAM record ({type(e).__name__}): "
                          f"{line[:60]!r}", line=ln) from e


def _has_suffix(path: str, suffixes) -> bool:
    return any(path.endswith(s) for s in suffixes)


def sequence_parser_for(path: str):
    """Extension dispatch for sequence files; None when unsupported."""
    if _has_suffix(path, FASTQ_EXTENSIONS):
        return parse_fastq
    if _has_suffix(path, SEQUENCE_EXTENSIONS):
        return parse_fasta
    return None


def overlap_parser_for(path: str):
    """Extension dispatch for overlap files; None when unsupported."""
    if _has_suffix(path, (".mhap", ".mhap.gz")):
        return parse_mhap
    if _has_suffix(path, (".paf", ".paf.gz")):
        return parse_paf
    if _has_suffix(path, (".sam", ".sam.gz")):
        return parse_sam
    return None
