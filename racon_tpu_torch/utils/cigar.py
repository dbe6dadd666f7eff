"""CIGAR parsing (copy of ``racon_tpu.utils.cigar.parse_cigar``).

The reference manipulates CIGAR strings produced by edlib
(``src/overlap.cpp:205-224``), cudaaligner (``src/cuda/cudaaligner.cpp:101``)
or taken from SAM input (``src/overlap.cpp:44-108``). Ops handled by the
reference's walkers: M/=/X (match-ish), I, D/N, S/H (clips), P.
"""

from __future__ import annotations

from typing import List, Tuple

_OPS = frozenset(b"MIDNSHP=X")


def parse_cigar(cigar: str | bytes) -> List[Tuple[int, str]]:
    """Parse a CIGAR string into ``[(length, op), ...]``."""
    if isinstance(cigar, bytes):
        cigar = cigar.decode()
    runs: List[Tuple[int, str]] = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            runs.append((num, ch))
            num = 0
    return runs
