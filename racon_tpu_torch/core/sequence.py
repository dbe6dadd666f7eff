"""Sequence domain object.

Behavioural spec from the reference's ``src/sequence.cpp``:
- data uppercased on ingest (``sequence.cpp:24-27``);
- FASTQ quality kept only if any base exceeds '!' (``sequence.cpp:34-41``);
- lazy reverse complement (A<->T, C<->G, others unchanged) and reversed
  quality (``sequence.cpp:49-84``);
- ``transmute(has_name, has_data, has_reverse_data)`` frees unused fields and
  materializes the reverse complement when needed (``sequence.cpp:86-100``).
"""

from __future__ import annotations

from typing import Optional

_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


class Sequence:
    __slots__ = ("name", "data", "quality", "_reverse_complement", "_reverse_quality")

    def __init__(self, name: bytes, data: bytes, quality: Optional[bytes] = None):
        if isinstance(name, str):
            name = name.encode()
        if isinstance(data, str):
            data = data.encode()
        if isinstance(quality, str):
            quality = quality.encode()
        self.name = name
        self.data = data.upper()
        # Drop all-'!' placeholder qualities (minimap2 -Q emits those).
        if quality is not None and any(q != 0x21 for q in quality):
            self.quality: Optional[bytes] = quality
        else:
            self.quality = None
        self._reverse_complement: Optional[bytes] = None
        self._reverse_quality: Optional[bytes] = None

    def __len__(self) -> int:
        return len(self.data)

    @property
    def reverse_complement(self) -> bytes:
        if self._reverse_complement is None:
            self.create_reverse_complement()
        return self._reverse_complement  # type: ignore[return-value]

    @property
    def reverse_quality(self) -> Optional[bytes]:
        if self._reverse_complement is None:
            self.create_reverse_complement()
        return self._reverse_quality

    def create_reverse_complement(self) -> None:
        if self._reverse_complement is not None:
            return
        # bytes.translate + flip: byte-identical to the JAX package's numpy
        # LUT take and faster on the main path's reads; the take's release
        # of the GIL bought a transmute thread pool no speed-up (PERF.md §6,
        # PR 13), so the polisher transmutes serially
        self._reverse_complement = self.data.translate(_COMPLEMENT)[::-1]
        self._reverse_quality = (self.quality[::-1]
                                 if self.quality is not None else None)

    def release(self) -> None:
        """Drop every byte payload (data, quality, reverse complement),
        keeping the name: the shard runner's eviction hook, once a read's
        window layers hold their own copies of its spans."""
        self.data = b""
        self.quality = None
        self._reverse_complement = None
        self._reverse_quality = None

    def transmute(self, has_name: bool, has_data: bool, has_reverse_data: bool) -> None:
        if not has_name:
            self.name = b""
        if has_reverse_data:
            self.create_reverse_complement()
        if not has_data:
            self.data = b""
            self.quality = None
