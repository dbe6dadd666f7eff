"""Stage-timing logger with a 20-bin progress bar (copy of the parts of
``racon_tpu.utils.logger`` the CLI needs, same stderr format).

Stage wall-times via paired ``log()`` calls, the 20-bin progress bar via
``bar()``/``bar_to()``, and a ``total()`` summary — the observable
behaviour of the reference's vendored ``logger`` library.
"""

from __future__ import annotations

import sys
import time


def warn(message: str) -> None:
    """Process-wide warning line on stderr (stdout carries the FASTA)."""
    print(f"[racon_tpu] warning: {message}", file=sys.stderr)


class Logger:
    """Wall-clock stage logger writing to stderr.

    ``log()`` with no message starts (or restarts) a stage timer;
    ``log(msg)`` prints ``msg`` and the elapsed stage time.
    ``bar(msg)`` advances a 20-bin progress bar on the same line.
    ``total(msg)`` prints time since construction.
    """

    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stderr
        self._origin = time.perf_counter()
        self._stage_start = self._origin
        self._bar_bins = 0
        self._bar_abs = 0

    def log(self, message: str | None = None) -> None:
        now = time.perf_counter()
        if message is None:
            self._stage_start = now
            return
        print(f"{message} {now - self._stage_start:.6f} s", file=self._stream)

    def bar(self, message: str) -> None:
        self._bar_bins = min(self._bar_bins + 1, 20)
        fill = "=" * self._bar_bins + ">" + " " * (20 - self._bar_bins)
        pct = self._bar_bins * 5
        end = "\n" if self._bar_bins == 20 else "\r"
        print(f"{message} [{fill}] {pct}%", file=self._stream, end=end)
        self._stream.flush()
        if self._bar_bins == 20:
            self._bar_bins = 0
            self._stage_start = time.perf_counter()

    def bar_to(self, message: str, done: int, total: int) -> None:
        """Advance the bar to ``20 * done / total`` bins (batched stages
        report chunk completions, so the bar may jump several bins)."""
        target = min(20, (20 * done) // max(1, total))
        while self._bar_abs < target:
            self._bar_abs += 1
            self.bar(message)
        if target >= 20:
            self._bar_abs = 0  # stage complete; next stage starts fresh

    def total(self, message: str) -> None:
        now = time.perf_counter()
        print(f"{message} {now - self._origin:.6f} s", file=self._stream)
