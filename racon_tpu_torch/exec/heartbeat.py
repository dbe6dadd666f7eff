"""The shard runner's progress line: shard i/N, Mbp/s, peak RSS, lane
occupancy and queue health (the port of ``racon_tpu/exec/heartbeat.py``
without its retrace counters: the port traces nothing).

A thread prints one self-contained line every ``RACON_TPU_HEARTBEAT_S``
seconds (0 turns the timer off), and the runner prints one more at every
shard's end, so the log of a killed run ends on its true position. Every
field is read from the metrics registry: occupancy from the ``align.*``
and ``consensus.*`` counters the engines publish, the queue from the
``queue.*`` metrics of ``Polisher.run()``. The resident service's
heartbeat renders the same fields per running job (their ``scope``
argument reads one job's metric scope).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

from .. import flags, sanitize
from ..obs import metrics


def retrace_summary(scope: str = "") -> str:
    """The JAX heartbeat's per-phase jit retraces: the port traces
    nothing, so the field is empty."""
    return ""


def pack_summary_str(scope: str = "") -> str:
    """Lane occupancy of the consensus groups and the aligner chunks, and
    the overlapper's chain arenas (``o:``); ``-`` before any launch
    (``scope``: one service job's numbers)."""
    pack = metrics.pack_summary(scope)
    parts = []
    if pack["groups"]:
        parts.append(f"{pack['pack_efficiency']:.2f}eff,"
                     f"{pack['windows_per_group']:.0f}w/g,"
                     f"{pack['groups']}g")
    if pack["align_chunks"]:
        parts.append(f"a:{pack['align_pack_efficiency']:.2f}eff,"
                     f"{pack['align_chunks']}c")
    o_total = metrics.counter(scope + "overlap.lanes_total")
    if o_total:
        o_eff = metrics.counter(scope + "overlap.lanes_occupied") / o_total
        parts.append(f"o:{o_eff:.2f}eff")
    return ";".join(parts) if parts else "-"


def queue_summary_str(scope: str = "") -> str:
    """The pipelined polish's queue: its depth and the stall seconds of
    both sides (``-`` before a pipelined run; ``scope``: one service
    job's numbers)."""
    q = metrics.queue_summary(scope)
    if not q["stall_s"] and not q["depth"]:
        return "-"
    return f"d={int(q['depth'])},stall={q['stall_s']:.1f}s"


class Heartbeat:
    """The shard runner's progress reporter."""

    def __init__(self, n_shards: int, stream=None,
                 worker: Optional[str] = None):
        self.n_shards = n_shards
        self.worker = worker
        self._stream = stream if stream is not None else sys.stderr
        self._t0 = time.perf_counter()
        self._lock = sanitize.named_lock("exec.heartbeat")
        self._done = 0
        self._mbp = 0.0
        self._phase = "indexing"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        interval = flags.get_float("RACON_TPU_HEARTBEAT_S")
        if interval > 0:
            self._thread = threading.Thread(
                target=self._tick, args=(interval,),
                name="racon-heartbeat", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def update(self, done: Optional[int] = None,
               phase: Optional[str] = None) -> None:
        with self._lock:
            if done is not None:
                self._done = done
            if phase is not None:
                self._phase = phase

    @staticmethod
    def _short(key: str) -> str:
        """A worker id for display: the slot suffix of an in-process slot
        (``host:123#w1`` -> ``w1``), the whole id otherwise."""
        return key.rsplit("#", 1)[-1]

    def add_mbp(self, mbp: float) -> None:
        """Credit polished megabases (a re-queued shard's retraction is
        negative; the total stays >= 0)."""
        with self._lock:
            self._mbp = max(0.0, self._mbp + mbp)

    def emit(self, tag: str = "heartbeat") -> None:
        with self._lock:
            done, mbp, phase = self._done, self._mbp, self._phase
        dt = max(1e-9, time.perf_counter() - self._t0)
        who = f" [{self.worker}]" if self.worker else ""
        print(f"[racon_tpu::exec] {tag}{who}: "
              f"shard {done}/{self.n_shards} "
              f"({phase}) {mbp:.2f} Mbp in {dt:.1f}s "
              f"({mbp / dt:.4f} Mbp/s) "
              f"peak_rss={metrics.peak_rss_bytes() >> 20}MB "
              f"pack[{pack_summary_str()}] "
              f"queue[{queue_summary_str()}]",
              file=self._stream)
        self._stream.flush()

    def _tick(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.emit()
