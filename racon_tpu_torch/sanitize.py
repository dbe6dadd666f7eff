"""Runtime sanitizer (``RACON_TPU_SANITIZE=1``; counterpart of
``racon_tpu/sanitize.py``). Off unless the flag is set:

- **K1 shadow**: a sampled aligner chunk or consensus group whose forward
  pass took the packed int16x2 kernel (K4) runs again through the int32
  kernel (K1), and the outputs are compared bit for bit
  (:class:`ShadowSampler`, :func:`shadow_compare`). ``swar.swar_fits``
  makes a K4 overflow unreachable while it holds; the shadow catches the
  day it stops holding, or a kernel regression. On the card both passes
  are the CUDA kernels.
- **Canaries**: value-range checks on every fetched chunk and group
  (:func:`check_aligner_canaries`, :func:`check_consensus_canaries`).
- **Queue watchdog**: :class:`QueueWatchdog` watches the pipelined
  polish's bounded queue and dumps every thread's stack to stderr when
  neither side moves for the timeout; given an ``escalate_cb`` (the shard
  runner's polishes) it also calls it once a stall outlasts
  ``escalate_after`` timeouts.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Optional, Sequence

import numpy as np

from . import flags
from .obs import metrics
from .utils.logger import warn


class SanitizerError(AssertionError):
    """Base of every sanitizer fault (an AssertionError, so test harnesses
    treat it as a hard failure)."""


class SwarShadowMismatch(SanitizerError):
    """The packed kernel's output diverged from its int32 shadow."""


class CanaryError(SanitizerError):
    """A fetched kernel output broke a value-range invariant."""


def enabled() -> bool:
    """The master switch, read on every call (tests toggle it)."""
    return flags.get_bool("RACON_TPU_SANITIZE")


# ------------------------------------------------------ shadow execution

class ShadowSampler:
    """Which packed chunks (or groups) get a shadow: the first, then every
    ``RACON_TPU_SANITIZE_SAMPLE``-th. One per engine, so every run's first
    chunk is checked; thread-safe."""

    def __init__(self):
        self._seen = 0
        self._lock = threading.Lock()

    def should_shadow(self) -> bool:
        if not enabled():
            return False
        n = max(1, flags.get_int("RACON_TPU_SANITIZE_SAMPLE"))
        with self._lock:
            k = self._seen
            self._seen += 1
        return k % n == 0


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def shadow_compare(packed_out: Sequence, shadow_out: Sequence,
                   names: Sequence[str], context: str) -> None:
    """Bit-exact comparison of a packed-path output tuple (tensors or
    arrays) with its int32 shadow; raises :class:`SwarShadowMismatch`
    naming the first output that differs and on how many lanes."""
    for name, a, b in zip(names, packed_out, shadow_out):
        ah, bh = _host(a), _host(b)
        if ah.shape != bh.shape:
            raise SwarShadowMismatch(
                f"{context}: {name} shape {ah.shape} != shadow {bh.shape}")
        if not np.array_equal(ah, bh):
            bad = int(np.count_nonzero(ah != bh))
            raise SwarShadowMismatch(
                f"{context}: {name} diverged from the int32 shadow on "
                f"{bad}/{ah.size} lanes (a packed-lane overflow or a "
                f"kernel regression: K4 no longer gives K1's bytes)")


# -------------------------------------------------------------- canaries

def check_aligner_canaries(score, fi, fj, *, big: int,
                           context: str) -> None:
    """A fetched aligner chunk: scores in ``[0, big]`` (a wrapped int16
    lane goes negative or past the ceiling), walk endpoints >= 0."""
    s = np.asarray(score)
    if s.size and (int(s.min()) < 0 or int(s.max()) > big):
        raise CanaryError(
            f"{context}: score outside [0, {big}] (min {int(s.min())}, "
            f"max {int(s.max())}) — packed-lane wraparound or kernel "
            f"corruption")
    for name, v in (("fi", fi), ("fj", fj)):
        vh = np.asarray(v)
        if vh.size and int(vh.min()) < 0:
            raise CanaryError(f"{context}: negative walk endpoint {name}")


def check_consensus_canaries(bcodes, blen, covs, *, Lb: int,
                             context: str) -> None:
    """A fetched consensus group: backbone codes in the six-symbol
    alphabet, lengths inside the backbone buffer, coverage >= 0."""
    bc = np.asarray(bcodes)
    if bc.size and int(bc.max()) > 5:
        raise CanaryError(
            f"{context}: backbone code {int(bc.max())} outside the "
            f"ACGTN- alphabet — vote corruption")
    bl = np.asarray(blen)
    if bl.size and (int(bl.min()) < 0 or int(bl.max()) > Lb):
        raise CanaryError(f"{context}: backbone length outside [0, {Lb}]")
    cv = np.asarray(covs)
    if cv.size and int(cv.min()) < 0:
        raise CanaryError(f"{context}: negative coverage count")


# -------------------------------------------------------- queue watchdog

def dump_all_stacks(reason: str, stream=None) -> None:
    """Write every live thread's stack to ``stream`` (stderr)."""
    stream = stream if stream is not None else sys.stderr
    lines = [f"[racon_tpu::sanitize] watchdog: {reason} — "
             f"dumping {threading.active_count()} thread stacks"]
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        lines.extend(ln.rstrip("\n")
                     for ln in traceback.format_stack(frame))
    print("\n".join(lines), file=stream)
    stream.flush()


class QueueWatchdog:
    """Stall monitor of a bounded producer/consumer queue: call
    :meth:`beat` on every put and get; when no beat lands for ``timeout``
    seconds the watchdog dumps every thread's stack once for that stall
    and counts it in ``fired``. Without an ``escalate_cb`` it reports and
    never ends the run. With one, a stall that lasts past ``timeout *
    escalate_after`` calls it once for that stall (counted in
    ``faults.stall_escalations``): the pipelined polish then fails with a
    ``stall``-class fault."""

    def __init__(self, timeout: float, name: str = "queue", stream=None,
                 escalate_cb=None, escalate_after: float = 2.0):
        self.timeout = float(timeout)
        self.name = name
        self.fired = 0
        self._stream = stream
        self._escalate_cb = escalate_cb
        self._escalate_after = max(1.0, float(escalate_after))
        self._last = time.monotonic()
        self._dumped_for_beat = -1.0
        self._escalated_for_beat = -1.0
        self._stop = threading.Event()
        self.stalled = threading.Event()  # set on each dump
        self.escalated = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = time.monotonic()
        self.stalled.clear()

    def start(self) -> "QueueWatchdog":
        self._thread = threading.Thread(
            target=self._watch, name=f"racon-watchdog-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def _watch(self) -> None:
        poll = max(0.01, self.timeout / 4.0)
        while not self._stop.wait(poll):
            last = self._last
            idle = time.monotonic() - last
            if idle > self.timeout and self._dumped_for_beat != last:
                self._dumped_for_beat = last
                self.fired += 1
                warn(f"{self.name} stalled for > {self.timeout:.1f}s")
                dump_all_stacks(f"{self.name} made no progress for "
                                f"{self.timeout:.1f}s", self._stream)
                self.stalled.set()
            if (self._escalate_cb is not None
                    and idle > self.timeout * self._escalate_after
                    and self._escalated_for_beat != last):
                self._escalated_for_beat = last
                metrics.inc("faults.stall_escalations")
                warn(f"{self.name} still stalled after "
                     f"{self.timeout * self._escalate_after:.1f}s — "
                     f"escalating to a stall-class fault")
                try:
                    self._escalate_cb()
                except Exception as e:  # the watchdog thread must go on
                    warn(f"{self.name} stall-escalation callback "
                         f"failed: {type(e).__name__}: {e}")
                self.escalated.set()


def queue_watchdog(name: str,
                   escalate_cb=None) -> Optional[QueueWatchdog]:
    """A started watchdog with the flag's timeout when the sanitizer is
    on, else None (callers beat with ``if wd:``)."""
    if not enabled():
        return None
    return QueueWatchdog(flags.get_float("RACON_TPU_SANITIZE_WATCHDOG_S"),
                         name, escalate_cb=escalate_cb).start()
