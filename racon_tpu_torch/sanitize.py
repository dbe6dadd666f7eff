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
- **Lock-order witness**: the named locks (:func:`named_lock`: the shard
  index's and the heartbeat's) become :class:`WitnessedLock`, the
  acquisition-order graph across threads is recorded (one stack per
  first-seen edge), and every cycle, a potential deadlock even where this
  run's interleaving never hung, is printed at process exit with the stack
  of each edge on it. The metrics registry's own lock stays plain: the
  witness publishes through it.
- **Contract audit**: at process exit, the registered metrics this process
  never wrote, and the report keys whose backing metric
  (``contracts.REPORT_BACKING``) never fired, so the report carries a
  default there (:func:`contract_audit`).
- **Warm-path assert**: :func:`check_post_warm_compiles` fails a
  resident-service job that built a kernel or host library after the
  server sealed its warm path (``obs.buildwatch``).
"""

from __future__ import annotations

import atexit
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import contracts, flags
from .obs import metrics
from .utils.logger import warn


class SanitizerError(AssertionError):
    """Base of every sanitizer fault (an AssertionError, so test harnesses
    treat it as a hard failure)."""


class SwarShadowMismatch(SanitizerError):
    """The packed kernel's output diverged from its int32 shadow."""


class CanaryError(SanitizerError):
    """A fetched kernel output broke a value-range invariant."""


class CompileAfterWarmError(SanitizerError):
    """A library was built after the resident server sealed its warm path:
    the claim that every job after the warm pool builds nothing is
    broken."""


def enabled() -> bool:
    """The master switch, read on every call (tests toggle it)."""
    return flags.get_bool("RACON_TPU_SANITIZE")


def check_post_warm_compiles(scope=None) -> list:
    """The warm-path assert: raise :class:`CompileAfterWarmError` when the
    build watch recorded a build after its seal (``scope``: one job's).
    Armed under ``RACON_TPU_SANITIZE=1``; otherwise returns the records, so
    the caller can count them."""
    from .obs import buildwatch
    builds = buildwatch.post_warm(scope)
    if builds and enabled():
        raise CompileAfterWarmError(buildwatch.describe(builds))
    return builds


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


# ----------------------------------------------------- lock-order witness

class LockOrderWitness:
    """The acquisition order of the named locks.

    Every acquire of a :class:`WitnessedLock` while the thread holds
    others adds the edges ``held -> acquired`` to one graph of the
    process, each stamped with the acquiring stack the first time it is
    seen (after that an acquire costs a list append). A cycle in the graph
    is a potential deadlock: two threads can reach its two edges at once
    and wait on each other, whether or not this run did. :meth:`report`
    prints every cycle with the first stack of each edge on it; it runs
    at process exit (:func:`lock_witness`).

    Edges from a name to itself are skipped: instances of one lock class
    share a name, and nesting two of them is ordered by something the
    name does not record."""

    def __init__(self):
        self._mu = threading.Lock()
        # (held name, acquired name) -> first-seen acquiring stack
        self._edges: Dict[Tuple[str, str], str] = {}
        self._tls = threading.local()

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquire(self, name: str) -> None:
        held = self._held()
        if held:
            fresh = [(p, name) for p in held
                     if p != name and (p, name) not in self._edges]
            if fresh:
                stack = "".join(traceback.format_stack()[:-1])
                with self._mu:
                    for edge in fresh:
                        self._edges.setdefault(edge, stack)
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def cycles(self) -> List[List[str]]:
        """Every distinct simple cycle of the order graph as a name list
        (``[a, b]`` is ``a -> b -> a``)."""
        adj: Dict[str, List[str]] = {}
        for a, b in self.edges():
            adj.setdefault(a, []).append(b)
        out: List[List[str]] = []
        seen: set = set()

        def dfs(node: str, path: List[str]) -> None:
            if len(path) > 32:   # the graphs here are tiny
                return
            for nxt in adj.get(node, ()):
                if nxt in path:
                    cyc = path[path.index(nxt):]
                    # a canonical rotation, not a set: A->B->C->A and its
                    # reverse are different potential deadlocks
                    k = cyc.index(min(cyc))
                    key = tuple(cyc[k:] + cyc[:k])
                    if key not in seen:
                        seen.add(key)
                        out.append(cyc)
                else:
                    dfs(nxt, path + [nxt])

        for start in sorted(adj):
            dfs(start, [start])
        return out

    def report(self, stream=None) -> int:
        """Print every cycle, with each edge's first acquiring stack, to
        ``stream`` (stderr); returns the number of cycles."""
        cycles = self.cycles()
        if not cycles:
            return 0
        stream = stream if stream is not None else sys.stderr
        edges = self.edges()
        lines: List[str] = []
        for cyc in cycles:
            ring = " -> ".join(cyc + [cyc[0]])
            lines.append(f"[racon_tpu::sanitize] lock-order witness: "
                         f"cycle {ring} (potential deadlock)")
            for a, b in zip(cyc, cyc[1:] + [cyc[0]]):
                lines.append(f"  edge {a} -> {b} first acquired at:")
                lines.append(edges.get((a, b), "  <stack unavailable>")
                             .rstrip("\n"))
        print("\n".join(lines), file=stream)
        stream.flush()
        metrics.set_gauge("sanitize.lock_order_cycles", len(cycles))
        return len(cycles)


_witness: Optional[LockOrderWitness] = None
_witness_mu = threading.Lock()


def lock_witness() -> LockOrderWitness:
    """The process's witness, made at first use; its cycle report is
    registered to run at exit, once."""
    global _witness
    with _witness_mu:
        if _witness is None:
            _witness = LockOrderWitness()
            atexit.register(_witness.report)
    return _witness


class WitnessedLock:
    """A ``threading.Lock`` that reports its acquires and releases to a
    :class:`LockOrderWitness` under the lock's name (one name a
    coordination point, shared by the instances of one class).

    It works under ``threading.Condition(lock)``: the Condition's
    fallbacks drive ``acquire``/``release``, so a ``wait()`` drops and
    restores the witness's record of the held lock around the sleep."""

    def __init__(self, name: str,
                 witness: Optional[LockOrderWitness] = None):
        self.name = name
        self._lock = threading.Lock()
        self._witness = witness if witness is not None else lock_witness()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._witness.note_acquire(self.name)
        return ok

    def release(self) -> None:
        self._witness.note_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<WitnessedLock {self.name!r} at {id(self):#x}>"


def named_lock(name: str):
    """The lock of a named coordination point: a :class:`WitnessedLock`
    when the sanitizer is on at its creation, else a plain
    ``threading.Lock``."""
    if enabled():
        return WitnessedLock(name)
    return threading.Lock()


# ------------------------------------------------------ contract audit

def contract_audit(stream=None) -> Dict[str, List[str]]:
    """The registry against what this process emitted: the registered
    metrics no site wrote (``never_emitted``), and the report keys whose
    backing metric or span timer never fired, so the section builder's
    default filled them (``defaulted_keys``). Informational: a plain
    polish never touches the shard runner's metrics. The two counts land
    in the ``sanitize.contract_*`` gauges."""
    seen = metrics.seen_names()
    audit: Dict[str, List[str]] = {"never_emitted": [], "defaulted_keys": []}
    if not seen:
        return audit     # nothing ran: everything would be missing

    def emitted(name: str) -> bool:
        return name in seen or any(s.startswith(name + ".") for s in seen)

    audit["never_emitted"] = sorted(
        m for m in contracts.METRICS if m not in seen)
    audit["defaulted_keys"] = sorted(
        key for key, backing in contracts.REPORT_BACKING.items()
        if not emitted(backing))
    stream = stream if stream is not None else sys.stderr
    ne, dk = audit["never_emitted"], audit["defaulted_keys"]
    metrics.set_gauge("sanitize.contract_never_emitted", len(ne))
    metrics.set_gauge("sanitize.contract_defaulted_keys", len(dk))
    if ne:
        print(f"[racon_tpu::sanitize] contract audit: "
              f"{len(ne)} registered metric(s) never emitted this "
              f"process: {', '.join(ne[:12])}"
              + (" ..." if len(ne) > 12 else ""), file=stream)
    if dk:
        print(f"[racon_tpu::sanitize] contract audit: "
              f"{len(dk)} report key(s) backed by silent metrics "
              f"(validator defaults): {', '.join(dk[:12])}"
              + (" ..." if len(dk) > 12 else ""), file=stream)
    stream.flush()
    return audit


def _exit_contract_audit() -> None:
    # the flag is read at exit, so a test that toggles it mid-process
    # gets or loses the audit accordingly
    if enabled():
        try:
            contract_audit()
        except Exception:  # graftlint: disable=swallowed-exception (exit path: a closed stderr must not mask the exit status)
            pass


atexit.register(_exit_contract_audit)
