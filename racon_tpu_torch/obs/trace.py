"""Spans, exported as Chrome trace-event JSON (counterpart of
``racon_tpu/obs/trace.py``)::

    with obs.span("align.dispatch", pairs=len(chunk)):
        ...

Switches:

- active (:func:`activate`): each span exit adds its host wall time to the
  metrics timer of the span's name (the run report's dispatch/fetch split
  reads them);
- tracing (``activate(tracing=True)``): span events also land in
  per-thread ring buffers (bounded; the oldest events of a thread drop
  first, counted in ``trace.dropped_events``) for :func:`export`;
- profiling (:func:`set_record_function`, armed by ``obs.profile``): each
  span also enters ``torch.profiler.record_function(name)``, so the
  profile's host rows carry the span names.

With none on, the default, ``span()`` returns one shared no-op object: a
global load, a branch and a return. Spans time the host only (no device
synchronisation) and never change an output byte.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import nullcontext
from typing import List

from . import metrics

# events kept per thread: ~64 bytes an event, a few MB a thread
RING_CAP = 1 << 18

_lock = threading.Lock()
_timing = False
_tracing = False
_active = False        # _timing, or a profile recording
_record_function = None  # torch.profiler.record_function while profiling
_origin = 0.0          # perf_counter at tracing start (trace time zero)
_threads: List["_ThreadBuf"] = []
_epoch = 0             # bumped by deactivate(): stale buffers re-register
_tls = threading.local()


class _ThreadBuf:
    """One thread's ring of finished span events and its track stack.
    Single writer: every thread gets its own through thread-local
    storage."""

    __slots__ = ("name", "events", "pos", "dropped", "tracks", "epoch")

    def __init__(self, name: str, epoch: int):
        self.name = name
        self.events: list = []     # (track, name, t0, t1, args)
        self.pos = 0
        self.dropped = 0
        self.tracks: List[str] = []
        self.epoch = epoch

    def append(self, ev) -> None:
        if len(self.events) < RING_CAP:
            self.events.append(ev)
        else:
            self.events[self.pos] = ev
            self.pos = (self.pos + 1) % RING_CAP
            self.dropped += 1


def _buf() -> _ThreadBuf:
    b = getattr(_tls, "buf", None)
    if b is None or b.epoch != _epoch:
        b = _ThreadBuf(threading.current_thread().name, _epoch)
        _tls.buf = b
        with _lock:
            _threads.append(b)
    return b


class _NullSpan:
    """The shared no-op span and track returned while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0", "_rf")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def __enter__(self):
        st = getattr(_tls, "span_stack", None)
        if st is None:
            st = _tls.span_stack = []
        st.append(self.name)
        rf = _record_function
        self._rf = rf(self.name) if rf is not None else None
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        st = getattr(_tls, "span_stack", None)
        if st:
            st.pop()
        metrics.add_time(self.name, t1 - self._t0)
        # the thread's timer prefix (set_timer_prefix): a chip worker's
        # spans also land under device.<ordinal>.*, the run report's
        # per-device seconds
        pfx = getattr(_tls, "timer_prefix", None)
        if pfx:
            metrics.add_time(pfx + self.name, t1 - self._t0)
        if _tracing:
            b = _buf()
            b.append((b.tracks[-1] if b.tracks else None,
                      self.name, self._t0, t1, self.args or None))
        return False


def span(name: str, **args):
    """A context manager timing the enclosed block as span ``name``
    (``args`` become the trace event's args). Use as ``with
    obs.span(...):``."""
    if not _active:
        return NULL_SPAN
    return _Span(name, args)


class _Track:
    __slots__ = ("name", "_b")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._b = _buf()
        self._b.tracks.append(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        b = getattr(_tls, "buf", None)
        if b is self._b and b.tracks:
            b.tracks.pop()
        return False


def track(name: str):
    """Route the current thread's spans onto a named sub-track of the
    trace until exit."""
    if not _tracing:
        return NULL_SPAN
    return _Track(name)


def current_span():
    """The current thread's innermost open span (None when none is open
    or recording is off)."""
    st = getattr(_tls, "span_stack", None)
    return st[-1] if st else None


def get_timer_prefix():
    """The current thread's span-timer mirror prefix (None when unset):
    a reader that wants this thread's own timer (the polisher's align
    dispatch/fetch split under concurrent chip workers) prepends it."""
    return getattr(_tls, "timer_prefix", None)


def set_timer_prefix(prefix) -> None:
    """Mirror the current thread's span timers under ``prefix + name`` as
    well as under the span's name (None clears). The in-process chip
    workers set ``device.<ordinal>.``, a mesh shard ``device.mesh.``."""
    _tls.timer_prefix = prefix or None


# ------------------------------------------------------------- lifecycle

def activate(tracing: bool = False) -> None:
    """Span timers on; ring buffers too with ``tracing``. Idempotent;
    trace time zero is the first tracing activation."""
    global _timing, _tracing, _active, _origin
    _timing = True
    if tracing and not _tracing:
        _origin = time.perf_counter()
        _tracing = True
    _active = True


def deactivate() -> None:
    """Recording off and every ring dropped (a live thread's stale buffer
    re-registers at its next span)."""
    global _timing, _tracing, _active, _threads, _epoch
    with _lock:
        _timing = False
        _tracing = False
        _active = _record_function is not None
        _threads = []
        _epoch += 1


def set_record_function(rf) -> None:
    """While ``rf`` (``torch.profiler.record_function``) is set, every
    span also enters ``rf(name)``; None stops it."""
    global _record_function, _active
    _record_function = rf
    _active = _timing or rf is not None


def is_active() -> bool:
    return _active


_NO_RANGE = nullcontext()


def profile_range(name: str):
    """``torch.profiler.record_function(name)`` while a profile recording
    is armed (:func:`set_record_function`), else one shared no-op: a
    kernel wrapper's range in ``obs.profile``'s trace, at no host cost
    without one (the range itself costs ~13 us a call on an H100
    machine's host, ``chip_smoke.py --bp-rows``)."""
    rf = _record_function
    return _NO_RANGE if rf is None else rf(name)


# ---------------------------------------------------------------- export

def export(path: str) -> dict:
    """Write every recorded span as Chrome trace-event JSON to ``path``
    (complete "X" events in microseconds from tracing start, one tid per
    thread and track, ``thread_name`` rows) and return ``{"events": n,
    "dropped": n}``."""
    pid = os.getpid()
    with _lock:
        bufs = list(_threads)
    events: list = []
    dropped = 0
    tids: dict = {}
    for b in bufs:
        dropped += b.dropped
        for track_name, name, t0, t1, args in b.events:
            key = (b.name, track_name)
            tid = tids.get(key)
            if tid is None:
                tid = len(tids) + 1
                tids[key] = tid
                label = (b.name if track_name is None
                         else f"{b.name}/{track_name}")
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": label}})
            ev = {"name": name, "cat": name.split(".", 1)[0], "ph": "X",
                  "pid": pid, "tid": tid,
                  "ts": round((t0 - _origin) * 1e6, 3),
                  "dur": round((t1 - t0) * 1e6, 3)}
            if args:
                ev["args"] = args
            events.append(ev)
    if dropped:
        metrics.set_gauge("trace.dropped_events", dropped)
    events.insert(0, {"name": "process_name", "ph": "M", "pid": pid,
                      "args": {"name": "racon_tpu_torch"}})
    from .report import atomic_write_bytes
    atomic_write_bytes(path, json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}).encode())
    return {"events": len(events), "dropped": dropped}
