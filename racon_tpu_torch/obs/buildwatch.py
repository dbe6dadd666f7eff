"""Kernel-library builds of the run (the port's counterpart of
``racon_tpu/obs/compilewatch.py``).

The JAX package compiles per shape and watches XLA through
``jax.monitoring``. The port compiles nothing per shape: its only builds
are the ``nvcc`` kernel libraries (``ops/_build.py``) and the ``g++`` host
library (``native/``), each at first use. :func:`record` is called after
each build and keeps (library, seconds, phase): the seconds in the
``compile.build_s`` timer, the counts in ``compile.builds`` and
``compile.<library>``, the records in a bounded ring for the run report's
``compiles`` section (:func:`summary`).

A build is ``post_warm`` when a kernel of the port launched after the
run's start (:func:`reset`) and before the build: the engines build every
stale library at their first launch, so a healthy run reads 0.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from . import metrics, trace

MAX_EVENTS = 256

_lock = threading.Lock()
_events: List[dict] = []
_launch_mark = 0


def _launches() -> int:
    from ..ops import cuda_nw
    return sum(cuda_nw.LAUNCHES.values())


def reset() -> None:
    """A run boundary: drop the records and mark the launches so far."""
    global _launch_mark
    mark = _launches()
    with _lock:
        _events.clear()
        _launch_mark = mark


def _warm() -> bool:
    return _launches() > _launch_mark


def record(library: str, seconds: float, tool: str) -> None:
    """One finished build of ``library`` (``tool``: ``nvcc`` or ``g++``),
    attributed to the innermost open span of the building thread."""
    metrics.add_time("compile.build_s", seconds)
    metrics.inc("compile.builds")
    metrics.inc(f"compile.{library}")
    ev = {"fn": library, "signature": tool,
          "phase": trace.current_span() or "",
          "duration_s": round(float(seconds), 4), "post_warm": _warm()}
    with _lock:
        _events.append(ev)
        if len(_events) > MAX_EVENTS:
            del _events[0]


def summary() -> dict:
    """The run report's ``compiles`` section: seconds and count of the
    builds, the post-warm count, ``sealed`` (1 once a kernel launched),
    per-library rollups and the trailing build records."""
    with _lock:
        evs = [dict(e) for e in _events]
    by_fn: Dict[str, Dict[str, float]] = {}
    for e in evs:
        row = by_fn.setdefault(e["fn"], {"count": 0, "seconds": 0.0})
        row["count"] += 1
        row["seconds"] = round(row["seconds"] + e["duration_s"], 4)
    return {
        "total_s": round(metrics.timer_s("compile.build_s"), 3),
        "count": int(metrics.counter("compile.builds")),
        "post_warm": sum(1 for e in evs if e["post_warm"]),
        "sealed": 1 if _warm() else 0,
        "by_function": by_fn,
        "events": [{k: e[k] for k in ("fn", "signature", "phase",
                                      "duration_s")} for e in evs[-32:]],
    }
