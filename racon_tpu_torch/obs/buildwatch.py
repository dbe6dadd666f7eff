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

A build is ``post_warm`` when it comes after the seal. A run seals itself
at its first kernel launch after :func:`reset` (the engines build every
stale library at their first launch, so a healthy run reads 0). The
resident polishing service seals by hand (:func:`seal`) once its warm pool
has loaded every library, and only its seal counts there
(``reset(explicit=True)``); :func:`unseal` re-opens it. Each record keeps
the metric scope of the building thread, so a build on a service job's
thread lands in that job's scope (its ``compile.build_s`` and
``compile.builds``, :func:`post_warm`, ``summary(scope)``), and
:func:`clear_scope` drops a judged job's records.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from . import metrics, trace

MAX_EVENTS = 256

_lock = threading.Lock()
_events: List[dict] = []
_launch_mark = 0
_sealed: Optional[str] = None   # the explicit seal's reason
_explicit = False               # only the explicit seal counts


def _launches() -> int:
    from ..ops import cuda_nw
    return sum(cuda_nw.LAUNCHES.values())


def reset(explicit: bool = False) -> None:
    """A run boundary: drop the records, open the seal and mark the
    launches so far; with ``explicit`` only :func:`seal` seals."""
    global _launch_mark, _sealed, _explicit
    mark = _launches()
    with _lock:
        _events.clear()
        _launch_mark = mark
        _sealed = None
        _explicit = explicit


def seal(reason: str) -> None:
    """Declare the warm-up complete: a later build is ``post_warm``. The
    first seal wins."""
    global _sealed
    with _lock:
        if _sealed is None:
            _sealed = reason


def unseal() -> None:
    """Re-open the seal (the service after a job's capacity halving)."""
    global _sealed
    with _lock:
        _sealed = None


def sealed() -> Optional[str]:
    """The seal's reason, or None while open."""
    if _sealed is not None:
        return _sealed
    if not _explicit and _launches() > _launch_mark:
        return "first kernel launch"
    return None


def record(library: str, seconds: float, tool: str) -> None:
    """One finished build of ``library`` (``tool``: ``nvcc`` or ``g++``),
    attributed to the innermost open span and the metric scope of the
    building thread."""
    metrics.add_time("compile.build_s", seconds)
    metrics.inc("compile.builds")
    metrics.inc(f"compile.{library}")
    ev = {"fn": library, "signature": tool,
          "phase": trace.current_span() or "",
          "scope": metrics.get_scope() or "",
          "duration_s": round(float(seconds), 4),
          "post_warm": sealed() is not None}
    with _lock:
        _events.append(ev)
        if len(_events) > MAX_EVENTS:
            del _events[0]


def post_warm(scope: Optional[str] = None) -> List[dict]:
    """The builds after the seal (``scope``: one job's)."""
    with _lock:
        return [dict(e) for e in _events if e["post_warm"]
                and (scope is None or e["scope"] == scope)]


def clear_scope(scope: str) -> None:
    """Drop one scope's records once its job was judged and reported, so
    the bounded ring keeps the records of jobs still running."""
    if not scope:
        return
    with _lock:
        _events[:] = [e for e in _events if e["scope"] != scope]


def describe(builds: List[dict]) -> str:
    """One line per post-warm build."""
    lines = [f"{len(builds)} library build(s) after the warm path was "
             f"sealed ({sealed() or 'open'}):"]
    for e in builds:
        lines.append(f"  `{e['fn']}` ({e['signature']}, "
                     f"{e['duration_s']:.2f}s, phase={e['phase'] or '-'})")
    return "\n".join(lines)


def summary(scope: str = "") -> dict:
    """The run report's ``compiles`` section: seconds and count of the
    builds, the post-warm count, ``sealed``, per-library rollups and the
    trailing build records (``scope``: one job's)."""
    with _lock:
        evs = [dict(e) for e in _events if not scope or e["scope"] == scope]
    by_fn: Dict[str, Dict[str, float]] = {}
    for e in evs:
        row = by_fn.setdefault(e["fn"], {"count": 0, "seconds": 0.0})
        row["count"] += 1
        row["seconds"] = round(row["seconds"] + e["duration_s"], 4)
    return {
        "total_s": round(metrics.timer_s(scope + "compile.build_s"), 3),
        "count": int(metrics.counter(scope + "compile.builds")),
        "post_warm": sum(1 for e in evs if e["post_warm"]),
        "sealed": 1 if sealed() is not None else 0,
        "by_function": by_fn,
        "events": [{k: e[k] for k in ("fn", "signature", "phase",
                                      "duration_s")} for e in evs[-32:]],
    }
