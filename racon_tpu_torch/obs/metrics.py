"""The process-wide metrics registry (counterpart of
``racon_tpu/obs/metrics.py`` without job scopes): one store of counters,
gauges and timers.

- counters: monotone sums (:func:`inc`);
- gauges: last-written values (:func:`set_gauge`);
- timers: accumulated seconds (:func:`add_time`; every span exit lands in
  the timer of the span's name, :mod:`.trace`).

The module is the registry (state in module globals under one lock), so
any module publishes with ``metrics.inc(...)``. A write is one dict add
under the lock. The run report reads the registry through the summaries
below. No torch, no numpy.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, Optional, Set, Union

from .. import contracts

Number = Union[int, float]

_lock = threading.Lock()
_counters: Dict[str, Number] = {}
_gauges: Dict[str, Number] = {}
_timers: Dict[str, float] = {}
# every name written this process (the exit audit's record; clear() and
# clear_run() leave it)
_seen: Set[str] = set()


def inc(name: str, delta: Number = 1) -> None:
    """Add ``delta`` to counter ``name`` (created at 0)."""
    with _lock:
        _seen.add(name)
        _counters[name] = _counters.get(name, 0) + delta


def set_gauge(name: str, value: Number) -> None:
    with _lock:
        _seen.add(name)
        _gauges[name] = value


def add_time(name: str, seconds: float) -> None:
    with _lock:
        _seen.add(name)
        _timers[name] = _timers.get(name, 0.0) + seconds


def seen_names() -> Set[str]:
    """Every metric name written this process, across run boundaries: the
    contract audit's record of what was emitted."""
    with _lock:
        return set(_seen)


def counter(name: str, default: Number = 0) -> Number:
    with _lock:
        return _counters.get(name, default)


def gauge(name: str, default: Number = 0) -> Number:
    with _lock:
        return _gauges.get(name, default)


def timer_s(name: str, default: float = 0.0) -> float:
    with _lock:
        return _timers.get(name, default)


def group(prefix: str) -> Dict[str, Number]:
    """Every metric under ``prefix`` (all three kinds merged), keyed by
    the name with the prefix stripped."""
    out: Dict[str, Number] = {}
    with _lock:
        for store in (_counters, _gauges, _timers):
            for k, v in store.items():
                if k.startswith(prefix):
                    out[k[len(prefix):]] = v
    return out


def clear(prefix: Optional[str] = None) -> None:
    """Drop the metrics under ``prefix`` (every metric when None)."""
    with _lock:
        for store in (_counters, _gauges, _timers):
            if prefix is None:
                store.clear()
            else:
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]


def clear_run() -> None:
    """Drop every per-run metric (``contracts.RUN_PREFIXES``): a run
    boundary, so back-to-back runs in one process report their own
    numbers."""
    for prefix in contracts.RUN_PREFIXES:
        clear(prefix)


def snapshot() -> Dict[str, Dict[str, Number]]:
    """A copy of the registry (the run report embeds it)."""
    with _lock:
        return {"counters": dict(_counters), "gauges": dict(_gauges),
                "timers": {k: round(v, 6) for k, v in _timers.items()}}


# ------------------------------------------------------------ derived views

def pack_summary() -> Dict[str, Number]:
    """Lane occupancy of the consensus groups and the aligner chunks."""
    with _lock:
        tot = _counters.get("consensus.lanes_total", 0)
        occ = _counters.get("consensus.lanes_occupied", 0)
        grp = _counters.get("consensus.groups", 0)
        wins = _counters.get("consensus.group_windows", 0)
        a_tot = _counters.get("align.lanes_total", 0)
        a_occ = _counters.get("align.lanes_occupied", 0)
        a_chunks = _counters.get("align.chunks", 0)
        a_wasted = _counters.get("align.steps_wasted", 0)
    eff = occ / tot if tot else 0.0
    a_eff = a_occ / a_tot if a_tot else 0.0
    return {"pack_efficiency": round(eff, 4),
            "pad_fraction": round(1.0 - eff, 4) if tot else 0.0,
            "windows_per_group": round(wins / grp, 2) if grp else 0.0,
            "groups": grp,
            "align_pack_efficiency": round(a_eff, 4),
            "align_pad_fraction": round(1.0 - a_eff, 4) if a_tot else 0.0,
            "align_chunks": a_chunks,
            "align_steps_wasted": a_wasted}


def queue_summary() -> Dict[str, Number]:
    """The pipelined polish's bounded queue: its last depth and the
    producer's and consumer's accumulated blocking time."""
    with _lock:
        depth = _gauges.get("queue.depth", 0)
        put_s = _timers.get("queue.producer_wait_s", 0.0)
        get_s = _timers.get("queue.consumer_wait_s", 0.0)
    return {"depth": depth,
            "producer_wait_s": round(put_s, 3),
            "consumer_wait_s": round(get_s, 3),
            "stall_s": round(put_s + get_s, 3)}


def overlap_summary() -> Dict[str, Number]:
    """The first-party overlapper: mode ``auto`` when it produced the
    overlaps (else ``paf``, with zeros), its volumes, and the seed, join
    and chain dispatch/fetch seconds from their span timers."""
    with _lock:
        c = _counters.get
        t = _timers.get
        return {
            "mode": "auto" if _gauges.get("overlap.mode_auto", 0) else "paf",
            "minimizers": c("overlap.minimizers", 0),
            "candidate_pairs": c("overlap.candidate_pairs", 0),
            "freq_capped_buckets": c("overlap.freq_capped_buckets", 0),
            "chains_kept": c("overlap.chains_kept", 0),
            "chains_dropped": c("overlap.chains_dropped", 0),
            "lanes_occupied": c("overlap.lanes_occupied", 0),
            "lanes_total": c("overlap.lanes_total", 0),
            "chunks": c("overlap.chunks", 0),
            "join_bailouts": c("overlap.join_bailouts", 0),
            "cache_hits": c("overlap.cache_hits", 0),
            "cache_misses": c("overlap.cache_misses", 0),
            "seed_dispatch_s": round(t("overlap.seed.dispatch", 0.0), 3),
            "seed_fetch_s": round(t("overlap.seed.fetch", 0.0), 3),
            "join_dispatch_s": round(t("overlap.join.dispatch", 0.0), 3),
            "join_fetch_s": round(t("overlap.join.fetch", 0.0), 3),
            "chain_dispatch_s": round(t("overlap.chain.dispatch", 0.0), 3),
            "chain_fetch_s": round(t("overlap.chain.fetch", 0.0), 3),
        }


def dataflow_summary() -> Dict[str, Number]:
    """The resident dataflow (``RACON_TPU_RESIDENT``): whether it ran
    this run (gauge ``dataflow.resident``; 0 with the flag off or after a
    bail-out), the bytes fetched from the device and the bytes whose fetch
    it avoided (the overlapper's join and table cache count theirs with
    the flag off too), the pairs decoded on the host, the bail-outs, the
    consensus groups whose lanes were gathered on the device.
    ``ins_overflow_windows`` is the JAX package's per-window attribution
    of ``consensus.ins_overflow``, which the port does not emit, so it
    reads 0."""
    with _lock:
        c = _counters.get
        return {
            "resident": _gauges.get("dataflow.resident", 0),
            "bytes_fetched": c("dataflow.bytes_fetched", 0),
            "bytes_avoided": c("dataflow.bytes_avoided", 0),
            "fallback_pairs": c("dataflow.fallback_pairs", 0),
            "resident_bailouts": c("dataflow.resident_bailouts", 0),
            "lanes_device_groups": c("dataflow.lanes_device_groups", 0),
            "ins_overflow_windows": c(
                "consensus.ins_overflow_windows", 0),
        }


def peak_rss_bytes() -> int:
    """Lifetime peak RSS of this process (ru_maxrss is KiB on Linux,
    bytes on macOS)."""
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return rss if sys.platform == "darwin" else rss * 1024
