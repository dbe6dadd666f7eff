"""Run reports: one schema-versioned ``run_report.json`` per CLI run,
shard run or service job (counterpart of ``racon_tpu/obs/report.py`` for
the kinds ``cli``, ``exec`` and ``job``).

The report is built from the metrics registry and the polisher's
``timings`` at the end of the run: per-phase wall clock, the
dispatch/fetch split from the span timers, lane occupancy, queue stalls,
swallowed faults, injected faults and the ladder's fault classes, lease
counters, kernel-library builds, the overlapper's counters, peak RSS, the
registry's snapshot and, for a shard run, one row per shard
(:func:`shard_row`). A service job's report reads its job's metric scope
only (``scope``), so concurrent jobs report disjoint numbers. The schema
is the JAX
package's version 11 with every section present (sections the port has no
subsystem for read zeros or ``{}``); :func:`validate_report` checks it,
``python -m racon_tpu_torch.obs check FILE`` from the shell.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

from . import buildwatch, metrics
from .. import contracts

SCHEMA_VERSION = contracts.SCHEMA_VERSION
KINDS = contracts.REPORT_KINDS

_NUM = (int, float)
_SCHEMA_KEYS = contracts.schema_keys()

# top-level key -> (accepted types, required)
_TOP = {
    "schema_version": (int, True),
    "kind": (str, True),
    "argv": (list, False),
    "started_unix": (_NUM, True),
    "wall_s": (_NUM, True),
    "phases": (dict, True),
    "dispatch_fetch": (dict, True),
    "pack": (dict, True),
    "retrace": (dict, True),
    "queue": (dict, True),
    "swallowed": (dict, True),
    "faults": (dict, True),
    "recovery": (dict, True),
    "compiles": (dict, True),
    "dataflow": (dict, True),
    "overlap": (dict, True),
    "fleet": (dict, True),
    "devices": (dict, True),
    "peak_rss_bytes": (int, True),
    "metrics": (dict, True),
    "shards": (list, False),
}

assert frozenset(_TOP) == _SCHEMA_KEYS["top"], \
    "report._TOP drifted from contracts.TOP_KEYS"

# sections whose every key is numeric
_NUMERIC_SECTIONS = ("queue", "pack", "recovery", "dataflow", "fleet")
_COMPILES_NUM_KEYS = tuple(sorted(
    _SCHEMA_KEYS["compiles"] - {"by_function", "events"}))
_OVERLAP_NUM_KEYS = tuple(sorted(_SCHEMA_KEYS["overlap"] - {"mode"}))
_COMPILE_EVENT_STR_KEYS = ("fn", "signature", "phase")

# a shard row's key -> (accepted types, required)
_SHARD_ROW = {
    "id": (int, True),
    "status": (str, True),
    "engine": (str, False),
    "worker": (str, False),             # the lease owner that finished it
    "mbp": (_NUM, False),
    "wall_s": (_NUM, False),
    "extract_s": (_NUM, False),
    "timings": (dict, False),
    "retrace": (dict, False),
    "peak_rss_mb": (int, False),
    "reason": (str, False),
    "attempts": (list, False),          # the degradation ladder's record
    "crc32": (int, False),              # the part's checksum
    "reclaimed": (int, False),          # stale-lease takeovers
    "device": (int, False),             # chip ordinal (multi-chip plans)
}


def _zeros(section: str) -> Dict[str, int]:
    return {k: 0 for k in sorted(_SCHEMA_KEYS[section])}


def build_report(kind: str = "cli", *, argv: Optional[list] = None,
                 started_unix: float = 0.0, wall_s: float = 0.0,
                 phases: Optional[Dict[str, float]] = None,
                 shards: Optional[List[dict]] = None,
                 scope: str = "") -> dict:
    """Assemble a report from the registry and the caller's phase
    timings (``Polisher.timings``) and, for a shard run, the manifest's
    shard entries. ``scope`` (a service job's ``job.<id>.``) reads that
    scope's metrics only, under their unscoped names."""
    def t(name):
        return metrics.timer_s(scope + name)

    rep = {
        "schema_version": SCHEMA_VERSION,
        "kind": kind,
        "argv": [str(a) for a in (argv or [])],
        "started_unix": round(float(started_unix), 3),
        "wall_s": round(float(wall_s), 3),
        "phases": {str(k): round(float(v), 6)
                   for k, v in (phases or {}).items()},
        "dispatch_fetch": {
            "align_dispatch_s": round(t("align.dispatch"), 3),
            "align_fetch_s": round(t("align.fetch"), 3),
            "consensus_pack_s": round(t("poa.pack"), 3),
            "consensus_dispatch_s": round(t("poa.dispatch"), 3),
            "consensus_fetch_s": round(t("poa.fetch"), 3),
            # nvcc and g++ library builds of this run
            "compile_s": round(t("compile.build_s"), 3),
        },
        "pack": metrics.pack_summary(scope),
        # the port traces nothing, so no phase ever retraces
        "retrace": {},
        "queue": metrics.queue_summary(scope),
        "swallowed": {k: int(v) for k, v in
                      metrics.group(scope + "swallowed.").items()},
        # the ladder's fault classes, injected sites and backpressure
        # halvings, and the lease lifecycle
        "faults": {
            **{k: int(v)
               for k, v in metrics.group(scope + "faults.").items()},
            **{f"lease.{k}": int(v)
               for k, v in metrics.group(scope + "lease.").items()},
        },
        # the service's journal and slot counters: server-level, so zeros
        # outside a server and the server's totals in a job's report
        "recovery": metrics.recovery_summary(),
        "compiles": buildwatch.summary(scope),
        "dataflow": metrics.dataflow_summary(scope),
        "overlap": metrics.overlap_summary(scope),
        # zeros: the port has no fleet gateway (the JAX package's numbers
        # outside that mode), and one device (no per-chip rows)
        "fleet": _zeros("fleet"),
        "devices": {},
        "peak_rss_bytes": metrics.peak_rss_bytes(),
        "metrics": metrics.snapshot(scope or None),
    }
    if shards is not None:
        rep["shards"] = [shard_row(e) for e in shards]
    return rep


def shard_row(entry: dict) -> dict:
    """One report row from a manifest shard entry: the schema's keys
    only (the part's file name stays in the manifest)."""
    row = {"id": int(entry["id"]), "status": str(entry["status"])}
    for key in ("engine", "worker", "mbp", "wall_s", "extract_s",
                "timings", "retrace", "peak_rss_mb", "reason",
                "attempts", "crc32", "reclaimed", "device"):
        if entry.get(key) is not None:
            row[key] = entry[key]
    return row


# ------------------------------------------------------------- validation

def _is_num(v) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


def _check_numeric_dict(errors: List[str], d: dict, where: str) -> None:
    for k, v in d.items():
        if not isinstance(k, str) or not _is_num(v):
            errors.append(f"{where}[{k!r}] is not a numeric value: {v!r}")


def validate_report(rep) -> List[str]:
    """Schema-check a parsed report; returns the violations ([] =
    valid)."""
    errors: List[str] = []
    if not isinstance(rep, dict):
        return [f"report is not an object: {type(rep).__name__}"]
    if rep.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"schema_version {rep.get('schema_version')!r} "
                      f"!= {SCHEMA_VERSION}")
    for key, (types, required) in _TOP.items():
        if key not in rep:
            if required:
                errors.append(f"missing required key {key!r}")
            continue
        if not isinstance(rep[key], types) or isinstance(rep[key], bool):
            errors.append(f"{key!r} has type {type(rep[key]).__name__}")
    for key in set(rep) - set(_TOP):
        errors.append(f"unknown key {key!r}")
    if errors:
        return errors
    if rep["kind"] not in KINDS:
        errors.append(f"kind {rep['kind']!r} not in {KINDS}")
    for key in ("phases", "dispatch_fetch", "retrace", "swallowed",
                "faults"):
        _check_numeric_dict(errors, rep[key], key)
    for dev, row in rep["devices"].items():
        if not isinstance(row, dict):
            errors.append(f"devices[{dev!r}] is not an object row")
        else:
            _check_numeric_dict(errors, row, f"devices[{dev!r}]")
    for section in _NUMERIC_SECTIONS:
        for key in sorted(_SCHEMA_KEYS[section]):
            if not _is_num(rep[section].get(key)):
                errors.append(f"{section}[{key!r}] missing or non-numeric")
    if rep["overlap"].get("mode") not in contracts.OVERLAP_MODES:
        errors.append(f"overlap['mode'] {rep['overlap'].get('mode')!r} "
                      f"not in {contracts.OVERLAP_MODES}")
    for key in _OVERLAP_NUM_KEYS:
        if not _is_num(rep["overlap"].get(key)):
            errors.append(f"overlap[{key!r}] missing or non-numeric")
    comp = rep["compiles"]
    for key in _COMPILES_NUM_KEYS:
        if not _is_num(comp.get(key)):
            errors.append(f"compiles[{key!r}] missing or non-numeric")
    if not isinstance(comp.get("by_function"), dict):
        errors.append("compiles['by_function'] missing or not an object")
    else:
        for fn, row in comp["by_function"].items():
            if not isinstance(row, dict):
                errors.append(f"compiles.by_function[{fn!r}] is not an "
                              f"object row")
            else:
                _check_numeric_dict(errors, row,
                                    f"compiles.by_function[{fn!r}]")
    if not isinstance(comp.get("events"), list):
        errors.append("compiles['events'] missing or not a list")
    else:
        for i, ev in enumerate(comp["events"]):
            if not isinstance(ev, dict) or not all(
                    isinstance(ev.get(k), str)
                    for k in _COMPILE_EVENT_STR_KEYS) \
                    or not _is_num(ev.get("duration_s")):
                errors.append(f"compiles.events[{i}] is not a build "
                              f"record (fn/signature/phase/duration_s)")
    for kind in ("counters", "gauges", "timers"):
        store = rep["metrics"].get(kind)
        if not isinstance(store, dict):
            errors.append(f"metrics[{kind!r}] missing or not an object")
        else:
            _check_numeric_dict(errors, store, f"metrics.{kind}")
    for i, row in enumerate(rep.get("shards", [])):
        if not isinstance(row, dict):
            errors.append(f"shards[{i}] is not an object")
            continue
        for key, (types, required) in _SHARD_ROW.items():
            if key not in row:
                if required:
                    errors.append(f"shards[{i}] missing {key!r}")
                continue
            if not isinstance(row[key], types) \
                    or isinstance(row[key], bool):
                errors.append(f"shards[{i}][{key!r}] has type "
                              f"{type(row[key]).__name__}")
        for key in set(row) - set(_SHARD_ROW):
            errors.append(f"shards[{i}] unknown key {key!r}")
        for j, att in enumerate(row.get("attempts") or []):
            if not isinstance(att, dict) or "class" not in att \
                    or "action" not in att:
                errors.append(f"shards[{i}].attempts[{j}] is not a "
                              f"ladder record (class/action)")
    return errors


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """Temporary file, fsync, atomic rename: a crash mid-write leaves the
    previous file, never a truncated one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_report(path: str, rep: dict) -> None:
    atomic_write_bytes(path, json.dumps(rep, indent=1).encode())


def main(argv) -> int:
    """``check FILE`` (or ``--check FILE``): validate a report; exit 0
    when valid, 1 with the violations, 2 when unreadable."""
    if len(argv) != 2 or argv[0] not in ("check", "--check"):
        print("usage: python -m racon_tpu_torch.obs check FILE",
              file=sys.stderr)
        return 2
    try:
        with open(argv[1], "rb") as f:
            rep = json.loads(f.read())
    except (OSError, ValueError) as e:
        print(f"run report {argv[1]}: unreadable ({e})", file=sys.stderr)
        return 2
    errors = validate_report(rep)
    for err in errors:
        print(f"run report {argv[1]}: {err}", file=sys.stderr)
    if not errors:
        print(f"run report {argv[1]}: valid (schema v{SCHEMA_VERSION}, "
              f"kind={rep['kind']})")
    return 1 if errors else 0
