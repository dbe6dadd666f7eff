"""Fault classification and seeded fault injection (counterpart of
``racon_tpu/faults.py`` at the port's seven injection sites).

**Classification**: :func:`classify` puts any failure in one of four
classes: ``transient-io`` (a retryable errno), ``device-oom`` (an
allocation failure: :class:`DeviceOOMError`, or any exception whose text
says out of memory — ``torch.cuda.OutOfMemoryError`` says "CUDA out of
memory"), ``stall`` (:class:`StallError`) and ``deterministic-compute``
(everything else). The shard runner (``racon_tpu_torch.exec.runner``)
walks a failed shard down its ladder by this class; a plain polish raises.

**Injection**: ``RACON_TPU_FAULTS=site:kind[@N][*][%P],...``

- *site*: ``align.dispatch``, ``align.fetch`` (the aligner's chunk launch
  and fetch), ``consensus.dispatch`` (a consensus group's rounds), or the
  shard runner's ``exec.polish`` (a shard attempt's polish),
  ``part.write``, ``manifest.write`` and ``worker.kill`` (a shard's
  start);
- *kind*: ``io`` (EIO), ``enospc``, ``oom``, ``err``, ``stall``, ``kill``
  (SIGKILL of the process);
- ``@N`` fires on the Nth hit of the site (1-based, default 1), ``*``
  keeps firing from there, ``%P`` fires each hit with probability P drawn
  from a per-site RNG seeded by ``RACON_TPU_FAULTS_SEED`` and the site
  name. The same spec and seed fire at the same calls as in the JAX
  package.

``RACON_TPU_EXEC_FAULT_SHARD=N`` (``N*``: every attempt) is the legacy
alias: it faults shard N's first attempt (every attempt) at
``exec.polish`` with :data:`LEGACY_MESSAGE`.
"""

from __future__ import annotations

import errno
import os
import random
import signal
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

from . import contracts, flags
from .obs import metrics

CLASS_TRANSIENT, CLASS_OOM, CLASS_STALL, CLASS_COMPUTE = \
    contracts.FAULT_CLASSES
CLASSES = contracts.FAULT_CLASSES


class InjectedFault(RuntimeError):
    """A deterministic compute fault raised by the injection harness."""


class DeviceOOMError(RuntimeError):
    """An injected device allocation failure."""


class StallError(RuntimeError):
    """A stalled pipeline: injected, or the queue watchdog's escalation in
    a shard runner's polish."""


class TransientIOError(OSError):
    """An injected retryable I/O fault (with a transient errno)."""


_TRANSIENT_ERRNOS = frozenset(
    e for e in (errno.EINTR, errno.EAGAIN, errno.EBUSY, errno.EIO,
                errno.ETIMEDOUT, errno.ENOSPC, errno.EDQUOT,
                getattr(errno, "ESTALE", None)) if e is not None)

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory")


def classify(exc: BaseException) -> str:
    """The fault class of ``exc`` (one of :data:`CLASSES`); the message
    text decides the OOM class, as device allocators raise types of
    their own."""
    if isinstance(exc, StallError):
        return CLASS_STALL
    if isinstance(exc, DeviceOOMError):
        return CLASS_OOM
    if isinstance(exc, OSError):
        return (CLASS_TRANSIENT if exc.errno in _TRANSIENT_ERRNOS
                else CLASS_COMPUTE)
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _OOM_MARKERS):
        return CLASS_OOM
    return CLASS_COMPUTE


def backoff_s(base: float, k: int, token: str) -> float:
    """``base * 2^k`` jittered by +-25% with a CRC32 hash of ``token``
    (deterministic: a rerun waits the same)."""
    frac = zlib.crc32(token.encode()) % 1000
    return max(0.0, base) * (2.0 ** k) * (0.75 + frac / 2000.0)


# --------------------------------------------------------------- injection

KNOWN_SITES = contracts.FAULT_SITES
_KINDS = contracts.FAULT_KINDS

LEGACY_MESSAGE = "injected device-engine fault (RACON_TPU_EXEC_FAULT_SHARD)"


@dataclass
class FaultSpec:
    """One parsed ``site:kind[@N][*][%P]`` entry."""

    site: str
    kind: str
    at: int = 1
    every: bool = False
    prob: Optional[float] = None


def parse_spec(raw: str) -> Dict[str, List[FaultSpec]]:
    """Parse a ``RACON_TPU_FAULTS`` value; raises ``ValueError`` on an
    unknown site or kind or a malformed entry."""
    out: Dict[str, List[FaultSpec]] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, rest = entry.partition(":")
        if not sep:
            raise ValueError(f"RACON_TPU_FAULTS entry {entry!r} has no "
                             f"':' — expected site:kind[@N][*][%P]")
        if site not in KNOWN_SITES:
            raise ValueError(f"RACON_TPU_FAULTS site {site!r} unknown "
                             f"(known: {', '.join(KNOWN_SITES)})")
        every = rest.endswith("*")
        if every:
            rest = rest[:-1]
        prob: Optional[float] = None
        at = 1
        if "%" in rest:
            rest, _, p = rest.partition("%")
            prob = float(p)
            if not 0.0 < prob <= 1.0:
                raise ValueError(f"RACON_TPU_FAULTS probability {p!r} "
                                 f"outside (0, 1]")
        if "@" in rest:
            rest, _, n = rest.partition("@")
            at = int(n)
            if at < 1:
                raise ValueError("RACON_TPU_FAULTS @N is 1-based")
        if rest not in _KINDS:
            raise ValueError(f"RACON_TPU_FAULTS kind {rest!r} unknown "
                             f"(known: {', '.join(_KINDS)})")
        out.setdefault(site, []).append(
            FaultSpec(site, rest, at=at, every=every, prob=prob))
    return out


# the parsed spec (reparsed, with the hit counts and RNGs reset, whenever
# the flags change), hits per site, the one-shots consumed, per-site RNGs
_lock = threading.Lock()
_cache_key: Optional[tuple] = None
_specs: Dict[str, List[FaultSpec]] = {}
_legacy: Optional[tuple] = None   # (shard id, every attempt)
_hits: Dict[str, int] = {}
_fired: set = set()
_rngs: Dict[str, random.Random] = {}


def reset() -> None:
    """Drop the parsed spec, the hit counts and the RNG streams."""
    global _cache_key
    with _lock:
        _cache_key = None
        _specs.clear()
        _hits.clear()
        _fired.clear()
        _rngs.clear()


def _refresh_locked(raw: str, legacy_raw: str) -> None:
    global _cache_key, _specs, _legacy
    key = (raw, legacy_raw, flags.get_int("RACON_TPU_FAULTS_SEED"))
    if key == _cache_key:
        return
    _cache_key = key
    _specs = parse_spec(raw) if raw else {}
    _hits.clear()
    _fired.clear()
    _rngs.clear()
    legacy_raw = legacy_raw.strip()
    if legacy_raw.endswith("*"):
        _legacy = (int(legacy_raw[:-1]), True)
    else:
        _legacy = (int(legacy_raw), False) if legacy_raw else None


def _rng_locked(site: str) -> random.Random:
    rng = _rngs.get(site)
    if rng is None:
        seed = flags.get_int("RACON_TPU_FAULTS_SEED")
        rng = _rngs[site] = random.Random(f"{seed}:{site}")
    return rng


def _fire(site: str, kind: str) -> None:
    metrics.inc(f"faults.injected.{site}")
    if kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if kind == "io":
        raise TransientIOError(
            errno.EIO, f"injected transient I/O fault at {site}")
    if kind == "enospc":
        raise TransientIOError(errno.ENOSPC, f"injected ENOSPC at {site}")
    if kind == "oom":
        raise DeviceOOMError(
            f"injected RESOURCE_EXHAUSTED: out of memory at {site}")
    if kind == "stall":
        raise StallError(f"injected stall at {site}")
    raise InjectedFault(f"injected deterministic fault at {site}")


def check(site: str, *, shard: Optional[int] = None,
          attempt: int = 0) -> None:
    """An injection point: raises (or kills the process) when the active
    spec fires at this hit of ``site``; with no spec set, two environment
    lookups. ``shard`` and ``attempt`` feed the legacy alias at
    ``exec.polish``."""
    raw = flags.get_str("RACON_TPU_FAULTS")
    legacy_raw = flags.get_str("RACON_TPU_EXEC_FAULT_SHARD")
    if not raw and not legacy_raw.strip():
        return
    kind = None
    with _lock:
        _refresh_locked(raw, legacy_raw)
        if site == "exec.polish" and _legacy is not None and \
                shard == _legacy[0] and (_legacy[1] or attempt == 0):
            kind = "legacy"
        else:
            n = _hits[site] = _hits.get(site, 0) + 1
            for i, spec in enumerate(_specs.get(site, ())):
                if spec.prob is not None:
                    if _rng_locked(site).random() < spec.prob:
                        kind = spec.kind
                        break
                elif spec.every:
                    if n >= spec.at:
                        kind = spec.kind
                        break
                elif n == spec.at and (site, i) not in _fired:
                    _fired.add((site, i))
                    kind = spec.kind
                    break
    if kind == "legacy":
        metrics.inc("faults.injected.exec.polish")
        raise InjectedFault(LEGACY_MESSAGE)
    if kind is not None:
        _fire(site, kind)
