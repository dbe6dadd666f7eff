"""The resident polishing service's wire protocol (a copy of
``racon_tpu/serve/protocol.py``: a JAX client and a port server, or the
reverse, understand each other byte for byte): newline-delimited JSON over
a unix-domain stream socket, with one raw-bytes escape for the polished
FASTA payload.

Every request and every response is ONE ``\\n``-terminated JSON object.
A connection may carry any number of requests; responses come back in
request order. The one exception to the line discipline: a successful
``result`` response announces ``"bytes": N`` in its header line and is
followed by exactly N raw bytes of polished FASTA, which the client copies
verbatim (no re-encoding), so a ``racon --submit`` stream is the one-shot
CLI's stdout byte for byte.

Requests (``op`` selects):

- ``ping``: liveness; the server's identity, uptime, engine profile,
  healthy slot count, serve dir and drain state;
- ``submit``: a job spec (input paths and polishing options,
  :data:`SPEC_KEYS`) and an optional top-level ``key`` (the client's
  idempotency key: a resubmission under a journaled key returns the
  existing job, ``"existing": true``). The answer carries the job id, or
  ``ok: false`` with the admission's reason. The spec's ``tenant`` and
  ``priority`` are routing hints: a serve host records them and schedules
  FIFO;
- ``status``: one job's state (queued/running/done/failed/cancelled), its
  queue position, cost estimate and ladder attempts;
- ``result``: waits (up to ``timeout_s``) until the job is terminal, then
  the header with the job's run report and the FASTA payload; with
  ``--serve-dir`` the payload comes from the CRC-verified spool and
  survives a server restart until one successful fetch;
- ``cancel``: cancels a QUEUED job (a running one cannot be interrupted
  mid-dispatch, and the answer says so);
- ``preempt``: a queued job is released at once; a running one drains at
  its next ladder boundary or completes first;
- ``stats``: the server's counters (jobs by outcome, in-flight footprint,
  queue depth, per-tenant queue depths, slot health, recovery);
- ``shutdown``: ``{"mode": "now"}`` (default) stops accepting and lets
  running jobs finish; ``{"mode": "drain"}`` also waits (bounded by
  ``RACON_TPU_SERVE_DRAIN_S``) for the queue to empty and compacts the
  journal before exit, as ``SIGTERM`` does.

Paths in a job spec are the server's: the socket is unix-domain, so client
and server share a filesystem.
"""

from __future__ import annotations

import json
import socket
from typing import Optional, Tuple

# every key a submit spec may carry; ("option", default) pairs mirror
# the CLI's polishing knobs (cli.build_parser) so --submit round-trips
# them verbatim
SPEC_DEFAULTS = {
    "fragment_correction": False,
    "window_length": 500,
    "quality_threshold": 10.0,
    "error_threshold": 0.3,
    "no_trimming": False,
    "match": 3, "mismatch": -5, "gap": -4,
    "banded": False,
    "threads": 1,
    "include_unpolished": False,
    # routing hints: the tenant queue a fleet gateway files the job
    # under, and its preemption priority (higher wins); a serve host
    # records them and schedules FIFO
    "tenant": "default",
    "priority": 0,
}
SPEC_PATHS = ("sequences", "overlaps", "target_sequences")
SPEC_KEYS = SPEC_PATHS + tuple(SPEC_DEFAULTS)


def encode(obj: dict) -> bytes:
    """One protocol line (compact separators keep headers small)."""
    return json.dumps(obj, separators=(",", ":")).encode() + b"\n"


def send_msg(sock: socket.socket, obj: dict) -> None:
    sock.sendall(encode(obj))


def read_msg(rfile) -> Optional[dict]:
    """Read one JSON line from a socket makefile; None at EOF.  Raises
    ``ValueError`` on a non-JSON or non-object line (the server turns
    that into an error response rather than dying)."""
    line = rfile.readline()
    if not line:
        return None
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError(f"protocol message is not an object: {obj!r}")
    return obj


def read_exact(rfile, n: int) -> bytes:
    """Read exactly ``n`` payload bytes (the FASTA body after a result
    header); raises ``ConnectionError`` on a short read."""
    parts = []
    remaining = n
    while remaining > 0:
        chunk = rfile.read(remaining)
        if not chunk:
            raise ConnectionError(
                f"connection closed {remaining} bytes short of the "
                f"announced {n}-byte payload")
        parts.append(chunk)
        remaining -= len(chunk)
    return b"".join(parts)


def normalize_spec(raw: dict) -> Tuple[Optional[dict], Optional[str]]:
    """Validate + default-fill a submitted job spec.  Returns
    ``(spec, None)`` or ``(None, reason)`` — a malformed spec is an
    admission rejection, never a server fault."""
    if not isinstance(raw, dict):
        return None, f"job spec is not an object: {type(raw).__name__}"
    unknown = set(raw) - set(SPEC_KEYS)
    if unknown:
        return None, f"unknown job spec keys: {sorted(unknown)}"
    spec = {}
    for key in SPEC_PATHS:
        val = raw.get(key)
        if not isinstance(val, str) or not val:
            return None, f"job spec is missing input path {key!r}"
        spec[key] = val
    for key, default in SPEC_DEFAULTS.items():
        val = raw.get(key, default)
        if isinstance(default, bool):
            if not isinstance(val, bool):
                return None, f"job spec {key!r} must be a boolean"
        elif isinstance(default, int):
            if not isinstance(val, int) or isinstance(val, bool):
                return None, f"job spec {key!r} must be an integer"
        elif isinstance(default, float):
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                return None, f"job spec {key!r} must be a number"
            val = float(val)
        else:
            if not isinstance(val, str):
                return None, f"job spec {key!r} must be a string"
        spec[key] = val
    if spec["window_length"] <= 0:
        return None, "job spec window_length must be positive"
    if spec["threads"] < 1:
        return None, "job spec threads must be >= 1"
    if not spec["tenant"]:
        return None, "job spec tenant must be a non-empty string"
    return spec, None
