"""The client side of the resident polishing service (a port of
``racon_tpu/serve/client.py``): a connection with bounded retry, and the
``racon --submit`` entry that streams a job's polished FASTA back byte for
byte as the one-shot CLI would print it.

The client never re-encodes the payload: the server announces ``"bytes":
N`` and the client copies exactly N raw bytes to the output stream.

Connects retry with exponential backoff and a deterministic jitter
(:func:`racon_tpu_torch.faults.backoff_s`), bounded by
``RACON_TPU_CLIENT_RETRIES`` and ``RACON_TPU_CLIENT_BACKOFF_S``; and
:func:`submit_and_stream` survives a server death mid-job by reconnecting
and resubmitting under the same idempotency key: a ``--serve-dir`` server,
restarted, returns the journaled job, and the fetch resumes with no
duplicated compute.

The client never touches CUDA: the device is the server's, so ``--submit``
works on a machine without a card whatever ``--device`` says.
"""

from __future__ import annotations

import os
import socket
import sys
import time
from typing import Optional, Tuple

from .. import faults, flags
from . import protocol


def parse_tcp_address(address: str) -> Optional[Tuple[str, int]]:
    """``host:port`` -> ``(host, port)`` when ``address`` names a TCP
    endpoint (a fleet gateway's listener), else None: a unix-socket path.
    A path contains ``/`` or exists on disk; a TCP address is
    ``host:port`` with a numeric port (IPv6 literals use the last
    colon)."""
    if "/" in address or os.path.exists(address):
        return None
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        return None
    return host, int(port)


class ServiceClient:
    """One connection to a :class:`PolishServer` socket, or, given a
    ``host:port`` address, to a TCP listener speaking the same protocol,
    made with bounded retry and backoff (a restarting server, its socket
    missing or refusing, is retried, not failed). A context manager; each
    helper returns the decoded response header (:meth:`result` the
    payload too)."""

    def __init__(self, socket_path: str, timeout_s: float = 600.0,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None):
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        self.retries = max(0, flags.get_int("RACON_TPU_CLIENT_RETRIES")
                           if retries is None else retries)
        self.backoff_base = max(0.0, flags.get_float(
            "RACON_TPU_CLIENT_BACKOFF_S")
            if backoff_s is None else backoff_s)
        self.sock: Optional[socket.socket] = None
        self.rfile = None
        self._connect()

    def _connect(self) -> None:
        last: Optional[BaseException] = None
        for k in range(self.retries + 1):
            try:
                faults.check("serve.socket")
                tcp = parse_tcp_address(self.socket_path)
                if tcp is not None:
                    sock = socket.create_connection(
                        tcp, timeout=self.timeout_s)
                    sock.settimeout(self.timeout_s)
                else:
                    sock = socket.socket(socket.AF_UNIX,
                                         socket.SOCK_STREAM)
                    sock.settimeout(self.timeout_s)
                    sock.connect(self.socket_path)
            except (OSError, ConnectionError) as e:
                last = e
                if k >= self.retries:
                    break
                delay = faults.backoff_s(
                    self.backoff_base, k,
                    f"{self.socket_path}:{os.getpid()}:{k}")
                time.sleep(delay)
                continue
            self.sock = sock
            self.rfile = sock.makefile("rb")
            return
        raise ConnectionError(
            f"could not connect to {self.socket_path} after "
            f"{self.retries + 1} attempt(s): {last}")

    def reconnect(self) -> None:
        """Drop the (possibly dead) connection and re-establish it with
        the same retry budget."""
        self.close()
        self._connect()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def close(self) -> None:
        if self.rfile is not None:
            try:
                self.rfile.close()
            except OSError:
                pass
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.rfile = None
        self.sock = None

    def _roundtrip(self, msg: dict) -> dict:
        protocol.send_msg(self.sock, msg)
        resp = protocol.read_msg(self.rfile)
        if resp is None:
            raise ConnectionError(
                "server closed the connection mid-request")
        return resp

    def ping(self) -> dict:
        return self._roundtrip({"op": "ping"})

    def stats(self) -> dict:
        return self._roundtrip({"op": "stats"})

    def submit(self, spec: dict, key: Optional[str] = None) -> dict:
        """Submit a job; ``key`` is an idempotency key — resubmitting
        under the same key returns the existing job (``existing`` in
        the response) instead of duplicating compute."""
        msg = {"op": "submit", "spec": spec}
        if key is not None:
            msg["key"] = key
        return self._roundtrip(msg)

    def status(self, job_id: str) -> dict:
        return self._roundtrip({"op": "status", "job": job_id})

    def cancel(self, job_id: str) -> dict:
        return self._roundtrip({"op": "cancel", "job": job_id})

    def preempt(self, job_id: str) -> dict:
        """Ask the server to drain a job: a queued job is released at once
        (``drained: true``); a running one drains at its next ladder
        boundary or completes first."""
        return self._roundtrip({"op": "preempt", "job": job_id})

    def shutdown(self, mode: str = "now") -> dict:
        """Stop the server; ``mode="drain"`` finishes queued +
        in-flight jobs and flushes the journal first."""
        return self._roundtrip({"op": "shutdown", "mode": mode})

    def result(self, job_id: str, timeout_s: Optional[float] = None,
               keep: bool = False) -> Tuple[dict, Optional[bytes]]:
        """Wait until the job is terminal; returns ``(header, payload)``:
        the polished FASTA bytes on success, None on failure or timeout
        (the header carries the reason and the job's run report either
        way). The server's wait defaults to this connection's socket
        timeout less a margin, so the server answers before the client's
        own read gives up; a longer ``timeout_s`` is clamped the same
        way."""
        sock_timeout = self.sock.gettimeout()
        if sock_timeout is not None:
            bound = max(1.0, sock_timeout - 5.0)
            timeout_s = bound if timeout_s is None \
                else min(timeout_s, bound)
        elif timeout_s is None:
            timeout_s = 3600.0
        header = self._roundtrip({"op": "result", "job": job_id,
                                  "timeout_s": timeout_s,
                                  "keep": keep})
        if not header.get("ok") or "bytes" not in header:
            return header, None
        payload = protocol.read_exact(self.rfile, int(header["bytes"]))
        return header, payload


def spec_from_args(args) -> dict:
    """A submit spec from the parsed ``racon`` CLI namespace: the one-shot
    options forwarded verbatim, so ``--submit`` prints what the same
    one-shot command would (``banded`` is ``-b/--cuda-banded-alignment``)."""
    from ..io import parsers
    spec = {
        "sequences": os.path.abspath(args.sequences),
        # the --overlaps auto sentinel travels verbatim (no file)
        "overlaps": (args.overlaps
                     if parsers.is_auto_overlaps(args.overlaps)
                     else os.path.abspath(args.overlaps)),
        "target_sequences": os.path.abspath(args.target_sequences),
        "fragment_correction": bool(args.fragment_correction),
        "window_length": args.window_length,
        "quality_threshold": args.quality_threshold,
        "error_threshold": args.error_threshold,
        "no_trimming": bool(args.no_trimming),
        "match": args.match, "mismatch": args.mismatch,
        "gap": args.gap,
        "banded": bool(args.cuda_banded_alignment),
        "threads": args.threads,
        "include_unpolished": bool(args.include_unpolished),
    }
    # routing hints ride only when given; normalize_spec fills the
    # defaults
    if getattr(args, "tenant", None):
        spec["tenant"] = args.tenant
    if getattr(args, "priority", None):
        spec["priority"] = int(args.priority)
    return spec


def _eprint(msg: str) -> None:
    print(f"[racon_tpu::serve] {msg}", file=sys.stderr, flush=True)


def submit_and_stream(socket_path: str, spec: dict, out,
                      report_path: Optional[str] = None,
                      timeout_s: float = 3600.0,
                      idempotency_key: Optional[str] = None) -> int:
    """The ``racon --submit`` flow: submit, wait, stream the FASTA to
    ``out``, and write the job's run report when asked. Returns the exit
    code (0 = polished bytes were streamed).

    Safe against the server dying mid-job: every submission carries an
    idempotency key (generated unless given), and a connection lost at any
    point reconnects with backoff and resubmits under the same key; a
    restarted ``--serve-dir`` server returns the journaled job, so the
    retry duplicates no compute and the bytes stay the same. Admission
    rejections are not retried (they are answers, not faults)."""
    key = idempotency_key or (
        f"{socket.gethostname()}:{os.getpid()}:{time.monotonic_ns()}")
    retries = max(0, flags.get_int("RACON_TPU_CLIENT_RETRIES"))
    base = max(0.0, flags.get_float("RACON_TPU_CLIENT_BACKOFF_S"))
    attempt = 0
    while True:
        try:
            with ServiceClient(socket_path,
                               timeout_s=timeout_s) as client:
                resp = client.submit(spec, key=key)
                if not resp.get("ok"):
                    _eprint(f"submission rejected: {resp.get('error')}")
                    return 1
                job_id = resp["job"]
                if resp.get("existing"):
                    _eprint(f"job {job_id} already journaled under "
                            f"this key — resuming it")
                else:
                    _eprint(f"job {job_id} submitted "
                            f"({resp.get('cost_bytes', 0) >> 20} MB "
                            f"estimated)")
                header, payload = client.result(job_id,
                                                timeout_s=timeout_s)
        except (OSError, ConnectionError) as e:
            attempt += 1
            if attempt > retries:
                _eprint(f"giving up after {retries} reconnect "
                        f"attempt(s): {e}")
                return 1
            delay = faults.backoff_s(base, attempt - 1,
                                     f"{key}:{attempt}")
            _eprint(f"connection lost ({e}) — reconnecting in "
                    f"{delay:.2f}s (attempt {attempt}/{retries}; the "
                    f"idempotency key resumes the same job)")
            time.sleep(delay)
            continue
        break
    if report_path and header.get("report"):
        from ..obs import report as obs_report
        obs_report.write_report(report_path, header["report"])
    if payload is None:
        _eprint(f"job {job_id} {header.get('state')}: "
                f"{header.get('error')}")
        return 1
    out.write(payload)
    out.flush()
    _eprint(f"job {job_id} done in {header.get('wall_s', 0.0):.2f}s "
            f"(compile {header.get('compile_s', 0.0):.2f}s, "
            f"engine={header.get('engine', '-')})")
    return 0
