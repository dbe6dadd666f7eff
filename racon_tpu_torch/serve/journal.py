"""The durable job journal and result spool of the resident polishing
service (``racon --serve SOCK --serve-dir D``; a port of
``racon_tpu/serve/journal.py`` whose record and spool bytes are the JAX
package's, so each package's serve dir replays in the other's).

Every job lifecycle transition is journaled to an append-only file, one
fsync'd record at a time, and result payloads are spooled to CRC32-checked
files instead of held in the server's RAM: a server OOM, preemption or
SIGKILL loses nothing, and a restart on the same ``--serve-dir`` replays
the journal and picks every job back up
(:meth:`racon_tpu_torch.serve.service.PolishServer._recover`).

Serve-dir layout::

    D/
      journal.jsonl      # append-only, one JSON record per line
      spool/             # result payloads: result_<job>.fasta

Record grammar (``rec`` selects, ``contracts.JOURNAL_RECORDS``; every
record carries ``job``):

- ``submitted``: ``{job, key, cost, unix, spec}``, admitted into the queue
  (``key`` is the client's idempotency key, if any);
- ``running``: ``{job, worker, run}``, an execution began. The count of
  these for a job with no terminal record is how many times it died with
  its server: recovery walks it down the crash ladder (retry, then fail)
  instead of redoing it forever;
- ``done``: ``{job, bytes, crc32, spool, wall_s, engine}``, the payload is
  in the spool (size and CRC checked at every fetch after a restart);
- ``failed`` / ``cancelled``: terminal without a payload;
- ``collected``: the one-fetch payload was streamed to a client; the next
  compaction drops the job's records and its spool file.

Appends go through :func:`racon_tpu_torch.exec.manifest.append_durable`
(write, flush, fsync a record), spool files and compaction rewrites
through :func:`racon_tpu_torch.obs.report.atomic_write_bytes` (tmp, fsync,
rename) and a directory fsync: the exec manifest's crash ordering. A torn
last line (a crash mid-append) is dropped on replay.

**Compaction** keeps a long-lived server's serve dir bounded: at startup
(after replay), every :attr:`JobJournal.compact_every` appends and at exit,
the journal is rewritten to the live jobs' records (queued, running, or
done and not collected); retired jobs drop out, with orphaned spool files
and the ``*.tmp*`` litter of crashed writes.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import List, Optional, Tuple

from .. import contracts, faults, sanitize
from ..exec import manifest as mf
from ..obs import metrics
from ..obs.report import atomic_write_bytes
from ..utils.logger import log_swallowed, warn

JOURNAL_NAME = "journal.jsonl"
SPOOL_DIR = "spool"

# record types (the "rec" field): contracts.JOURNAL_RECORDS, the job
# machine's alphabet
SUBMITTED = contracts.JOB_SUBMITTED
RUNNING = contracts.JOB_RUNNING
DONE = contracts.JOB_DONE
FAILED = contracts.JOB_FAILED
CANCELLED = contracts.JOB_CANCELLED
COLLECTED = contracts.JOB_COLLECTED


class JobJournal:
    """The serve dir's journal and spool, behind one named lock
    (``serve.journal``: under ``RACON_TPU_SANITIZE=1`` it feeds the
    lock-order witness with the scheduler's locks)."""

    # appended records between automatic compactions (class attribute:
    # the size-bound test shrinks it)
    compact_every = 256

    def __init__(self, serve_dir: str):
        self.serve_dir = os.path.abspath(serve_dir)
        self.spool_dir = os.path.join(self.serve_dir, SPOOL_DIR)
        os.makedirs(self.spool_dir, exist_ok=True)
        self.path = os.path.join(self.serve_dir, JOURNAL_NAME)
        self.lock = sanitize.named_lock("serve.journal")
        self._f = None
        self._closed = False
        self.appends_since_rewrite = 0
        self.sweep_tmp()

    # ------------------------------------------------------------ hygiene

    def sweep_tmp(self) -> int:
        """Drop the ``*.tmp*`` litter of atomic writes that crashed between
        create and rename (a crash-restarted serve dir would otherwise
        collect it forever)."""
        swept = 0
        for d in (self.serve_dir, self.spool_dir):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if ".tmp" not in name:
                    continue
                try:
                    os.unlink(os.path.join(d, name))
                    swept += 1
                except OSError as e:
                    log_swallowed("serve: tmp-litter sweep failed", e)
        return swept

    # ------------------------------------------------------------- append

    def _handle(self):
        if self._f is None:
            # the handle stays open for the journal's life; every append
            # flushes and fsyncs through mf.append_durable, and every
            # write of _f (here, rewrite_locked, close) runs with
            # self.lock held by its caller
            self._f = open(self.path, "ab")
        return self._f

    def _truncate_to_locked(self, pos: int) -> None:
        """Roll a failed append back to its offset before the write
        (caller holds the lock): a write or flush that raised may have
        landed some bytes, and a retry on top of them would weld a torn
        prefix onto the record, one corrupt line that stops replay for
        every later job. The handle is dropped (its buffer may hold the
        partial record) and the file truncated."""
        if self._f is not None:
            try:
                self._f.close()
            except OSError as e:
                log_swallowed("serve: failed-append handle close", e)
            self._f = None
        try:
            with open(self.path, "ab") as f:
                f.truncate(pos)
        except OSError as e:
            log_swallowed("serve: journal rollback truncate failed "
                          "(replay drops the torn line)", e)

    def append(self, rec: dict, retries: int = 3) -> None:
        """Durably append one lifecycle record (fsync'd before return),
        with the transient-I/O retry ``manifest.durable_write`` gives
        checkpoints: a blip on a journal write must not kill a server
        whose work succeeded. A failed attempt rolls the file back to its
        size before the append, so a retry never leaves a torn record
        before its copy."""
        blob = json.dumps(rec, separators=(",", ":")).encode() + b"\n"
        delay = 0.05
        for k in range(retries + 1):
            try:
                with self.lock:
                    if self._closed:
                        return
                    faults.check("serve.journal")
                    f = self._handle()
                    # earlier appends were flushed and fsync'd, so the
                    # file's size is its logical end: the rollback point
                    pos = os.fstat(f.fileno()).st_size
                    try:
                        # the fsync under the lock is the lock's point: a
                        # record reaches the disk before another thread's
                        # record or a compaction interleaves
                        mf.append_durable(f, blob)
                    except OSError:
                        self._truncate_to_locked(pos)
                        raise
                    self.appends_since_rewrite += 1
                metrics.inc("serve.journal_records")
                return
            except OSError as e:
                if k >= retries or \
                        faults.classify(e) != faults.CLASS_TRANSIENT:
                    raise
                warn(f"transient fault appending to the job journal "
                     f"({e}) — retrying in {delay:.2f}s")
                time.sleep(delay)
                delay *= 2

    # ------------------------------------------------------------- replay

    def replay(self) -> List[dict]:
        """Every complete record, in append order. A torn or corrupt line
        ends the replay there: the fsync of every record makes all before
        a torn tail complete, and a corruption mid-file means the disk
        lied, so later records cannot be trusted (their jobs re-run)."""
        out: List[dict] = []
        try:
            with open(self.path, "rb") as f:
                lines = f.read().split(b"\n")
        except FileNotFoundError:
            return out
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                warn(f"job journal line {i + 1} is torn/corrupt — "
                     f"replay stops there (jobs past it re-run)")
                break
            if isinstance(rec, dict):
                out.append(rec)
        return out

    # --------------------------------------------------------- compaction

    def rewrite_locked(self, records: List[dict]) -> None:
        """The compaction, with :attr:`lock` held by the caller (the server
        snapshots its live jobs and rewrites under one hold, so no append
        slips between the two and is lost): the journal atomically
        replaced by the given records (tmp, fsync, rename, directory
        fsync)."""
        blob = b"".join(
            json.dumps(r, separators=(",", ":")).encode() + b"\n"
            for r in records)
        if self._f is not None:
            self._f.close()
            self._f = None
        # the rename lands before appends resume
        atomic_write_bytes(self.path, blob)
        mf.fsync_dir(self.serve_dir)
        self.appends_since_rewrite = 0
        metrics.inc("serve.journal_compactions")

    def rewrite(self, records: List[dict]) -> None:
        """:meth:`rewrite_locked` under the journal lock."""
        with self.lock:
            self.rewrite_locked(records)

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    # -------------------------------------------------------------- spool

    def spool_name(self, job_id: str) -> str:
        return f"result_{job_id}.fasta"

    def spool_path(self, job_id: str) -> str:
        return os.path.join(self.spool_dir, self.spool_name(job_id))

    def spool_write(self, job_id: str, blob: bytes) \
            -> Tuple[str, int, int]:
        """Durably spool one result payload (an atomic write); returns
        ``(spool name, byte size, crc32)`` for the ``done`` record that
        the fetch checks against."""
        crc = zlib.crc32(blob)
        atomic_write_bytes(self.spool_path(job_id), blob)
        mf.fsync_dir(self.spool_dir)
        return self.spool_name(job_id), len(blob), crc

    def spool_read(self, job_id: str, size: int,
                   crc32: int) -> Optional[bytes]:
        """The spooled payload, checked against its recorded size and CRC32;
        None when missing, truncated or corrupt (the caller re-queues the
        job, as the shard runner re-queues a corrupt part)."""
        try:
            with open(self.spool_path(job_id), "rb") as f:
                blob = f.read()
        except OSError:
            return None
        if len(blob) != size or zlib.crc32(blob) != crc32:
            warn(f"result spool for job {job_id} failed verification "
                 f"({len(blob)}B vs recorded {size}B) — treating the "
                 f"result as lost")
            return None
        return blob

    def spool_unlink(self, job_id: str) -> None:
        try:
            os.unlink(self.spool_path(job_id))
        except FileNotFoundError:
            pass
        except OSError as e:
            log_swallowed("serve: spool unlink failed", e)

    def sweep_spool(self, keep_jobs) -> int:
        """Unlink the spool files whose job is not in ``keep_jobs``: the
        orphans of collected or compacted jobs (run with compaction)."""
        keep = {self.spool_name(j) for j in keep_jobs}
        swept = 0
        try:
            names = os.listdir(self.spool_dir)
        except OSError:
            return 0
        for name in names:
            if name in keep or not name.startswith("result_"):
                continue
            try:
                os.unlink(os.path.join(self.spool_dir, name))
                swept += 1
            except OSError as e:
                log_swallowed("serve: orphan spool sweep failed", e)
        return swept

    # -------------------------------------------------------------- close

    def close(self) -> None:
        with self.lock:
            self._closed = True
            if self._f is not None:
                try:
                    self._f.close()
                except OSError as e:
                    log_swallowed("serve: journal close failed", e)
                self._f = None
