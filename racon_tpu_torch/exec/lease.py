"""Shard leases: the O_EXCL claim files through which a worker owns a
shard (the port of ``racon_tpu/exec/lease.py``).

One lease file a shard (``lease_0007.json``) beside the manifest. The
protocol uses only portable filesystem atomics:

- **claim**: ``open(O_CREAT | O_EXCL)``, one claimant wins; the payload
  records the worker, pid, host and claim time (fsync'd);
- **heartbeat**: the owner refreshes the file's mtime every TTL/4
  (:class:`LeaseKeeper`, a daemon thread); the payload is never
  rewritten;
- **expiry**: a lease whose mtime is older than
  ``RACON_TPU_EXEC_LEASE_TTL_S`` marks a dead worker. A claimant breaks
  it by renaming it to a unique tombstone first (one of several racing
  claimants wins the rename), then claims afresh with O_EXCL. A claimant
  whose rename took a fresh lease (another claimant's, made after the
  stale one was seen) links it back and backs off. A lease whose owner
  ran on this host and whose pid is gone is broken at once;
- **release**: unlink on the shard's completion or quarantine.

A worker presumed dead but only slow finds out at its next heartbeat (the
file is gone, or is the reclaimer's: another inode) and stops treating
the shard as its own; its part write stays harmless, since parts are
written tmp -> rename and every worker writes the same bytes for a shard.

Every transition counts in the registry: ``lease.claimed``,
``lease.expired``, ``lease.lost``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Optional

from .. import flags
from ..obs import metrics
from ..utils.logger import warn

LEASE_PREFIX = "lease_"


def worker_identity() -> str:
    """This worker's id: ``RACON_TPU_WORKER``, else ``hostname:pid``."""
    override = flags.get_str("RACON_TPU_WORKER").strip()
    if override:
        return override
    return f"{socket.gethostname()}:{os.getpid()}"


def lease_ttl_s() -> float:
    return max(0.05, flags.get_float("RACON_TPU_EXEC_LEASE_TTL_S"))


def lease_path(work_dir: str, shard_id) -> str:
    """The lease file of one work item: an integer id is a shard ordinal
    (zero-padded, so ``ls`` sorts), a string id a fleet job lease
    (``job_<id>``); the protocol is the same for both."""
    tag = f"{shard_id:04d}" if isinstance(shard_id, int) else str(shard_id)
    return os.path.join(work_dir, f"{LEASE_PREFIX}{tag}.json")


class Lease:
    """An owned shard lease: refresh it with :meth:`heartbeat` (or its
    :class:`LeaseKeeper`), drop it with :meth:`release`."""

    def __init__(self, work_dir: str, shard_id, worker: str,
                 claimed_unix: float = 0.0, inode: Optional[int] = None):
        self.work_dir = work_dir
        self.shard_id = shard_id
        self.worker = worker
        self.claimed_unix = claimed_unix
        # the claimed file's inode: a reclaimer's lease at the same path is
        # another file
        self.inode = inode
        self.path = lease_path(work_dir, shard_id)
        self.lost = threading.Event()
        self._keeper: Optional["LeaseKeeper"] = None

    def heartbeat(self) -> bool:
        """Refresh the lease's mtime; False (and ``lost`` set) when the
        file is gone or is another claimant's: another worker broke it
        after a missed TTL, and this worker no longer owns the shard."""
        try:
            if self.inode is not None and \
                    os.stat(self.path).st_ino != self.inode:
                raise FileNotFoundError(self.path)
            os.utime(self.path)
            return True
        except FileNotFoundError:
            if not self.lost.is_set():
                self.lost.set()
                metrics.inc("lease.lost")
                warn(f"lease on shard {self.shard_id} was broken by "
                     f"another worker (missed heartbeats?) — "
                     f"{self.worker} no longer owns it")
            return False

    def start_keeper(self) -> "Lease":
        self._keeper = LeaseKeeper(self).start()
        return self

    def release(self) -> None:
        if self._keeper is not None:
            self._keeper.stop()
            self._keeper = None
        if self.lost.is_set():
            return  # the file on disk is the reclaimer's lease
        # unlink only what is still provably ours: a broken and reclaimed
        # shard has a new lease at the same path
        info = read_lease(self.work_dir, self.shard_id)
        if info is not None and (
                info.get("worker") != self.worker
                or info.get("pid") != os.getpid()
                or info.get("claimed_unix") != self.claimed_unix):
            self.lost.set()
            return
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


class LeaseKeeper:
    """A daemon thread refreshing a lease's mtime every TTL/4, the
    worker's liveness signal; it stops once the lease is lost."""

    def __init__(self, lease: Lease):
        self.lease = lease
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LeaseKeeper":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"racon-lease-{self.lease.shard_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def _run(self) -> None:
        interval = lease_ttl_s() / 4.0
        while not self._stop.wait(interval):
            if not self.lease.heartbeat():
                return


def read_lease(work_dir: str, shard_id) -> Optional[dict]:
    """The lease payload (None when absent or torn); a claim never trusts
    it, only O_EXCL and the mtime."""
    try:
        with open(lease_path(work_dir, shard_id), "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def _pid_alive(pid) -> bool:
    """Whether a same-host lease owner lives; an unknown or unreadable
    pid counts as alive (the TTL then decides)."""
    if not isinstance(pid, int) or pid <= 0:
        return True
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def try_claim(work_dir: str, shard_id, worker: str,
              ttl_s: Optional[float] = None,
              keeper: bool = True) -> Optional[Lease]:
    """Claim a shard: an owned :class:`Lease` with its keeper running, or
    None while another worker holds a live lease. A lease past its TTL,
    or a same-host lease whose pid is gone, is broken (renamed to a
    tombstone: atomic, one winner) and claimed afresh. With
    ``keeper=False`` no keeper starts: the fleet gateway heartbeats its
    job leases by hand, only while the owning host's beacon is fresh, so
    a dead host's leases age out and a claimant must break them."""
    ttl = lease_ttl_s() if ttl_s is None else ttl_s
    path = lease_path(work_dir, shard_id)
    try:
        st = os.stat(path)
    except FileNotFoundError:
        pass
    else:
        if time.time() - st.st_mtime <= ttl:
            info = read_lease(work_dir, shard_id)
            if not (info is not None
                    and info.get("host") == socket.gethostname()
                    and not _pid_alive(info.get("pid"))):
                return None
        tomb = f"{path}.stale.{os.getpid()}.{time.monotonic_ns()}"
        try:
            os.rename(path, tomb)
        except OSError:
            return None  # a racing claimant broke it first
        # the rename took whatever lay at the path: a claimant that broke
        # the stale lease and claimed afresh after our stat put its live
        # lease there. Give that one back (a link replaces no newer
        # claim) and back off
        try:
            taken = os.stat(tomb)
            stolen = (taken.st_ino, taken.st_mtime_ns) != \
                (st.st_ino, st.st_mtime_ns)
            if stolen:
                os.link(tomb, path)
        except OSError:  # graftlint: disable=swallowed-exception (the owner finds the loss at its next heartbeat)
            stolen = True
        try:
            os.unlink(tomb)
        except OSError:  # graftlint: disable=swallowed-exception (the tombstone's removal is best-effort)
            pass
        if stolen:
            return None
        metrics.inc("lease.expired")
        warn(f"lease on shard {shard_id} expired "
             f"(no heartbeat for > {ttl:.1f}s) — {worker} is breaking "
             f"it and reclaiming the shard")
    claimed_unix = round(time.time(), 3)
    payload = json.dumps({
        "worker": worker, "pid": os.getpid(),
        "host": socket.gethostname(),
        "claimed_unix": claimed_unix,
    }, indent=1).encode()
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        return None
    try:
        os.write(fd, payload)
        os.fsync(fd)
        inode = os.fstat(fd).st_ino
    finally:
        os.close(fd)
    metrics.inc("lease.claimed")
    lease = Lease(work_dir, shard_id, worker, claimed_unix=claimed_unix,
                  inode=inode)
    return lease.start_keeper() if keeper else lease
