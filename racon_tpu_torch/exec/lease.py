"""Shard leases: the O_EXCL claim files through which a worker owns a
shard (the port of ``racon_tpu/exec/lease.py``).

One lease file a shard (``lease_0007.json``) beside the manifest. The
protocol uses filesystem atomics and one advisory lock:

- **claim**: ``open(O_CREAT | O_EXCL)``, one claimant wins; the payload
  records the worker, pid, host, claim time and a random 64-bit claim
  ``token`` (fsync'd). The token, not the inode, names the claim: a
  filesystem may give a freed inode number to the next lease at the path;
- **heartbeat**: the owner refreshes the file's mtime every TTL/4
  (:class:`LeaseKeeper`, a daemon thread) through a descriptor of the file
  whose token it has just read; the payload is never rewritten;
- **expiry**: a lease whose mtime is older than
  ``RACON_TPU_EXEC_LEASE_TTL_S`` marks a dead worker, and so does a lease
  whose owner ran on this host and whose pid is gone. A claimant breaks
  it under the break lock, an exclusive ``flock`` on ``<lease>.break``
  that the kernel drops when its holder dies: it reads the lease again
  under the lock and unlinks it only while it is still the stale claim it
  saw, then claims afresh with O_EXCL and lets go of the lock. A lease
  file leaves its path only under that lock (a break or a release), so
  the file a breaker checked is the file it unlinks, and one break yields
  at most one winner;
- **release**: unlink on the shard's completion or quarantine, under the
  break lock (waited for at most a TTL), only while the file holds the
  owner's token.

On NFS, Linux maps ``flock`` to a byte-range lock, which excludes across
hosts but not between two descriptors of one process.

A worker presumed dead but only slow finds out at its next heartbeat (the
file is gone, or holds the reclaimer's token) and stops treating the
shard as its own; its part write stays harmless, since parts are written
tmp -> rename and every worker writes the same bytes for a shard.

Every transition counts in the registry: ``lease.claimed``,
``lease.expired``, ``lease.lost``.
"""

from __future__ import annotations

import fcntl
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
# the break lock beside a lease file (``lease_0007.json.break``): no scan
# of a work or fleet dir takes it for a lease, a state or a part
BREAK_SUFFIX = ".break"


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
                 claimed_unix: float = 0.0, token: Optional[int] = None,
                 ttl_s: Optional[float] = None):
        self.work_dir = work_dir
        self.shard_id = shard_id
        self.worker = worker
        self.claimed_unix = claimed_unix
        # the claim's token: a reclaimer's lease at the same path holds
        # another one, whatever inode the filesystem gave it
        self.token = token
        self.ttl_s = lease_ttl_s() if ttl_s is None else ttl_s
        self.path = lease_path(work_dir, shard_id)
        self.lost = threading.Event()
        self._keeper: Optional["LeaseKeeper"] = None

    def _mark_lost(self) -> None:
        if not self.lost.is_set():
            self.lost.set()
            metrics.inc("lease.lost")
            warn(f"lease on shard {self.shard_id} was broken by "
                 f"another worker (missed heartbeats?) — "
                 f"{self.worker} no longer owns it")

    def heartbeat(self) -> bool:
        """Refresh the lease's mtime; False (and ``lost`` set) when the
        file is gone or holds another claim's token: another worker broke
        it after a missed TTL, and this worker no longer owns the shard.
        The token is read from, and the mtime set on, one open descriptor,
        so a file that replaced ours between the two is never refreshed."""
        try:
            fd = os.open(self.path, os.O_RDONLY)
        except FileNotFoundError:
            self._mark_lost()
            return False
        try:
            if _fd_token(fd) != self.token:
                self._mark_lost()
                return False
            os.utime(fd)
            return True
        finally:
            os.close(fd)

    def start_keeper(self) -> "Lease":
        self._keeper = LeaseKeeper(self).start()
        return self

    def release(self) -> None:
        if self._keeper is not None:
            self._keeper.stop()
            self._keeper = None
        if self.lost.is_set():
            return  # the file on disk is the reclaimer's lease
        # unlink only what is still provably ours, under the break lock: a
        # broken and reclaimed shard has a new lease at the same path
        lock = _take_break_lock(self.path, wait_s=self.ttl_s)
        if lock is None:
            return  # a claimant stuck mid-break: the lease ages out
        try:
            if _path_token(self.path) != self.token:
                self.lost.set()
                return
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
        finally:
            _drop_break_lock(self.path, lock)


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
    it, only O_EXCL, the mtime and the token."""
    try:
        with open(lease_path(work_dir, shard_id), "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def _fd_payload(fd: int) -> Optional[dict]:
    try:
        data = b""
        while True:
            chunk = os.read(fd, 65536)
            if not chunk:
                break
            data += chunk
        info = json.loads(data)
    except (OSError, ValueError):
        return None
    return info if isinstance(info, dict) else None


def _fd_token(fd: int) -> Optional[int]:
    info = _fd_payload(fd)
    return None if info is None else info.get("token")


def _path_token(path: str) -> Optional[int]:
    """The token of the lease file at ``path`` (None when it is absent,
    torn or has none)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        return _fd_token(fd)
    finally:
        os.close(fd)


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


def _take_break_lock(path: str, wait_s: float = 0.0) -> Optional[int]:
    """Take the break lock ``<lease>.break`` of the lease at ``path``: an
    exclusive ``flock`` on the lock file, returned as its open descriptor,
    or None while another claimant holds it (after ``wait_s`` seconds of
    retries). The kernel drops the lock when its holder dies, so a dead
    claimant's lock never needs breaking. A holder unlinks the file before
    it lets go, so a lock taken on a file that has since left the path is
    let go again and the path's new file tried: the lock held is always
    that of the file the path names."""
    lock = path + BREAK_SUFFIX
    deadline = time.monotonic() + wait_s
    while True:
        fd = os.open(lock, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            os.close(fd)
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.001)
            continue
        except BaseException:
            os.close(fd)
            raise
        held = os.fstat(fd)
        try:
            named = os.stat(lock)
        except FileNotFoundError:
            named = None
        if named is not None and (named.st_dev, named.st_ino) == (
                held.st_dev, held.st_ino):
            return fd
        # its holder unlinked it while we waited: our descriptor keeps
        # that inode alive, so the path's file is another one
        os.close(fd)


def _drop_break_lock(path: str, fd: int) -> None:
    """Let go of the break lock held through ``fd``: unlink the file, then
    close the descriptor (which drops the flock)."""
    try:
        os.unlink(path + BREAK_SUFFIX)
    except FileNotFoundError:
        pass
    finally:
        os.close(fd)


def _new_token() -> int:
    return int.from_bytes(os.urandom(8), "little")


def _stale_claim(path: str, ttl: float) -> Optional[object]:
    """The identity (token, or the file's stat when it has none) of the
    lease at ``path`` when it is stale: older than ``ttl``, or a same-host
    lease whose pid is gone. None when the path is empty or the lease is
    live. Payload and mtime are read through one descriptor."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except FileNotFoundError:
        return None
    try:
        st = os.fstat(fd)
        info = _fd_payload(fd)
    finally:
        os.close(fd)
    if time.time() - st.st_mtime <= ttl and not (
            info is not None and info.get("host") == socket.gethostname()
            and not _pid_alive(info.get("pid"))):
        return None
    token = None if info is None else info.get("token")
    return token if token is not None else (st.st_ino, st.st_mtime_ns)


def try_claim(work_dir: str, shard_id, worker: str,
              ttl_s: Optional[float] = None,
              keeper: bool = True) -> Optional[Lease]:
    """Claim a shard: an owned :class:`Lease` with its keeper running, or
    None while another worker holds a live lease (or is breaking a stale
    one). A lease past its TTL, or a same-host lease whose pid is gone, is
    broken under the break lock (checked again there, then unlinked) and
    claimed afresh. With ``keeper=False`` no keeper starts:
    the fleet gateway heartbeats its job leases by hand, only while the
    owning host's beacon is fresh, so a dead host's leases age out and a
    claimant must break them."""
    ttl = lease_ttl_s() if ttl_s is None else ttl_s
    path = lease_path(work_dir, shard_id)
    lock = None
    if os.path.lexists(path):
        seen = _stale_claim(path, ttl)
        if seen is None:
            return None
        lock = _take_break_lock(path)
        if lock is None:
            return None  # a racing claimant is breaking it
        try:
            # under the lock no other claimant removes the file, and its
            # owner cannot release it: if it is still the stale claim we
            # saw, the unlink takes exactly that file
            broke = _stale_claim(path, ttl) == seen
            if broke:
                os.unlink(path)
        except BaseException:
            _drop_break_lock(path, lock)
            raise
        if not broke:
            _drop_break_lock(path, lock)
            return None
        metrics.inc("lease.expired")
        warn(f"lease on shard {shard_id} expired "
             f"(no heartbeat for > {ttl:.1f}s) — {worker} is breaking "
             f"it and reclaiming the shard")
    try:
        claimed_unix = round(time.time(), 3)
        token = _new_token()
        payload = json.dumps({
            "worker": worker, "pid": os.getpid(),
            "host": socket.gethostname(),
            "claimed_unix": claimed_unix, "token": token,
        }, indent=1).encode()
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return None
        try:
            os.write(fd, payload)
            os.fsync(fd)
        finally:
            os.close(fd)
    finally:
        if lock is not None:
            _drop_break_lock(path, lock)
    metrics.inc("lease.claimed")
    lease = Lease(work_dir, shard_id, worker, claimed_unix=claimed_unix,
                  token=token, ttl_s=ttl)
    return lease.start_keeper() if keeper else lease
