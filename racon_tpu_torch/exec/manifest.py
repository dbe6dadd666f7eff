"""The checkpoint manifest: the fsync'd JSON records that let a shard run
survive a crash (the port of ``racon_tpu/exec/manifest.py``).

Write order (crash ordering matters more than speed: one write a shard
transition):

1. a part file is written to ``<part>.tmp.<pid>.<ns>``, fsync'd and
   ``os.replace``d into place, so it exists whole or not at all;
2. the lease owner then writes the shard's state file (``state_0007.json``:
   tmp, fsync, atomic replace, directory fsync), the authoritative record
   of the shard; only a shard's lease owner writes it;
3. last it rewrites ``manifest.json`` as a snapshot: the plan and
   fingerprint with the state records laid over them. The state files are
   the truth and the snapshot is what ``--resume`` and a reader see.

``--resume`` trusts a shard when its record says ``done`` and its part
exists; before the merge every part is read again against its recorded
size and CRC32. A corrupt or truncated manifest counts as absent: the run
plans again and re-runs every shard. A fingerprint of the inputs and the
output-shaping parameters keeps a resume out of another run's directory.

:func:`create_manifest_if_absent` publishes the plan under an O_EXCL
``plan.lock``, so of several workers starting at once exactly one plans
and the others adopt its plan.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from .. import contracts, faults
from ..utils.logger import warn

MANIFEST_NAME = "manifest.json"
# the run report next to the manifest (same durable writes)
REPORT_NAME = "run_report.json"
STATE_PREFIX = "state_"
VERSION = 2

# a shard's states (contracts.SHARD_MACHINE): pending -> running -> done
# | quarantined, and back to pending when a part fails verification
PENDING = contracts.SHARD_PENDING
RUNNING = contracts.SHARD_RUNNING
DONE = contracts.SHARD_DONE
QUARANTINED = contracts.SHARD_QUARANTINED


def fsync_dir(path: str) -> None:
    """fsync a directory, so that a rename inside it survives power
    loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes) -> None:
    faults.check("manifest.write")
    # unique to the process and the call: two threads writing one target
    # must not tear each other's tmp file
    tmp = f"{path}.tmp.{os.getpid()}.{time.monotonic_ns()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def durable_write(path: str, data: bytes, retries: int = 3) -> None:
    """:func:`atomic_write` with a short retry of transient I/O faults
    (EINTR, a passing ENOSPC, an injected ``manifest.write`` fault): a
    blip on a checkpoint must not end a run whose work succeeded. Other
    faults, and the last retry's, raise."""
    delay = 0.05
    for k in range(retries + 1):
        try:
            atomic_write(path, data)
            return
        except OSError as e:
            if k >= retries or \
                    faults.classify(e) != faults.CLASS_TRANSIENT:
                raise
            warn(f"transient fault writing {os.path.basename(path)} "
                 f"({e}) — retrying in {delay:.2f}s")
            time.sleep(delay)
            delay *= 2


def save_manifest(work_dir: str, manifest: dict) -> None:
    manifest = dict(manifest, version=VERSION)
    durable_write(os.path.join(work_dir, MANIFEST_NAME),
                  json.dumps(manifest, indent=1).encode())


_PLAN_LOCK_STALE_S = 10.0


def create_manifest_if_absent(work_dir: str, manifest: dict) -> dict:
    """Publish ``manifest`` unless a valid one exists; returns the one on
    disk (ours, or the plan of a worker that won the race, which the
    caller must adopt). One plan wins, over a corrupt leftover manifest
    too: it is published under an O_EXCL ``plan.lock`` (a lock older than
    ``_PLAN_LOCK_STALE_S`` marks a dead publisher and is broken), and the
    losers poll until the winner's manifest reads."""
    path = os.path.join(work_dir, MANIFEST_NAME)
    lock = os.path.join(work_dir, "plan.lock")
    deadline = time.monotonic() + 60.0
    while True:
        existing = load_manifest(work_dir)
        if existing is not None:
            return existing
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                         0o644)
        except FileExistsError:
            try:
                # break a dead publisher's lock by renaming it to a
                # tombstone (one winner; an unlink could remove a new lock
                # taken between our stat and the unlink)
                if time.time() - os.stat(lock).st_mtime > \
                        _PLAN_LOCK_STALE_S:
                    os.rename(lock, f"{lock}.stale.{os.getpid()}."
                                    f"{time.monotonic_ns()}")
            except OSError:  # graftlint: disable=swallowed-exception (another worker broke or released it first)
                pass
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no worker managed to publish a valid manifest "
                    f"in {work_dir} (plan.lock contended for 60s)")
            time.sleep(0.02)
            continue
        os.close(fd)
        try:
            existing = load_manifest(work_dir)
            if existing is not None:
                return existing  # published while we took the lock
            out = dict(manifest, version=VERSION)
            atomic_write(path, json.dumps(out, indent=1).encode())
            return out
        finally:
            try:
                os.unlink(lock)
            except FileNotFoundError:
                pass


# ----------------------------------------------------- per-shard state

def state_path(work_dir: str, shard_id: int) -> str:
    return os.path.join(work_dir, f"{STATE_PREFIX}{shard_id:04d}.json")


def save_shard_state(work_dir: str, entry: dict) -> None:
    """Durably record one shard's state (its lease owner only)."""
    durable_write(state_path(work_dir, int(entry["id"])),
                  json.dumps(entry, indent=1).encode())


def load_shard_state(work_dir: str, shard_id: int) -> Optional[dict]:
    """One shard's state record (None when absent or torn)."""
    try:
        with open(state_path(work_dir, shard_id), "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def load_shard_states(work_dir: str) -> Dict[int, dict]:
    """Every readable shard state, by shard id (a torn state file is
    skipped with a warning: its shard counts as pending and runs again)."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(work_dir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(STATE_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(work_dir, name), "rb") as f:
                entry = json.loads(f.read())
            out[int(entry["id"])] = entry
        except (OSError, ValueError, KeyError, TypeError) as e:
            warn(f"shard state {name} is corrupt ({type(e).__name__}: "
                 f"{e}) — treating the shard as pending")
    return out


def merge_states(manifest: dict, states: Dict[int, dict]) -> dict:
    """Lay the state records over the manifest's shard entries (in place;
    also returns the manifest)."""
    for i, entry in enumerate(manifest["shards"]):
        st = states.get(int(entry["id"]))
        if st is not None and st.get("contigs") == entry.get("contigs"):
            manifest["shards"][i] = dict(st)
    return manifest


def load_manifest(work_dir: str) -> Optional[dict]:
    """The stored manifest, or None when absent, corrupt or of another
    version (with the reason on stderr)."""
    path = os.path.join(work_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
        if manifest.get("version") != VERSION:
            warn(f"manifest {path} has version "
                 f"{manifest.get('version')!r} (want {VERSION}) — "
                 f"ignoring it and re-running every shard")
            return None
        manifest["shards"]  # the required keys
        manifest["fingerprint"]
        return manifest
    except (OSError, ValueError, KeyError, TypeError) as e:
        warn(f"manifest {path} is corrupt ({type(e).__name__}: {e}) — "
             f"ignoring it and re-running every shard")
        return None


def input_fingerprint(paths, params: dict) -> dict:
    """A run's identity: the inputs' absolute paths and sizes and every
    parameter that shapes the output bytes. The sizing knobs
    (``--shards``, ``--max-ram``) and the plan are not in it: the shard
    boundaries do not change the merged bytes, a ``--max-ram`` plan
    depends on the planning process's RSS, and a bare ``--resume`` adopts
    the stored plan."""
    files = [{"path": os.path.abspath(p), "size": os.path.getsize(p)}
             for p in paths]
    return {"files": files, "params": params}
