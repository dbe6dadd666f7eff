"""Fleet host membership: beacon files under ``<fleet-dir>/hosts/`` (the
port of ``racon_tpu/fleet/registry.py``; the file format is JAX's, so
either package's gateway reads either package's hosts).

Each ``racon --serve SOCK --fleet-dir DIR`` host writes a beacon
(``hosts/<name>.json``, atomically, through :func:`exec.manifest.
atomic_write`) and refreshes its mtime every TTL/4 from a daemon thread,
as a lease keeper does; the payload is never rewritten.

The gateway reads the directory: a beacon fresher than
``RACON_TPU_FLEET_HOST_TTL_S`` is an alive host, a staler one a silent
host (its jobs' leases stop being refreshed and age out), and a removed
file (a clean shutdown unlinks it) an immediate goodbye. The gateway walks
each host along ``contracts.PLACEMENT_MACHINE``: registered -> alive <->
silent -> dead, and dead -> alive when a host restarts under its name.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, Optional

from .. import flags
from ..exec import manifest
from ..utils.logger import warn

HOSTS_DIR = "hosts"


def host_ttl_s() -> float:
    return max(0.05, flags.get_float("RACON_TPU_FLEET_HOST_TTL_S"))


def hosts_dir(fleet_dir: str) -> str:
    return os.path.join(os.path.abspath(fleet_dir), HOSTS_DIR)


def host_name(socket_path: str) -> str:
    """A stable member name from the serve socket's path: the basename
    less its extension, sanitized, so a restart on the same socket keeps
    its identity (the gateway's dead -> alive edge)."""
    base = os.path.basename(socket_path)
    stem = base.rsplit(".", 1)[0] if "." in base else base
    clean = "".join(c if c.isalnum() or c in "._-" else "_"
                    for c in stem)
    return clean or "host"


class HostBeacon:
    """One host's membership heartbeat (start/stop; a daemon thread)."""

    def __init__(self, fleet_dir: str, socket_path: str,
                 name: Optional[str] = None):
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.dir = hosts_dir(fleet_dir)
        self.socket_path = os.path.abspath(socket_path)
        self.name = name or host_name(socket_path)
        self.path = os.path.join(self.dir, f"{self.name}.json")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def announce(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        manifest.atomic_write(self.path, json.dumps({
            "name": self.name, "socket": self.socket_path,
            "pid": os.getpid(), "host": socket.gethostname(),
            "registered_unix": round(time.time(), 3),
        }, indent=1).encode())

    def start(self) -> "HostBeacon":
        self.announce()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"racon-fleet-beacon-{self.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Deregister: stop the keeper and remove the beacon, so the
        gateway sees a goodbye instead of waiting out the TTL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        except OSError as e:
            warn(f"fleet beacon {self.name}: deregister failed ({e}) "
                 f"— the gateway will age it out over the TTL")

    def _run(self) -> None:
        interval = host_ttl_s() / 4.0
        while not self._stop.wait(interval):
            try:
                os.utime(self.path)
            except FileNotFoundError:
                # swept or lost: announce again rather than let the
                # gateway declare a live host dead
                try:
                    self.announce()
                except OSError as e:
                    warn(f"fleet beacon {self.name}: re-register "
                         f"failed ({e}); retrying next interval")
            except OSError as e:
                warn(f"fleet beacon {self.name}: heartbeat failed "
                     f"({e}); retrying next interval")


def read_hosts(fleet_dir: str,
               ttl_s: Optional[float] = None) -> Dict[str, dict]:
    """Every registered host's beacon payload with ``age_s`` (since its
    last heartbeat) and ``alive`` (that age within the TTL). Torn or
    unreadable beacons are skipped: the next announce heals them."""
    ttl = host_ttl_s() if ttl_s is None else ttl_s
    out: Dict[str, dict] = {}
    hdir = hosts_dir(fleet_dir)
    try:
        names = sorted(os.listdir(hdir))
    except OSError:
        return out
    now = time.time()
    for fname in names:
        if not fname.endswith(".json"):
            continue
        path = os.path.join(hdir, fname)
        try:
            st = os.stat(path)
            with open(path, "rb") as f:
                info = json.loads(f.read())
        except (OSError, ValueError):
            continue
        if not isinstance(info, dict) or "socket" not in info:
            continue
        age = max(0.0, now - st.st_mtime)
        info["age_s"] = round(age, 3)
        info["alive"] = age <= ttl
        out[info.get("name") or fname[:-5]] = info
    return out
