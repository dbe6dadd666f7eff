"""The fleet gateway: one TCP front door over N resident serve hosts (the
port of ``racon_tpu/fleet/gateway.py``).

``racon --gateway HOST:PORT --fleet-dir DIR`` listens on TCP and speaks
the serve protocol unchanged, so the same
:class:`racon_tpu_torch.serve.client.ServiceClient` drives one host or a
whole fleet. What the gateway adds:

- **durable admission**: every accepted job is journaled into a fleet
  :class:`racon_tpu_torch.serve.journal.JobJournal` under ``--fleet-dir``
  before the acknowledgment goes out, so a restarted gateway recovers as
  a restarted server does and idempotency keys hold fleet-wide;
- **weighted-fair tenancy**: per-tenant FIFO queues drained by stride
  scheduling (``RACON_TPU_FLEET_TENANTS=name:weight:budget``), per-tenant
  cost budgets that reject with the reason, and priority preemption that
  drains a placed low-priority job back to the queue (the host's
  cooperative ``preempt`` op) rather than killing it;
- **lease-backed placement**: jobs go to the least-loaded alive host
  under a per-job :mod:`racon_tpu_torch.exec.lease` lease, claimed with
  the keeper off: the gateway refreshes a job's lease only while its
  host's beacon is fresh, so a dead host's leases age out and a reclaim
  must break them (one winner). A host silent past
  ``RACON_TPU_FLEET_HOST_TTL_S`` has its jobs placed on survivors;
  results already collected into the fleet spool serve without a second
  polish.

Placement incarnations ride the journal: each placement appends a
``running`` record with the host and the host-side idempotency key
(``<job>:i<n>``). Contacting the same host again (a gateway restart, a
host restarted with ``--serve-dir``) reuses the key, and the host serves
its spooled result; a different host gets a fresh incarnation, since a
key the old host answered ``cancelled`` must not pin the new host to that
answer.

The gateway does no device work: it builds no engine and makes no
``torch.cuda`` call, so it holds no CUDA context. Its listener is woken at
shutdown by one connection, since ``shutdown()`` on a listening socket
fails under some kernels (gVisor's ENOTCONN) and leaves ``accept()``
blocked.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import contracts, faults, flags, obs, sanitize
from ..exec import lease as lease_mod
from ..exec.planner import cached_job_cost
from ..io import parsers
from ..obs import metrics
from ..serve import protocol
from ..serve.client import ServiceClient
from ..serve.journal import JobJournal
from ..utils.logger import log_swallowed, warn
from . import registry
from .tenants import TenantScheduler, parse_tenants

# fleet-job lifecycle: the contract-declared `tenant` machine
ACCEPTED = contracts.TENANT_ACCEPTED
QUEUED = contracts.TENANT_QUEUED
PLACED = contracts.TENANT_PLACED
DONE = contracts.TENANT_DONE
FAILED = contracts.TENANT_FAILED
CANCELLED = contracts.TENANT_CANCELLED
COLLECTED = contracts.TENANT_COLLECTED
_TERMINAL = (DONE, FAILED, CANCELLED)

# host lifecycle: the contract-declared `placement` machine
H_REGISTERED = contracts.HOST_REGISTERED
H_ALIVE = contracts.HOST_ALIVE
H_SILENT = contracts.HOST_SILENT
H_DEAD = contracts.HOST_DEAD

DEFAULT_RESULT_TIMEOUT_S = 600.0

# host submit-rejection answers that are HOST-LOCAL, not verdicts on
# the job: a queue filled by direct (non-gateway) submissions, a
# member started with a smaller --serve-budget, a drain in progress.
# These requeue (bounded, with the rejecting host deprioritized);
# everything else — profile mismatch, bad spec — is deterministic and
# fails the job terminally.
TRANSIENT_REJECT_MARKERS = ("queue full", "exceeds the service budget",
                            "draining")
MAX_TRANSIENT_REJECTS = 32


def _rejection_is_transient(error: str) -> bool:
    return any(m in error for m in TRANSIENT_REJECT_MARKERS)


def parse_gateway_address(address: str) -> Tuple[str, int]:
    """``HOST:PORT`` (port 0 = ephemeral, host empty = loopback)."""
    host, sep, port = address.rpartition(":")
    if not sep or not port.lstrip("-").isdigit() or int(port) < 0:
        raise ValueError(
            f"--gateway address {address!r} is not HOST:PORT")
    return host or "127.0.0.1", int(port)


def _eprint(msg: str) -> None:
    import sys
    print(f"[racon_tpu::fleet] {msg}", file=sys.stderr, flush=True)


class FleetJob:
    """One fleet-admitted job: spec, cost, tenant routing, placement
    incarnations, and the collected result's fleet-spool coordinates.
    The lifecycle attribute is ``stage`` and every move through it is
    asserted against the declared ``tenant`` state machine."""

    def __init__(self, job_id: str, spec: dict, cost: int,
                 key: Optional[str]):
        self.id = job_id
        self.spec = spec
        self.cost = cost
        self.tenant = str(spec.get("tenant", "default"))
        self.priority = int(spec.get("priority", 0))
        self.key = key
        self.stage = ACCEPTED
        self.error: Optional[str] = None
        self.engine: Optional[str] = None
        self.wall_s = 0.0
        self.submitted_unix = time.time()
        # placement bookkeeping: current host + host-side job id/key,
        # the journal's `running` incarnation records, and the lease
        # owned on this job's behalf while it is placed
        self.host: Optional[str] = None
        self.host_job: Optional[str] = None
        self.host_key: Optional[str] = None
        self.journal_runs = 0
        self.run_records: List[dict] = []
        self.lease: Optional[lease_mod.Lease] = None
        self.prior_host: Optional[str] = None
        self.prior_key: Optional[str] = None
        self.preempt_requested = False
        self.migrations = 0
        # host-local rejections (queue full, smaller budget, drain):
        # requeue-and-try-elsewhere bookkeeping, never terminal on
        # the first answer
        self.host_rejects = 0
        self.rejected_hosts: set = set()
        # answered FAILED in RAM by a hard stop, but still journaled
        # `submitted` on disk: the final compaction must keep it live
        # so the restarted gateway runs it
        self.shutdown_orphan = False
        # collected result (always spooled: the gateway is durable by
        # construction — no fleet journal, no gateway)
        self.spool: Optional[str] = None
        self.result_bytes = 0
        self.crc32 = 0
        self.report: Optional[dict] = None
        self.collected = False
        self.done = threading.Event()

    def row(self) -> dict:
        out = {"job": self.id, "state": self.stage,
               "tenant": self.tenant, "priority": self.priority,
               "cost_bytes": self.cost,
               "submitted_unix": round(self.submitted_unix, 3)}
        if self.host:
            out["host"] = self.host
        if self.migrations:
            out["migrations"] = self.migrations
        if self.stage in _TERMINAL:
            out["wall_s"] = round(self.wall_s, 3)
            out["bytes"] = self.result_bytes
        if self.engine:
            out["engine"] = self.engine
        if self.error:
            out["error"] = self.error
        return out


class Gateway:
    """The multi-tenant fleet front door (see the module docstring).
    One listener thread + per-connection handlers mutate admission
    state; ONE placement thread does every bit of host I/O (beacons,
    submits, status polls, result fetches, preempts) — snapshots are
    taken under the state lock, the I/O happens outside it."""

    def __init__(self, address: str, fleet_dir: str, *,
                 tenants: Optional[str] = None,
                 max_queue: int = 0):
        self.host, self.port = parse_gateway_address(address)
        self.fleet_dir = os.path.abspath(fleet_dir)
        os.makedirs(self.fleet_dir, exist_ok=True)
        self._journal = JobJournal(self.fleet_dir)
        self._lock = sanitize.named_lock("fleet.state")
        self._cond = threading.Condition(self._lock)
        raw = tenants if tenants is not None \
            else flags.get_str("RACON_TPU_FLEET_TENANTS")
        self._sched = TenantScheduler(parse_tenants(raw))
        self.max_queue = max_queue or max(
            1, flags.get_int("RACON_TPU_SERVE_QUEUE"))
        self._jobs: Dict[str, FleetJob] = {}
        self._by_key: Dict[str, str] = {}
        self._retired: List[str] = []
        self.max_retained_jobs = 1024
        self._next_id = 0
        self._counts = {"submitted": 0, "rejected": 0, "done": 0,
                        "failed": 0, "cancelled": 0, "migrated": 0,
                        "preempted": 0}
        # host membership as the gateway sees it: beacon payloads,
        # per-host `placement`-machine stage, advertised worker
        # counts, and how many jobs are placed on each
        self._host_info: Dict[str, dict] = {}
        self._host_stage: Dict[str, str] = {}
        # advertised healthy-worker counts, (count, fetched_monotonic):
        # entries age out over the host TTL (slot quarantine shrinks a
        # live host's count) and drop on death or re-registration
        self._host_workers: Dict[str, Tuple[int, float]] = {}
        self._placed: Dict[str, FleetJob] = {}
        self._draining = False
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._placer: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._t0 = time.perf_counter()
        self.started = threading.Event()
        self.recovery: Dict[str, int] = {}

    # ------------------------------------------------------ state helpers

    def _advance(self, job: FleetJob, stage: str) -> None:
        """Move a job along the declared ``tenant`` machine — an
        undeclared transition is a bug, not a judgment call."""
        if not contracts.TENANT_MACHINE.has_edge(job.stage, stage):
            raise AssertionError(
                f"fleet job {job.id}: undeclared tenant transition "
                f"{job.stage!r} -> {stage!r}")
        job.stage = stage

    def _host_advance_locked(self, name: str, stage: str) -> None:
        """Move a host along the declared ``placement`` machine (a
        same-state write is a no-op, not a transition) — like
        :meth:`_advance`, an undeclared edge is a bug."""
        prev = self._host_stage.get(name, H_REGISTERED)
        if prev == stage:
            return
        if not contracts.PLACEMENT_MACHINE.has_edge(prev, stage):
            raise AssertionError(
                f"fleet host {name}: undeclared placement transition "
                f"{prev!r} -> {stage!r}")
        self._host_stage[name] = stage  # graftlint: disable=lock-discipline (caller holds _lock)

    def _retire_locked(self, job: FleetJob) -> None:
        """Terminal bookkeeping under the state lock: counts, the
        bounded retained-history horizon, budget release."""
        n = self._counts.get(job.stage, 0) + 1
        self._counts[job.stage] = n  # graftlint: disable=lock-discipline (caller holds _cond)
        self._retired.append(job.id)
        while len(self._retired) > self.max_retained_jobs:
            old = self._jobs.pop(self._retired.pop(0), None)
            if old is not None and old.key:
                self._by_key.pop(old.key, None)
        if job.stage in (FAILED, CANCELLED):
            self._sched.uncharge(job.tenant, job.cost)
        job.done.set()
        self._cond.notify_all()

    # ---------------------------------------------------------- admission

    def _admit(self, raw_spec: dict, key: Optional[str]) \
            -> Tuple[Optional[FleetJob], Optional[str], bool]:
        """Fleet admission: normalize + stat the spec (shared-FS
        paths), price it through the fingerprint-cached cost model,
        check the tenant's budget, journal ``submitted`` durably, THEN
        queue — the write-ahead order that makes the acknowledgment a
        promise a restart keeps."""
        if key:
            with self._lock:
                jid = self._by_key.get(key)
                prior = self._jobs.get(jid) if jid else None
            if prior is not None and prior.stage != FAILED:
                return prior, None, True
        if self._draining:
            return None, (
                "gateway is draining: admission is stopped — resubmit "
                "to the restarted gateway (your idempotency key keeps "
                "it safe)"), False
        spec, err = protocol.normalize_spec(raw_spec)
        if err is not None:
            return None, err, False
        for pkey in protocol.SPEC_PATHS:
            if pkey == "overlaps" \
                    and parsers.is_auto_overlaps(spec[pkey]):
                continue
            spec[pkey] = os.path.abspath(spec[pkey])
            if not os.path.isfile(spec[pkey]):
                return None, (f"input not found on the fleet "
                              f"filesystem: {spec[pkey]}"), False
        cost = cached_job_cost(spec["sequences"], spec["overlaps"],
                               spec["target_sequences"])
        with self._cond:
            if len(self._sched) >= self.max_queue:
                return None, (
                    f"fleet queue full ({self.max_queue} jobs "
                    f"waiting; RACON_TPU_SERVE_QUEUE raises the "
                    f"bound)"), False
            reason = self._sched.admit_check(spec["tenant"], cost)
            if reason is not None:
                return None, reason, False
            if key and key in self._by_key:
                prior = self._jobs.get(self._by_key[key])
                if prior is not None and prior.stage != FAILED:
                    return prior, None, True
            self._next_id += 1
            job = FleetJob(f"g{self._next_id}", spec, cost, key or None)
            self._jobs[job.id] = job
            if job.key:
                self._by_key[job.key] = job.id
            self._sched.charge(job.tenant, cost)
        try:
            self._journal.append({
                "rec": "submitted", "job": job.id, "key": job.key,
                "cost": cost, "unix": round(job.submitted_unix, 3),
                "spec": spec})
        # graftlint: disable=swallowed-exception (the failure IS the reply)
        except Exception as e:
            with self._cond:
                job.stage = FAILED
                job.error = (f"fleet journal write failed "
                             f"({type(e).__name__}: {e})")
                self._retire_locked(job)
            return None, (f"fleet journal write failed "
                          f"({type(e).__name__}: {e}) — the fleet-dir "
                          f"is not accepting durable admissions"), False
        with self._cond:
            self._advance(job, QUEUED)
            self._sched.push(job.tenant, job, job.priority)
            self._counts["submitted"] += 1
            self._cond.notify_all()
        metrics.inc("gateway.accepted")
        metrics.inc(f"fleet.tenant.{job.tenant}.accepted")
        return job, None, False

    # ----------------------------------------------------------- recovery

    def _recover(self) -> None:
        """Replay the fleet journal, as a ``--serve-dir`` server replays
        its own: collected jobs drop, done jobs with a verified spool
        keep serving without re-polish, live jobs re-enter the tenant
        queues — a job whose last record is a placement incarnation
        remembers its host + key so re-contact dedupes instead of
        re-polishing."""
        records = self._journal.replay()
        if not records:
            return
        jobs: Dict[str, FleetJob] = {}
        terminal: Dict[str, dict] = {}
        collected = set()
        for rec in records:
            kind, jid = rec.get("rec"), rec.get("job")
            if not jid:
                continue
            if kind == "submitted" and isinstance(rec.get("spec"),
                                                  dict):
                spec, err = protocol.normalize_spec(rec["spec"])
                if err is not None:
                    continue
                job = FleetJob(jid, spec, int(rec.get("cost", 0)),
                               rec.get("key") or None)
                job.submitted_unix = float(
                    rec.get("unix", job.submitted_unix))
                jobs[jid] = job
            elif kind == "running" and jid in jobs:
                job = jobs[jid]
                job.journal_runs = int(rec.get("run",
                                               job.journal_runs + 1))
                job.run_records.append(dict(rec))
                job.prior_host = rec.get("host")
                job.prior_key = rec.get("hkey")
                terminal.pop(jid, None)
            elif kind in ("done", "failed", "cancelled"):
                terminal[jid] = rec
            elif kind == "collected":
                collected.add(jid)
        # spool verification is file I/O — done BEFORE taking the
        # state lock (the locked commit below touches memory only)
        spool_ok: Dict[str, bool] = {}
        for jid, term in terminal.items():
            if term["rec"] == "done" and jid in jobs \
                    and jid not in collected:
                spool_ok[jid] = self._journal.spool_read(
                    jid, int(term.get("bytes", 0)),
                    int(term.get("crc32", 0))) is not None
        recovered = requeued = served = 0
        with self._cond:
            for jid, job in jobs.items():
                try:
                    self._next_id = max(self._next_id,
                                        int(jid.lstrip("g")))
                except ValueError:
                    pass
                if jid in collected:
                    continue
                term = terminal.get(jid)
                if term is not None and term["rec"] == "done":
                    if spool_ok.get(jid):
                        job.stage = DONE
                        job.spool = term.get("spool")
                        job.result_bytes = int(term.get("bytes", 0))
                        job.crc32 = int(term.get("crc32", 0))
                        job.wall_s = float(term.get("wall_s", 0.0))
                        job.engine = term.get("engine")
                        job.done.set()
                        self._jobs[jid] = job
                        if job.key:
                            self._by_key[job.key] = jid
                        self._sched.charge(job.tenant, job.cost)
                        served += 1
                        continue
                    term = None  # lost spool: the job re-runs
                if term is not None:
                    # failed/cancelled with the client already
                    # answerable: keep the terminal row servable,
                    # nothing to re-run
                    job.stage = FAILED if term["rec"] == "failed" \
                        else CANCELLED
                    job.error = term.get("error") or None
                    job.done.set()
                    self._jobs[jid] = job
                    self._retired.append(jid)
                    if job.key:
                        self._by_key[job.key] = jid
                    continue
                # live: back into its tenant queue (prior host/key
                # ride along so placement re-contacts instead of
                # re-running)
                job.stage = QUEUED
                self._jobs[jid] = job
                if job.key:
                    self._by_key[job.key] = jid
                self._sched.charge(job.tenant, job.cost)
                self._sched.push(job.tenant, job, job.priority)
                recovered += 1
                if job.journal_runs:
                    requeued += 1
        self.recovery = {"jobs_recovered": recovered,
                         "jobs_requeued": requeued,
                         "results_served": served}
        if recovered or served:
            _eprint(f"recovery: {recovered} live job(s) re-queued "
                    f"({requeued} with placement history), {served} "
                    f"spooled result(s) kept servable")

    # ---------------------------------------------------- host membership

    def _refresh_hosts(self) -> None:
        """Read the beacon directory and walk each host along the
        declared ``placement`` machine; a host crossing into DEAD has
        its placed jobs migrated to survivors."""
        ttl = registry.host_ttl_s()
        beacons = registry.read_hosts(self.fleet_dir, ttl_s=ttl)
        newly_dead: List[str] = []
        with self._lock:
            names = set(beacons) | set(self._host_stage)
            for name in sorted(names):
                prev = self._host_stage.get(name, H_REGISTERED)
                info = beacons.get(name)
                cached = self._host_info.get(name)
                if info is not None and cached is not None and (
                        info.get("pid") != cached.get("pid")
                        or info.get("registered_unix")
                        != cached.get("registered_unix")):
                    # same name, new incarnation: the restarted host
                    # may run fewer workers — re-learn the count
                    self._host_workers.pop(name, None)
                if info is None or info["age_s"] > ttl:
                    # withdrawn beacon = clean goodbye; stale past the
                    # TTL = presumed dead — either way placements on
                    # it must move
                    if prev == H_ALIVE:
                        self._host_advance_locked(name, H_SILENT)
                        prev = H_SILENT
                    if prev in (H_SILENT, H_REGISTERED):
                        self._host_advance_locked(name, H_DEAD)
                        self._host_workers.pop(name, None)
                        newly_dead.append(name)
                        metrics.inc("fleet.hosts_dead")
                elif info["age_s"] > ttl / 2.0:
                    if prev == H_ALIVE:
                        self._host_advance_locked(name, H_SILENT)
                else:
                    self._host_advance_locked(name, H_ALIVE)
                if info is not None:
                    self._host_info[name] = info
            alive = sum(1 for s in self._host_stage.values()
                        if s == H_ALIVE)
        metrics.set_gauge("fleet.hosts_alive", alive)
        for name in newly_dead:
            warn(f"fleet host {name} is dead (no heartbeat within "
                 f"{ttl:.1f}s) — breaking its job leases and "
                 f"re-placing on survivors")
            self._migrate_host(name)

    def _alive_hosts(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._host_stage.items()
                    if s == H_ALIVE]

    def _host_socket(self, name: str) -> Optional[str]:
        with self._lock:
            info = self._host_info.get(name)
        return info.get("socket") if info else None

    def _host_capacity(self, name: str) -> int:
        """Free placement slots on a host: its advertised healthy
        worker count minus the jobs the gateway already placed
        there."""
        sock = self._host_socket(name)
        if sock is None:
            return 0
        now = time.monotonic()
        with self._lock:
            entry = self._host_workers.get(name)
            load = sum(1 for j in self._placed.values()
                       if j.host == name)
        workers: Optional[int] = None
        if entry is not None and now - entry[1] <= \
                registry.host_ttl_s():
            workers = entry[0]
        if workers is None:
            # first sight, stale, or invalidated by death /
            # re-registration: re-learn the advertised count
            try:
                with ServiceClient(sock, timeout_s=10.0,
                                   retries=0) as client:
                    workers = max(1, int(client.ping().get("workers",
                                                           1)))
            except (OSError, ConnectionError):
                return 0
            with self._lock:
                self._host_workers[name] = (workers, now)
        return max(0, workers - load)

    # ---------------------------------------------------------- placement

    def _host_key_for(self, job: FleetJob, host: str) -> str:
        """The host-side idempotency key for this placement: REUSED on
        the job's prior host (its journal/spool dedupes — no
        re-polish), FRESH anywhere else (the old host may have
        answered this key ``cancelled``, and a new host must not
        inherit that answer)."""
        if host == job.prior_host and job.prior_key:
            return job.prior_key
        return f"{job.id}:i{job.journal_runs + 1}"

    def _place(self, job: FleetJob, host: str) -> bool:
        """One placement attempt (placement thread only).  Lease
        first, journal the incarnation second, submit third — the
        write-ahead order restart recovery depends on."""
        sock = self._host_socket(host)
        if sock is None:
            return False
        with obs.span("fleet.place", host=host):
            faults.check("fleet.place")
            lease = lease_mod.try_claim(
                self.fleet_dir, f"job_{job.id}", worker=host,
                ttl_s=registry.host_ttl_s(), keeper=False)
            if lease is None:
                # another claimant (a second gateway, or a prior
                # incarnation not yet expired) holds it: back off
                return False
            host_key = self._host_key_for(job, host)
            reused = host_key == job.prior_key
            run = job.journal_runs + (0 if reused else 1)
            rec = {"rec": "running", "job": job.id, "host": host,
                   "run": max(1, run), "hkey": host_key}
            try:
                self._journal.append(rec)
                with ServiceClient(sock, timeout_s=30.0,
                                   retries=0) as client:
                    resp = client.submit(job.spec, key=host_key)
            except Exception as e:
                lease.release()
                warn(f"fleet: placing {job.id} on {host} failed "
                     f"({type(e).__name__}: {e}) — requeued")
                return False
            if not resp.get("ok"):
                lease.release()
                err = str(resp.get("error") or "")
                if _rejection_is_transient(err):
                    # host-local answer: another member (or this one,
                    # later) may accept — requeue, deprioritize the
                    # rejecting host, and only give up after a bound
                    # so a fleet that can never take the job still
                    # answers the client
                    job.host_rejects += 1
                    job.rejected_hosts.add(host)
                    if job.host_rejects < MAX_TRANSIENT_REJECTS:
                        metrics.inc("fleet.reject_requeued")
                        warn(f"fleet: host {host} rejected {job.id} "
                             f"({err}) — requeued (attempt "
                             f"{job.host_rejects}/"
                             f"{MAX_TRANSIENT_REJECTS})")
                        return False
                    err = (f"rejected by {job.host_rejects} placement "
                           f"attempt(s), last by host {host}: {err}")
                else:
                    # deterministic (profile mismatch, bad spec): the
                    # rejection IS the job's answer — every member
                    # compiled the same profile would say the same
                    err = f"rejected by host {host}: {err}"
                with self._cond:
                    self._advance(job, FAILED)
                    job.error = err
                    self._retire_locked(job)
                try:
                    self._journal.append({"rec": "failed",
                                          "job": job.id,
                                          "error": job.error})
                except Exception as e:
                    log_swallowed("fleet: journal failed-record "
                                  "append failed", e)
                metrics.inc(f"fleet.tenant.{job.tenant}.failed")
                return True
            with self._cond:
                self._advance(job, PLACED)
                job.host = host
                job.host_job = resp.get("job")
                job.host_key = host_key
                job.journal_runs = max(1, run)
                job.run_records.append(rec)
                job.lease = lease
                job.preempt_requested = False
                job.host_rejects = 0
                job.rejected_hosts.clear()
                self._placed[job.id] = job
        metrics.inc("fleet.placed")
        metrics.inc(f"fleet.tenant.{job.tenant}.placed")
        _eprint(f"job {job.id} (tenant {job.tenant}, prio "
                f"{job.priority}) placed on {host} as "
                f"{job.host_job}" + (" [re-contact]" if reused
                                     else ""))
        return True

    def _unplace_locked(self, job: FleetJob, migrated: bool) \
            -> Optional[lease_mod.Lease]:
        """Back to the tenant queue (front of its priority class):
        the drain/requeue half of preemption and migration.  Returns
        the job's lease for the CALLER to release outside the state
        lock (lease release is file I/O)."""
        self._advance(job, QUEUED)
        self._placed.pop(job.id, None)
        job.prior_host, job.prior_key = job.host, job.host_key
        job.host = job.host_job = None
        lease, job.lease = job.lease, None
        if migrated:
            job.migrations += 1
            self._counts["migrated"] += 1
        else:
            self._counts["preempted"] += 1
        self._sched.requeue(job.tenant, job, job.priority)
        self._cond.notify_all()
        return lease

    def _migrate_host(self, host: str) -> None:
        """A dead host's placed jobs move to survivors.  Last-chance
        collect first: if the member actually finished (clean drain,
        or a restart that recovered its spool), the result is taken
        as-is — never re-polished."""
        with self._lock:
            victims = [j for j in self._placed.values()
                       if j.host == host]
        for job in victims:
            if self._try_collect(job):
                continue
            with self._cond:
                if job.stage != PLACED or job.host != host:
                    continue
                # the key point: on a DIFFERENT survivor the key is
                # fresh; if the SAME host re-registers, prior_key
                # re-contact serves its spooled result
                lease = self._unplace_locked(job, migrated=True)
            if lease is not None:
                lease.release()
            metrics.inc("fleet.migrated")
            metrics.inc(f"fleet.tenant.{job.tenant}.migrated")
            _eprint(f"job {job.id} migrated off dead host {host} "
                    f"(migration #{job.migrations})")

    # --------------------------------------------------------- collection

    def _try_collect(self, job: FleetJob) -> bool:
        """Poll one placed job's host; absorb a terminal answer into
        the fleet journal + spool.  True when the job left PLACED."""
        sock = self._host_socket(job.host) if job.host else None
        if sock is None:
            return False
        try:
            with ServiceClient(sock, timeout_s=30.0,
                               retries=0) as client:
                row = client.status(job.host_job)
                state = row.get("state")
                if not row.get("ok") and "unknown job" in \
                        (row.get("error") or ""):
                    # the host restarted WITHOUT its serve-dir and
                    # forgot the job: treat like a dead host
                    lease = None
                    with self._cond:
                        if job.stage == PLACED:
                            lease = self._unplace_locked(
                                job, migrated=True)
                    if lease is not None:
                        lease.release()
                    metrics.inc("fleet.migrated")
                    return True
                if state == "done":
                    header, payload = client.result(
                        job.host_job, timeout_s=60.0)
                    if payload is None:
                        return False
                    return self._absorb_done(job, header, payload)
                if state in ("failed", "cancelled"):
                    return self._absorb_terminal(job, state,
                                                 row.get("error"))
        except (OSError, ConnectionError):
            return False  # beacon TTL is the authority on host death
        return False

    def _absorb_done(self, job: FleetJob, header: dict,
                     payload: bytes) -> bool:
        spool, size, crc = self._journal.spool_write(job.id, payload)
        try:
            self._journal.append({
                "rec": "done", "job": job.id, "bytes": size,
                "crc32": crc, "spool": spool,
                "wall_s": round(float(header.get("wall_s", 0.0)), 3),
                "engine": header.get("engine")})
        except Exception as e:
            log_swallowed("fleet: journal done-record append failed "
                          "(the job would re-run after a restart)", e)
        with self._cond:
            if job.stage != PLACED:
                return True
            self._advance(job, DONE)
            job.spool, job.result_bytes, job.crc32 = spool, size, crc
            job.wall_s = float(header.get("wall_s", 0.0))
            job.engine = header.get("engine")
            job.report = header.get("report")
            self._placed.pop(job.id, None)
            lease, job.lease = job.lease, None
            self._counts["done"] += 1
            job.done.set()
            self._cond.notify_all()
        if lease is not None:
            lease.release()
        metrics.inc(f"fleet.tenant.{job.tenant}.done")
        _eprint(f"job {job.id} done on {job.host} "
                f"({size} B collected into the fleet spool)")
        return True

    def _absorb_terminal(self, job: FleetJob, state: str,
                         error: Optional[str]) -> bool:
        if state == "cancelled":
            # the cooperative preempt drained at a ladder boundary:
            # requeue, do not fail — drain, never kill
            lease = None
            with self._cond:
                if job.stage == PLACED:
                    lease = self._unplace_locked(job, migrated=False)
                    # the host ANSWERED this key cancelled — unlike a
                    # migration (outcome unknown, re-contact dedupes),
                    # the re-placement needs a fresh incarnation key
                    # even on the same host, or its dedupe would
                    # return the cancelled answer forever
                    job.prior_host = job.prior_key = None
            if lease is not None:
                lease.release()
            metrics.inc("fleet.preempted")
            metrics.inc(f"fleet.tenant.{job.tenant}.preempted")
            return True
        try:
            self._journal.append({"rec": "failed", "job": job.id,
                                  "error": error or ""})
        except Exception as e:
            log_swallowed("fleet: journal failed-record append "
                          "failed", e)
        with self._cond:
            if job.stage != PLACED:
                return True
            self._advance(job, FAILED)
            job.error = error or f"failed on host {job.host}"
            self._placed.pop(job.id, None)
            lease, job.lease = job.lease, None
            self._retire_locked(job)
        if lease is not None:
            lease.release()
        metrics.inc(f"fleet.tenant.{job.tenant}.failed")
        return True

    # --------------------------------------------------------- preemption

    def _maybe_preempt(self) -> None:
        """When the best queued job outranks a placed one and no alive
        host has a free slot, ask the lowest-priority placed job's
        host to DRAIN it (the serve-side cooperative ``preempt`` op):
        a host-queued job comes back immediately; a running one drains
        at its next ladder boundary or completes first."""
        with self._lock:
            best = self._sched.peek_priority()
            if best is None:
                return
            _, priority, _ = best
            candidates = [j for j in self._placed.values()
                          if j.priority < priority
                          and not j.preempt_requested]
            if not candidates:
                return
            victim = min(candidates,
                         key=lambda j: (j.priority,
                                        -j.submitted_unix))
        if any(self._host_capacity(h) > 0
               for h in self._alive_hosts()):
            return  # capacity exists: place, don't preempt
        sock = self._host_socket(victim.host)
        if sock is None:
            return
        try:
            with ServiceClient(sock, timeout_s=10.0,
                               retries=0) as client:
                resp = client.preempt(victim.host_job)
        except (OSError, ConnectionError):
            return
        if not resp.get("ok"):
            victim.preempt_requested = True  # terminal: collector acts
            return
        if resp.get("drained"):
            lease = None
            with self._cond:
                if victim.stage == PLACED:
                    lease = self._unplace_locked(victim,
                                                 migrated=False)
            if lease is not None:
                lease.release()
            metrics.inc("fleet.preempted")
            metrics.inc(f"fleet.tenant.{victim.tenant}.preempted")
            _eprint(f"job {victim.id} (prio {victim.priority}) "
                    f"drained off {victim.prior_host} for a prio-"
                    f"{priority} job")
        else:
            victim.preempt_requested = True

    # ----------------------------------------------------- placement loop

    def _placement_tick(self) -> None:
        self._refresh_hosts()
        # heartbeat the placed jobs' leases — but ONLY while their
        # host's beacon is live: a dead host's leases must age out so
        # reclaim goes through the break-with-one-winner path
        with self._lock:
            placed = list(self._placed.values())
            stages = dict(self._host_stage)
        for job in placed:
            if job.lease is not None and \
                    stages.get(job.host) in (H_ALIVE, H_SILENT):
                job.lease.heartbeat()
        for job in placed:
            self._try_collect(job)
        self._maybe_preempt()
        # drain the tenant queues into free slots, fairness-ordered
        while not self._stop.is_set():
            hosts = [(h, self._host_capacity(h))
                     for h in self._alive_hosts()]
            hosts = [(h, c) for h, c in hosts if c > 0]
            if not hosts:
                return
            with self._lock:
                popped = self._sched.pop()
            if popped is None:
                return
            _, job = popped
            # most-free-slots first: least-loaded-by-outstanding work
            hosts.sort(key=lambda hc: (-hc[1], hc[0]))
            target = hosts[0][0]
            # a host that already rejected this job (queue full,
            # smaller budget) comes last: try the others first
            for name, _ in hosts:
                if name not in job.rejected_hosts:
                    target = name
                    break
            try:
                if not self._place(job, target):
                    with self._cond:
                        if job.stage == QUEUED:
                            self._sched.requeue(job.tenant, job,
                                                job.priority)
                    return
            except Exception as e:
                # an injected fleet.place fault (or any placement
                # bug) costs one tick, never the job
                with self._cond:
                    if job.stage == QUEUED:
                        self._sched.requeue(job.tenant, job,
                                            job.priority)
                warn(f"fleet: placement of {job.id} faulted "
                     f"({type(e).__name__}: {e}) — retrying next "
                     f"tick")
                return

    def _placement_loop(self) -> None:
        poll = max(0.02, flags.get_float("RACON_TPU_FLEET_POLL_S"))
        while not self._stop.wait(poll):
            try:
                self._placement_tick()
            except Exception as e:
                warn(f"fleet: placement tick faulted "
                     f"({type(e).__name__}: {e}) — continuing")

    # ----------------------------------------------------------- protocol

    def _handle_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        try:
            while True:
                try:
                    msg = protocol.read_msg(rfile)
                except ValueError as e:
                    protocol.send_msg(conn, {
                        "ok": False, "error": f"bad request: {e}"})
                    return
                if msg is None:
                    return
                try:
                    if not self._dispatch_op(conn, msg):
                        return
                except (ValueError, TypeError, KeyError) as e:
                    protocol.send_msg(conn, {
                        "ok": False,
                        "error": f"bad request field: "
                                 f"{type(e).__name__}: {e}"})
        except OSError as e:
            log_swallowed("fleet: client connection dropped", e)
        except RuntimeError as e:
            # an accept-path fault (gateway.accept injection, or a
            # genuine dispatch bug) kills THIS connection before any
            # acknowledgment — the client's keyed retry is safe, and
            # the gateway itself never goes down with a connection
            warn(f"fleet: connection handler fault "
                 f"({type(e).__name__}: {e}) — connection closed "
                 f"pre-acknowledgment")
        finally:
            rfile.close()
            conn.close()

    def _dispatch_op(self, conn, msg: dict) -> bool:
        op = msg.get("op")
        if op == "ping":
            with self._lock:
                stages = dict(self._host_stage)
            protocol.send_msg(conn, {
                "ok": True, "server": "gateway",
                "gateway": lease_mod.worker_identity(),
                "uptime_s": round(time.perf_counter() - self._t0, 3),
                "fleet_dir": self.fleet_dir,
                "hosts": {"alive": sum(1 for s in stages.values()
                                       if s == H_ALIVE),
                          "dead": sum(1 for s in stages.values()
                                      if s == H_DEAD)},
                "draining": self._draining})
            return True
        if op == "submit":
            # chaos site: an accept fault fires BEFORE anything is
            # journaled or acknowledged, so the client's keyed retry
            # is exactly safe
            faults.check("gateway.accept")
            key = msg.get("key")
            if key is not None and not isinstance(key, str):
                protocol.send_msg(conn, {
                    "ok": False,
                    "error": "idempotency key must be a string"})
                return True
            with obs.span("gateway.admit"):
                job, reason, existing = self._admit(
                    msg.get("spec", {}), key=key)
            if job is None:
                with self._lock:
                    self._counts["rejected"] += 1
                metrics.inc("gateway.rejected")
                protocol.send_msg(conn, {"ok": False, "error": reason,
                                         "rejected": True})
                return True
            protocol.send_msg(conn, {"ok": True, "job": job.id,
                                     "state": job.stage,
                                     "tenant": job.tenant,
                                     "cost_bytes": job.cost,
                                     "existing": existing})
            return True
        if op in ("status", "result", "cancel"):
            job = self._jobs.get(msg.get("job", ""))
            if job is None:
                protocol.send_msg(conn, {
                    "ok": False,
                    "error": f"unknown job {msg.get('job')!r}"})
                return True
            if op == "status":
                protocol.send_msg(conn, {"ok": True, **job.row()})
                return True
            if op == "cancel":
                return self._op_cancel(conn, job)
            return self._op_result(conn, job, msg)
        if op == "stats":
            with self._lock:
                counts = dict(self._counts)
                depths = self._sched.depths()
                charged = {t: self._sched.charged_bytes(t)
                           for t in depths}
                stages = dict(self._host_stage)
                placed = len(self._placed)
            protocol.send_msg(conn, {
                "ok": True, **counts,
                "queued": sum(depths.values()), "placed": placed,
                "tenants": depths, "charged_bytes": charged,
                "hosts": {"alive": sum(1 for s in stages.values()
                                       if s == H_ALIVE),
                          "dead": sum(1 for s in stages.values()
                                      if s == H_DEAD)},
                "fleet": metrics.fleet_summary(),
                "fleet_dir": self.fleet_dir,
                "recovery": dict(self.recovery)})
            return True
        if op == "shutdown":
            mode = msg.get("mode", "now")
            if mode not in ("now", "drain"):
                protocol.send_msg(conn, {
                    "ok": False,
                    "error": f"unknown shutdown mode {mode!r} "
                             f"(now | drain)"})
                return True
            if mode == "drain":
                with self._lock:
                    self._draining = True
            protocol.send_msg(conn, {
                "ok": True,
                "state": "draining" if mode == "drain"
                else "stopping"})
            self.shutdown(mode=mode)
            return False
        protocol.send_msg(conn, {"ok": False,
                                 "error": f"unknown op {op!r}"})
        return True

    def _op_cancel(self, conn, job: FleetJob) -> bool:
        cancelled = False
        with self._cond:
            if job.stage == QUEUED and \
                    self._sched.remove(job.tenant, job):
                self._advance(job, CANCELLED)
                job.error = "cancelled by client"
                self._retire_locked(job)
                cancelled = True
        if cancelled:
            try:
                self._journal.append({"rec": "cancelled",
                                      "job": job.id})
            except Exception as e:
                log_swallowed("fleet: journal cancel record failed "
                              "(the job would re-run after a "
                              "restart)", e)
            protocol.send_msg(conn, {"ok": True, "job": job.id,
                                     "state": job.stage})
            return True
        protocol.send_msg(conn, {
            "ok": False, "job": job.id, "state": job.stage,
            "error": f"job {job.id} is not queued ({job.stage}) — "
                     f"placed work drains via preemption, not "
                     f"cancellation"})
        return True

    def _op_result(self, conn, job: FleetJob, msg: dict) -> bool:
        timeout = float(msg.get("timeout_s",
                                DEFAULT_RESULT_TIMEOUT_S))
        if not job.done.wait(timeout):
            protocol.send_msg(conn, {
                "ok": False, "job": job.id, "state": job.stage,
                "timeout": True,
                "error": f"job {job.id} not finished within "
                         f"{timeout:.0f}s (still {job.stage})"})
            return True
        header = {"ok": job.stage == DONE, **job.row(),
                  "report": job.report}
        if job.stage != DONE:
            if job.stage == COLLECTED:
                # collection advanced DONE -> COLLECTED: a second
                # fetch lands here, and deserves the why
                header["error"] = (
                    f"job {job.id} result was already collected "
                    f"(payloads are retained for one successful "
                    f"fetch)")
            protocol.send_msg(conn, header)
            return True
        blob = self._journal.spool_read(job.id, job.result_bytes,
                                        job.crc32)
        if blob is None:
            header.update(ok=False, error=(
                f"job {job.id} result spool failed verification — "
                f"resubmit under a fresh key to re-run it"))
            protocol.send_msg(conn, header)
            return True
        header["bytes"] = len(blob)
        protocol.send_msg(conn, header)
        conn.sendall(blob)
        if not msg.get("keep", False):
            with self._cond:
                newly = not job.collected
                job.collected = True
                if newly:
                    self._advance(job, COLLECTED)
                    self._sched.uncharge(job.tenant, job.cost)
                    self._retired.append(job.id)
            if newly:
                try:
                    self._journal.append({"rec": "collected",
                                          "job": job.id})
                except Exception as e:
                    log_swallowed("fleet: journal collected record "
                                  "failed (the result stays "
                                  "re-servable — safe)", e)
                self._journal.spool_unlink(job.id)
        return True

    # ---------------------------------------------------------- lifecycle

    def _bind(self) -> socket.socket:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self.port))
        listener.listen(64)
        self.port = listener.getsockname()[1]
        return listener

    def serve_forever(self) -> int:
        # one thread per gateway instance runs serve_forever — its
        # attribute writes below never race themselves
        # graftlint: disable=lock-discipline (single serve_forever thread)
        self._listener = self._bind()
        self._recover()
        self._placer = threading.Thread(target=self._placement_loop,
                                        name="racon-fleet-placer",
                                        daemon=True)
        self._placer.start()
        if threading.current_thread() is threading.main_thread():
            import signal as signal_mod
            try:
                signal_mod.signal(
                    signal_mod.SIGTERM,
                    lambda *_: threading.Thread(
                        target=self.shutdown,
                        kwargs={"mode": "drain"},
                        name="racon-fleet-drain",
                        daemon=True).start())
            except (ValueError, OSError) as e:
                log_swallowed("fleet: SIGTERM drain handler "
                              "unavailable", e)
        _eprint(f"gateway listening on {self.host}:{self.port} "
                f"(fleet-dir {self.fleet_dir})")
        self.started.set()
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    break  # listener closed by shutdown()
                if self._stop.is_set():
                    conn.close()  # shutdown's wake-up connection
                    break
                t = threading.Thread(target=self._handle_conn,
                                     args=(conn,), daemon=True)
                t.start()
                self._conn_threads.append(t)
                # graftlint: disable=lock-discipline (single serve_forever thread)
                self._conn_threads = [c for c in self._conn_threads
                                      if c.is_alive()]
        finally:
            self.shutdown()
            if self._placer is not None:
                self._placer.join()
            self._finish_journal()
        _eprint(f"gateway stopped ({self._counts['done']} done, "
                f"{self._counts['failed']} failed, "
                f"{self._counts['rejected']} rejected, "
                f"{self._counts['migrated']} migrated)")
        return 0

    def _finish_journal(self) -> None:
        """Final live-jobs-only compaction + close (single-threaded:
        the placement loop and every handler are stopped)."""
        live: List[dict] = []
        keep: List[str] = []
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            if job.collected:
                continue
            live.append({"rec": "submitted", "job": job.id,
                         "key": job.key, "cost": job.cost,
                         "unix": round(job.submitted_unix, 3),
                         "spec": job.spec})
            live.extend(job.run_records)
            if job.stage == DONE:
                live.append({"rec": "done", "job": job.id,
                             "bytes": job.result_bytes,
                             "crc32": job.crc32, "spool": job.spool,
                             "wall_s": round(job.wall_s, 3),
                             "engine": job.engine})
                keep.append(job.id)
            elif job.stage == FAILED and not job.shutdown_orphan:
                live.append({"rec": "failed", "job": job.id,
                             "error": job.error or ""})
            elif job.stage == CANCELLED:
                live.append({"rec": "cancelled", "job": job.id})
        try:
            with self._journal.lock:
                self._journal.rewrite_locked(live)
            self._journal.sweep_spool(keep)
        except Exception as e:
            log_swallowed("fleet: final journal compaction failed "
                          "(the un-compacted journal replays fine)",
                          e)
        self._journal.close()

    def shutdown(self, mode: str = "now") -> None:
        """Stop the gateway (idempotent).  ``drain`` waits (bounded
        by ``RACON_TPU_SERVE_DRAIN_S``) for the queues to empty and
        placed jobs to collect; ``now`` answers queued jobs FAILED in
        RAM but leaves them journaled, so a restarted gateway runs
        them, as a ``--serve-dir`` server does."""
        if mode == "drain" and not self._stop.is_set():
            with self._lock:
                self._draining = True
            bound = flags.get_float("RACON_TPU_SERVE_DRAIN_S")
            deadline = (time.monotonic() + bound) if bound > 0 \
                else None
            with self._cond:
                while len(self._sched) or self._placed:
                    if self._stop.is_set():
                        break
                    if deadline is not None and \
                            time.monotonic() > deadline:
                        warn(f"fleet drain: still busy after "
                             f"{bound:.0f}s — stopping anyway")
                        break
                    self._cond.wait(0.2)
        if self._stop.is_set():
            return
        self._stop.set()
        leases: List[lease_mod.Lease] = []
        with self._cond:
            while True:
                popped = self._sched.pop()
                if popped is None:
                    break
                _, job = popped
                job.stage = FAILED
                job.shutdown_orphan = True
                job.error = ("gateway shutdown before the job "
                             "placed — it is journaled and will "
                             "recover on restart from the same "
                             "--fleet-dir")
                job.done.set()
            # placed jobs keep their journal records (re-contacted on
            # restart under the same host key); their leases release
            # so the restart need not wait out a TTL
            for job in list(self._placed.values()):
                if job.lease is not None:
                    leases.append(job.lease)
                    job.lease = None
            self._cond.notify_all()
        for lease in leases:
            lease.release()
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError as e:
                log_swallowed("fleet: listener shutdown failed", e)
            # where shutdown() refuses a listening socket (ENOTCONN, as
            # under gVisor) accept() stays blocked: one connection wakes
            # it, and the accept loop sees the stop
            wake_host = "127.0.0.1" if self.host in ("", "0.0.0.0") \
                else self.host
            try:
                with socket.create_connection((wake_host, self.port),
                                              timeout=1.0):
                    pass
            except OSError as e:
                log_swallowed("fleet: accept wake-up connect failed", e)
            try:
                self._listener.close()
            except OSError as e:
                log_swallowed("fleet: listener close failed", e)
