"""PolishServer: the resident polishing service (``racon --serve``; the
port of ``racon_tpu/serve/service.py``).

One long-lived process keeps a pool of engine pairs on the card and runs
submitted polish jobs through :meth:`Polisher.run` with a slot's engines
injected, so a job pays for its compute and not for a process start, a
CUDA context, the kernel libraries' loads and the engines' arenas.

- **Slots**: :class:`racon_tpu_torch.exec.runner._ChipWorker` slots (the
  server passes itself as the duck-typed engine profile), each with its
  own engine pair (engines hold per-run state and are never shared by
  concurrent jobs) and the ladder's host pair: one slot pinned to each
  card when the chip scheduler engages (``--chips N``, or a ``cuda``
  backend on a multi-card host), then unpinned slots up to ``workers``;
  without it ``max(1, workers)`` unpinned slots on the one device.
- **Admission**: the exec planner's cost model
  (:func:`racon_tpu_torch.exec.planner.cached_job_cost`) gates
  submissions: a job over the budget, a full queue, a spec the resident
  engines cannot serve (scores and banding are the server's) is rejected
  with the reason; the scheduler starts a job only while the summed
  estimate of running jobs fits the budget, in strict FIFO order.
- **Ladder**: a failed attempt walks the shard runner's per-class ladder
  (transient-io backoff, device-OOM backpressure through the slot's
  ``reduce_capacity``, the host engines, fail with the reason); the
  server survives every rung.
- **Per-job observability**: each job runs under its own metric scope
  (``job.<id>.*``) and returns a run report of kind ``job`` built from
  it.
- **Crash safety** (``--serve-dir``): every transition is journaled
  (:mod:`.journal`), results spool to CRC-checked files, a restart on the
  same directory replays the journal (done jobs serve from the spool,
  queued and running ones re-enter the queue down the crash ladder,
  idempotency keys dedupe resubmissions), dead slot threads are restarted
  with fresh engines and quarantined after repeated deaths, and
  ``SIGTERM`` or ``shutdown {"mode": "drain"}`` stops admission, finishes
  the queue and compacts the journal before exit.

How it departs from the JAX service, on purpose:

- **Warm pool.** The JAX pool compiles XLA shapes (its warm-up profile and
  each admitted job's estimated geometry). The port compiles nothing per
  shape, so :meth:`PolishServer._warm_pool` builds each slot's engine pair
  on the device, loads every kernel library and the native library
  (building only stale ones), so job 1 builds nothing, and then seals the
  build watch (``obs.buildwatch``). ``RACON_TPU_SERVE_WARM_SHAPES`` is
  still parsed (a malformed profile fails the start with JAX's message,
  and the startup line counts the profiles) but drives no compile, and
  :meth:`PolishServer._warm_job_geometry` returns False.
- **Compile attribution.** ``compile_s`` of a job is its scope's
  ``compile.build_s``: the nvcc and g++ seconds of builds on the job's
  thread. The report's ``retrace`` is ``{}``, as in every port report.
  Under ``RACON_TPU_SANITIZE=1`` a job that built a library after the
  seal fails (``sanitize.check_post_warm_compiles``).
- **No CPU rung on the card.** With a slot's primary engines on the card,
  the rung the JAX ladder spends on the host engines is a ``fail`` with
  the reason, in the per-job ladder and at a job's second crash: the card's
  work never moves to the host (as the shard runner does,
  ``ShardRunner.primary_on_card``). With host primary engines the ladder
  is JAX's.
- **Slots.** A pinned slot's engines take its card as an explicit
  device, and its thread runs with that card current
  (``ChipSlot.pin``); on a ``--device cpu`` server the pinned slots stay
  on the CPU. The server and the shard runner share one slot rule
  (``topology.executor_slots``), so an explicit ``--chips 1`` pins card 0
  here as well: the JAX service leaves that slot unpinned, where its
  engines' automatic mesh would take every chip.
- **Fleet membership.** With ``fleet_dir`` (``--fleet-dir``) the server
  registers a beacon under ``<fleet-dir>/hosts/`` once its socket is
  bound (:class:`racon_tpu_torch.fleet.registry.HostBeacon`) and
  withdraws it at shutdown, as JAX's does; a ``racon --gateway`` places
  jobs on it.

A server asked for ``cuda`` on a machine without a card raises in its
constructor, before it binds its socket: it never serves from the CPU
unless asked for ``cpu``.
"""

from __future__ import annotations

import gc
import os
import signal as signal_mod
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import contracts, faults, flags, sanitize
from ..core.polisher import PolisherType, create_polisher
from ..device import resolve
from ..exec import heartbeat as hb
from ..exec import lease as lease_mod
from ..exec.planner import cached_job_cost, parse_ram
from ..exec.runner import _ChipWorker
from ..io import parsers
from ..obs import buildwatch, metrics, report as obs_report
from ..parallel import topology
from ..parallel.topology import ChipSlot
from ..utils.logger import log_swallowed, warn
from . import protocol
from .journal import JobJournal

# the job states: contracts.JOB_MACHINE
QUEUED = contracts.JOB_QUEUED
RUNNING = contracts.JOB_RUNNING
DONE = contracts.JOB_DONE
FAILED = contracts.JOB_FAILED
CANCELLED = contracts.JOB_CANCELLED

_TERMINAL = (DONE, FAILED, CANCELLED)

# the default wait of a blocking result request
DEFAULT_RESULT_TIMEOUT_S = 3600.0

# the crash ladder (a server or slot death counts): crash 1 re-runs on the
# primary engines, crash 2 on the host engines (or fails, with the
# primary engines on the card), crash 3 fails
_MAX_JOB_CRASHES = 3
# consecutive deaths before a slot is quarantined instead of restarted
_SLOT_QUARANTINE_DEATHS = 3
_SUPERVISE_POLL_S = 0.5

# the reason a job fails where the JAX ladder takes the host engines
_NO_CPU_RUNG = ("the slot's primary engines are on the card, so the "
                "ladder has no CPU rung")


def _eprint(msg: str) -> None:
    print(f"[racon_tpu::serve] {msg}", file=sys.stderr, flush=True)


def parse_warm_shapes(raw: str) -> List[Tuple[int, int, int, int]]:
    """Parse ``RACON_TPU_SERVE_WARM_SHAPES``: comma-separated
    ``window_length:pairs:windows[:contigs]`` entries. A malformed entry
    fails loudly (an operator's typo must not pass unnoticed)."""
    out: List[Tuple[int, int, int, int]] = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"RACON_TPU_SERVE_WARM_SHAPES entry {entry!r} is not "
                f"window_length:pairs:windows[:contigs]")
        vals = [int(p) for p in parts]
        if any(v <= 0 for v in vals):
            raise ValueError(
                f"RACON_TPU_SERVE_WARM_SHAPES entry {entry!r} has a "
                f"non-positive field")
        out.append((vals[0], vals[1], vals[2],
                    vals[3] if len(vals) == 4 else 1))
    return out


class Job:
    """One submitted polish job: spec, admission cost, lifecycle state,
    ladder attempts, result payload and the job's run report."""

    def __init__(self, job_id: str, spec: dict, cost: int):
        self.id = job_id
        self.spec = spec
        self.cost = cost
        self.state = QUEUED
        self.error: Optional[str] = None
        self.engine: Optional[str] = None
        self.attempts: List[dict] = []
        self.result: Optional[bytes] = None
        self.result_bytes = 0          # kept after the payload is dropped
        self.collected = False
        self.phases: Dict[str, float] = {}
        self.report: Optional[dict] = None
        self.worker: Optional[str] = None
        # routing hints: recorded for status and stats; scheduling is FIFO
        self.tenant = str(spec.get("tenant", "default"))
        self.priority = int(spec.get("priority", 0))
        # cooperative preemption: set by the preempt op on a RUNNING job,
        # honoured at the next ladder boundary (a polish is never
        # interrupted)
        self.preempt = threading.Event()
        self.submitted_unix = time.time()
        self.started_at: Optional[float] = None
        self.wall_s = 0.0
        self.compile_s = 0.0
        # library builds of this job after the warm path was sealed
        self.compiles_after_warm = 0
        # only a job that started after the seal is judged by the
        # warm-path assert
        self.post_warm_eligible = False
        # the JAX service's admission warm-up of a new geometry; always
        # False here (the port compiles nothing per shape)
        self.warmup_declared = False
        self.done = threading.Event()
        # crash safety: the idempotency key, the spooled result's name and
        # CRC, the count of journaled `running` records, the deaths with
        # an executor (the crash ladder's input)
        self.key: Optional[str] = None
        self.spool: Optional[str] = None
        self.crc32 = 0
        self.journal_runs = 0
        self.crash_count = 0
        # answered FAILED in memory by a hard stop but journaled
        # `submitted` on disk: the last compaction keeps it, so the
        # restarted server runs it
        self.shutdown_orphan = False

    def row(self) -> dict:
        """The protocol's status view of this job."""
        out = {"job": self.id, "state": self.state,
               "cost_bytes": self.cost,
               "tenant": self.tenant, "priority": self.priority,
               "submitted_unix": round(self.submitted_unix, 3)}
        if self.worker:
            out["worker"] = self.worker
        if self.engine:
            out["engine"] = self.engine
        if self.attempts:
            out["attempts"] = self.attempts
        if self.state in _TERMINAL:
            out["wall_s"] = round(self.wall_s, 3)
            out["compile_s"] = round(self.compile_s, 3)
            out["compiles_after_warm"] = self.compiles_after_warm
            out["bytes"] = self.result_bytes
        elif self.started_at is not None:
            out["wall_s"] = round(time.perf_counter() - self.started_at,
                                  3)
        if self.error:
            out["error"] = self.error
        return out


class PolishServer:
    """The resident polishing service (see the module docstring).

    The server is also the duck-typed engine profile its
    :class:`_ChipWorker` slots read (the attributes named like
    :class:`ShardRunner`'s), and the service profile admission holds a
    job to: the scores and banding are the resident engines', so a job
    asking for others is rejected with the reason."""

    def __init__(self, socket_path: str, *,
                 match: int = 3, mismatch: int = -5, gap: int = -4,
                 banded: bool = False, num_threads: int = 1,
                 aligner_backend: str = "native",
                 consensus_backend: str = "native",
                 aligner_batches: int = 1, consensus_batches: int = 1,
                 chips: int = 0, workers: int = 0,
                 budget_bytes: int = 0, max_queue: int = 0,
                 autostart: bool = True,
                 serve_dir: Optional[str] = None,
                 fleet_dir: Optional[str] = None,
                 device="cuda"):
        # before anything binds: no card for a cuda server raises here
        self._device = resolve(device)
        self.device = device
        self.socket_path = os.path.abspath(socket_path)
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.banded = banded
        self.num_threads = num_threads
        self.aligner_backend = aligner_backend
        self.consensus_backend = consensus_backend
        self.aligner_batches = aligner_batches
        self.consensus_batches = consensus_batches
        self.chips_requested = chips
        self.workers_requested = workers
        self.worker = lease_mod.worker_identity()
        self.budget_bytes = budget_bytes or parse_ram(
            flags.get_str("RACON_TPU_SERVE_BUDGET"))
        self.max_queue = max_queue or max(
            1, flags.get_int("RACON_TPU_SERVE_QUEUE"))
        self.autostart = autostart

        self._slots: Optional[List[_ChipWorker]] = None
        # the slot pool's first resolution races connection handlers
        # (ping) against the startup warm pool
        self._slots_lock = sanitize.named_lock("serve.slots")
        # the scheduler's lock (queue, counts, footprint); under
        # RACON_TPU_SANITIZE=1 both feed the lock-order witness
        self._lock = sanitize.named_lock("serve.state")
        self._cond = threading.Condition(self._lock)
        self._queue: List[Job] = []            # admitted, not yet running
        self._jobs: Dict[str, Job] = {}
        # terminal jobs kept for status and result queries, oldest first,
        # bounded (payloads go after one fetch, scoped metrics at the
        # job's end, whole records past this horizon)
        self._retired: List[str] = []
        self.max_retained_jobs = 1024
        self._next_id = 0
        self._running_cost = 0
        self._counts = {"submitted": 0, "rejected": 0, "done": 0,
                        "failed": 0, "cancelled": 0}
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._t0 = time.perf_counter()
        self.started = threading.Event()       # listener bound, pool warm
        # crash safety: the journal and spool (None = in memory only), the
        # idempotency-key index, the drain flag, slot supervision
        serve_dir = serve_dir or \
            flags.get_str("RACON_TPU_SERVE_DIR").strip() or None
        self.serve_dir = os.path.abspath(serve_dir) if serve_dir else None
        self._journal: Optional[JobJournal] = \
            JobJournal(self.serve_dir) if self.serve_dir else None
        self._by_key: Dict[str, str] = {}
        self._draining = False
        self._slot_threads: Dict[int, threading.Thread] = {}
        self._slot_deaths: Dict[int, int] = {}
        self._quarantined: set = set()
        self._supervisor: Optional[threading.Thread] = None
        self._warm_shapes: List[Tuple[int, int, int, int]] = []
        # fleet membership: a --fleet-dir host advertises itself to the
        # gateway with a beacon file; a beacon stale past
        # RACON_TPU_FLEET_HOST_TTL_S is how the gateway declares this host
        # dead and moves its jobs
        self.fleet_dir = os.path.abspath(fleet_dir) if fleet_dir else None
        self._beacon = None

    # ------------------------------------------------------- engine pool

    def primary_on_card(self) -> bool:
        """Whether the slots' primary engines launch kernels on the card.
        Then no rung moves a job to the host engines."""
        return self._chip_slots()[0].primary_on_card()

    def _chip_slots(self) -> List[_ChipWorker]:
        """The slot pool: the chip scheduler's slots
        (:func:`~racon_tpu_torch.parallel.topology.executor_slots`, one
        pinned slot a card when it engages), topped up with unpinned slots
        to ``workers``. Each slot owns its engine pair. Resolved once,
        under its own lock (a connection handler and the warm pool race
        for the first resolution)."""
        if self._slots is not None:
            return self._slots
        with self._slots_lock:
            if self._slots is not None:
                return self._slots
            slots = [_ChipWorker(self, s) for s in topology.executor_slots(
                self.chips_requested,
                (self.aligner_backend, self.consensus_backend),
                self._device)]
            for k in range(len(slots), max(1, self.workers_requested)):
                extra = _ChipWorker(self, ChipSlot(k, None))
                extra.worker = f"{self.worker}#w{k}"
                slots.append(extra)
            self._slots = slots
        return slots

    def _device_memory(self) -> str:
        """The card's allocated bytes for the log lines (empty on the
        CPU)."""
        if self._device.type != "cuda":
            return ""
        import torch
        return (f", device_mem="
                f"{torch.cuda.memory_allocated(self._device) >> 20}MB"
                f" (reserved "
                f"{torch.cuda.memory_reserved(self._device) >> 20}MB)")

    def _warm_pool(self) -> None:
        """Make the pool resident before the first job: each slot's engine
        pair on the device, every kernel library and the native library
        loaded (stale ones built), then the build watch sealed, so job 1
        builds nothing. The warm-shape profile is parsed and counted; it
        drives no compile (the port compiles nothing per shape)."""
        for w in self._chip_slots():
            w.get_engines(cpu=False)
        from .. import native
        native.load()
        if self._device.type == "cuda":
            from ..ops import _build
            for name in _build.SOURCES:
                _build.load(name)
        buildwatch.seal("serve warm pool")
        _eprint(f"engine pool: {len(self._chip_slots())} worker(s), "
                f"budget {self.budget_bytes >> 20} MB, "
                f"{len(self._warm_shapes)} warm shape profile(s)"
                + self._device_memory())

    def _warm_job_geometry(self, spec: dict) -> bool:
        """The JAX service's admission warm-up of a job's estimated
        geometry. The port compiles nothing per shape: no warm-up, and the
        job declares no geometry expansion."""
        return False

    # --------------------------------------------------------- admission

    def _admit(self, raw_spec: dict, key: Optional[str] = None) \
            -> Tuple[Optional[Job], Optional[str], bool]:
        """Admission: validate the spec, hold it to the resident engine
        profile, estimate its footprint, bound the queue. Returns ``(job,
        None, existing)`` or ``(None, reason, False)``. Under an
        idempotency ``key`` already journaled, the existing job comes back
        (``existing``) instead of a duplicate."""
        if key:
            with self._lock:
                jid = self._by_key.get(key)
                prior = self._jobs.get(jid) if jid else None
            # a FAILED prior is retryable; queued, running and done work is
            # never duplicated
            if prior is not None and prior.state != FAILED:
                return prior, None, True
        if self._draining:
            return None, (
                "server is draining (SIGTERM / shutdown mode=drain): "
                "admission is stopped — resubmit to the restarted "
                "server (your idempotency key keeps it safe)"), False
        if self._quarantined and self.healthy_workers() == 0:
            return None, (
                "every worker slot is quarantined after repeated "
                "deaths — the server has no healthy capacity left; "
                "restart it (a --serve-dir server recovers its queue "
                "on restart)"), False
        spec, err = protocol.normalize_spec(raw_spec)
        if err is not None:
            return None, err, False
        for pkey in protocol.SPEC_PATHS:
            if pkey == "overlaps" \
                    and parsers.is_auto_overlaps(spec[pkey]):
                # the first-party overlapper: no overlaps file
                continue
            spec[pkey] = os.path.abspath(spec[pkey])
            if not os.path.isfile(spec[pkey]):
                return None, f"input not found: {spec[pkey]}", False
        for path, kind in ((spec["sequences"], "sequences"),
                           (spec["target_sequences"], "target")):
            if parsers.sequence_parser_for(path) is None:
                return None, (f"{kind} file {path} has an unsupported "
                              f"format extension"), False
        if not parsers.is_auto_overlaps(spec["overlaps"]) \
                and parsers.overlap_parser_for(spec["overlaps"]) is None:
            return None, (f"overlaps file {spec['overlaps']} has an "
                          f"unsupported format extension"), False
        profile = (self.match, self.mismatch, self.gap, self.banded)
        requested = (spec["match"], spec["mismatch"], spec["gap"],
                     spec["banded"])
        if requested != profile:
            return None, (
                f"engine profile mismatch: the resident engines are "
                f"compiled for (match, mismatch, gap, banded) = "
                f"{profile}, the job asked for {requested} — submit to "
                f"a server started with those scores, or restart this "
                f"one with them"), False
        cost = cached_job_cost(spec["sequences"], spec["overlaps"],
                               spec["target_sequences"])
        if cost > self.budget_bytes:
            return None, (
                f"job footprint estimate {cost >> 20} MB exceeds the "
                f"service budget {self.budget_bytes >> 20} MB "
                f"(--serve-budget / RACON_TPU_SERVE_BUDGET) — run it "
                f"one-shot through the streaming shard runner "
                f"(--max-ram) instead"), False
        with self._cond:
            if len(self._queue) >= self.max_queue:
                return None, (
                    f"queue full ({self.max_queue} jobs waiting; "
                    f"RACON_TPU_SERVE_QUEUE raises the bound)"), False
            if key and key in self._by_key:
                # a racing duplicate landed since the check above: the
                # first submission wins
                prior = self._jobs.get(self._by_key[key])
                if prior is not None and prior.state != FAILED:
                    return prior, None, True
            self._next_id += 1
            job = Job(f"j{self._next_id}", spec, cost)
            job.key = key or None
            # registered and key-indexed before it can run, so a duplicate
            # submission dedupes while the journal write below runs
            self._jobs[job.id] = job
            if job.key:
                self._by_key[job.key] = job.id
        if self._journal is not None:
            # the write-ahead half of admission: `submitted` is durable
            # before the job can run; a journal that cannot record the job
            # means the job is not admitted
            try:
                self._journal.append({
                    "rec": "submitted", "job": job.id, "key": job.key,
                    "cost": cost, "unix": round(job.submitted_unix, 3),
                    "spec": spec})
            except Exception as e:
                # registered but FAILED (an id a racing duplicate was
                # already answered with keeps resolving; a FAILED prior
                # leaves the key reusable)
                with self._cond:
                    job.state = FAILED
                    job.error = (f"job journal write failed "
                                 f"({type(e).__name__}: {e})")
                    self._counts["failed"] = \
                        self._counts.get("failed", 0) + 1
                    self._retired.append(job.id)
                    job.done.set()
                return None, (f"job journal write failed "
                              f"({type(e).__name__}: {e}) — the "
                              f"serve-dir is not accepting durable "
                              f"admissions"), False
        with self._cond:
            self._queue.append(job)
            self._counts["submitted"] += 1
            self._cond.notify_all()
        job.warmup_declared = self._warm_job_geometry(spec)
        return job, None, False

    # ------------------------------------------------------ job execution

    def _next_job(self, worker: _ChipWorker) -> Optional[Job]:
        """Wait until the head of the queue fits the in-flight footprint
        budget (or the server stops). Strict FIFO: a big job waiting for
        footprint is never overtaken by later small ones, which could
        starve it. Admission rejected anything over the whole budget, so
        the head fits once enough running jobs end."""
        with self._cond:
            while True:
                if self._stop.is_set():
                    return None
                if self._queue:
                    job = self._queue[0]
                    if job.cost + self._running_cost \
                            <= self.budget_bytes \
                            or self._running_cost == 0:
                        self._queue.pop(0)
                        job.state = RUNNING
                        job.worker = worker.worker
                        job.post_warm_eligible = (
                            buildwatch.sealed() is not None
                            and not job.warmup_declared)
                        job.started_at = time.perf_counter()
                        self._running_cost += job.cost
                        # the supervisor finds the job here if this
                        # slot's thread dies
                        worker.current_job = job
                        return job
                self._cond.wait(0.2)

    def _worker_loop(self, worker: _ChipWorker) -> None:
        with worker.slot.pin():
            self._worker_loop_inner(worker)

    def _worker_loop_inner(self, worker: _ChipWorker) -> None:
        while True:
            job = self._next_job(worker)
            if job is None:
                return
            # the slot-supervision chaos site: a fault here is outside the
            # per-job ladder and kills the slot's thread, the death the
            # supervisor detects, re-queues the job from and restarts
            faults.check("serve.slot")
            try:
                self._run_job(worker, job)
            except Exception as e:
                # a fault outside the ladder (a report bug, say) fails the
                # job, never the slot
                job.state = FAILED
                job.error = f"internal error: {type(e).__name__}: {e}"
                warn(f"job {job.id} worker fault past the ladder: {e}")
            finally:
                with self._cond:
                    self._running_cost -= job.cost
                    worker.current_job = None
                    self._counts[job.state] = \
                        self._counts.get(job.state, 0) + 1
                    self._retired.append(job.id)
                    while len(self._retired) > self.max_retained_jobs:
                        old = self._jobs.pop(self._retired.pop(0),
                                             None)
                        if old is not None:
                            old.result = None  # a never-fetched payload
                    self._cond.notify_all()
                self._journal_terminal(job)
                job.done.set()
            self._maybe_compact()
            _eprint(f"job {job.id} {job.state} in {job.wall_s:.2f}s "
                    f"(engine={job.engine or '-'}, "
                    f"compile {job.compile_s:.2f}s, "
                    f"{job.result_bytes} B) on {worker.worker}"
                    + self._device_memory())

    def _polish(self, job: Job, worker: _ChipWorker,
                cpu: bool) -> bytes:
        """One polish attempt with the slot's resident engines injected:
        the job's latency is :meth:`Polisher.run`."""
        spec = job.spec
        aligner, consensus = worker.get_engines(cpu)
        p = create_polisher(
            spec["sequences"], spec["overlaps"],
            spec["target_sequences"],
            PolisherType.F if spec["fragment_correction"]
            else PolisherType.C,
            window_length=spec["window_length"],
            quality_threshold=spec["quality_threshold"],
            error_threshold=spec["error_threshold"],
            trim=not spec["no_trimming"],
            match=spec["match"], mismatch=spec["mismatch"],
            gap=spec["gap"], num_threads=spec["threads"],
            aligner=aligner, consensus=consensus,
            device=(worker.device if worker.device is not None
                    else self.device))
        polished = p.run(not spec["include_unpolished"])
        job.phases = dict(p.timings)
        return b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                        for s in polished)

    def _ladder(self, job: Job, worker: _ChipWorker,
                tier_cpu: bool) -> Tuple[Optional[bytes], bool]:
        """The per-job degradation ladder; returns (payload or None, on
        the host engines)."""
        max_retries = max(0, flags.get_int("RACON_TPU_EXEC_RETRIES"))
        transient_used = 0
        on_card = self.primary_on_card()
        for attempt_no in range(64):  # the ladder is finite
            if job.preempt.is_set():
                # cooperative preemption, at ladder boundaries only: a
                # first attempt that succeeds outruns its preemption
                job.attempts.append({
                    "n": attempt_no, "engine": "-",
                    "class": "preempt", "action": "drain"})
                return None, tier_cpu
            try:
                faults.check("serve.polish", attempt=attempt_no)
                return self._polish(job, worker, cpu=tier_cpu), tier_cpu
            except Exception as e:
                cls = faults.classify(e)
                metrics.inc(f"faults.{cls}")
                err = f"{type(e).__name__}: {e}"
                att = {"n": attempt_no,
                       "engine": "cpu" if tier_cpu else "primary",
                       "class": cls, "error": err}
                job.attempts.append(att)
                if cls == faults.CLASS_TRANSIENT and \
                        transient_used < max_retries:
                    backoff = faults.backoff_s(
                        max(0.0, flags.get_float(
                            "RACON_TPU_EXEC_BACKOFF_S")),
                        transient_used,
                        f"{job.id}:{transient_used}")
                    att["action"] = "retry-backoff"
                    att["backoff_s"] = round(backoff, 3)
                    transient_used += 1
                    warn(f"job {job.id} transient fault ({err}) — "
                         f"retry {transient_used}/{max_retries} in "
                         f"{backoff:.2f}s")
                    time.sleep(backoff)
                elif cls == faults.CLASS_OOM and not tier_cpu and \
                        worker.reduce_capacity():
                    att["action"] = "reduce-capacity"
                    # the halved arenas launch new geometries: the job
                    # leaves the warm-path claim and the seal re-opens
                    # (the next completed job seals again)
                    job.post_warm_eligible = False
                    buildwatch.unseal()
                    warn(f"job {job.id} device OOM ({err}) — "
                         f"halved worker {worker.worker}'s "
                         f"consensus arena/group capacity, "
                         f"re-dispatching on the device "
                         f"(warm-path seal re-opened)")
                elif not tier_cpu and not on_card:
                    tier_cpu = True
                    att["action"] = "cpu-retry"
                    job.post_warm_eligible = False
                    warn(f"job {job.id} attempt failed ({err}) — "
                         f"retrying on the CPU engines")
                else:
                    att["action"] = "fail"
                    job.error = "; ".join(
                        a["error"] for a in job.attempts)
                    if not tier_cpu:
                        job.error += f" ({_NO_CPU_RUNG})"
                    return None, tier_cpu
        return None, tier_cpu

    def _run_job(self, worker: _ChipWorker, job: Job) -> None:
        """Run one job under its own metric scope down the ladder; the
        ladder's record rides in the job's status, result and report."""
        if self._journal is not None:
            # write-ahead: the incarnation is journaled before any
            # compute, so a crash from here on leaves a countable record
            job.journal_runs += 1
            self._journal.append({"rec": "running", "job": job.id,
                                  "worker": worker.worker,
                                  "run": job.journal_runs})
        # the kill-restart chaos site: a SIGKILL here leaves the job
        # journaled `running` with no terminal record
        faults.check("server.kill")
        scope = metrics.job_scope(job.id)
        metrics.set_scope(scope)
        t_start = time.time()
        t0 = time.perf_counter()
        # a job that died with its executor re-enters the ladder where it
        # left off: the second crash takes the host engines (or fails,
        # with the primary engines on the card)
        tier_cpu = job.crash_count >= 2
        try:
            if tier_cpu and self.primary_on_card():
                job.attempts.append({
                    "n": len(job.attempts), "engine": "primary",
                    "class": "crash", "action": "fail",
                    "error": f"the job died {job.crash_count} times with "
                             f"its executor"})
                job.error = (f"the job died {job.crash_count} times with "
                             f"its executor; {_NO_CPU_RUNG}")
                blob = None
            else:
                blob, tier_cpu = self._ladder(job, worker, tier_cpu)
            job.wall_s = time.perf_counter() - t0
            job.compile_s = metrics.timer_s(scope + "compile.build_s")
            # the warm-path claim: builds of this job after the seal are
            # counted into the header, and fail the job under
            # RACON_TPU_SANITIZE=1
            if job.post_warm_eligible:
                try:
                    job.compiles_after_warm = len(
                        sanitize.check_post_warm_compiles(scope))
                except sanitize.CompileAfterWarmError as e:
                    job.compiles_after_warm = len(
                        buildwatch.post_warm(scope))
                    job.error = f"sanitized warm-path assert: {e}"
                    blob = None
            if blob is not None:
                if self._journal is not None:
                    # results spool to CRC-checked files, not RAM
                    job.spool, job.result_bytes, job.crc32 = \
                        self._journal.spool_write(job.id, blob)
                    job.result = None
                else:
                    job.result = blob
                    job.result_bytes = len(blob)
                job.engine = "cpu-retry" if tier_cpu else "primary"
                job.state = DONE
                # re-seals after a capacity halving opened the seal
                buildwatch.seal(f"serve warm path (job {job.id} complete)")
            elif job.preempt.is_set():
                # drained at a ladder boundary: terminal, not failed
                job.state = CANCELLED
                job.error = job.error or (
                    "preempted: drained back to the queue at a "
                    "ladder boundary")
            else:
                job.state = FAILED
            # the job's report, from its own scope: concurrent jobs' stay
            # disjoint
            job.report = obs_report.build_report(
                "job", argv=[job.id, spec_summary(job.spec)],
                started_unix=t_start, wall_s=job.wall_s,
                phases=job.phases, scope=scope)
            buildwatch.clear_scope(scope)
        finally:
            metrics.set_scope(None)
            # the report holds the scope's numbers; dropping them now
            # keeps a server that runs many jobs bounded
            metrics.clear_job(job.id)

    # ----------------------------------------- journal lifecycle + recovery

    def _journal_terminal(self, job: Job) -> None:
        """Durably record a job's terminal transition. A failed append is
        logged, not raised: a lost ``done`` record only means the job
        re-runs (to the same bytes) after a restart."""
        if self._journal is None or \
                job.state not in (DONE, FAILED, CANCELLED):
            return
        try:
            if job.state == DONE:
                self._journal.append({
                    "rec": "done", "job": job.id,
                    "bytes": job.result_bytes, "crc32": job.crc32,
                    "spool": job.spool,
                    "wall_s": round(job.wall_s, 3),
                    "engine": job.engine})
            elif job.state == CANCELLED:
                self._journal.append({"rec": "cancelled",
                                      "job": job.id,
                                      "error": job.error or ""})
            else:
                self._journal.append({"rec": "failed", "job": job.id,
                                      "error": job.error or ""})
        except Exception as e:
            log_swallowed("serve: journal terminal record failed "
                          "(the job will re-run after a restart)", e)

    def _live_records_locked(self) -> Tuple[List[dict], List[str]]:
        """The records a compaction keeps: for each live job its
        ``submitted`` record, its ``running`` incarnations (the crash
        ladder's input) and the ``done`` record of an uncollected payload.
        Retired jobs (collected, failed, cancelled) drop out. Caller holds
        the scheduler lock; returns (records, live job ids)."""
        recs: List[dict] = []
        live: List[str] = []
        for job in self._jobs.values():
            if (job.state in (FAILED, CANCELLED)
                    and not job.shutdown_orphan) or \
                    (job.state == DONE and job.collected):
                continue
            live.append(job.id)
            recs.append({"rec": "submitted", "job": job.id,
                         "key": job.key, "cost": job.cost,
                         "unix": round(job.submitted_unix, 3),
                         "spec": job.spec})
            for k in range(job.journal_runs):
                recs.append({"rec": "running", "job": job.id,
                             "worker": job.worker, "run": k + 1})
            if job.state == DONE:
                recs.append({"rec": "done", "job": job.id,
                             "bytes": job.result_bytes,
                             "crc32": job.crc32, "spool": job.spool,
                             "wall_s": round(job.wall_s, 3),
                             "engine": job.engine})
        return recs, live

    def _compact(self) -> None:
        """Rewrite the journal to the live jobs (atomically) and sweep the
        orphaned spool files."""
        j = self._journal
        if j is None:
            return
        # lock order journal -> state, as at every append site; snapshot
        # and rewrite under one journal hold, so no append slips between
        with j.lock:
            with self._cond:
                recs, live = self._live_records_locked()
            j.rewrite_locked(recs)
        j.sweep_spool(live)

    def _maybe_compact(self) -> None:
        j = self._journal
        if j is not None and \
                j.appends_since_rewrite >= j.compact_every:
            self._compact()

    def _recover(self) -> None:
        """Restart recovery: replay the journal before any slot starts.
        Done jobs serve from the CRC-checked spool without a re-polish,
        queued and running ones re-enter the queue in submission order
        down the crash ladder, terminal ones answer status queries."""
        if self._journal is None:
            return
        records = self._journal.replay()
        metrics.inc("serve.journal_replayed", len(records))
        by_job: Dict[str, List[dict]] = {}
        order: List[str] = []
        for rec in records:
            jid = rec.get("job")
            if not isinstance(jid, str):
                continue
            if jid not in by_job:
                order.append(jid)
            by_job.setdefault(jid, []).append(rec)
        max_id = 0
        n_live = n_spool = n_requeued = 0
        for jid in order:
            recs = by_job[jid]
            sub = next((r for r in recs
                        if r.get("rec") == "submitted"), None)
            if sub is None:
                continue  # no admission record: nothing to restore
            if jid.startswith("j") and jid[1:].isdigit():
                max_id = max(max_id, int(jid[1:]))
            if any(r.get("rec") == "collected" for r in recs):
                continue  # retired; the compaction drops it
            kinds = {r.get("rec"): r for r in recs}
            spec, err = protocol.normalize_spec(sub.get("spec") or {})
            if spec is None:
                warn(f"journal job {jid} has an unreadable spec "
                     f"({err}) — dropping it")
                continue
            job = Job(jid, spec, int(sub.get("cost", 0)))
            job.key = sub.get("key") or None
            job.submitted_unix = float(sub.get("unix") or
                                       job.submitted_unix)
            job.journal_runs = sum(1 for r in recs
                                   if r.get("rec") == "running")
            n_live += 1
            if "cancelled" in kinds:
                job.state = CANCELLED
                job.error = "cancelled by client (before the restart)"
                self._register_recovered(job)
                continue
            if "failed" in kinds:
                job.state = FAILED
                job.error = str(kinds["failed"].get("error") or
                                "failed (before the restart)")
                self._register_recovered(job)
                continue
            done_rec = kinds.get("done")
            if done_rec is not None:
                blob = self._journal.spool_read(
                    jid, int(done_rec.get("bytes", -1)),
                    int(done_rec.get("crc32", 0)))
                if blob is not None:
                    # served from the spool: no re-polish
                    job.state = DONE
                    job.spool = done_rec.get("spool") or \
                        self._journal.spool_name(jid)
                    job.result_bytes = int(done_rec.get("bytes", 0))
                    job.crc32 = int(done_rec.get("crc32", 0))
                    job.wall_s = float(done_rec.get("wall_s") or 0.0)
                    job.engine = done_rec.get("engine")
                    n_spool += 1
                    self._register_recovered(job)
                    continue
                # a truncated or corrupt spool: the result is lost, the job
                # re-runs rather than serve garbage
                metrics.inc("serve.spool_corrupt")
                warn(f"job {jid}: result spool failed verification — "
                     f"re-queueing instead of serving a corrupt result")
            # queued or running at the crash: back down the ladder
            job.crash_count = job.journal_runs
            for k in range(job.crash_count):
                job.attempts.append({
                    "n": k, "engine": "primary", "class": "crash",
                    "error": "server died while the job was running",
                    "action": ("fail" if k + 1 >= _MAX_JOB_CRASHES
                               else "requeue")})
            if job.crash_count >= _MAX_JOB_CRASHES:
                job.state = FAILED
                job.error = (f"the server crashed {job.crash_count} "
                             f"times while running this job — failing "
                             f"it down the ladder instead of an "
                             f"infinite redo loop")
                self._register_recovered(job)
                continue
            with self._cond:
                self._queue.append(job)
            n_requeued += 1
            self._register_recovered(job)
        with self._cond:
            self._next_id = max(self._next_id, max_id)
        metrics.inc("serve.recovered_jobs", n_live)
        metrics.inc("serve.requeued_jobs", n_requeued)
        metrics.inc("serve.spool_served", n_spool)
        if n_live:
            _eprint(f"recovery: {n_live} journaled job(s) restored "
                    f"({n_spool} served from the result spool, "
                    f"{n_requeued} re-queued) from {self.serve_dir}")
        # the startup compaction: a crash-looping serve dir stays bounded
        self._compact()

    def _register_recovered(self, job: Job) -> None:
        with self._cond:
            self._jobs[job.id] = job
            if job.key:
                self._by_key[job.key] = job.id
            self._counts["submitted"] += 1
            if job.state in _TERMINAL:
                self._counts[job.state] = \
                    self._counts.get(job.state, 0) + 1
                self._retired.append(job.id)
                job.done.set()
            self._cond.notify_all()

    # --------------------------------------------------- slot supervision

    def healthy_workers(self) -> int:
        """The advertised capacity: slots less quarantined ones (a server
        with none left rejects instead of queueing)."""
        with self._slots_lock:
            slots = self._slots or []
            return sum(1 for w in slots
                       if w.ordinal not in self._quarantined)

    def _supervise_loop(self) -> None:
        """Slot supervision: a slot thread that died outside the per-job
        ladder fails its job down the crash ladder and restarts with
        fresh engines; repeated deaths quarantine the slot."""
        while not self._stop.wait(_SUPERVISE_POLL_S):
            with self._slots_lock:
                slots = list(self._slots or [])
            for idx, slot in enumerate(slots):
                t = self._slot_threads.get(slot.ordinal)
                if t is None or t.is_alive() or self._stop.is_set():
                    continue
                if slot.ordinal in self._quarantined:
                    continue
                self._handle_slot_death(idx, slot)

    def _handle_slot_death(self, idx: int, slot: _ChipWorker) -> None:
        deaths = self._slot_deaths.get(slot.ordinal, 0) + 1
        self._slot_deaths[slot.ordinal] = deaths
        metrics.inc("slot.deaths")
        job = slot.current_job
        failed_job = None
        with self._cond:
            if job is not None and job.state == RUNNING:
                # the dying thread never reached its finally: its
                # footprint and its job are orphaned
                self._running_cost -= job.cost
                job.crash_count += 1
                att = {"n": len(job.attempts), "engine": "primary",
                       "class": "crash",
                       "error": f"worker slot {slot.worker} died while "
                                f"running this job"}
                job.attempts.append(att)
                if job.crash_count >= _MAX_JOB_CRASHES:
                    att["action"] = "fail"
                    job.state = FAILED
                    job.error = (f"executor died {job.crash_count} "
                                 f"times on this job — failing it "
                                 f"down the ladder")
                    self._counts["failed"] = \
                        self._counts.get("failed", 0) + 1
                    self._retired.append(job.id)
                    failed_job = job
                else:
                    att["action"] = "requeue"
                    job.state = QUEUED
                    job.worker = None
                    job.started_at = None
                    # the head of the queue: it was already running
                    self._queue.insert(0, job)
                self._cond.notify_all()
            slot.current_job = None
        if failed_job is not None:
            self._journal_terminal(failed_job)
            failed_job.done.set()
        # the dead slot's engines go with it: two dead slots must not pin
        # two arenas on the card
        slot.engines = None
        slot.cpu_engines = None
        gc.collect()
        if self._device.type == "cuda":
            import torch
            torch.cuda.empty_cache()
        if deaths >= _SLOT_QUARANTINE_DEATHS:
            self._quarantined.add(slot.ordinal)
            metrics.inc("slot.quarantined")
            warn(f"worker slot {slot.worker} died {deaths} times — "
                 f"quarantining it (advertised capacity is now "
                 f"{self.healthy_workers()} worker(s))")
            if self.healthy_workers() == 0:
                warn("every worker slot is quarantined — failing "
                     "queued jobs and rejecting new submissions")
                with self._cond:
                    stranded = list(self._queue)
                    for queued in stranded:
                        queued.state = FAILED
                        queued.error = ("no healthy worker slots left "
                                        "(all quarantined)")
                        self._counts["failed"] = \
                            self._counts.get("failed", 0) + 1
                        self._retired.append(queued.id)
                        queued.done.set()
                    self._queue.clear()
                    self._cond.notify_all()
                # journaled outside the lock: the clients were told
                # failed, so a restart must not re-run them
                for queued in stranded:
                    self._journal_terminal(queued)
            return
        fresh = _ChipWorker(self, slot.slot)
        fresh.worker = slot.worker  # the identity stays
        with self._slots_lock:
            if self._slots is not None and idx < len(self._slots) \
                    and self._slots[idx] is slot:
                self._slots[idx] = fresh
            # drop the dead thread's registration now: an absent entry
            # reads "not started yet" until the replacement registers
            self._slot_threads.pop(slot.ordinal, None)
        metrics.inc("slot.restarts")
        _eprint(f"slot {slot.worker} died (death {deaths}/"
                f"{_SLOT_QUARANTINE_DEATHS}) — restarting it with "
                f"fresh engines" + self._device_memory())
        self._spawn_worker(fresh)

    # ----------------------------------------------------------- protocol

    def _handle_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        try:
            while True:
                try:
                    msg = protocol.read_msg(rfile)
                except ValueError as e:
                    protocol.send_msg(conn, {"ok": False,
                                             "error": f"bad request: {e}"})
                    return
                if msg is None:
                    return
                try:
                    if not self._dispatch_op(conn, msg):
                        return
                except (ValueError, TypeError, KeyError) as e:
                    # a malformed field is the client's fault: answer
                    # with the reason instead of dropping the connection
                    protocol.send_msg(conn, {
                        "ok": False,
                        "error": f"bad request field: "
                                 f"{type(e).__name__}: {e}"})
        except OSError as e:
            # a client hanging up mid-response leaves the jobs intact
            log_swallowed("serve: client connection dropped", e)
        finally:
            rfile.close()
            conn.close()

    def _dispatch_op(self, conn, msg: dict) -> bool:
        """Answer one request; False ends the connection."""
        op = msg.get("op")
        if op == "ping":
            self._chip_slots()  # resolved before counting capacity
            protocol.send_msg(conn, {
                "ok": True, "server": self.worker,
                "uptime_s": round(time.perf_counter() - self._t0, 3),
                "profile": {"match": self.match,
                            "mismatch": self.mismatch, "gap": self.gap,
                            "banded": self.banded},
                "workers": self.healthy_workers(),
                "serve_dir": self.serve_dir,
                "draining": self._draining})
            return True
        if op == "submit":
            key = msg.get("key")
            if key is not None and not isinstance(key, str):
                protocol.send_msg(conn, {
                    "ok": False,
                    "error": "idempotency key must be a string"})
                return True
            job, reason, existing = self._admit(msg.get("spec", {}),
                                                key=key)
            if job is None:
                with self._lock:
                    self._counts["rejected"] += 1
                protocol.send_msg(conn, {"ok": False, "error": reason,
                                         "rejected": True})
                return True
            protocol.send_msg(conn, {"ok": True, "job": job.id,
                                     "state": job.state,
                                     "cost_bytes": job.cost,
                                     "existing": existing})
            return True
        if op in ("status", "result", "cancel", "preempt"):
            job = self._jobs.get(msg.get("job", ""))
            if job is None:
                protocol.send_msg(conn, {
                    "ok": False,
                    "error": f"unknown job {msg.get('job')!r}"})
                return True
            if op == "status":
                row = job.row()
                with self._lock:
                    if job in self._queue:
                        row["queue_position"] = self._queue.index(job)
                protocol.send_msg(conn, {"ok": True, **row})
                return True
            if op == "cancel":
                return self._op_cancel(conn, job)
            if op == "preempt":
                return self._op_preempt(conn, job)
            return self._op_result(conn, job, msg)
        if op == "stats":
            with self._lock:
                counts = dict(self._counts)
                depth = len(self._queue)
                running = self._running_cost
                tenants: Dict[str, int] = {}
                for queued_job in self._queue:
                    tenants[queued_job.tenant] = \
                        tenants.get(queued_job.tenant, 0) + 1
            out = {
                "ok": True, **counts, "queued": depth,
                "tenants": tenants,
                "running_cost_bytes": running,
                "budget_bytes": self.budget_bytes,
                "peak_rss_bytes": metrics.peak_rss_bytes(),
                "quarantined_slots": len(self._quarantined),
                "slots": {"healthy": self.healthy_workers(),
                          "quarantined": len(self._quarantined)},
                "slot_restarts": int(metrics.counter("slot.restarts"))}
            if self._journal is not None:
                out["serve_dir"] = self.serve_dir
                out["recovery"] = metrics.recovery_summary()
            protocol.send_msg(conn, out)
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
                # admission stops before the reply lands: a client that
                # sees "draining" and submits is rejected
                with self._lock:
                    self._draining = True
            protocol.send_msg(conn, {
                "ok": True,
                "state": "draining" if mode == "drain" else "stopping"})
            self.shutdown(mode=mode)
            return False
        protocol.send_msg(conn, {"ok": False,
                                 "error": f"unknown op {op!r}"})
        return True

    def _op_cancel(self, conn, job: Job) -> bool:
        cancelled = False
        with self._cond:
            if job in self._queue:
                self._queue.remove(job)
                job.state = CANCELLED
                job.error = "cancelled by client"
                self._counts["cancelled"] += 1
                self._retired.append(job.id)
                job.done.set()
                cancelled = True
        # the reply goes outside the scheduler lock: a client slow to
        # read must not stall the slots
        if cancelled:
            if self._journal is not None:
                try:
                    self._journal.append({"rec": "cancelled",
                                          "job": job.id})
                except Exception as e:
                    log_swallowed(
                        "serve: journal cancel record failed (the job "
                        "would re-run after a restart)", e)
            protocol.send_msg(conn, {"ok": True, "job": job.id,
                                     "state": job.state})
            return True
        protocol.send_msg(conn, {
            "ok": False, "job": job.id, "state": job.state,
            "error": f"job {job.id} is not queued ({job.state}) — a "
                     f"running job cannot be safely interrupted "
                     f"mid-dispatch"})
        return True

    def _op_preempt(self, conn, job: Job) -> bool:
        """A drain request: a QUEUED job is released at once (``drained:
        true``); a RUNNING one gets its preempt flag and drains at its
        next ladder boundary or completes first (``drained: false``).
        Never kills a dispatch mid-flight."""
        drained = False
        running = False
        with self._cond:
            if job in self._queue:
                self._queue.remove(job)
                job.state = CANCELLED
                job.error = "preempted by the fleet scheduler"
                self._counts["cancelled"] += 1
                self._retired.append(job.id)
                job.done.set()
                drained = True
            elif job.state == RUNNING:
                job.preempt.set()
                running = True
        if drained:
            if self._journal is not None:
                try:
                    self._journal.append({"rec": "cancelled",
                                          "job": job.id})
                except Exception as e:
                    log_swallowed(
                        "serve: journal preempt record failed (the "
                        "job would re-run after a restart)", e)
            protocol.send_msg(conn, {"ok": True, "job": job.id,
                                     "state": job.state,
                                     "drained": True})
            return True
        if running:
            protocol.send_msg(conn, {
                "ok": True, "job": job.id, "state": job.state,
                "drained": False,
                "note": "running — drains at the next ladder "
                        "boundary or completes first"})
            return True
        protocol.send_msg(conn, {
            "ok": False, "job": job.id, "state": job.state,
            "error": f"job {job.id} is already terminal "
                     f"({job.state})"})
        return True

    def _op_result(self, conn, job: Job, msg: dict) -> bool:
        timeout = float(msg.get("timeout_s", DEFAULT_RESULT_TIMEOUT_S))
        if not job.done.wait(timeout):
            protocol.send_msg(conn, {
                "ok": False, "job": job.id, "state": job.state,
                "timeout": True,
                "error": f"job {job.id} not finished within "
                         f"{timeout:.0f}s (still {job.state})"})
            return True
        header = {"ok": job.state == DONE, **job.row(),
                  "report": job.report}
        if job.state != DONE:
            protocol.send_msg(conn, header)
            return True
        with self._lock:
            blob = job.result
            spool = job.spool if self._journal is not None else None
            collected = job.collected
        if blob is None and spool and not collected:
            # a spooled result is re-read and CRC-checked at every fetch:
            # a disk that lied must re-queue the job, never stream garbage
            blob = self._journal.spool_read(job.id, job.result_bytes,
                                            job.crc32)
            if blob is None:
                with self._lock:
                    racing_collected = job.collected
                if not racing_collected:
                    self._requeue_corrupt_spool(job)
                    header.update(
                        ok=False, state=job.state,
                        error=f"job {job.id} result spool failed "
                              f"verification — the job was re-queued; "
                              f"retry the fetch")
                    protocol.send_msg(conn, header)
                    return True
                # a racing fetcher streamed and unlinked the spool: the
                # result was delivered, not lost
        if blob is None:
            why = ("was already collected (payloads are retained for "
                   "one successful fetch)" if job.collected
                   else "was retired (the server keeps a bounded "
                        "terminal-job history)")
            header.update(ok=False,
                          error=f"job {job.id} result {why}")
            protocol.send_msg(conn, header)
            return True
        header["bytes"] = len(blob)
        protocol.send_msg(conn, header)
        conn.sendall(blob)
        if not msg.get("keep", False):
            # one successful fetch per job: the payload is dropped only
            # after sendall returned, so a client that died waiting can
            # reconnect and fetch
            with self._lock:
                newly = not job.collected
                job.result = None
                job.collected = True
            if newly and self._journal is not None:
                try:
                    self._journal.append({"rec": "collected",
                                          "job": job.id})
                except Exception as e:
                    log_swallowed(
                        "serve: journal collected record failed (the "
                        "result would be re-servable after a restart "
                        "— safe)", e)
                self._journal.spool_unlink(job.id)
                self._maybe_compact()
        return True

    def _requeue_corrupt_spool(self, job: Job) -> None:
        """A spooled result that fails its check is lost work: the job
        goes back to the head of the queue (it re-polishes to the same
        bytes), as the shard runner re-queues a corrupt part."""
        with self._cond:
            if job.state != DONE or job.collected:
                return  # a racing fetcher re-queued it or served it
            metrics.inc("serve.spool_corrupt")
            warn(f"job {job.id}: result spool corrupt at fetch time — "
                 f"re-queueing the job")
            job.state = QUEUED
            job.done.clear()
            job.result = None
            job.spool = None
            job.attempts.append({
                "n": len(job.attempts), "engine": "primary",
                "class": "spool-corrupt", "action": "requeue",
                "error": "result spool failed size/CRC verification"})
            # live again: off the retention horizon
            try:
                self._retired.remove(job.id)
            except ValueError:
                pass
            self._queue.insert(0, job)
            self._cond.notify_all()

    # ---------------------------------------------------------- lifecycle

    def _heartbeat_loop(self, interval: float) -> None:
        """One line per tick naming every running job with its scope's
        pack, queue and retrace fields."""
        while not self._stop.wait(interval):
            with self._lock:
                running = [j for j in self._jobs.values()
                           if j.state == RUNNING]
                depth = len(self._queue)
                counts = dict(self._counts)
            fields = []
            for j in running:
                scope = metrics.job_scope(j.id)
                dt = (time.perf_counter() - j.started_at
                      if j.started_at else 0.0)
                fields.append(
                    f"{j.id}@{hb.Heartbeat._short(j.worker or '?')}"
                    f" {dt:.1f}s pack[{hb.pack_summary_str(scope)}]"
                    f" queue[{hb.queue_summary_str(scope)}]"
                    f" retrace[{hb.retrace_summary(scope)}]")
            _eprint(f"heartbeat: {counts.get('done', 0)} done, "
                    f"{counts.get('failed', 0)} failed, "
                    f"{len(running)} running"
                    + (" (" + "; ".join(fields) + ")" if fields else "")
                    + f", {depth} queued, "
                    f"peak_rss={metrics.peak_rss_bytes() >> 20}MB")

    def _spawn_worker(self, w: _ChipWorker) -> None:
        t = threading.Thread(target=self._worker_loop, args=(w,),
                             name=f"racon-serve-{w.worker}",
                             daemon=True)
        t.start()
        # registered after start(): a registered thread not yet started
        # reads as dead to the supervisor
        with self._slots_lock:
            self._threads.append(t)
            self._slot_threads[w.ordinal] = t

    def start_workers(self) -> None:
        """Start the slots' threads and their supervisor (idempotent;
        separate so tests can fill the queue before a slot drains it)."""
        if self._threads:
            return
        for w in self._chip_slots():
            self._spawn_worker(w)
        self._supervisor = threading.Thread(
            target=self._supervise_loop,
            name="racon-serve-supervisor", daemon=True)
        self._supervisor.start()

    def _bind(self) -> socket.socket:
        path = self.socket_path
        if os.path.exists(path):
            import stat as stat_mod
            if not stat_mod.S_ISSOCK(os.stat(path).st_mode):
                # refuse rather than unlink a regular file
                raise RuntimeError(
                    f"{path} exists and is not a socket — refusing to "
                    f"replace it")
            # a dead server may have left its socket: only a connectable
            # one proves a live server
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(1.0)
            try:
                probe.connect(path)
            except OSError as e:
                log_swallowed("serve: removing stale socket file", e)
                os.unlink(path)
            else:
                raise RuntimeError(
                    f"another server is already listening on {path}")
            finally:
                probe.close()
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(path)
        listener.listen(64)
        return listener

    def serve_forever(self) -> int:
        """Bind, recover, warm the pool, accept until :meth:`shutdown`.
        Returns the exit code (0 on a clean stop)."""
        # a fresh server owns the process's build watch: only its own seal
        # counts, and the builds of a predecessor in this process are gone
        # a malformed warm-shape profile fails the start before the bind
        raw = flags.get_str("RACON_TPU_SERVE_WARM_SHAPES")
        self._warm_shapes = parse_warm_shapes(raw) if raw.strip() else []
        buildwatch.reset(explicit=True)
        metrics.clear("compile.")
        # span timers on for the server's life (each job's dispatch/fetch
        # split reads them through its scope); no ring buffers
        from ..obs import trace
        trace.activate()
        self._listener = self._bind()
        # recovery before any slot can drain the queue
        self._recover()
        self._warm_pool()
        if self.autostart:
            self.start_workers()
        # SIGTERM drains: stop admission, finish the queue, compact the
        # journal, exit. Only the main thread may install a handler
        # (in-process test servers run on another thread)
        if threading.current_thread() is threading.main_thread():
            try:
                signal_mod.signal(
                    signal_mod.SIGTERM,
                    lambda *_: threading.Thread(
                        target=self.shutdown, kwargs={"mode": "drain"},
                        name="racon-serve-drain", daemon=True).start())
            except (ValueError, OSError) as e:
                log_swallowed("serve: SIGTERM drain handler "
                              "unavailable", e)
        interval = flags.get_float("RACON_TPU_HEARTBEAT_S")
        if interval > 0:
            t = threading.Thread(target=self._heartbeat_loop,
                                 args=(interval,),
                                 name="racon-serve-heartbeat",
                                 daemon=True)
            t.start()
        if self.fleet_dir:
            # registered after the bind: the beacon advertises a listener
            # the gateway can reach
            from ..fleet import registry as fleet_registry
            beacon = fleet_registry.HostBeacon(
                self.fleet_dir, socket_path=self.socket_path).start()
            # written once before the accept loop; shutdown reads it only
            # after _stop is set
            self._beacon = beacon  # graftlint: disable=lock-discipline (pre-accept-loop write)
            _eprint(f"fleet member {self._beacon.name} registered "
                    f"in {self.fleet_dir}")
        _eprint(f"listening on {self.socket_path} "
                f"(server {self.worker})")
        self.started.set()
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    break  # the listener closed by shutdown()
                if self._stop.is_set():
                    conn.close()  # shutdown's wake-up connection
                    break
                threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            self.shutdown()
            for t in list(self._threads):
                t.join()
            if self._supervisor is not None:
                self._supervisor.join()
            self._finish_journal()
        _eprint(f"stopped ({self._counts['done']} done, "
                f"{self._counts['failed']} failed, "
                f"{self._counts['rejected']} rejected)")
        return 0

    def _finish_journal(self) -> None:
        """The last compaction (every slot has exited, so the snapshot is
        the run's final truth) and a clean close."""
        if self._journal is None:
            return
        try:
            self._compact()
        except Exception as e:
            log_swallowed("serve: final journal compaction failed "
                          "(the un-compacted journal replays fine)", e)
        self._journal.close()

    def shutdown(self, mode: str = "now") -> None:
        """Stop the server (idempotent). ``now``: admission and scheduling
        stop at once; running jobs finish; queued jobs are answered FAILED
        in memory but not journaled as failed, so a ``--serve-dir`` server
        runs them after its restart. ``drain``: admission stops, then the
        queue and the running jobs finish (bounded by
        ``RACON_TPU_SERVE_DRAIN_S``) before the stop."""
        if mode == "drain" and not self._stop.is_set():
            with self._cond:
                self._draining = True
            _eprint("drain: admission stopped — finishing queued "
                    "and in-flight jobs")
            bound = flags.get_float("RACON_TPU_SERVE_DRAIN_S")
            deadline = (time.monotonic() + bound) if bound > 0 \
                else None
            drained = True
            with self._cond:
                while self._queue or any(
                        j.state == RUNNING
                        for j in self._jobs.values()):
                    if self._stop.is_set():
                        drained = False
                        break
                    if deadline is not None and \
                            time.monotonic() > deadline:
                        warn(f"drain: still busy after {bound:.0f}s "
                             f"(RACON_TPU_SERVE_DRAIN_S) — stopping "
                             f"anyway")
                        drained = False
                        break
                    self._cond.wait(0.2)
            if drained:
                _eprint("drain: all jobs finished")
        if self._stop.is_set():
            return
        self._stop.set()
        if self._beacon is not None:
            # a clean goodbye: the gateway sees the beacon withdrawn
            # instead of waiting out a TTL
            self._beacon.stop()
            self._beacon = None  # graftlint: disable=lock-discipline (_stop-gated shutdown)
        with self._cond:
            for job in self._queue:
                job.state = FAILED
                job.shutdown_orphan = self._journal is not None
                job.error = ("server shutdown before the job ran"
                             + (" — it is journaled and will recover "
                                "on restart from the same --serve-dir"
                                if self._journal is not None else ""))
                job.done.set()
            self._queue.clear()
            self._cond.notify_all()
        if self._listener is not None:
            try:
                # shutdown() before close(): a close alone does not always
                # wake a thread blocked in accept() on Linux
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError as e:
                log_swallowed("serve: listener shutdown failed", e)
            # where shutdown() refuses a listening socket (ENOTCONN, as
            # under gVisor) accept() stays blocked: one connection wakes
            # it, and the accept loop sees the stop
            try:
                with socket.socket(socket.AF_UNIX,
                                   socket.SOCK_STREAM) as wake:
                    wake.settimeout(1.0)
                    wake.connect(self.socket_path)
            except OSError as e:
                log_swallowed("serve: accept wake-up connect failed", e)
            try:
                self._listener.close()
            except OSError as e:
                log_swallowed("serve: listener close failed", e)
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        except OSError as e:
            log_swallowed("serve: socket unlink failed", e)


def spec_summary(spec: dict) -> str:
    """One line describing a job spec (the report's argv, logs)."""
    return (f"{os.path.basename(spec['sequences'])} "
            f"{os.path.basename(spec['overlaps'])} "
            f"{os.path.basename(spec['target_sequences'])} "
            f"-w {spec['window_length']} -t {spec['threads']}"
            + (" -f" if spec["fragment_correction"] else "")
            + (" -u" if spec["include_unpolished"] else ""))
