"""The port's contract registry (counterpart of ``racon_tpu/contracts.py``,
trimmed to what the port emits): the metric names, the span names, the
fault-injection sites, the run report's schema, which metric backs each
report key, the job, shard, lease, tenant and placement lifecycle
machines and the service journal's record alphabet, declared once.

The consumers (:mod:`.obs.metrics`, :mod:`.obs.report`, :mod:`.faults`,
:mod:`.exec.manifest`, :mod:`.serve.journal`, :mod:`.serve.service`,
:mod:`.fleet.gateway`) import their sets from here, and
``tests/test_torch_obs.py`` holds the registry to a traced run in both
directions: every name a run emits is declared, and every declared span
is opened by the PAF path, the auto path, the device engines, the shard
runner or the fleet gateway. The report schema is the JAX package's
(version 11, every section), so a port report passes the JAX validator
and a JAX CLI report passes the port's. :func:`selfcheck` audits the
registry itself; the runtime half (``RACON_TPU_SANITIZE=1``) is the exit
audit in :mod:`.sanitize`, which reads :data:`REPORT_BACKING`. The job,
tenant and placement machines and the journal's record alphabet come
with the service and the fleet. Stdlib only.
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, Iterable, Tuple

# ----------------------------------------------------------- metric names

# lowercase dotted segments: the report groups metrics by "segment."
# prefixes, so a stray uppercase or separator breaks an aggregation
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)*$")

# every statically named counter, gauge and timer the port publishes
# (span timers are keyed by the span name and declared in SPANS)
METRICS: FrozenSet[str] = frozenset((
    # aligner chunks: wavefront-arena occupancy, packed (K4) chunks and
    # the sanitizer's K1 shadows of them
    "align.chunks", "align.lanes_occupied", "align.lanes_total",
    "align.steps_wasted", "align.wavefront_work", "align.shadow_chunks",
    "aligner.swar_chunks",
    # device-OOM backpressure (reduce_capacity) in either engine
    "aligner.capacity_scale", "consensus.capacity_scale",
    "faults.backpressure_halvings",
    # kernel library builds (obs.buildwatch)
    "compile.build_s", "compile.builds",
    # the resident dataflow (RACON_TPU_RESIDENT) and the overlapper's
    # device-link bytes
    "dataflow.bytes_avoided", "dataflow.bytes_fetched",
    "dataflow.fallback_pairs", "dataflow.lanes_device_groups",
    "dataflow.resident", "dataflow.resident_bailouts",
    # consensus groups, and the sanitizer's K1 shadows of them
    "consensus.dropped_layers", "consensus.fallback_windows",
    "consensus.group_windows", "consensus.groups", "consensus.ins_overflow",
    "consensus.ins_overflow_windows", "consensus.lanes_occupied",
    "consensus.lanes_total", "consensus.shadow_groups",
    "consensus.sweep_truncated",
    "consensus.wavefront_steps",
    # the shard runner's ladder, part verification and leases
    "exec.backoff_s", "faults.part_corrupt", "faults.stall_escalations",
    "lease.claimed", "lease.expired", "lease.lost", "lease.reclaimed",
    "lease.stale_write_suppressed",
    # first-party overlapper
    "overlap.cache_hits", "overlap.cache_misses", "overlap.candidate_pairs",
    "overlap.chains_dropped", "overlap.chains_kept", "overlap.chunks",
    "overlap.freq_capped_buckets", "overlap.join_bailouts",
    "overlap.lanes_occupied", "overlap.lanes_total", "overlap.minimizers",
    "overlap.mode_auto", "overlap.seed_lanes_occupied",
    "overlap.seed_lanes_total", "overlap.stream_groups",
    # the host all-gathers of a process group's mesh merges
    # (parallel.fetch_global)
    "parallel.gather_bytes", "parallel.gather_calls", "parallel.gather_s",
    # the pipelined polish's bounded queue
    "queue.consumer_wait_s", "queue.depth", "queue.producer_wait_s",
    # the runtime sanitizer's exit reports (lock-order cycles, the
    # contract audit)
    "sanitize.contract_defaulted_keys", "sanitize.contract_never_emitted",
    "sanitize.lock_order_cycles",
    # the resident service's journal and recovery (server-level, unscoped)
    "serve.journal_compactions", "serve.journal_records",
    "serve.journal_replayed", "serve.recovered_jobs",
    "serve.requeued_jobs", "serve.spool_corrupt", "serve.spool_served",
    # the service's slot supervision (server-level, unscoped)
    "slot.deaths", "slot.quarantined", "slot.restarts",
    # the fleet gateway and its placement (gateway-process lifetime,
    # unscoped), and the admission cost model's fingerprint cache
    # (exec/planner.py)
    "fleet.cost_cache_hits", "fleet.cost_cache_misses",
    "fleet.hosts_alive", "fleet.hosts_dead", "fleet.migrated",
    "fleet.placed", "fleet.preempted", "fleet.reject_requeued",
    "gateway.accepted", "gateway.rejected",
    # the span rings' overflow; the torch profile's stop and export
    "trace.dropped_events", "trace.profile_stop_s",
))

# f"<prefix>{suffix}" families: the suffix is a runtime value
DYNAMIC_METRIC_PREFIXES: Tuple[str, ...] = (
    "compile.",          # compile.<library> builds per library
    "device.",           # device.<ordinal|mesh>.shards/.mbp/.polish_s/...
    "faults.",           # faults.<class> counts of the runner's ladder
    "faults.injected.",  # faults.injected.<site>
    "fleet.tenant.",     # fleet.tenant.<name>.placed/.done/...
    "swallowed.",        # swallowed.<context>|<exception type>
)

# a service job's thread-local write scope (obs.metrics.set_scope)
# prefixes every write with job.<id>.: a scope root, never a literal name
JOB_SCOPE_ROOT = "job."

# every name under these prefixes describes one run: obs.begin() clears
# them (span timers are keyed by the span name, hence the phase prefixes;
# "serve.", "slot.", "fleet." and "gateway." are server- or gateway-level
# and stay)
RUN_PREFIXES: Tuple[str, ...] = (
    "align.", "aligner.", "poa.", "consensus.", "queue.", "retrace.",
    "retrace_total.", "swallowed.", "trace.", "parse.", "overlap.",
    "transmute", "bp.", "build.", "stitch", "exec.", "faults.",
    "lease.", "device.", "compile.", "dataflow.", "parallel.",
)

# ------------------------------------------------------------- span names

# every obs.span name the port opens; a span's exits land in the metrics
# timer of the same name, which the report's dispatch/fetch splits read
SPANS: FrozenSet[str] = frozenset((
    "align", "align.dispatch", "align.fetch",
    "bp.decode",
    "build.backbone", "build.store", "build.windows",
    "consensus", "consensus.feed", "consensus.finish", "consensus.run",
    "exec.extract", "exec.index", "exec.merge", "exec.plan",
    "exec.shard",
    "fleet.place", "gateway.admit",
    "overlap.chain", "overlap.chain.dispatch", "overlap.chain.fetch",
    "overlap.filter", "overlap.join.dispatch", "overlap.join.fetch",
    "overlap.match", "overlap.seed", "overlap.seed.dispatch",
    "overlap.seed.fetch",
    "parse.overlaps", "parse.reads", "parse.targets",
    "poa.dispatch", "poa.fetch", "poa.pack", "poa.stage_b",
    "queue.get", "queue.put",
    "stitch", "transmute",
))

# ------------------------------------------------------------ fault sites

# the RACON_TPU_FAULTS injection points (faults.check call sites)
FAULT_SITES: Tuple[str, ...] = ("consensus.dispatch", "align.dispatch",
                                "align.fetch", "part.write",
                                "manifest.write", "worker.kill",
                                "exec.polish", "serve.polish",
                                "serve.journal", "serve.socket",
                                "serve.slot", "server.kill",
                                "fleet.place", "gateway.accept")

FAULT_KINDS: Tuple[str, ...] = ("io", "enospc", "oom", "err", "stall",
                                "kill")

FAULT_CLASSES: Tuple[str, ...] = ("transient-io", "device-oom", "stall",
                                  "deterministic-compute")

# -------------------------------------------------------- report schema

SCHEMA_VERSION = 11

REPORT_KINDS: Tuple[str, ...] = ("cli", "exec", "job")

OVERLAP_MODES: Tuple[str, ...] = ("auto", "paf")

# key -> the schema version it first appeared in (the JAX package's)
TOP_KEYS: Dict[str, int] = {
    "schema_version": 1, "kind": 1, "argv": 1, "started_unix": 1,
    "wall_s": 1, "phases": 1, "dispatch_fetch": 1, "pack": 1,
    "retrace": 1, "queue": 1, "swallowed": 1, "metrics": 1,
    "peak_rss_bytes": 1, "shards": 1,
    "faults": 2,
    "devices": 3,
    "recovery": 5,
    "compiles": 7,
    "dataflow": 8,
    "overlap": 9,
    "fleet": 11,
}

SECTION_KEYS: Dict[str, Dict[str, int]] = {
    "dispatch_fetch": {
        "align_dispatch_s": 1, "align_fetch_s": 1,
        "consensus_pack_s": 1, "consensus_dispatch_s": 1,
        "consensus_fetch_s": 1,
        "compile_s": 4,
    },
    "queue": {"depth": 1, "producer_wait_s": 1, "consumer_wait_s": 1,
              "stall_s": 1},
    "pack": {
        "pack_efficiency": 1, "pad_fraction": 1, "windows_per_group": 1,
        "groups": 1,
        "align_pack_efficiency": 6, "align_pad_fraction": 6,
        "align_chunks": 6, "align_steps_wasted": 6,
    },
    "recovery": {
        "recovered_jobs": 5, "requeued_jobs": 5, "served_from_spool": 5,
        "spool_corrupt": 5, "journal_replayed": 5, "journal_records": 5,
        "journal_compactions": 5, "slot_restarts": 5,
        "slot_quarantined": 5,
    },
    "compiles": {"total_s": 7, "count": 7, "post_warm": 7, "sealed": 7,
                 "by_function": 7, "events": 7},
    "dataflow": {
        "resident": 8, "bytes_fetched": 8, "bytes_avoided": 8,
        "fallback_pairs": 8, "resident_bailouts": 8,
        "lanes_device_groups": 8, "ins_overflow_windows": 8,
    },
    "overlap": {
        "mode": 9, "minimizers": 9, "candidate_pairs": 9,
        "freq_capped_buckets": 9, "chains_kept": 9, "chains_dropped": 9,
        "seed_dispatch_s": 9, "seed_fetch_s": 9, "chain_dispatch_s": 9,
        "chain_fetch_s": 9,
        "lanes_occupied": 10, "lanes_total": 10, "chunks": 10,
        "join_bailouts": 10, "cache_hits": 10, "cache_misses": 10,
        "join_dispatch_s": 10, "join_fetch_s": 10,
    },
    "fleet": {
        "jobs_accepted": 11, "jobs_rejected": 11, "jobs_placed": 11,
        "jobs_migrated": 11, "jobs_preempted": 11,
        "hosts_alive": 11, "hosts_dead": 11,
        "cost_cache_hits": 11, "cost_cache_misses": 11,
    },
}


def schema_keys() -> Dict[str, FrozenSet[str]]:
    """Per-section key sets (``"top"`` is the report's top level)."""
    out = {"top": frozenset(TOP_KEYS)}
    for section, keys in SECTION_KEYS.items():
        out[section] = frozenset(keys)
    return out


# which function emits each section (module path, function name): the
# ``top`` keys and ``dispatch_fetch`` are assembled inline by
# build_report
SECTION_EMITTERS: Dict[str, Tuple[str, str]] = {
    "top": ("racon_tpu_torch/obs/report.py", "build_report"),
    "dispatch_fetch": ("racon_tpu_torch/obs/report.py", "build_report"),
    "queue": ("racon_tpu_torch/obs/metrics.py", "queue_summary"),
    "pack": ("racon_tpu_torch/obs/metrics.py", "pack_summary"),
    "recovery": ("racon_tpu_torch/obs/metrics.py", "recovery_summary"),
    "compiles": ("racon_tpu_torch/obs/buildwatch.py", "summary"),
    "dataflow": ("racon_tpu_torch/obs/metrics.py", "dataflow_summary"),
    "overlap": ("racon_tpu_torch/obs/metrics.py", "overlap_summary"),
    "fleet": ("racon_tpu_torch/obs/metrics.py", "fleet_summary"),
}

# report key -> the metric or span timer whose emission backs it. The
# RACON_TPU_SANITIZE=1 exit audit uses it to tell a real zero (the metric
# fired and summed to 0) from a default (it never fired, and the section
# builder's .get() default filled the key). The JAX package's map, except
# that ``compile_s`` reads the port's library builds.
REPORT_BACKING: Dict[str, str] = {
    "dispatch_fetch.align_dispatch_s": "align.dispatch",
    "dispatch_fetch.align_fetch_s": "align.fetch",
    "dispatch_fetch.consensus_pack_s": "poa.pack",
    "dispatch_fetch.consensus_dispatch_s": "poa.dispatch",
    "dispatch_fetch.consensus_fetch_s": "poa.fetch",
    "dispatch_fetch.compile_s": "compile.build_s",
    "queue.depth": "queue.depth",
    "queue.producer_wait_s": "queue.producer_wait_s",
    "queue.consumer_wait_s": "queue.consumer_wait_s",
    "queue.stall_s": "queue.producer_wait_s",
    "pack.pack_efficiency": "consensus.lanes_occupied",
    "pack.pad_fraction": "consensus.lanes_total",
    "pack.windows_per_group": "consensus.group_windows",
    "pack.groups": "consensus.groups",
    "pack.align_pack_efficiency": "align.lanes_occupied",
    "pack.align_pad_fraction": "align.lanes_total",
    "pack.align_chunks": "align.chunks",
    "pack.align_steps_wasted": "align.steps_wasted",
    "recovery.recovered_jobs": "serve.recovered_jobs",
    "recovery.requeued_jobs": "serve.requeued_jobs",
    "recovery.served_from_spool": "serve.spool_served",
    "recovery.spool_corrupt": "serve.spool_corrupt",
    "recovery.journal_replayed": "serve.journal_replayed",
    "recovery.journal_records": "serve.journal_records",
    "recovery.journal_compactions": "serve.journal_compactions",
    "recovery.slot_restarts": "slot.restarts",
    "recovery.slot_quarantined": "slot.quarantined",
    "dataflow.resident": "dataflow.resident",
    "dataflow.bytes_fetched": "dataflow.bytes_fetched",
    "dataflow.bytes_avoided": "dataflow.bytes_avoided",
    "dataflow.fallback_pairs": "dataflow.fallback_pairs",
    "dataflow.resident_bailouts": "dataflow.resident_bailouts",
    "dataflow.lanes_device_groups": "dataflow.lanes_device_groups",
    "dataflow.ins_overflow_windows": "consensus.ins_overflow_windows",
    "overlap.minimizers": "overlap.minimizers",
    "overlap.candidate_pairs": "overlap.candidate_pairs",
    "overlap.freq_capped_buckets": "overlap.freq_capped_buckets",
    "overlap.chains_kept": "overlap.chains_kept",
    "overlap.chains_dropped": "overlap.chains_dropped",
    "overlap.lanes_occupied": "overlap.lanes_occupied",
    "overlap.lanes_total": "overlap.lanes_total",
    "overlap.chunks": "overlap.chunks",
    "overlap.join_bailouts": "overlap.join_bailouts",
    "overlap.cache_hits": "overlap.cache_hits",
    "overlap.cache_misses": "overlap.cache_misses",
    "overlap.seed_dispatch_s": "overlap.seed.dispatch",
    "overlap.seed_fetch_s": "overlap.seed.fetch",
    "overlap.join_dispatch_s": "overlap.join.dispatch",
    "overlap.join_fetch_s": "overlap.join.fetch",
    "overlap.chain_dispatch_s": "overlap.chain.dispatch",
    "overlap.chain_fetch_s": "overlap.chain.fetch",
    "fleet.jobs_accepted": "gateway.accepted",
    "fleet.jobs_rejected": "gateway.rejected",
    "fleet.jobs_placed": "fleet.placed",
    "fleet.jobs_migrated": "fleet.migrated",
    "fleet.jobs_preempted": "fleet.preempted",
    "fleet.hosts_alive": "fleet.hosts_alive",
    "fleet.hosts_dead": "fleet.hosts_dead",
    "fleet.cost_cache_hits": "fleet.cost_cache_hits",
    "fleet.cost_cache_misses": "fleet.cost_cache_misses",
}

# -------------------------------------------------------- state machines


class StateMachine:
    """A declared lifecycle machine: states, directed edges and the
    initial states. Frozen data: the consumers keep their own logic, and
    the tests check the writes they make against :meth:`has_edge`."""

    def __init__(self, name: str, states: Iterable[str],
                 edges: Iterable[Tuple[str, str]],
                 initial: Iterable[str]):
        self.name = name
        self.states: Tuple[str, ...] = tuple(states)
        self.edges: FrozenSet[Tuple[str, str]] = frozenset(edges)
        self.initial: Tuple[str, ...] = tuple(initial)
        for src, dst in self.edges:
            if src not in self.states or dst not in self.states:
                raise ValueError(
                    f"{name}: edge {src!r}->{dst!r} references an "
                    f"undeclared state")
        for s in self.initial:
            if s not in self.states:
                raise ValueError(f"{name}: initial {s!r} undeclared")

    @property
    def terminal(self) -> Tuple[str, ...]:
        """States with no outgoing edge."""
        srcs = {src for src, _ in self.edges}
        return tuple(s for s in self.states if s not in srcs)

    def has_edge(self, src: str, dst: str) -> bool:
        return (src, dst) in self.edges

    def __contains__(self, state: str) -> bool:
        return state in self.states


# the job states' one spelling (serve/service.py binds its job states and
# serve/journal.py its record types to these)
JOB_SUBMITTED = "submitted"
JOB_QUEUED = "queued"
JOB_RUNNING = "running"
JOB_DONE = "done"
JOB_FAILED = "failed"
JOB_CANCELLED = "cancelled"
JOB_COLLECTED = "collected"

# the resident service's job machine. "submitted" is the journal's
# admission record; a job in memory starts "queued". running->queued is
# the crash re-queue (a server or slot death), running->running a new
# incarnation after a crash (the journal's count of running records is the
# crash ladder's input), done->queued the corrupt-spool re-queue, and
# done->collected retires the job after its one fetch.
JOB_MACHINE = StateMachine(
    "job",
    states=(JOB_SUBMITTED, JOB_QUEUED, JOB_RUNNING, JOB_DONE,
            JOB_FAILED, JOB_CANCELLED, JOB_COLLECTED),
    edges=(
        (JOB_SUBMITTED, JOB_QUEUED), (JOB_SUBMITTED, JOB_FAILED),
        (JOB_QUEUED, JOB_RUNNING), (JOB_QUEUED, JOB_FAILED),
        (JOB_QUEUED, JOB_CANCELLED),
        (JOB_RUNNING, JOB_RUNNING), (JOB_RUNNING, JOB_QUEUED),
        (JOB_RUNNING, JOB_DONE), (JOB_RUNNING, JOB_FAILED),
        (JOB_RUNNING, JOB_CANCELLED),
        (JOB_DONE, JOB_COLLECTED), (JOB_DONE, JOB_QUEUED),
    ),
    initial=(JOB_SUBMITTED, JOB_QUEUED),
)

# the journal's record types (the "rec" field): the job machine's
# observable alphabet
JOURNAL_RECORDS: Tuple[str, ...] = (JOB_SUBMITTED, JOB_RUNNING, JOB_DONE,
                                    JOB_FAILED, JOB_CANCELLED,
                                    JOB_COLLECTED)

# the shard states' one spelling (exec/manifest.py binds its names to
# these)
SHARD_PENDING = "pending"
SHARD_RUNNING = "running"
SHARD_DONE = "done"
SHARD_QUARANTINED = "quarantined"

# the shard machine. done->pending is the part-CRC re-queue,
# quarantined->pending the retry of a quarantined shard, running->running
# the stale-lease reclaim (a takeover rewrites the worker, not the
# state), running->pending a re-queue of an abandoned shard.
SHARD_MACHINE = StateMachine(
    "shard",
    states=(SHARD_PENDING, SHARD_RUNNING, SHARD_DONE,
            SHARD_QUARANTINED),
    edges=(
        (SHARD_PENDING, SHARD_RUNNING),
        (SHARD_RUNNING, SHARD_RUNNING), (SHARD_RUNNING, SHARD_PENDING),
        (SHARD_RUNNING, SHARD_DONE), (SHARD_RUNNING, SHARD_QUARANTINED),
        (SHARD_DONE, SHARD_PENDING), (SHARD_QUARANTINED, SHARD_PENDING),
    ),
    initial=(SHARD_PENDING,),
)

# the shard lease (exec/lease.py); the lease.* metrics name these
# transitions one to one
LEASE_MACHINE = StateMachine(
    "lease",
    states=("free", "claimed", "expired", "lost"),
    edges=(
        ("free", "claimed"),
        ("claimed", "free"), ("claimed", "expired"), ("claimed", "lost"),
        ("expired", "claimed"),
    ),
    initial=("free",),
)

# the fleet job machine, as the gateway sees it. A job is "accepted" once
# its admission record is journaled, "queued" in its tenant's FIFO,
# "placed" while an incarnation runs on a member host. placed->queued is
# the drain shared by preemption (a higher-priority job needs the host)
# and migration (the host went silent past its TTL): the job re-enters
# its tenant queue and is placed again under a new incarnation key.
# done->collected retires the job after its one fetch.
TENANT_ACCEPTED = "accepted"
TENANT_QUEUED = "queued"
TENANT_PLACED = "placed"
TENANT_DONE = "done"
TENANT_FAILED = "failed"
TENANT_CANCELLED = "cancelled"
TENANT_COLLECTED = "collected"

TENANT_MACHINE = StateMachine(
    "tenant",
    states=(TENANT_ACCEPTED, TENANT_QUEUED, TENANT_PLACED, TENANT_DONE,
            TENANT_FAILED, TENANT_CANCELLED, TENANT_COLLECTED),
    edges=(
        (TENANT_ACCEPTED, TENANT_QUEUED),
        (TENANT_ACCEPTED, TENANT_FAILED),
        (TENANT_QUEUED, TENANT_PLACED), (TENANT_QUEUED, TENANT_FAILED),
        (TENANT_QUEUED, TENANT_CANCELLED),
        (TENANT_PLACED, TENANT_QUEUED),   # preempt / migrate drain
        (TENANT_PLACED, TENANT_PLACED),   # re-place incarnation
        (TENANT_PLACED, TENANT_DONE), (TENANT_PLACED, TENANT_FAILED),
        (TENANT_PLACED, TENANT_CANCELLED),
        (TENANT_DONE, TENANT_COLLECTED),
    ),
    initial=(TENANT_ACCEPTED,),
)

# the member host's liveness machine (beacon files under --fleet-dir,
# refreshed like lease keepers). "registered" is the beacon's first
# write; "silent" a missed refresh inside the TTL's grace; silent->dead
# fires past the TTL (the gateway breaks the host's job leases and places
# its jobs on survivors); dead->alive is a host restarted under the same
# name. registered->dead: the gateway's first sight of a beacon may
# already be stale (the host died before the gateway started).
HOST_REGISTERED = "registered"
HOST_ALIVE = "alive"
HOST_SILENT = "silent"
HOST_DEAD = "dead"

PLACEMENT_MACHINE = StateMachine(
    "placement",
    states=(HOST_REGISTERED, HOST_ALIVE, HOST_SILENT, HOST_DEAD),
    edges=(
        (HOST_REGISTERED, HOST_ALIVE), (HOST_REGISTERED, HOST_DEAD),
        (HOST_ALIVE, HOST_SILENT),
        (HOST_SILENT, HOST_ALIVE), (HOST_SILENT, HOST_DEAD),
        (HOST_DEAD, HOST_ALIVE),
    ),
    initial=(HOST_REGISTERED,),
)

MACHINES: Tuple[StateMachine, ...] = (JOB_MACHINE, SHARD_MACHINE,
                                      LEASE_MACHINE, TENANT_MACHINE,
                                      PLACEMENT_MACHINE)


def selfcheck() -> list:
    """The registry's audit of itself: every metric, span and fault-site
    name parses under the grammar, every :data:`REPORT_BACKING` key is a
    schema key backed by a registered metric or span timer, every journal
    record is a job state, and every emitter section is declared. Returns
    the violations ([] = clean)."""
    errors = []
    for name in sorted(METRICS):
        if not METRIC_NAME_RE.match(name):
            errors.append(f"metric {name!r} violates METRIC_NAME_RE")
    for span in sorted(SPANS):
        if not METRIC_NAME_RE.match(span):
            errors.append(f"span {span!r} violates METRIC_NAME_RE")
    for site in FAULT_SITES:
        if not METRIC_NAME_RE.match(site):
            errors.append(f"fault site {site!r} violates the name "
                          f"grammar")
    for key, metric in REPORT_BACKING.items():
        section = key.split(".", 1)[0]
        if section not in SECTION_KEYS:
            errors.append(f"REPORT_BACKING {key!r}: unknown section")
        elif key.split(".", 1)[1] not in SECTION_KEYS[section]:
            errors.append(f"REPORT_BACKING {key!r}: key not in "
                          f"SECTION_KEYS[{section!r}]")
        if metric not in METRICS and metric not in SPANS:
            errors.append(f"REPORT_BACKING {key!r} -> {metric!r}: "
                          f"backing metric is neither a registered "
                          f"metric nor a span timer")
    for rec in JOURNAL_RECORDS:
        if rec not in JOB_MACHINE:
            errors.append(f"journal record {rec!r} is not a job state")
    for section in SECTION_EMITTERS:
        if section != "top" and section not in SECTION_KEYS:
            errors.append(f"SECTION_EMITTERS {section!r}: no key set")
    return errors
