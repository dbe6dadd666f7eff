"""ShardRunner: a checkpointed, crash-safe streaming polish (the port of
``racon_tpu/exec/runner.py``). Several worker processes, and several
in-process chip workers, may drain one work directory.

- **Shards**: the index pass (:mod:`.index`) and the plan (:mod:`.planner`)
  cut the target contigs into shards; each shard's inputs are copied out
  of the original files by byte range and polished by a fresh
  ``Polisher`` on its worker's engine pair, built once and reused by
  every shard the worker runs.
- **Leases and the manifest**: the worker claims each shard through its
  lease file (:mod:`.lease`) and records every transition in the shard's
  state file and the manifest snapshot (:mod:`.manifest`), so
  ``--resume`` skips the shards that finished.
- **Degradation ladder**: a failed attempt is classified
  (:func:`racon_tpu_torch.faults.classify`). ``transient-io`` retries on
  the same engines after a backoff; ``device-oom`` halves both engines'
  capacity (``reduce_capacity``) and re-dispatches on the device. Any
  other fault, or an OOM at the floor, quarantines the shard when the
  primary engines run on the card (their work never moves to the host);
  when they are host engines already, it retries once on the native host
  engines, and a failure there quarantines the shard. Every attempt is
  kept in the shard's manifest entry (``attempts``) and its report row.
- **Parts**: each finished part records its size and CRC32; before the
  merge every part is read again, and a truncated or corrupt one is
  re-queued rather than merged. The merge writes the parts' records back
  in target-file order, so the output equals a single-shot run's bytes.
- **Workers**: processes that share a work dir cooperate through the
  leases: the first to start publishes the plan
  (``create_manifest_if_absent``) and the others adopt it; a shard leased
  by a live worker is waited on, and one whose worker died is reclaimed.
  A ``secondary`` (the CLI's ``--workers`` spawns them) waits for the
  primary's manifest instead of planning, never verifies or merges the
  parts and never removes the work dir; ``defer_cleanup`` leaves the
  removal to the caller, which reaps its secondaries first.
- **Chip scheduler**: one process drives every local card. With a
  ``cuda`` backend on a multi-card host (or ``--chips N``), the runner
  starts one in-process chip worker per card, each with its own engine
  pair pinned to its card, and the workers drain the same manifest
  through the same leases (thread ``racon-chipK``, worker id
  ``...#chipK``). The plan's advisory card assignment orders each
  worker's walk (its own shards first, then the others'); a shard marked
  ``MESH_DEVICE`` (one contig dominating the run) is run by slot 0 on the
  mesh engines, its batches split over all of the run's cards.
  Device-OOM backpressure acts on the failing worker's engines only.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import sys
import threading
import time
import traceback
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults, flags, obs, sanitize
from ..core.backends import make_aligner, make_consensus
from ..core.polisher import PolisherType, create_polisher
from ..device import resolve
from ..io import parsers
from ..obs import metrics, report as obs_report
from ..parallel import get_mesh, topology
from ..parallel.topology import ChipSlot
from ..utils.logger import warn
from . import heartbeat as hb
from . import lease as lease_mod
from . import manifest as mf
from .index import RunIndex, build_index, build_index_auto
from .planner import MESH_DEVICE, ShardPlan, assign_devices, plan_shards

# verification rounds before a part that keeps failing is a hard error
# (each round polishes the shard again)
_MAX_VERIFY_ROUNDS = 3
# how long a secondary worker waits for the primary's manifest
_SECONDARY_MANIFEST_WAIT_S = 120.0


def _eprint(msg: str) -> None:
    print(f"[racon_tpu::exec] {msg}", file=sys.stderr, flush=True)


def _plain_ext(path: str, candidates, default: str) -> str:
    """The extension of an extracted (always uncompressed) input."""
    base = path[:-3] if path.endswith(".gz") else path
    for ext in candidates:
        if not ext.endswith(".gz") and base.endswith(ext):
            return ext
    return default


def _terminal(entry: dict) -> bool:
    return entry.get("status") in (mf.DONE, mf.QUARANTINED)


class _ChipWorker:
    """One executor slot: a worker identity (suffixed ``#chipK`` when the
    slot is pinned, so leases and manifest rows attribute work per card),
    the primary engine pair on the slot's card (or on the profile's
    ``device`` when unpinned), the ladder's host pair and, for slot 0
    only, the mesh engines that run the plan's mesh-marked shards over all
    of the run's cards. Each pair is built at first use and reused by
    every shard or job the slot runs. A run without the chip scheduler
    has exactly one unpinned slot whose worker id is the profile's own.

    ``profile`` is duck-typed: anything carrying the engine recipe
    (``num_threads``, ``match``/``mismatch``/``gap``, ``banded``,
    ``aligner_backend``/``consensus_backend``, ``aligner_batches``/
    ``consensus_batches``, ``device``), a ``worker`` identity and, for the
    mesh slot, ``_chip_slots()``. :class:`ShardRunner` passes itself; the
    resident polishing service (``racon_tpu_torch.serve``) passes its
    ``PolishServer``, one slot per card or concurrent job."""

    def __init__(self, profile, slot: Optional[ChipSlot] = None):
        self.profile = profile
        self.slot = slot if slot is not None else ChipSlot(0, None)
        self.ordinal = self.slot.ordinal
        # a slot with a device is pinned to it
        self.device = self.slot.device
        self.worker = (f"{profile.worker}#{self.slot.key}"
                       if self.device is not None else profile.worker)
        self.can_mesh = self.ordinal == 0
        self.engines = None
        self.cpu_engines = None
        self.mesh_engines = None
        # the service's supervision handle: the job this slot runs (set
        # by the scheduler under its lock, read by the supervisor when the
        # slot's thread dies)
        self.current_job = None

    def get_engines(self, cpu: bool, mesh: bool = False):
        """The primary pair (``aligner``/``consensus`` on the slot's card,
        pinned, or on the profile's ``device``), with ``cpu`` the ladder's
        native host pair, with ``mesh`` the pair over a mesh of every
        slot's card. One thread drives a slot (the service builds every
        slot's pair before its threads start), so the caches take no
        lock."""
        r = self.profile
        if cpu:
            if self.cpu_engines is None:
                self.cpu_engines = (
                    make_aligner("native", r.num_threads),
                    make_consensus("native", r.match, r.mismatch, r.gap,
                                   r.num_threads))
            return self.cpu_engines
        if mesh:
            if self.mesh_engines is None:
                # the run's cards, not every visible one: a --chips 2 run
                # on an 8-card host leaves the other six alone
                mesh_obj = get_mesh(devices=[w.device
                                             for w in r._chip_slots()])
                self.mesh_engines = (
                    make_aligner(r.aligner_backend, r.num_threads,
                                 num_batches=r.aligner_batches,
                                 mesh=mesh_obj),
                    make_consensus(r.consensus_backend, r.match, r.mismatch,
                                   r.gap, r.num_threads,
                                   num_batches=r.consensus_batches,
                                   banded=r.banded, mesh=mesh_obj))
            return self.mesh_engines
        if self.engines is None:
            pinned = self.device is not None
            device = self.device if pinned else r.device
            self.engines = (
                make_aligner(r.aligner_backend, r.num_threads,
                             num_batches=r.aligner_batches,
                             device=device),
                make_consensus(r.consensus_backend, r.match, r.mismatch,
                               r.gap, r.num_threads,
                               num_batches=r.consensus_batches,
                               banded=r.banded, device=device,
                               pinned=pinned))
        return self.engines

    def primary_on_card(self) -> bool:
        """Whether the primary pair launches kernels on a card. Then the
        ladder has no CPU rung: the card's work never moves to the host
        engines."""
        r = self.profile
        device = self.device if self.device is not None else r.device
        return "cuda" in (r.aligner_backend, r.consensus_backend) \
            and resolve(device).type == "cuda"

    def reduce_capacity(self, mesh: bool = False) -> bool:
        """Device-OOM backpressure on this slot's primary (or mesh) engines
        only, per card and not per process: each that has the knob halves
        its capacity. False when none could (not built, host engines, or
        both at their floor)."""
        engines = self.mesh_engines if mesh else self.engines
        if engines is None:
            return False
        reduced = False
        for eng in engines:
            shrink = getattr(eng, "reduce_capacity", None)
            if shrink is not None and shrink():
                reduced = True
        return reduced


class ShardRunner:
    """The bounded-memory, checkpointed drive of the polishing pipeline.

    ``aligner`` and ``consensus`` name the backends of the primary engine
    pair (``cuda`` or ``native``, as for ``create_polisher``); ``device``
    is where the ``cuda`` engines and the ``auto`` overlapper run."""

    def __init__(self, sequences: str, overlaps: str, target_sequences: str,
                 *, type_: PolisherType = PolisherType.C,
                 window_length: int = 500, quality_threshold: float = 10.0,
                 error_threshold: float = 0.3, trim: bool = True,
                 match: int = 3, mismatch: int = -5, gap: int = -4,
                 num_threads: int = 1, aligner: str = "native",
                 consensus: str = "native", aligner_batches: int = 1,
                 consensus_batches: int = 1, banded: bool = False,
                 include_unpolished: bool = False, n_shards: int = 0,
                 max_ram_bytes: int = 0, max_target_bytes: int = 0,
                 resume: bool = False, work_dir: Optional[str] = None,
                 keep_work_dir: Optional[bool] = None,
                 secondary: bool = False, defer_cleanup: bool = False,
                 device="cuda", chips: int = 0):
        self.sequences = os.path.abspath(sequences)
        # ``auto``: run() writes the overlapper's PAF into the work dir
        # and points self.overlaps at it before indexing
        self.overlaps = (parsers.AUTO_OVERLAPS
                         if parsers.overlaps_mode(overlaps) == "auto"
                         else os.path.abspath(overlaps))
        self.target_sequences = os.path.abspath(target_sequences)
        self.type = type_
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.trim = trim
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.num_threads = num_threads
        self.aligner_backend = aligner
        self.consensus_backend = consensus
        self.aligner_batches = aligner_batches
        self.consensus_batches = consensus_batches
        self.banded = banded
        self.include_unpolished = include_unpolished
        self.n_shards = n_shards
        self.max_ram_bytes = max_ram_bytes
        self.max_target_bytes = max_target_bytes
        self.resume = resume
        # a secondary adopts the primary's manifest, polishes shards and
        # writes no merged FASTA; defer_cleanup leaves the work dir's
        # removal to the caller (cleanup_work_dir)
        self.secondary = secondary
        self.defer_cleanup = defer_cleanup
        # resolved where it is used (the cuda engines, the overlapper), as
        # create_polisher does: host engines never touch it
        self.device = device
        self.worker = lease_mod.worker_identity()
        # an explicit work dir is the user's (resume workflows); a derived
        # one is removed after a fully successful run, never by a secondary
        self.keep_work_dir = (keep_work_dir if keep_work_dir is not None
                              else work_dir is not None or secondary)
        self.work_dir = os.path.abspath(work_dir or self.derive_work_dir())
        self.index: Optional[RunIndex] = None
        self.plan: Optional[ShardPlan] = None
        self.summary: Dict = {}
        self.report: Dict = {}     # the run report (also in work_dir)
        # in-process chip workers: 0 = automatic (every local card when a
        # cuda backend runs on a multi-card host), 1 pins card 0
        self.chips_requested = chips
        # the executor slots (_chip_slots), each holding its primary
        # engine pair and the CPU rung's, built at first use and reused
        # by every shard it runs
        self._slots: Optional[List[_ChipWorker]] = None
        self._retry_quarantined: set = set()  # resume: claimable again
        self._initially_done: set = set()
        self._announced: set = set()
        self._beat: Optional[hb.Heartbeat] = None
        # the chip workers share the manifest: entry changes and snapshot
        # writes (exec.manifest), the terminal-shard notes (exec.notes)
        # and the state-scan cache (exec.states) each take a named lock,
        # the lock-order witness's under RACON_TPU_SANITIZE=1
        self._mf_lock = sanitize.named_lock("exec.manifest")
        self._note_lock = sanitize.named_lock("exec.notes")
        # a dying chip worker sets this, so its siblings stop polling
        self._abort = threading.Event()
        self._states_lock = sanitize.named_lock("exec.states")
        self._states_cache: Tuple[float, Dict[int, dict]] = (-1e9, {})

    # ------------------------------------------------------------ identity

    def derive_work_dir(self) -> str:
        """The default work dir: the same inputs and parameters give the
        same directory, so ``--resume`` needs nothing more."""
        h = hashlib.sha1()
        for part in (self.sequences, self.overlaps, self.target_sequences,
                     self.type.name, self.window_length,
                     self.quality_threshold, self.error_threshold,
                     self.trim, self.match, self.mismatch, self.gap,
                     self.include_unpolished):
            h.update(repr(part).encode())
        return os.path.join(os.getcwd(),
                            f"racon_exec_{h.hexdigest()[:12]}")

    def _params_fingerprint(self) -> dict:
        return {"type": self.type.name,
                "window_length": self.window_length,
                "quality_threshold": self.quality_threshold,
                "error_threshold": self.error_threshold,
                "trim": self.trim, "match": self.match,
                "mismatch": self.mismatch, "gap": self.gap,
                "include_unpolished": self.include_unpolished}

    # ---------------------------------------------------------- chip slots

    def _chip_slots(self) -> List[_ChipWorker]:
        """This run's in-process executor slots, resolved once
        (:func:`~racon_tpu_torch.parallel.topology.executor_slots`). A
        ``--workers`` run spans processes on either side (the spawned
        secondaries, or the primary that shares the host's cards with
        them), so it never engages the scheduler on its own."""
        if self._slots is not None:
            return self._slots
        # defer_cleanup marks the primary of a --workers spawn
        slots = [_ChipWorker(self, s) for s in topology.executor_slots(
            self.chips_requested,
            (self.aligner_backend, self.consensus_backend), self.device,
            multi_process=self.secondary or self.defer_cleanup)]
        if len(slots) > 1:
            kind = topology.Topology(len(slots)).describe()["device_kind"]
            _eprint(f"chip scheduler: {len(slots)} in-process chip workers "
                    f"({kind})")
        self._slots = slots
        return slots

    # ------------------------------------------------------------- engines

    @property
    def engines(self):
        return self._chip_slots()[0].engines

    @property
    def cpu_engines(self):
        return self._chip_slots()[0].cpu_engines

    def get_engines(self, cpu: bool):
        """The first slot's primary pair (``aligner``/``consensus`` on
        ``device``), or with ``cpu`` its native host pair."""
        return self._chip_slots()[0].get_engines(cpu)

    def primary_on_card(self) -> bool:
        """Whether the primary pair launches kernels on a card. Then the
        ladder has no CPU rung: a fault there quarantines the shard rather
        than move the card's work to the host engines."""
        return self._chip_slots()[0].primary_on_card()

    def reduce_capacity(self, worker: Optional[_ChipWorker] = None,
                        mesh: bool = False) -> bool:
        """Device-OOM backpressure on the engines that failed: ``worker``'s
        (the first slot's by default) mesh pair, or its primary pair
        (built first if the fault came before its first polish). Each that
        has the knob halves its capacity. False when none could (host
        engines, or both at their floor)."""
        worker = worker if worker is not None else self._chip_slots()[0]
        if not mesh:
            worker.get_engines(cpu=False)
        return worker.reduce_capacity(mesh=mesh)

    # ----------------------------------------------------------------- run

    def run(self, out) -> Dict:
        """Run (or resume, or join) the whole sharded polish, writing the
        merged FASTA to the binary stream ``out`` (a secondary writes
        nothing). Returns the summary (also kept as :attr:`summary`)."""
        t0 = time.perf_counter()
        t_start = time.time()
        # a run boundary, and the span timers on: the report written next
        # to the manifest carries the dispatch/fetch split
        metrics.clear_run()
        obs.trace.activate()
        if parsers.is_auto_overlaps(self.overlaps):
            os.makedirs(self.work_dir, exist_ok=True)
            auto_paf = os.path.join(self.work_dir, "auto_overlaps.paf")
            _eprint(f"overlapping {os.path.basename(self.sequences)} "
                    f"(first-party overlapper, worker {self.worker})")
            with obs.span("exec.index"):
                self.index = build_index_auto(
                    self.sequences, self.target_sequences, auto_paf,
                    self.type, self.error_threshold,
                    device=resolve(self.device))
            self.overlaps = auto_paf
        else:
            _eprint(f"indexing {os.path.basename(self.overlaps)} / "
                    f"{os.path.basename(self.sequences)} "
                    f"(worker {self.worker})")
            with obs.span("exec.index"):
                self.index = build_index(self.sequences, self.overlaps,
                                         self.target_sequences, self.type,
                                         self.error_threshold)
        base_rss = metrics.peak_rss_bytes()
        with obs.span("exec.plan"):
            self.plan = plan_shards(self.index, self.n_shards,
                                    self.max_ram_bytes,
                                    self.max_target_bytes,
                                    base_rss=base_rss,
                                    n_devices=len(self._chip_slots()))
        os.makedirs(self.work_dir, exist_ok=True)
        # a valid resume manifest carries the stored plan, which wins (a
        # --max-ram plan depends on this process's RSS)
        manifest = self._load_or_init_manifest()
        n = self.plan.n_shards
        total_mbp = sum(t.bases for t in self.index.targets) / 1e6
        _eprint(f"plan: {len(self.index.targets)} contigs "
                f"({total_mbp:.2f} Mbp), {len(self.index.ov_start)} "
                f"overlaps -> {n} shards (mode={self.plan.mode})")
        beat = self._beat = hb.Heartbeat(n, worker=self.worker).start()
        try:
            for _ in range(_MAX_VERIFY_ROUNDS):
                self._drain(manifest, beat)
                # the merging worker verifies: the parts it emits are
                # what the check protects
                bad = [] if self.secondary else self._verify_parts(manifest)
                if not bad:
                    break
                for si in bad:
                    self._requeue_shard(si, manifest,
                                        "part verification failed")
            else:
                raise RuntimeError(
                    f"parts still failing verification after "
                    f"{_MAX_VERIFY_ROUNDS} re-polish rounds — refusing "
                    f"to emit a corrupt assembly")
            mf.merge_states(manifest, mf.load_shard_states(self.work_dir))
            mf.save_manifest(self.work_dir, manifest)
            if not self.secondary:
                beat.update(phase="merging")
                with obs.span("exec.merge"):
                    self._merge_parts(manifest, out)
        finally:
            beat.stop()

        quarantined = [e for e in manifest["shards"]
                       if e["status"] == mf.QUARANTINED]
        for e in quarantined:
            warn(f"shard {e['id']} quarantined: {e.get('reason')}")
        mbp_done = sum(e.get("mbp", 0.0) for e in manifest["shards"]
                       if e["status"] == mf.DONE)
        wall = time.perf_counter() - t0
        self.summary = {
            "n_shards": n, "mode": self.plan.mode,
            "worker": self.worker,
            "chips": len(self._chip_slots()),
            "devices": metrics.device_summary(),
            "mbp_total": round(total_mbp, 4),
            "mbp_polished": round(mbp_done, 4),
            "wall_s": round(wall, 2),
            "mbp_per_sec": round(mbp_done / wall, 4) if wall else 0.0,
            "peak_rss_bytes": metrics.peak_rss_bytes(),
            "base_rss_bytes": base_rss,
            "budget_bytes": self.plan.budget_bytes,
            "quarantined": [e["id"] for e in quarantined],
            "consensus_pack": metrics.pack_summary(),
            "faults": metrics.group("faults."),
            "lease": metrics.group("lease."),
            "shards": [dict(e) for e in manifest["shards"]],
        }
        # the run report next to the manifest; a derived work dir goes
        # with it after a fully successful run (--run-report keeps a copy)
        self.report = obs_report.build_report(
            "exec", started_unix=t_start, wall_s=wall,
            shards=manifest["shards"])
        mf.durable_write(os.path.join(self.work_dir, mf.REPORT_NAME),
                         json.dumps(self.report, indent=1).encode())
        if not self.defer_cleanup:
            self.cleanup_work_dir()
        return self.summary

    def cleanup_work_dir(self) -> None:
        """Remove a derived work dir after a fully successful run (a kept
        dir, a secondary's, or a run with quarantined shards, stays)."""
        if self.summary.get("quarantined") or self.keep_work_dir:
            return
        shutil.rmtree(self.work_dir, ignore_errors=True)

    # ------------------------------------------------------------ manifest

    def _load_or_init_manifest(self) -> dict:
        fingerprint = mf.input_fingerprint(
            (self.sequences, self.overlaps, self.target_sequences),
            self._params_fingerprint())
        manifest = None
        rejected = False
        if self.secondary:
            manifest = self._await_manifest(fingerprint)
            if not self._adopt_plan(manifest):
                raise RuntimeError(
                    "the published manifest's shard plan does not "
                    "cover this input — refusing to join it")
        elif self.resume:
            manifest = mf.load_manifest(self.work_dir)
            if manifest is not None and \
                    manifest["fingerprint"] != fingerprint:
                warn("manifest fingerprint does not match this run's "
                     "inputs/parameters — re-running every shard")
                manifest, rejected = None, True
            if manifest is not None and not self._adopt_plan(manifest):
                manifest, rejected = None, True
        if (not self.resume and not self.secondary) or rejected:
            self._clean_work_dir()
        if manifest is None:
            fresh = {
                "fingerprint": fingerprint,
                "shards": [{"id": si, "contigs": list(map(int, shard)),
                            "status": mf.PENDING,
                            "part": f"part_{si:04d}.fasta",
                            **({"device": self.plan.device_of(si)}
                               if self.plan.devices else {})}
                           for si, shard in enumerate(self.plan.shards)],
            }
            manifest = mf.create_manifest_if_absent(self.work_dir, fresh)
            if manifest is not fresh and not self._adopt_plan(manifest):
                raise RuntimeError(
                    "another worker published a manifest whose shard "
                    "plan does not cover this input — refusing to "
                    "join it")
        # the state files win over the snapshot
        mf.merge_states(manifest, mf.load_shard_states(self.work_dir))
        for e in manifest["shards"]:
            if e["status"] == mf.DONE:
                # trusted for now: the verification before the merge
                # re-queues a missing, truncated or corrupt part
                self._initially_done.add(int(e["id"]))
            elif e["status"] == mf.QUARANTINED and \
                    (self.resume or self.secondary):
                # a new run retries what an earlier one gave up on
                self._retry_quarantined.add(int(e["id"]))
        return manifest

    def _await_manifest(self, fingerprint) -> dict:
        """A secondary adopts a plan and never makes one: poll until the
        primary has published the manifest of these inputs."""
        deadline = time.monotonic() + _SECONDARY_MANIFEST_WAIT_S
        while True:
            manifest = mf.load_manifest(self.work_dir)
            if manifest is not None and \
                    manifest["fingerprint"] == fingerprint:
                return manifest
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"secondary worker {self.worker}: no manifest for "
                    f"these inputs appeared in {self.work_dir} within "
                    f"{_SECONDARY_MANIFEST_WAIT_S:.0f}s")
            time.sleep(0.1)

    def _adopt_plan(self, manifest: dict) -> bool:
        """Adopt the stored shard plan (the one the parts were cut by);
        False when it does not cover this input's contigs."""
        stored = [list(map(int, e["contigs"])) for e in manifest["shards"]]
        if sorted(ci for s in stored for ci in s) == \
                list(range(len(self.index.targets))):
            self.plan.shards = stored
            # the card assignment is process-local: derived again from the
            # adopted shards for this process's cards
            self.plan.devices = assign_devices(
                stored, self.plan.contig_cost, len(self._chip_slots()))
            return True
        warn("manifest shard plan does not cover this input's "
             "contigs — re-running every shard")
        return False

    def _clean_work_dir(self) -> None:
        """Drop a previous run's artifacts (a fresh run must not trust old
        parts), torn ``*.tmp.*`` files and tombstones included. Refuses
        while another worker holds a live lease there: a plain launch into
        a directory with a run in progress must not destroy it."""
        for name in os.listdir(self.work_dir):
            if name.startswith(lease_mod.LEASE_PREFIX) \
                    and name.endswith(".json"):
                sid = name[len(lease_mod.LEASE_PREFIX):-len(".json")]
                if not sid.isdigit():
                    continue
                probe = lease_mod.try_claim(self.work_dir, int(sid),
                                            self.worker)
                if probe is None:
                    raise RuntimeError(
                        f"{self.work_dir} has a live shard lease "
                        f"({name}) — another worker is mid-run there. "
                        f"Pass --resume to continue its run, or pick a "
                        f"different --shard-dir.")
                probe.release()  # a dead leftover
        for name in os.listdir(self.work_dir):
            path = os.path.join(self.work_dir, name)
            if name in (mf.MANIFEST_NAME, mf.REPORT_NAME) \
                    or name.startswith(("part_", mf.STATE_PREFIX,
                                        lease_mod.LEASE_PREFIX,
                                        "plan.lock")) \
                    or ".tmp." in name:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            elif name.startswith("shard_") and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)

    def _save(self, entry: dict, manifest: dict) -> None:
        """Durably record one owned shard's state, then the manifest
        snapshot (state first: it is the truth). Under ``exec.manifest``:
        the snapshot serializes ``manifest`` while sibling chip workers
        change entries in place, and interleaved writes would invert the
        state-then-snapshot order."""
        with self._mf_lock:
            mf.save_shard_state(self.work_dir, entry)
            mf.save_manifest(self.work_dir, manifest)

    def _save_owned(self, entry: dict, manifest: dict, claim) -> None:
        """A terminal write, made only while the lease is still ours: a
        worker whose lease was broken (it stalled past the TTL and another
        worker reclaimed the shard) must not overwrite the reclaimer's
        state."""
        if claim.lost.is_set() or not claim.heartbeat():
            metrics.inc("lease.stale_write_suppressed")
            warn(f"shard {entry['id']}: lease was broken while this "
                 f"worker ran — discarding its late "
                 f"{entry.get('status')} result (the reclaiming "
                 f"worker's state stands)")
            fresh = mf.load_shard_state(self.work_dir, int(entry["id"]))
            if fresh is not None:
                with self._mf_lock:
                    entry.clear()
                    entry.update(fresh)
            return
        self._save(entry, manifest)

    # ---------------------------------------------------------- drain loop

    def _drain(self, manifest: dict, beat) -> None:
        """Drain the manifest with every slot: one slot runs the claim loop
        inline; with the chip scheduler engaged, one thread a chip worker
        runs the same loop, and the lease files are all the coordination
        there is (in-process chips, ``--workers`` processes and workers
        launched by hand interleave on one manifest)."""
        slots = self._chip_slots()
        if len(slots) == 1:
            self._drain_loop(slots[0], manifest, beat)
            return
        self._abort.clear()
        errors: List[BaseException] = []

        def body(worker: _ChipWorker) -> None:
            try:
                self._drain_loop(worker, manifest, beat)
            except BaseException as e:  # re-raised after the join
                errors.append(e)
                # the siblings stop polling for shards only the dead
                # worker could run (a dead primary's mesh shard)
                self._abort.set()

        threads = [threading.Thread(target=body, args=(w,),
                                    name=f"racon-{w.slot.key}",
                                    daemon=True)
                   for w in slots[1:]]
        for t in threads:
            t.start()
        body(slots[0])
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def _shard_order(self, worker: _ChipWorker) -> List[int]:
        """The order a slot walks the plan: the mesh-marked shards first
        (slot 0 only; they are the largest by construction), then the
        slot's own, then the others' (stealing through the leases keeps a
        fast card from idling behind a slow one)."""
        n = self.plan.n_shards
        devs = self.plan.devices
        if not devs:
            return list(range(n))
        mesh = [si for si in range(n) if devs[si] == MESH_DEVICE]
        mine = [si for si in range(n) if devs[si] == worker.ordinal]
        rest = [si for si in range(n)
                if devs[si] != MESH_DEVICE and devs[si] != worker.ordinal]
        return (mesh if worker.can_mesh else []) + mine + rest

    def _drain_loop(self, worker: _ChipWorker, manifest: dict,
                    beat) -> None:
        """Claim and run shards until every one is terminal, on the slot's
        card (its current device for the thread). With several slots the
        thread's span timers are mirrored under ``device.<ordinal>.``, the
        report's per-device seconds."""
        poll_s = max(0.05, flags.get_float("RACON_TPU_EXEC_POLL_S"))
        multi = len(self._chip_slots()) > 1
        if multi:
            obs.trace.set_timer_prefix(f"device.{worker.ordinal}.")
        try:
            with worker.slot.pin():
                self._drain_loop_inner(worker, manifest, beat, poll_s,
                                       multi)
        finally:
            if multi:
                obs.trace.set_timer_prefix(None)

    def _load_states(self, max_age_s: float) -> Dict[int, dict]:
        """The state-file scan behind a short shared cache (N chip workers
        polling one directory would multiply its metadata reads). A stale
        scan is safe: states only move toward terminal, and a requeue
        drops the cache."""
        now = time.monotonic()
        with self._states_lock:
            ts, states = self._states_cache
            if now - ts <= max_age_s:
                return states
        states = mf.load_shard_states(self.work_dir)
        with self._states_lock:
            self._states_cache = (time.monotonic(), states)
        return states

    def _drain_loop_inner(self, worker: _ChipWorker, manifest: dict, beat,
                          poll_s: float, multi: bool) -> None:
        """A shard leased by another live worker is waited on: its lease
        expires after the TTL if that worker died, and the next pass
        reclaims it."""
        order = self._shard_order(worker)
        devs = self.plan.devices
        cache_s = poll_s / 2 if multi else 0.0
        while True:
            if self._abort.is_set():
                return  # a sibling died; the pool is unwinding
            progressed = False
            waiting: List[int] = []
            states = self._load_states(cache_s)
            with self._mf_lock:
                mf.merge_states(manifest, states)
            for si in order:
                shard = self.plan.shards[si]
                use_mesh = bool(devs) and devs[si] == MESH_DEVICE
                if use_mesh and not worker.can_mesh:
                    continue  # slot 0 owns the mesh shards
                entry = manifest["shards"][si]
                if _terminal(entry) and si not in self._retry_quarantined:
                    self._note_terminal(si, entry, beat)
                    continue
                claim = lease_mod.try_claim(self.work_dir, si,
                                            worker.worker)
                if claim is None:
                    waiting.append(si)
                    continue
                try:
                    # the previous owner may have finished between the
                    # state read and the claim
                    fresh = mf.load_shard_state(self.work_dir, si)
                    if fresh is not None:
                        with self._mf_lock:
                            manifest["shards"][si] = entry = dict(fresh)
                    if _terminal(entry) and \
                            si not in self._retry_quarantined:
                        self._note_terminal(si, entry, beat)
                        continue
                    self._retry_quarantined.discard(si)
                    if entry.get("status") == mf.QUARANTINED:
                        # the retry goes back through pending: the shard
                        # machine has no quarantined -> running edge
                        with self._mf_lock:
                            entry["status"] = mf.PENDING
                        self._save(entry, manifest)
                    if entry.get("status") == mf.RUNNING:
                        # an abandoned shard, taken over
                        metrics.inc("lease.reclaimed")
                        with self._mf_lock:
                            entry["reclaimed"] = int(
                                entry.get("reclaimed", 0)) + 1
                        _eprint(f"reclaiming shard {si} abandoned by "
                                f"worker {entry.get('worker', '?')}")
                    beat.update(done=self._done_count(manifest),
                                phase="polishing")
                    if use_mesh and multi:
                        # a mesh shard's seconds belong to the report's
                        # "mesh" row, not to the card driving it
                        obs.trace.set_timer_prefix("device.mesh.")
                    try:
                        with obs.track(f"shard {si}"), \
                                obs.span("exec.shard", shard=si):
                            self._run_shard(si, shard, entry, manifest,
                                            claim, worker, use_mesh)
                    finally:
                        if use_mesh and multi:
                            obs.trace.set_timer_prefix(
                                f"device.{worker.ordinal}.")
                finally:
                    claim.release()
                progressed = True
                self._note_terminal(si, entry, beat)
                beat.emit(f"shard {si} {entry['status']} "
                          f"engine={entry.get('engine', '-')}")
            if not waiting and self._done_all(manifest):
                return
            if not progressed:
                beat.update(phase=f"waiting on {len(waiting)} leased "
                                  f"shard(s)")
                time.sleep(poll_s)

    def _done_count(self, manifest: dict) -> int:
        with self._mf_lock:
            return sum(_terminal(e) for e in manifest["shards"])

    def _done_all(self, manifest: dict) -> bool:
        states = self._load_states(
            0.05 if len(self._chip_slots()) > 1 else 0.0)
        with self._mf_lock:
            mf.merge_states(manifest, states)
            return all(_terminal(e) for e in manifest["shards"])

    def _my_worker_ids(self) -> set:
        return {w.worker for w in (self._slots or [])} | {self.worker}

    def _shard_mbp(self, si: int) -> float:
        return sum(self.index.targets[ci].bases
                   for ci in self.plan.shards[si]) / 1e6

    def _note_terminal(self, si: int, entry: dict, beat) -> None:
        with self._note_lock:
            if si in self._announced or not _terminal(entry):
                return
            self._announced.add(si)
            announced = len(self._announced)
        shard_mbp = self._shard_mbp(si)
        if entry["status"] == mf.DONE:
            # credited to the worker that polished it: per-card rates
            beat.add_mbp(entry.get("worker"), shard_mbp)
        if si in self._initially_done and self.resume:
            _eprint(f"resume: skipping completed shard {si} "
                    f"({shard_mbp:.2f} Mbp)")
        elif entry.get("worker") not in ({None} | self._my_worker_ids()):
            _eprint(f"shard {si} {entry['status']} by worker "
                    f"{entry.get('worker')}")
        beat.update(done=announced)

    # ------------------------------------------------- verification/requeue

    def _verify_parts(self, manifest: dict) -> List[int]:
        """Read every done part again against its recorded size and CRC32
        (a disk that lied about fsync, a truncated copy or a flipped bit);
        the shard ids whose parts fail."""
        mf.merge_states(manifest, mf.load_shard_states(self.work_dir))
        bad: List[int] = []
        for entry in manifest["shards"]:
            if entry["status"] != mf.DONE:
                continue
            part = os.path.join(self.work_dir, entry["part"])
            try:
                crc = 0
                size = 0
                with open(part, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        crc = zlib.crc32(chunk, crc)
                        size += len(chunk)
                ok = (size == entry.get("bytes")
                      and crc == entry.get("crc32"))
            except OSError:
                ok = False
            if not ok:
                warn(f"part {entry['part']} failed verification "
                     f"(recorded {entry.get('bytes')}B "
                     f"crc32={entry.get('crc32')}) — re-queueing "
                     f"shard {entry['id']} instead of merging a "
                     f"corrupt assembly")
                metrics.inc("faults.part_corrupt")
                bad.append(int(entry["id"]))
        return bad

    def _requeue_shard(self, si: int, manifest: dict, why: str) -> None:
        """Reset a shard to pending, under its lease, for the drain loop
        to polish again (its re-run replaces the part atomically)."""
        claim = lease_mod.try_claim(self.work_dir, si, self.worker)
        if claim is None:
            return  # another worker is on it
        try:
            was = manifest["shards"][si]
            entry = {"id": si,
                     "contigs": list(map(int, self.plan.shards[si])),
                     "status": mf.PENDING,
                     "part": f"part_{si:04d}.fasta",
                     "requeued": why}
            with self._mf_lock:
                manifest["shards"][si] = entry
            self._save(entry, manifest)
            # done -> pending breaks the cached scan's only-toward-
            # terminal rule: drop the cache
            with self._states_lock:
                self._states_cache = (-1e9, {})
            if si in self._announced and was.get("status") == mf.DONE:
                if self._beat is not None:
                    self._beat.add_mbp(was.get("worker"),
                                       -self._shard_mbp(si))
                if was.get("device") is not None and \
                        len(self._chip_slots()) > 1 and \
                        was.get("worker") in self._my_worker_ids():
                    # retract the per-device credit this process gave (the
                    # polish seconds stay: they were spent)
                    dev_key = ("mesh" if was["device"] == MESH_DEVICE
                               else str(was["device"]))
                    metrics.inc(f"device.{dev_key}.shards", -1)
                    metrics.inc(f"device.{dev_key}.mbp",
                                -round(self._shard_mbp(si), 4))
            self._announced.discard(si)
            self._initially_done.discard(si)
        finally:
            claim.release()

    # ------------------------------------------------------ shard execution

    def _backoff_s(self, si: int, k: int) -> float:
        """Exponential backoff with a jitter keyed by worker, shard and
        retry (``faults.backoff_s``)."""
        base = max(0.0, flags.get_float("RACON_TPU_EXEC_BACKOFF_S"))
        return faults.backoff_s(base, k, f"{self.worker}:{si}:{k}")

    def _release_device_memory(self) -> None:
        """After a device OOM: collect the failed attempt's cycles (its
        pipeline threads' exceptions hold frames with device tensors) and
        hand the cached blocks back, so the re-dispatch at half capacity
        starts from free memory."""
        gc.collect()
        if resolve(self.device).type == "cuda":
            import torch
            torch.cuda.empty_cache()

    def _run_shard(self, si: int, shard: List[int], entry: dict,
                   manifest: dict, claim,
                   worker: Optional[_ChipWorker] = None,
                   use_mesh: bool = False) -> None:
        worker = worker if worker is not None else self._chip_slots()[0]
        sleep_s = flags.get_float("RACON_TPU_EXEC_SLEEP_S")
        if sleep_s > 0 and si > 0:
            time.sleep(sleep_s)  # test hook: widens a kill's window
        with self._mf_lock:
            entry.update(status=mf.RUNNING, worker=worker.worker)
            # this attempt's record only: drop an earlier run's outcome
            for stale in ("requeued", "reason", "attempts", "engine",
                          "bytes", "crc32"):
                entry.pop(stale, None)
        self._save(entry, manifest)
        # a SIGKILL here leaves the shard running under a lease that is
        # no longer refreshed: what a resume or another worker reclaims
        faults.check("worker.kill")
        t0 = time.perf_counter()

        part = os.path.join(self.work_dir, entry["part"])
        max_retries = max(0, flags.get_int("RACON_TPU_EXEC_RETRIES"))
        attempts: List[dict] = []
        transient_used = 0
        tier_cpu = False
        paths: Optional[Dict[str, str]] = None
        extract_s = 0.0
        timings: Dict = {}
        part_stat: Optional[Tuple[int, int]] = None  # (bytes, crc32)
        for attempt_no in range(64):  # the ladder ends well before this
            try:
                if paths is None:
                    t_ext = time.perf_counter()
                    with obs.span("exec.extract", shard=si):
                        paths = self._extract_shard(si, shard)
                    extract_s += time.perf_counter() - t_ext
                faults.check("exec.polish", shard=si, attempt=attempt_no)
                records, timings = self._polish_shard(
                    paths, cpu=tier_cpu, worker=worker, use_mesh=use_mesh)
                part_stat = self._write_part(part, records)
                break
            except Exception as e:
                cls = faults.classify(e)
                metrics.inc(f"faults.{cls}")
                err = f"{type(e).__name__}: {e}"
                att = {"n": attempt_no,
                       "engine": "cpu" if tier_cpu else "primary",
                       "class": cls, "error": err}
                attempts.append(att)
                if cls == faults.CLASS_TRANSIENT and \
                        transient_used < max_retries:
                    backoff = self._backoff_s(si, transient_used)
                    att["action"] = "retry-backoff"
                    att["backoff_s"] = round(backoff, 3)
                    transient_used += 1
                    metrics.add_time("exec.backoff_s", backoff)
                    warn(f"shard {si} transient fault ({err}) — "
                         f"retry {transient_used}/{max_retries} in "
                         f"{backoff:.2f}s")
                    if isinstance(e, OSError):
                        paths = None  # extract again after an I/O fault
                    time.sleep(backoff)
                elif cls == faults.CLASS_OOM and not tier_cpu and \
                        self.reduce_capacity(worker, use_mesh):
                    att["action"] = "reduce-capacity"
                    warn(f"shard {si} device OOM ({err}) — halved worker "
                         f"{worker.worker}'s engine capacity (align "
                         f"direction-matrix budget, consensus pair arena "
                         f"and group), re-dispatching on the device")
                    # the failed attempt's frames hold its device tensors
                    traceback.clear_frames(e.__traceback__)
                    del e
                    self._release_device_memory()
                elif not tier_cpu and not worker.primary_on_card():
                    tier_cpu = True
                    att["action"] = "cpu-retry"
                    warn(f"shard {si} attempt failed ({err}) — "
                         f"retrying on the CPU engines")
                else:
                    att["action"] = "quarantine"
                    where = "CPU retry" if tier_cpu else "attempt on the card"
                    warn(f"shard {si} {where} failed ({err}) — quarantining")
                    break
        if part_stat is None:
            with self._mf_lock:
                entry.update(status=mf.QUARANTINED,
                             reason=self._reason(attempts),
                             attempts=attempts, worker=worker.worker,
                             wall_s=round(time.perf_counter() - t0, 2))
            self._save_owned(entry, manifest, claim)
            self._drop_shard_inputs(paths)
            return
        wall = round(time.perf_counter() - t0, 2)
        shard_mbp = round(self._shard_mbp(si), 4)
        with self._mf_lock:
            entry.update(
                status=mf.DONE,
                engine="cpu-retry" if tier_cpu else "primary",
                worker=worker.worker,
                bytes=part_stat[0], crc32=part_stat[1],
                mbp=shard_mbp,
                wall_s=wall,
                extract_s=round(extract_s, 2),
                timings=timings,
                # the port traces nothing: no retrace deltas
                retrace={},
                peak_rss_mb=metrics.peak_rss_bytes() >> 20)
            if self.plan.devices:
                # the card the shard ran on (MESH_DEVICE: over all of
                # them), in the manifest and the report's shard row
                entry["device"] = (MESH_DEVICE if use_mesh
                                   else worker.ordinal)
            if attempts:
                entry["attempts"] = attempts
                entry["reason"] = self._reason(attempts)
        if len(self._chip_slots()) > 1:
            # the report's devices rows and the per-card Mbp/s
            dev_key = "mesh" if use_mesh else str(worker.ordinal)
            metrics.inc(f"device.{dev_key}.shards")
            metrics.inc(f"device.{dev_key}.mbp", shard_mbp)
            metrics.add_time(f"device.{dev_key}.polish_s", wall)
        self._save_owned(entry, manifest, claim)
        self._drop_shard_inputs(paths)

    @staticmethod
    def _reason(attempts: List[dict]) -> str:
        return "; ".join(("cpu retry: " if a["engine"] == "cpu" else "")
                         + a["error"] for a in attempts)

    @staticmethod
    def _drop_shard_inputs(paths: Optional[Dict[str, str]]) -> None:
        if paths is not None:
            shutil.rmtree(os.path.dirname(paths["targets"]),
                          ignore_errors=True)

    def _write_part(self, part: str,
                    records: List[Tuple[bytes, bytes]]) -> Tuple[int, int]:
        """Durably write one part (tmp, fsync, atomic rename) and return
        its (size, CRC32) for the record the merge verifies against."""
        faults.check("part.write")
        tmp = f"{part}.tmp.{os.getpid()}.{time.monotonic_ns()}"
        crc = 0
        size = 0
        with open(tmp, "wb") as f:
            for name, data in records:
                blob = b">" + name + b"\n" + data + b"\n"
                f.write(blob)
                crc = zlib.crc32(blob, crc)
                size += len(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, part)
        mf.fsync_dir(self.work_dir)
        return size, crc

    def _polish_shard(self, paths: Dict[str, str], cpu: bool,
                      worker: Optional[_ChipWorker] = None,
                      use_mesh: bool = False
                      ) -> Tuple[List[Tuple[bytes, bytes]], Dict]:
        if paths["n_overlaps"] == 0:
            return self._unpolished_records(paths), {}
        worker = worker if worker is not None else self._chip_slots()[0]
        aligner, consensus = worker.get_engines(cpu, mesh=use_mesh)
        p = create_polisher(
            paths["reads"], paths["overlaps"], paths["targets"],
            self.type, window_length=self.window_length,
            quality_threshold=self.quality_threshold,
            error_threshold=self.error_threshold, trim=self.trim,
            match=self.match, mismatch=self.mismatch, gap=self.gap,
            num_threads=self.num_threads, aligner=aligner,
            consensus=consensus,
            device=(worker.device if worker.device is not None
                    else self.device),
            window_type=self.index.window_type,
            prefiltered_overlaps=True, evict_reads=True,
            stall_escalation=True)
        polished = p.run(not self.include_unpolished)
        return [(s.name, s.data) for s in polished], dict(p.timings)

    def _unpolished_records(self, paths) -> List[Tuple[bytes, bytes]]:
        """A shard whose contigs kept no overlap: a single-shot run drops
        them, or with ``-u`` emits them uppercased with zero-coverage tags
        (a Polisher would refuse the empty overlap set)."""
        if not self.include_unpolished:
            return []
        out = []
        tag_prefix = b"r" if self.type == PolisherType.F else b""
        for rec in parsers.sequence_parser_for(paths["targets"])(
                paths["targets"]):
            data = rec.data.upper()
            tags = tag_prefix + b" LN:i:%d RC:i:0 XC:f:%.6f" % (
                len(data), 0.0)
            out.append((rec.name + tags, data))
        return out

    # ----------------------------------------------------- shard extraction

    def _extract_shard(self, si: int, shard: List[int]) -> Dict[str, str]:
        """Write the shard's input triple by byte range from the original
        files. Deterministic, so a retried, resumed or reclaimed shard
        reads the same inputs; the files are scratch (no fsync), written
        anew by every attempt that needs them."""
        d = os.path.join(self.work_dir, f"shard_{si:04d}")
        os.makedirs(d, exist_ok=True)
        idx = self.index

        t_ext = _plain_ext(self.target_sequences,
                           parsers.SEQUENCE_EXTENSIONS, ".fasta")
        tgt_path = os.path.join(d, "targets" + t_ext)
        with open(tgt_path, "wb") as f:
            parsers.copy_byte_ranges(
                self.target_sequences,
                [(idx.targets[ci].start, idx.targets[ci].end)
                 for ci in shard], f)

        line_ids = np.concatenate(
            [idx.lines_of_contig(ci) for ci in shard]) \
            if shard else np.zeros(0, np.int64)
        line_ids = line_ids[np.argsort(idx.ov_start[line_ids],
                                       kind="stable")]
        read_ords = np.unique(idx.ov_read[line_ids])

        r_ext = _plain_ext(self.sequences, parsers.SEQUENCE_EXTENSIONS,
                           ".fasta")
        reads_path = os.path.join(d, "reads" + r_ext)
        with open(reads_path, "wb") as f:
            parsers.copy_byte_ranges(
                self.sequences,
                [(int(idx.read_spans[r, 0]), int(idx.read_spans[r, 1]))
                 for r in read_ords], f)

        ovl_path = os.path.join(d, "overlaps." + idx.overlap_fmt)
        ranges = [(int(idx.ov_start[i]), int(idx.ov_end[i]))
                  for i in line_ids]
        with open(ovl_path, "wb") as f:
            if idx.overlap_fmt == "mhap":
                # MHAP addresses records by file ordinal: rewrite both id
                # columns to the shard's own 1-based positions
                read_pos = {int(r): k for k, r in enumerate(read_ords)}
                contig_pos = {ci: k for k, ci in enumerate(shard)}
                for blob, i in zip(
                        parsers.iter_byte_ranges(self.overlaps, ranges),
                        line_ids):
                    fields = blob.split()
                    fields[0] = b"%d" % (read_pos[int(idx.ov_read[i])] + 1)
                    fields[1] = b"%d" % (contig_pos[int(idx.ov_target[i])]
                                         + 1)
                    f.write(b" ".join(fields) + b"\n")
            else:
                parsers.copy_byte_ranges(self.overlaps, ranges, f)

        return {"targets": tgt_path, "reads": reads_path,
                "overlaps": ovl_path, "n_overlaps": len(line_ids)}

    # ----------------------------------------------------------- part merge

    def _merge_parts(self, manifest: dict, out) -> None:
        """The parts' records back in target-file order (the LPT pack
        scatters contigs over shards; a single-shot run emits them in file
        order), copied verbatim."""
        owner = self.plan.owner_of()
        readers: Dict[int, "_PartReader"] = {}
        tag = b"r" if self.type == PolisherType.F else b""
        try:
            for ci, target in enumerate(self.index.targets):
                si = owner[ci]
                entry = manifest["shards"][si]
                if entry["status"] != mf.DONE:
                    continue  # quarantined: nothing to emit
                if si not in readers:
                    readers[si] = _PartReader(
                        os.path.join(self.work_dir, entry["part"]))
                readers[si].emit_if(target.name + tag, out)
        finally:
            for r in readers.values():
                r.close()
        out.flush()


class _PartReader:
    """A sequential reader of one part's two-line FASTA records with one
    record of lookahead (a dropped contig leaves its slot empty, and the
    pending record belongs to a later contig)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        self.pending: Optional[Tuple[bytes, bytes]] = None
        self._advance()

    def _advance(self) -> None:
        header = self.f.readline()
        if not header:
            self.pending = None
            return
        data = self.f.readline()
        token = header[1:].split(None, 1)[0]
        self.pending = (token, header + data)

    def emit_if(self, token: bytes, out) -> bool:
        if self.pending is not None and self.pending[0] == token:
            out.write(self.pending[1])
            self._advance()
            return True
        return False

    def close(self) -> None:
        self.f.close()
