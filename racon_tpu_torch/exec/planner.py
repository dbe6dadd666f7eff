"""Memory-budgeted shard planning: an LPT bin-pack of target contigs (the
port of ``racon_tpu/exec/planner.py``).

The cost model is a resident-footprint estimate per contig, in bytes:

    cost = 2 * target_bases  +  3 * read_bases  +  2 * overlap_bytes

- the targets count twice: the contig and the backbone copies its windows
  hold;
- the reads three times: the forward data, the reverse complement about
  half of them materialise (with reversed qualities), and the layer
  slices the windows copy;
- the overlap bytes stand for the breaking-point rows and transient span
  copies.

It errs high on purpose: ``--max-ram`` is a promise, so it splits one
shard too many rather than overrunning with one too few. The resident
service's admission (``racon_tpu_torch.serve``) applies the same weights
to a job's whole files (:func:`estimate_job_cost`, behind the fingerprint
cache of :func:`cached_job_cost`).

Three sizing modes, the first that applies wins: a shard count
(``--shards N``, clamped to the number of contigs), a process RAM budget
(``--max-ram``: the data is packed into ``budget - base_rss`` and the
shard count grows until every bin fits), or a cap on target bytes a
shard (the wrapper's ``--split``). A contig whose cost alone exceeds the
budget gets a shard of its own and a warning: splitting a contig would
break its window stitching.

Device topology: with ``n_devices > 1`` (in-process chip workers) the plan
knows the cards. A run with no sizing flag plans ``SHARDS_PER_CHIP x
n_devices`` shards (mode ``chips``; more than one a card lets the LPT
rebalance stragglers), and every plan LPT-assigns its shards over the cards
(:func:`assign_devices`, kept per shard in the plan and the manifest as an
advisory preference: a chip worker drains its own shards first and steals
the rest through the leases). A single-contig shard whose cost exceeds the
balanced per-card load by ``MESH_DOMINANT_FACTOR`` would be the run's
straggler on one card; it is marked ``device = MESH_DEVICE`` instead and
runs mesh-sharded over all of the run's cards (``sharded_align`` and
``sharded_refine_loop``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..io import parsers
from ..obs import metrics
from ..utils.logger import warn
from .index import RunIndex

_MIN_AVAIL = 64 << 20  # floor of budget - base_rss before the warning
# shards a card when a multi-card run gives no sizing flag
SHARDS_PER_CHIP = 2
# a lone contig whose cost exceeds the balanced per-card load by this factor
# runs mesh-sharded over all cards instead of holding one card for longer
# than the rest of the run
MESH_DOMINANT_FACTOR = 1.5
MESH_DEVICE = -1  # ShardPlan.devices marker: mesh over all cards

# a .gz input's resident cost follows its inflated bytes; genomic FASTA,
# FASTQ and PAF compress about 4:1, so admission multiplies a gzipped
# file's size by this (erring high, as the shard cost model does)
GZ_INFLATE_FACTOR = 4


def input_cost_bytes(path: str) -> int:
    """The approximate inflated size of one input file."""
    size = os.path.getsize(path)
    return size * GZ_INFLATE_FACTOR if path.endswith(".gz") else size


def estimate_job_cost(sequences: str, overlaps: str,
                      target_sequences: str) -> int:
    """The resident-footprint estimate, in bytes, of polishing one input
    triple as one service job: the per-contig cost model applied to the
    whole files, with its deliberate over-estimate (reject one job too
    many rather than run one into an OOM). An ``--overlaps auto`` job has
    no overlaps file; its rows live in memory at about the reads' scale,
    so the reads count once more instead."""
    base = (2 * input_cost_bytes(target_sequences)
            + 3 * input_cost_bytes(sequences))
    if parsers.is_auto_overlaps(overlaps):
        return base + input_cost_bytes(sequences)
    return base + 2 * input_cost_bytes(overlaps)


# the admission estimate's cache, keyed by the inputs' stat fingerprint
# (absolute path, size, mtime_ns: a rewrite in place misses). Bounded; a
# full cache is dropped whole.
_COST_CACHE: dict = {}
_COST_CACHE_LOCK = threading.Lock()
_COST_CACHE_MAX = 1024


def _spec_fingerprint(sequences: str, overlaps: str,
                      target_sequences: str) -> tuple:
    """The stat fingerprint of one job's inputs (never their bytes). A
    vanished input raises the ``OSError`` the estimate would."""
    auto = parsers.is_auto_overlaps(overlaps)
    paths = [sequences, target_sequences] + ([] if auto else [overlaps])
    key = ["auto" if auto else "paf"]
    for p in paths:
        st = os.stat(p)
        key.append((os.path.abspath(p), st.st_size, st.st_mtime_ns))
    return tuple(key)


def cached_job_cost(sequences: str, overlaps: str,
                    target_sequences: str) -> int:
    """:func:`estimate_job_cost` behind the fingerprint cache (admission
    calls this): hits and misses count in ``fleet.cost_cache_hits`` and
    ``fleet.cost_cache_misses``."""
    key = _spec_fingerprint(sequences, overlaps, target_sequences)
    with _COST_CACHE_LOCK:
        hit = _COST_CACHE.get(key)
    if hit is not None:
        metrics.inc("fleet.cost_cache_hits")
        return hit
    cost = estimate_job_cost(sequences, overlaps, target_sequences)
    metrics.inc("fleet.cost_cache_misses")
    with _COST_CACHE_LOCK:
        if len(_COST_CACHE) >= _COST_CACHE_MAX:
            _COST_CACHE.clear()
        _COST_CACHE[key] = cost
    return cost


def parse_ram(text: str) -> int:
    """``--max-ram``: a plain number is megabytes; ``K``/``M``/``G``/``T``
    suffixes are explicit (``4G``, ``500M``)."""
    s = text.strip().upper()
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1] in mult:
        return int(float(s[:-1]) * mult[s[-1]])
    return int(float(s) * (1 << 20))


@dataclass
class ShardPlan:
    shards: List[List[int]]               # contig indices, ascending
    costs: List[int]                      # the cost of each bin
    mode: str                             # "shards"|"max-ram"|"split"|"chips"
    budget_bytes: int = 0                 # the process budget (max-ram)
    avail_bytes: int = 0                  # budget - base_rss
    contig_cost: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    # each shard's advisory card (parallel to ``shards``): an ordinal >= 0
    # or MESH_DEVICE. Process-local (a worker re-derives it for its own
    # cards after adopting a plan); empty on one card, so the manifest
    # entries carry no "device" key
    devices: List[int] = field(default_factory=list)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def device_of(self, si: int) -> int:
        """Shard ``si``'s advisory device (0 when the plan has none)."""
        return self.devices[si] if si < len(self.devices) else 0

    def owner_of(self) -> dict:
        """contig index -> shard id."""
        return {ci: si for si, shard in enumerate(self.shards)
                for ci in shard}


def _lpt(costs: np.ndarray, n_bins: int) -> List[List[int]]:
    """Longest processing time first: items in descending cost, each into
    the least-loaded bin. Deterministic (a stable sort; the lowest bin
    index wins a tie)."""
    loads = np.zeros(n_bins, np.int64)
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for ci in np.argsort(-costs, kind="stable"):
        b = int(np.argmin(loads))
        bins[b].append(int(ci))
        loads[b] += int(costs[ci])
    out = [sorted(b) for b in bins if b]
    out.sort(key=lambda s: s[0])  # shard ids stable across runs
    return out


def assign_devices(bins: List[List[int]], cost: np.ndarray,
                   n_devices: int) -> List[int]:
    """Each shard's advisory card: mesh-mark the dominant single-contig
    shards, then LPT the rest over the cards (empty on one card, so the
    manifest entries carry no ``device`` key).

    Deterministic from (bins, cost, n_devices), so every chip worker, and
    a worker that adopted the plan from the manifest, derives the same
    assignment for its own topology."""
    if n_devices <= 1 or not bins:
        return []
    shard_cost = np.asarray(
        [sum(int(cost[ci]) for ci in b) for b in bins], np.int64)
    per_chip = float(shard_cost.sum()) / n_devices
    devices = [0] * len(bins)
    rest: List[int] = []
    for si, b in enumerate(bins):
        if len(b) == 1 and shard_cost[si] > MESH_DOMINANT_FACTOR * per_chip:
            # splitting a contig would break its window stitching: its
            # batches are mesh-sharded over every card instead
            devices[si] = MESH_DEVICE
        else:
            rest.append(si)
    loads = np.zeros(n_devices, np.int64)
    for si in sorted(rest, key=lambda s: (-int(shard_cost[s]), s)):
        d = int(np.argmin(loads))
        devices[si] = d
        loads[d] += int(shard_cost[si])
    return devices


def plan_shards(index: RunIndex, n_shards: int = 0, max_ram_bytes: int = 0,
                max_target_bytes: int = 0, base_rss: int = 0,
                n_devices: int = 1,
                shards_per_chip: int = SHARDS_PER_CHIP) -> ShardPlan:
    n_contigs = len(index.targets)
    t_bases = np.fromiter((t.bases for t in index.targets), np.int64,
                          n_contigs)
    cost = (2 * t_bases + 3 * index.contig_read_bytes()
            + 2 * index.contig_overlap_bytes())

    if n_shards:
        mode = "shards"
        n = max(1, min(n_shards, n_contigs))
        bins = _lpt(cost, n)
        avail = budget = 0
    elif max_ram_bytes:
        mode = "max-ram"
        budget = max_ram_bytes
        avail = budget - base_rss
        if avail < _MIN_AVAIL:
            warn(f"--max-ram {budget >> 20} MB leaves "
                 f"{max(0, avail) >> 20} MB after the current process "
                 f"footprint ({base_rss >> 20} MB) — planning against a "
                 f"{_MIN_AVAIL >> 20} MB floor")
            avail = _MIN_AVAIL
        n = max(1, min(int(-(-int(cost.sum()) // avail)), n_contigs))
        bins = _lpt(cost, n)
        # grow the shard count until every bin of two or more contigs fits
        while n < n_contigs and any(
                sum(int(cost[ci]) for ci in b) > avail and len(b) > 1
                for b in bins):
            n += 1
            bins = _lpt(cost, n)
        for b in bins:
            over = sum(int(cost[ci]) for ci in b) - avail
            if over > 0:
                warn(f"contig {index.targets[b[0]].name.decode()} alone "
                     f"is estimated {over >> 20} MB over the --max-ram "
                     f"budget — it gets its own shard; expect RSS above "
                     f"budget while it runs")
    elif max_target_bytes:
        mode = "split"
        n = max(1, min(int(-(-int(t_bases.sum()) // max_target_bytes)),
                       n_contigs))
        bins = _lpt(t_bases, n)
        while n < n_contigs and any(
                sum(int(t_bases[ci]) for ci in b) > max_target_bytes
                and len(b) > 1 for b in bins):
            n += 1
            bins = _lpt(t_bases, n)
        avail = budget = 0
    elif n_devices > 1:
        # no sizing flag, several cards: k x cards shards, so one run
        # keeps every card busy
        mode = "chips"
        n = max(1, min(max(1, shards_per_chip) * n_devices, n_contigs))
        bins = _lpt(cost, n)
        avail = budget = 0
    else:
        mode = "shards"
        bins = [list(range(n_contigs))]
        avail = budget = 0

    return ShardPlan(
        shards=bins,
        costs=[sum(int(cost[ci]) for ci in b) for b in bins],
        mode=mode, budget_bytes=budget, avail_bytes=avail,
        contig_cost=cost,
        devices=assign_devices(bins, cost, n_devices))
