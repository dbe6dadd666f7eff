"""Memory-budgeted shard planning: an LPT bin-pack of target contigs (the
port of ``racon_tpu/exec/planner.py`` without its chip-count mode).

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
shard too many rather than overrunning with one too few.

Three sizing modes, the first that applies wins: a shard count
(``--shards N``, clamped to the number of contigs), a process RAM budget
(``--max-ram``: the data is packed into ``budget - base_rss`` and the
shard count grows until every bin fits), or a cap on target bytes a
shard (the wrapper's ``--split``). A contig whose cost alone exceeds the
budget gets a shard of its own and a warning: splitting a contig would
break its window stitching.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..utils.logger import warn
from .index import RunIndex

_MIN_AVAIL = 64 << 20  # floor of budget - base_rss before the warning


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
    mode: str                             # "shards" | "max-ram" | "split"
    budget_bytes: int = 0                 # the process budget (max-ram)
    avail_bytes: int = 0                  # budget - base_rss
    contig_cost: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    # each shard's advisory device (parallel to ``shards``); empty on one
    # device, so the manifest entries carry no "device" key
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
                   n_devices: int = 1) -> List[int]:
    """Each shard's advisory device. The port drives one device, which
    needs no assignment: the empty list, which keeps the ``device`` key
    out of the manifest entries as on the JAX package's single-chip runs
    (its LPT over chips and mesh marker come with multi-GPU, ROADMAP
    Queue 1 item 9)."""
    if n_devices != 1:
        raise ValueError(f"shard plans cover one device, not {n_devices}")
    return []


def plan_shards(index: RunIndex, n_shards: int = 0, max_ram_bytes: int = 0,
                max_target_bytes: int = 0, base_rss: int = 0,
                n_devices: int = 1) -> ShardPlan:
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
