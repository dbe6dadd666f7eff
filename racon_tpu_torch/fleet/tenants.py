"""Weighted-fair tenant scheduling: per-tenant FIFO queues drained by
stride scheduling, and per-tenant cost budgets (the port of
``racon_tpu/fleet/tenants.py``).

The grammar (``RACON_TPU_FLEET_TENANTS``)::

    name:weight[:budget][,name:weight[:budget]...]

``weight`` is the tenant's share of placements: each pop charges the
chosen tenant ``STRIDE_ONE / weight``, and the tenant with the smallest
accumulated pass goes next, so over any window tenants drain in
proportion to their weights. ``budget`` bounds the summed cost estimate
(bytes; ``K/M/G/T`` suffixes through the planner's :func:`parse_ram`) of
the tenant's admitted and uncollected jobs; 0 or absent is unbounded. A
tenant the grammar does not name gets weight 1 and no budget.

The scheduler is a plain data structure: no locks (the gateway holds its
state lock around every call), no I/O, no clocks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..exec.planner import parse_ram

# pass increments are STRIDE_ONE / weight: headroom enough that float
# accumulation error does not matter for any realistic queue
STRIDE_ONE = float(1 << 20)


def parse_tenants(raw: str) -> Dict[str, Tuple[float, int]]:
    """``name:weight[:budget],...`` -> ``{name: (weight, budget_bytes)}``.
    A malformed entry raises: a typo must not quietly make every tenant
    best-effort."""
    out: Dict[str, Tuple[float, int]] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3) or not parts[0]:
            raise ValueError(
                f"RACON_TPU_FLEET_TENANTS entry {entry!r} is not "
                f"name:weight[:budget]")
        try:
            weight = float(parts[1])
        except ValueError:
            raise ValueError(
                f"RACON_TPU_FLEET_TENANTS entry {entry!r} has a "
                f"non-numeric weight {parts[1]!r}")
        if weight <= 0:
            raise ValueError(
                f"RACON_TPU_FLEET_TENANTS entry {entry!r} has a "
                f"non-positive weight")
        budget = parse_ram(parts[2]) if len(parts) == 3 and parts[2] \
            else 0
        out[parts[0]] = (weight, budget)
    return out


class TenantScheduler:
    """Per-tenant FIFO queues, stride fairness and cost budgets.

    Items are opaque (the gateway queues its jobs); within a tenant they
    go by descending ``priority``, then by submission, and
    :meth:`requeue` puts a drained or migrated job at the front of its
    priority class, so preemption and migration do not also cost it its
    place in line."""

    def __init__(self, config: Optional[Dict[str, Tuple[float, int]]]
                 = None):
        self.config = dict(config or {})
        self._queues: Dict[str, List[Tuple[int, int, object]]] = {}
        self._pass: Dict[str, float] = {}
        self._charged: Dict[str, int] = {}
        self._seq = 0

    def weight(self, tenant: str) -> float:
        return self.config.get(tenant, (1.0, 0))[0]

    def budget_bytes(self, tenant: str) -> int:
        return self.config.get(tenant, (1.0, 0))[1]

    # ------------------------------------------------------------ budgets

    def charged_bytes(self, tenant: str) -> int:
        return self._charged.get(tenant, 0)

    def admit_check(self, tenant: str, cost: int) -> Optional[str]:
        """None when the tenant's budget admits ``cost`` more bytes, else
        the reason for the rejection."""
        budget = self.budget_bytes(tenant)
        if budget <= 0:
            return None
        charged = self.charged_bytes(tenant)
        if charged + cost > budget:
            return (f"tenant {tenant!r} budget exhausted: "
                    f"{charged >> 20} MB in flight + {cost >> 20} MB "
                    f"requested > {budget >> 20} MB budget "
                    f"(RACON_TPU_FLEET_TENANTS) — collect or cancel "
                    f"outstanding jobs first")
        return None

    def charge(self, tenant: str, cost: int) -> None:
        self._charged[tenant] = self.charged_bytes(tenant) + cost

    def uncharge(self, tenant: str, cost: int) -> None:
        self._charged[tenant] = max(0, self.charged_bytes(tenant) - cost)

    # ------------------------------------------------------------- queues

    def _entries(self, tenant: str) -> List[Tuple[int, int, object]]:
        return self._queues.setdefault(tenant, [])

    def _activate(self, tenant: str) -> None:
        # a tenant going from idle to busy starts at the current pass
        # floor: an idle tenant must not bank credit and then monopolize
        if tenant not in self._pass or not self._entries(tenant):
            floor = min((self._pass[t] for t, q in self._queues.items()
                         if q and t in self._pass), default=0.0)
            self._pass[tenant] = max(self._pass.get(tenant, 0.0), floor)

    def push(self, tenant: str, item, priority: int = 0) -> None:
        self._activate(tenant)
        entries = self._entries(tenant)
        self._seq += 1
        entries.append((-priority, self._seq, item))
        entries.sort(key=lambda e: (e[0], e[1]))

    def requeue(self, tenant: str, item, priority: int = 0) -> None:
        """Put a preempted or migrated job back at the front of its
        priority class."""
        self._activate(tenant)
        entries = self._entries(tenant)
        self._seq += 1
        idx = 0
        while idx < len(entries) and entries[idx][0] < -priority:
            idx += 1
        entries.insert(idx, (-priority, -self._seq, item))

    def pop(self) -> Optional[Tuple[str, object]]:
        """The next ``(tenant, item)`` by stride fairness, or None when
        every queue is empty."""
        busy = [t for t, q in self._queues.items() if q]
        if not busy:
            return None
        tenant = min(busy, key=lambda t: (self._pass.get(t, 0.0), t))
        self._pass[tenant] = self._pass.get(tenant, 0.0) + \
            STRIDE_ONE / self.weight(tenant)
        _, _, item = self._queues[tenant].pop(0)
        return tenant, item

    def peek_priority(self) -> Optional[Tuple[str, int, object]]:
        """The highest-priority queued item of any tenant, ``(tenant,
        priority, item)``: what preemption compares against."""
        best = None
        for tenant, entries in self._queues.items():
            if not entries:
                continue
            neg_pri, seq, item = entries[0]
            key = (neg_pri, seq)
            if best is None or key < best[0]:
                best = (key, tenant, -neg_pri, item)
        if best is None:
            return None
        return best[1], best[2], best[3]

    def remove(self, tenant: str, item) -> bool:
        entries = self._queues.get(tenant, [])
        for idx, (_, _, queued) in enumerate(entries):
            if queued is item:
                entries.pop(idx)
                return True
        return False

    def depths(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())
