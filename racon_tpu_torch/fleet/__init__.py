"""racon_tpu_torch.fleet: multi-tenant serving across a fleet of hosts
(the port of ``racon_tpu/fleet``; stdlib and the port's own modules).

- **gateway** (:mod:`.gateway`): the TCP front door (``racon --gateway
  HOST:PORT --fleet-dir DIR``). It speaks the serve protocol unchanged,
  journals every accepted job before acknowledging it (the machinery of
  ``serve/journal.py``) and places jobs on member hosts under per-job
  leases. It does no device work.
- **tenants** (:mod:`.tenants`): weighted-fair (stride) scheduling over
  per-tenant FIFO queues, with per-tenant cost budgets
  (``RACON_TPU_FLEET_TENANTS=name:weight:budget,...``).
- **registry** (:mod:`.registry`): host membership as beacon files under
  ``--fleet-dir/hosts/``. Each ``racon --serve --fleet-dir`` host
  refreshes its beacon's mtime as a lease keeper does; a beacon stale past
  ``RACON_TPU_FLEET_HOST_TTL_S`` marks the host dead, and the gateway
  breaks its job leases and places the work on survivors.
"""

from __future__ import annotations

from .gateway import Gateway  # noqa: F401
from .registry import HostBeacon, read_hosts  # noqa: F401
from .tenants import TenantScheduler, parse_tenants  # noqa: F401
