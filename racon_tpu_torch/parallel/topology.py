"""Local device topology: enumerate the cards, hand out executor slots
(the port of ``racon_tpu/parallel/topology.py``).

The reference driver round-robins its batches over every visible GPU from
one process (``src/cuda/cudapolisher.cpp:72-83``). A run here takes one of
two shapes:

- **shard per card** (the common case): each local card gets its own
  pinned engine pair, and an in-process chip worker drains manifest shards
  onto it (``racon_tpu_torch.exec.runner``) through the same lease files
  that worker processes use: no collectives, no mesh, and every card runs
  the single-device fast path (ragged packing, streaming sessions);
- **mesh-sharded** (one contig dominates the plan): ``sharded_align`` and
  ``sharded_refine_loop`` (:mod:`racon_tpu_torch.parallel`) split that one
  shard's batches over all cards.

A :class:`ChipSlot`'s :meth:`~ChipSlot.pin` is ``torch.cuda.device`` of
its card: it makes the card the calling thread's current device (PyTorch
keeps that per thread, so N chip workers share one process). The engines
still receive the slot's device explicitly and launch there.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import torch

from .. import flags
from ..device import resolve


def local_devices() -> List[torch.device]:
    """Every card this process can drive, ``cuda:0`` .. ``cuda:N-1``, or
    ``[cpu]`` on a machine without one (the plain versions of the
    kernels)."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def n_local_chips() -> int:
    return len(local_devices())


def resolve_chips(requested: int = 0) -> int:
    """How many in-process chip workers a run spawns: an explicit request
    (CLI ``--chips``) wins, then ``RACON_TPU_CHIPS``, then every local
    device. Always clamped to the local device count and floored at 1."""
    if requested <= 0:
        requested = flags.get_int("RACON_TPU_CHIPS")
    n = n_local_chips()
    if requested <= 0:
        return max(1, n)
    return max(1, min(requested, n))


@dataclass
class ChipSlot:
    """One local card's executor slot: its device and its ordinal (the
    key of per-device metrics, worker ids and plan assignments)."""

    ordinal: int
    device: Optional[torch.device] = None

    @property
    def key(self) -> str:
        return f"chip{self.ordinal}"

    def pin(self):
        """The slot's card as the calling thread's current CUDA device (a
        null context for the unpinned slot and for a CPU device)."""
        if self.device is None:
            return contextlib.nullcontext()
        from . import on_device
        return on_device(self.device)


def executor_slots(requested: int, backends, device,
                   multi_process: bool = False) -> List[ChipSlot]:
    """The slots of a shard run or a service: one slot a card when the
    chip scheduler engages, else one unpinned slot (the single-device
    path). A slot with a device is pinned to it.

    An explicit request (``requested`` from ``--chips``, or
    ``RACON_TPU_CHIPS``) always wins, and an explicit ``1`` pins card 0,
    so no mesh of every card engages. Otherwise a ``cuda`` backend on a
    host with several cards engages every card, unless the run spans
    processes (``--workers``: cards times processes must be asked for).
    A ``cpu`` run keeps its pinned slots on the CPU; any other pin goes
    through :func:`~racon_tpu_torch.device.resolve`, which raises when
    there is no card."""
    explicit = requested > 0 or flags.get_int("RACON_TPU_CHIPS") > 0
    on_cpu = torch.device(device).type == "cpu"
    n = 1
    if explicit:
        n = resolve_chips(requested)
    elif not multi_process and not on_cpu and "cuda" in backends:
        devs = local_devices()
        if len(devs) > 1 and devs[0].type != "cpu":
            n = len(devs)
    if n <= 1 and not explicit:
        return [ChipSlot(0, None)]
    devs = ([torch.device("cuda", 0)] if n <= 1
            else [s.device for s in Topology(n).slots])
    return [ChipSlot(k, torch.device("cpu") if on_cpu else resolve(d))
            for k, d in enumerate(devs)]


class Topology:
    """The local cards as executor slots.

    ``n_chips <= 1`` gives one *unpinned* slot: the single-device path.
    ``n_chips > 1`` gives one pinned slot per device of a prefix of
    :func:`local_devices`; slot 0 doubles as the mesh-capable slot (it runs
    the plan's shards marked mesh-sharded over all of the run's cards)."""

    def __init__(self, n_chips: int = 0):
        n = resolve_chips(n_chips)
        if n <= 1:
            self.slots: List[ChipSlot] = [ChipSlot(0, None)]
        else:
            devs = local_devices()
            self.slots = [ChipSlot(k, devs[k]) for k in range(n)]

    @property
    def n_chips(self) -> int:
        return len(self.slots)

    def describe(self) -> dict:
        """The topology record of plans and reports: platform (``gpu`` or
        ``cpu``), device kind and card count."""
        devs = local_devices()
        first = devs[0] if devs else None
        on_card = first is not None and first.type == "cuda"
        return {
            "n_chips": self.n_chips,
            "n_local_devices": len(devs),
            "platform": "gpu" if on_card else "cpu",
            "device_kind": (torch.cuda.get_device_name(first) if on_card
                            else "cpu"),
        }
