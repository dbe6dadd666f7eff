"""racon_tpu_torch.parallel: one process driving several cards (the port of
``racon_tpu/parallel/__init__.py`` on one host).

Reference analog: the CUDA driver round-robins its batches across every
visible GPU (``src/cuda/cudapolisher.cpp:72-83,163-171,217-228``). Windows
and overlap pairs are independent, so a device batch is split along its
batch dimension over a 1-D :class:`Mesh` of cards; each card runs the same
hand-written kernels on its slice, and nothing in the hot path reads across
slices (a window's pairs never leave its shard, so the vote scatter stays
shard-local).

Launches go out from one host thread, slice after slice, each under
``torch.cuda.device`` of its card and on that card's current stream. They
are asynchronous, so N cards overlap; two slices on one card run one after
the other. A mesh may name one device more than once (``[cuda:0] * 2``):
every split, pad and merge then runs with the real kernels on one card.

Public surface:

- :func:`get_mesh`: a mesh over (a prefix of) the local devices, or over a
  given device list;
- :func:`sharded_align`: banded NW and its walk with the batch split over
  the mesh (:class:`racon_tpu_torch.ops.nw.CudaAligner` with ``mesh=``);
- :func:`sharded_refine_loop`: a consensus group's refinement loop with
  its pair rows and window rows co-sharded
  (:class:`racon_tpu_torch.ops.poa.CudaPoaConsensus` with ``mesh=``);
- :func:`partition_balanced`: the LPT binning of variable-cost items into
  per-shard groups (the host analog of the reference's dynamic work queue,
  ``src/cuda/cudapolisher.cpp:98-118``).

Multi-host meshes (the JAX package's ``distributed_init``, ``to_global``,
``fetch_global``) are not ported yet.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

AXIS = "d"


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: a frozen tuple of ``torch.device`` along the
    axis ``"d"``. A device may appear more than once; all devices are of
    one type."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in devs})
        if len(kinds) > 1:
            raise ValueError(f"mesh devices are of different types "
                             f"({', '.join(kinds)})")
        object.__setattr__(self, "devices", devs)

    axis_names = (AXIS,)

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}


def get_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh named ``d`` over ``n_devices`` (default: all) of
    ``devices`` (default: every local device)."""
    if devices is None:
        from .topology import local_devices
        devices = local_devices()
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} visible")
        devices = devices[:n_devices]
    return Mesh(tuple(devices))


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape[AXIS]


def on_device(dev: torch.device):
    """``dev`` as the calling thread's current CUDA device (a null context
    for a CPU device)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def partition_balanced(costs: Sequence[int], n_bins: int) -> List[List[int]]:
    """Greedy longest-processing-time binning: per-bin item indices (items
    in descending cost, each into the least-loaded bin, the lowest bin on
    a tie)."""
    order = sorted(range(len(costs)), key=lambda i: -costs[i])
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    loads = [0] * n_bins
    for i in order:
        b = loads.index(min(loads))
        bins[b].append(i)
        loads[b] += costs[i]
    return bins


def _shard(x: torch.Tensor, nd: int, k: int) -> torch.Tensor:
    """Slice ``k`` of ``nd`` along dim 0."""
    b = x.shape[0] // nd
    return x[k * b:(k + 1) * b]


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev, non_blocking=True).contiguous()


def sharded_align(mesh: Mesh, qrp, tp, n, m, *, max_len: int, band: int,
                  steps: int = 0, packed16: bool = False) -> list:
    """NW and its walk with the batch dimension split over ``mesh``: slice
    ``k`` of ``(qrp, tp, n, m)`` moves to device ``k`` and runs the port's
    :func:`~racon_tpu_torch.ops.nw.align_chain` there (K4 with
    ``packed16``, else K1, then K2). The batch must be a multiple of the
    mesh size (callers pad). Returns one ``(ops_packed, score, fi, fj)``
    tuple per shard, on the shard's device; :func:`gather_shards`
    concatenates them in shard order, into what the single-device chain
    returns for the whole batch."""
    from ..ops.nw import align_chain
    nd = mesh_size(mesh)
    B = qrp.shape[0]
    if B % nd:
        raise ValueError(f"sharded_align: batch {B} is not a multiple of "
                         f"the mesh size {nd}")
    parts = []
    for k, dev in enumerate(mesh.devices):
        with on_device(dev):
            args = [_to(_shard(x, nd, k), dev) for x in (qrp, tp, n, m)]
            parts.append(align_chain(*args, max_len=max_len, band=band,
                                     steps=steps, packed16=packed16))
    return parts


def gather_shards(parts, device=None) -> tuple:
    """Per-shard output tuples concatenated in shard order along dim 0, on
    ``device`` (default: the first shard's)."""
    dev = parts[0][0].device if device is None else torch.device(device)
    return tuple(torch.cat([p[i].to(dev, non_blocking=True) for p in parts])
                 for i in range(len(parts[0])))


# ``dropped``'s place in the state: one row per shard (the other arrays
# stack one row per pair or per window)
_DROPPED = 9


def sharded_refine_loop(mesh: Mesh, static, state, ins_theta, del_beta, *,
                        rounds: int, n_windows_local: int, max_len: int,
                        band: int, Lb: int, K: int, steps: int = 0,
                        packed16: bool = False, Lq2: int = 0,
                        scores=(3, -5, -4), early_exit: bool = True,
                        idle=None):
    """A group's whole refinement loop over a co-sharded batch: shard
    ``k`` runs :func:`~racon_tpu_torch.ops.poa.refine_loop` (K4 or K1,
    then K3, each round) on device ``k``, and no step reads across shards.

    ``static`` = (n, qpw, win_of, real) with leading dim ``n_shards *
    B_local``; ``win_of`` holds **shard-local** window ordinals. ``state``
    = (bg, ed, bcodes, bweights, blen, covs, ever, frozen, conv, dropped):
    pair rows stack like ``static``, window rows have leading dim
    ``n_shards * n_windows_local``, and ``dropped`` is one ``[n_shards, 4 +
    n_windows_local]`` telemetry row per shard (rejected alignments,
    sweep-truncated spans, insertion-fold overflows, executed wavefront
    steps, then the overflows per shard-local window row). The pairs of a
    window must live in that window's shard (:func:`partition_balanced`
    and per-shard packing make it so). ``idle``, an int64 scalar, gains
    every shard's rounds run after its windows settled. Returns the
    updated ``state`` stacked the same way, on the device of the input
    ``state``."""
    from ..ops.poa import refine_loop
    nd = mesh_size(mesh)
    home = state[0].device
    outs, idles = [], []
    for k, dev in enumerate(mesh.devices):
        with on_device(dev):
            sh_static = [_to(_shard(x, nd, k), dev) for x in static]
            sh_state = [_to(x[k:k + 1], dev) if i == _DROPPED
                        else _to(_shard(x, nd, k), dev)
                        for i, x in enumerate(state)]
            sh_idle = (None if idle is None else
                       torch.zeros((), dtype=torch.int64, device=dev))
            outs.append(refine_loop(
                *sh_static, *sh_state, ins_theta, del_beta, rounds=rounds,
                early_exit=early_exit, idle=sh_idle,
                n_windows=n_windows_local, max_len=max_len, band=band,
                Lb=Lb, K=K, steps=steps, packed16=packed16, Lq2=Lq2,
                scores=scores))
            idles.append(sh_idle)
    if idle is not None:
        for sh_idle in idles:
            idle += sh_idle.to(home, non_blocking=True)
    return tuple(torch.cat([o[i].to(home, non_blocking=True) for o in outs])
                 for i in range(len(state)))
