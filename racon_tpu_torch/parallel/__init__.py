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
  ``src/cuda/cudapolisher.cpp:98-118``);
- :func:`distributed_init`, :func:`is_multihost`, :func:`to_global`,
  :func:`fetch_global`: meshes over several processes.

Several processes (``racon_tpu/parallel/__init__.py:52-103``): after
:func:`distributed_init` the processes form one ``torch.distributed``
group over gloo, and :func:`get_mesh` builds one global mesh, every
process's devices in rank order (as ``jax.devices()`` orders them). Every
process does the same deterministic host work (parsing, filtering,
packing every chunk and group) and launches only the shards of the slots
it owns (:meth:`Mesh.addressable`); the shards' outputs are copied to the
host and all-gathered (:func:`fetch_global`), so every process decodes,
stitches and writes the whole polished FASTA. The exchange runs on the
host: gloo takes any number of ranks on one card, where NCCL refuses two.
Every process must reach the collectives in the same order, so none sits
on a path that only some processes take.
"""

from __future__ import annotations

import contextlib
import datetime
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS = "d"

# a collective that waits longer than this raises in every rank still
# waiting: a rank that failed surfaces as an error, not a hang
GROUP_TIMEOUT_S = 120

def distributed_init(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """Join a group of ``num_processes`` processes as rank ``process_id``
    (idempotent: a process already in a group keeps it): after this,
    :func:`get_mesh` builds one mesh over every process's devices. The
    group is gloo's over TCP at ``coordinator_address`` (``host:port``,
    served by rank 0), with a :data:`GROUP_TIMEOUT_S` timeout on every
    collective."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _group_ready() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def is_multihost() -> bool:
    """True in a process group of more than one process."""
    import torch.distributed as dist
    return _group_ready() and dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    import torch.distributed as dist
    return dist.get_rank() if _group_ready() else 0


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: a frozen tuple of ``torch.device`` along the
    axis ``"d"``, and the rank of the process that owns each slot
    (``owners``; default: the calling process owns them all). A device may
    appear more than once; all devices are of one type."""

    devices: Tuple[torch.device, ...]
    owners: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in devs})
        if len(kinds) > 1:
            raise ValueError(f"mesh devices are of different types "
                             f"({', '.join(kinds)})")
        owners = ((process_index(),) * len(devs) if self.owners is None
                  else tuple(int(r) for r in self.owners))
        if len(owners) != len(devs):
            raise ValueError(f"{len(owners)} owners for {len(devs)} mesh "
                             f"slots")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "owners", owners)

    axis_names = (AXIS,)

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    def addressable(self) -> List[Tuple[int, torch.device]]:
        """``(slot, device)`` of every slot the calling process owns, in
        slot order."""
        me = process_index()
        return [(k, d) for k, (d, r) in enumerate(zip(self.devices,
                                                      self.owners))
                if r == me]

    @property
    def home(self) -> torch.device:
        """The calling process's first device of the mesh: its engines'
        uploads land there and a one-process mesh's merges come back
        there."""
        mine = self.addressable()
        return mine[0][1] if mine else self.devices[0]


def get_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh named ``d`` over ``n_devices`` (default: all) of
    ``devices`` (default: every local device). In a process group
    ``devices`` are this process's: every process's lists are exchanged
    and the mesh holds them all, rank after rank, ``n_devices`` counting
    the whole (a collective: every process calls it alike)."""
    if devices is None:
        from .topology import local_devices
        devices = local_devices()
    devices = [torch.device(d) for d in devices]
    owners = None
    if is_multihost():
        import torch.distributed as dist
        lists: list = [None] * dist.get_world_size()
        dist.all_gather_object(lists, [str(d) for d in devices])
        devices = [torch.device(d) for lst in lists for d in lst]
        owners = tuple(r for r, lst in enumerate(lists) for _ in lst)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} visible")
        devices = devices[:n_devices]
        if owners is not None:
            owners = owners[:n_devices]
            # fetch_global learns a shard's shape from the rank's own
            if len(set(owners)) != len(lists):
                raise ValueError("every process of the group needs a slot "
                                 "of the mesh")
    return Mesh(tuple(devices), owners)


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


def to_global(mesh: Optional[Mesh], arr, device=None) -> torch.Tensor:
    """The whole of an array every process computed alike (a numpy array
    or a tensor), placed for ``mesh``'s sharded functions: on ``device``
    (default: the mesh's home device) with one process or no mesh,
    through pinned memory to a card; in a process group kept on the host
    (pinned where the mesh's devices are cards), so each process's shards
    go from its host straight to its own cards and no process moves
    another's shard."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    if mesh is not None and is_multihost():
        on_card = mesh.home.type == "cuda"
        return t.pin_memory() if on_card and not t.is_pinned() else t
    dev = mesh.home if device is None else torch.device(device)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def fetch_global(tree, mesh: Optional[Mesh] = None) -> list:
    """Sharded results as host numpy arrays, one for each entry of
    ``tree``. With one process each entry is a whole array (a tensor on
    any device). In a process group each entry holds this process's
    shards only, its addressable slots' stacked along dim 0 in slot order
    (every shard of one entry has one shape in every process): they are
    copied to the host and all-gathered over gloo, one collective for the
    whole tree, and come back whole, in global slot order, in every
    process (``racon_tpu.parallel.fetch_global``). Each collective is
    counted in the metrics ``parallel.gather_calls``,
    ``parallel.gather_bytes`` (what it brought to this process) and
    ``parallel.gather_s``."""
    if not is_multihost():
        return [_host(t) for t in tree]
    if mesh is None:
        raise ValueError("fetch_global in a process group needs the mesh")
    import torch.distributed as dist

    from ..obs import metrics
    t0 = time.perf_counter()
    world = dist.get_world_size()
    mine = [k for k, _ in mesh.addressable()]
    slots = [[k for k, r in enumerate(mesh.owners) if r == rank]
             for rank in range(world)]
    width = max(len(s) for s in slots)
    local = [np.ascontiguousarray(_host(t)) for t in tree]
    # one row of bytes a shard: each entry's shard after the other
    shard_shapes = [(a.shape[0] // len(mine),) + a.shape[1:] for a in local]
    rows = np.concatenate(
        [a.reshape(len(mine), -1).view(np.uint8).reshape(len(mine), -1)
         for a in local], axis=1)
    send = np.zeros((width, rows.shape[1]), np.uint8)
    send[:len(mine)] = rows
    send_t = torch.from_numpy(send)
    recv = [torch.empty_like(send_t) for _ in range(world)]
    dist.all_gather(recv, send_t)
    whole = np.empty((len(mesh.owners), rows.shape[1]), np.uint8)
    for rank, got in enumerate(recv):
        whole[slots[rank]] = got.numpy()[:len(slots[rank])]
    out, col = [], 0
    for a, shp in zip(local, shard_shapes):
        nb = int(np.prod(shp, dtype=np.int64)) * a.dtype.itemsize
        part = np.ascontiguousarray(whole[:, col:col + nb]).view(a.dtype)
        out.append(part.reshape((len(mesh.owners) * shp[0],) + shp[1:]))
        col += nb
    metrics.inc("parallel.gather_calls")
    metrics.inc("parallel.gather_bytes", world * send.nbytes)
    metrics.add_time("parallel.gather_s", time.perf_counter() - t0)
    return out


def sharded_align(mesh: Mesh, qrp, tp, n, m, *, max_len: int, band: int,
                  steps: int = 0, packed16: bool = False) -> list:
    """NW and its walk with the batch dimension split over ``mesh``: slice
    ``k`` of ``(qrp, tp, n, m)`` moves to device ``k`` and runs the port's
    :func:`~racon_tpu_torch.ops.nw.align_chain` there (K4 with
    ``packed16``, else K1, then K2). ``qrp`` and ``tp`` are the rows, or
    the flat byte blocks of :func:`~racon_tpu_torch.ops.nw.build_rows`
    (pair ``k`` at ``k * max_len``): then each shard builds its rows on
    its own device (rows are pair-local, so the shards' rows are the whole
    batch's slices). The batch must be a multiple of the mesh
    size (callers pad). Returns one ``(ops_packed, score, fi, fj)`` tuple
    a slot, on the slot's device, and ``None`` for a slot another process
    owns; :func:`gather_shards` merges them in slot order into what the
    single-device chain returns for the whole batch."""
    from ..ops.nw import align_chain, build_rows
    nd = mesh_size(mesh)
    B = n.shape[0]
    if B % nd:
        raise ValueError(f"sharded_align: batch {B} is not a multiple of "
                         f"the mesh size {nd}")
    parts: list = [None] * nd
    for k, dev in mesh.addressable():
        with on_device(dev):
            q, t, nk, mk = [_to(_shard(x, nd, k), dev)
                            for x in (qrp, tp, n, m)]
            if q.dim() == 1:   # the byte blocks
                q, t = build_rows(q, t, nk, mk, max_len=max_len, band=band)
            parts[k] = align_chain(q, t, nk, mk, max_len=max_len,
                                   band=band, steps=steps,
                                   packed16=packed16)
    return parts


def _host_stacks(parts) -> list:
    """This process's slots' output tuples, each entry's concatenated on
    the host in slot order (:func:`fetch_global`'s input)."""
    return [torch.cat([p[i].cpu() for p in parts])
            for i in range(len(parts[0]))]


def gather_shards(parts, device=None, mesh: Optional[Mesh] = None) -> tuple:
    """Per-slot output tuples concatenated in slot order along dim 0, on
    ``device`` (default: the first shard's). In a process group (with
    ``mesh``) the slots of the other processes are ``None`` here: the
    merge is :func:`fetch_global`'s, and the tuple comes back on the
    host."""
    if mesh is not None and is_multihost():
        local = _host_stacks([p for p in parts if p is not None])
        return tuple(torch.from_numpy(a) for a in fetch_global(local, mesh))
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
    ``state``. In a process group each process runs its own slots and the
    shards are merged by :func:`fetch_global` (``idle`` summed over every
    slot), so every process returns the whole state."""
    from ..ops.poa import refine_loop
    nd = mesh_size(mesh)
    home = state[0].device
    outs, idles = [], []
    for k, dev in mesh.addressable():
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
    if is_multihost():
        local = _host_stacks(outs)
        if idle is not None:
            local.append(torch.stack([t.cpu() for t in idles]))
        whole = fetch_global(local, mesh)
        if idle is not None:
            idle += int(whole.pop().sum())
        return tuple(torch.from_numpy(a).to(home) for a in whole)
    if idle is not None:
        for sh_idle in idles:
            idle += sh_idle.to(home, non_blocking=True)
    return tuple(torch.cat([o[i].to(home, non_blocking=True) for o in outs])
                 for i in range(len(state)))
