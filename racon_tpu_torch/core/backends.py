"""Compute backends of the port's pipeline.

- ``cuda``: the device engines (:class:`~racon_tpu_torch.ops.nw.CudaAligner`,
  :class:`~racon_tpu_torch.ops.poa.CudaPoaConsensus`), each keeping the
  native host engine as the destination of the pairs and windows it
  rejects — the reference's accelerator contract;
- ``native``: the host C++ engines alone.

On a host with several cards an unpinned ``cuda`` pair runs over a mesh of
all of them (:func:`_auto_mesh`), as the JAX package's engines do over
every visible chip.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .. import native


class NativeAligner:
    """C++ global aligner over a thread pool."""

    def __init__(self, num_threads: int = 1):
        self.num_threads = num_threads

    def align_batch(self, pairs: Sequence[Tuple[bytes, bytes]]) -> List[str]:
        return native.nw_cigar_batch(list(pairs),
                                     num_threads=self.num_threads)


class NativePoaConsensus:
    """C++ POA engine threaded over windows (the reference's CPU path)."""

    def __init__(self, match: int, mismatch: int, gap: int,
                 num_threads: int = 1):
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.num_threads = num_threads

    def run(self, windows, trim: bool, progress=None) -> List[bool]:
        flags: List[bool] = []
        results = native.poa_consensus_batch(
            windows, trim, self.match, self.mismatch, self.gap,
            self.num_threads)
        for w, (consensus, polished, failed) in zip(windows, results):
            if failed:
                raise RuntimeError(
                    f"native POA failed on window {w.rank} of contig {w.id}")
            w.consensus = consensus
            flags.append(polished)
        if progress is not None:
            progress(len(windows), len(windows))
        return flags


def _auto_mesh(mesh, device):
    """The device mesh of a ``cuda`` engine pair: an explicit mesh wins;
    otherwise every local card is engaged when the engines' device is an
    unindexed ``cuda`` and more than one card is visible (the reference's
    ``-c N`` uses every visible GPU, ``src/cuda/cudapolisher.cpp:46,
    72-83``). An indexed device is a pin and never engages one; neither
    does the CPU, nor a machine with one card. In a process group
    (:func:`racon_tpu_torch.parallel.distributed_init`) the global mesh
    always engages, as the JAX package's does over ``jax.devices()``: this
    process contributes every local card for an unindexed ``cuda``, else
    the one device it was given."""
    if mesh is not None:
        return mesh
    import torch

    from ..parallel import get_mesh, is_multihost
    dev = torch.device(device)
    if is_multihost():
        return get_mesh() if dev.type == "cuda" and dev.index is None \
            else get_mesh(devices=[dev])
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return get_mesh()
    return None


def make_aligner(backend: str, num_threads: int, num_batches: int = 1,
                 device="cuda", mesh=None):
    """See :func:`_auto_mesh` for ``mesh``."""
    if backend == "native":
        return NativeAligner(num_threads)
    if backend == "cuda":
        from ..ops.nw import CudaAligner
        mesh = _auto_mesh(mesh, device)
        return CudaAligner(fallback=NativeAligner(num_threads),
                           num_batches=num_batches,
                           device=None if mesh is not None else device,
                           mesh=mesh)
    raise ValueError(f"unknown aligner backend {backend!r}")


def make_consensus(backend: str, match: int, mismatch: int, gap: int,
                   num_threads: int = 1, num_batches: int = 1,
                   banded: bool = False, device="cuda", mesh=None,
                   pinned: bool = False):
    """``pinned`` marks a chip worker's engine, whose groups never gather
    their lanes from a layer store's device pool (the device alone cannot
    say so: a pinned and an unpinned CPU engine share ``cpu``)."""
    if backend == "native":
        return NativePoaConsensus(match, mismatch, gap, num_threads)
    if backend == "cuda":
        from ..ops.poa import BAND, CudaPoaConsensus
        mesh = None if pinned else _auto_mesh(mesh, device)
        # -b halves the alignment band (the reference's banded-cudapoa
        # speed/accuracy trade)
        return CudaPoaConsensus(
            match, mismatch, gap,
            fallback=NativePoaConsensus(match, mismatch, gap, num_threads),
            band=BAND // 2 if banded else BAND, num_batches=num_batches,
            device=None if mesh is not None else device, mesh=mesh,
            pinned=pinned)
    raise ValueError(f"unknown consensus backend {backend!r}")
