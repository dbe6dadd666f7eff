"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The ``torch.device`` an entry point runs on. ``cuda`` (the default
    everywhere) raises when there is no card: the port never continues on
    the CPU unless the caller asked for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions of the kernels")
    return dev
