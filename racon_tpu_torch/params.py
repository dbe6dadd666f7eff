"""The engines' calibrated parameters, and the refine-loop state carried
across from the JAX package.

This system has no weights. What plays their part is the consensus
engine's calibrated constants (``racon_tpu/ops/poa.py:92-146,1226-1306``)
and the aligner's bucket table (``racon_tpu/ops/nw.py:38-45``):
:class:`EngineParams` freezes them, :meth:`EngineParams.thresholds`
applies the ``-m/-g`` scale rule, and :func:`refine_state_to_torch` turns
a JAX refine-loop state (as numpy arrays) into the port's tensors so both
engines can run the same round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

DEFAULT_MATCH, DEFAULT_MISMATCH, DEFAULT_GAP = 3, -5, -4


@dataclasses.dataclass(frozen=True)
class EngineParams:
    rounds: int = 6             # refinement rounds per group
    max_depth: int = 200        # layers voting per window
    band: int = 512             # consensus alignment band (-b halves it)
    ins_theta: float = 0.25     # insertion emission threshold
    del_beta: float = 0.65      # column deletion threshold
    k_ins: int = 4              # insertion slots per backbone junction
    grow: int = 256             # backbone growth headroom (columns)
    ch: int = 8                 # vote channels: A C G T N DEL (+2 pad)
    # aligner (max query length, band) buckets
    buckets: Tuple[Tuple[int, int], ...] = (
        (256, 128), (1024, 384), (4096, 1024), (8192, 2048),
        (16384, 4096), (16384, 8192))

    def thresholds(self, match: int, gap: int) -> Tuple[float, float]:
        """(ins_theta, del_beta) under the CLI scores: the gap cost
        relative to the match reward scales both, identity at the
        defaults, capped at 0.95 and 2.5."""
        scale = ((max(abs(gap), 1) * DEFAULT_MATCH)
                 / (abs(DEFAULT_GAP) * max(match, 1)))
        return (min(self.ins_theta * scale, 0.95),
                min(self.del_beta * scale, 2.5))


PARAMS = EngineParams()

# refine-loop state: name -> port dtype
STATE_DTYPES: Dict[str, torch.dtype] = {
    "n": torch.int32, "qpw": torch.int16, "win_of": torch.int64,
    "real": torch.bool, "bg": torch.int32, "ed": torch.int32,
    "bcodes": torch.uint8, "bweights": torch.float32, "blen": torch.int32,
    "covs": torch.int32, "ever": torch.bool, "frozen": torch.bool,
    "conv": torch.bool, "dropped": torch.int64,
}
STATE_NAMES: Sequence[str] = tuple(STATE_DTYPES)


def refine_state_to_torch(state, device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX refine-loop state (a mapping of ``STATE_NAMES`` — ``n, qpw,
    win_of, real, bg, ed, bcodes, bweights, blen, covs, ever, frozen,
    conv, dropped`` — to numpy arrays) as the port's tensors on
    ``device``. The uint16 ``weight << 3 | code`` lanes become int16 with
    the same bits (their values stay below 2^15). To a card the arrays go
    through pinned memory, so the copies do not wait for the work already
    queued on the stream. An entry that is already a tensor on ``device``
    (the lanes the resident dataflow gathered there) is taken as it is:
    nothing is pinned or copied for it."""
    dev = torch.device(device)
    out = {}
    for name in STATE_NAMES:
        if isinstance(state[name], torch.Tensor):
            t = state[name]
            if t.device.type != dev.type or t.dtype != STATE_DTYPES[name]:
                raise ValueError(f"state {name!r}: a {t.dtype} tensor on "
                                 f"{t.device}, wanted "
                                 f"{STATE_DTYPES[name]} on {dev}")
            out[name] = t
            continue
        arr = np.asarray(state[name])
        if name == "qpw":
            arr = arr.astype(np.uint16).view(np.int16)
        out[name] = upload(arr, dev, STATE_DTYPES[name])
    return out


def upload(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device`` (as ``dtype`` when given).
    To a card it goes through pinned memory with a non-blocking copy, so
    it does not wait for the work already queued on the stream."""
    dev = torch.device(device)
    t = torch.as_tensor(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
