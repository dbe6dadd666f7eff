"""Which forward kernel a launch takes: the int16x2 overflow guard (copy of
``racon_tpu.ops.swar.swar_fits``) and, per band, the faster of the two
kernels on the card; and the aligner's 2-bit upload: whether a chunk may
take it (:func:`swar_choice`) and its packing (:func:`pack_bases_2bit`).

The packed forward kernel (``nw_fwd_i16x2``) saturates scores at
``BIG16``; every real cell value of a ``max_len`` bucket is at most
``max_len`` (+1 per step of saturated-source slack), so the packed kernel
is byte-identical to the int32 one exactly where this guard holds. Both
kernels give the same bytes wherever the guard holds, so the choice
between them only moves time.
"""

from __future__ import annotations

import numpy as np

from .. import flags
from ..obs import metrics

BIG16 = 0x4800

# band -> the forward kernel the engines launch there: the one that
# measured faster, each kernel's body as ops/cuda_nw.py picks it for the
# launch. chip_smoke.py kernels phase, one run on an NVIDIA H100 80GB HBM3
# at 700.00 W, ms per launch, the winner first:
# - 128: K1 warp 2.847 vs K4 block 6.423 (aligner (256, 128), 65536 pairs);
# - 384: K1 warp 23.613 vs K4 block 52.437 (aligner (1024, 384), 65536);
# - 512: K4 wide 6.133 vs K1 warp 8.813 (consensus group, 32768 pairs;
#   0.206 vs 0.277 at its 32-pair group);
# - 1024: K4 wide 1.878 vs K1 wide 2.824 (aligner (4096, 1024), 512);
#   18.522 vs 32.107 (consensus group of 1024 bp windows, 32768);
# - 2048: K4 wide 1.588 vs K1 block 2.705 (aligner (8192, 2048), 128);
#   34.364 vs 120.495 (consensus, 2048 bp windows, 16384);
# - 4096: K4 wide 31.159 vs K1 wide 56.576 (aligner (16384, 4096), 2048);
#   33.794 vs 66.006 (consensus, 4096 bp windows, 4096);
# - 8192: K4 wide 17.562 vs K1 wide 38.397 (aligner (16384, 8192), 512).
# The band ladder's rungs (ops/nw.py BAND_RUNGS), another run of the same
# card and limit: on the 1 Mbp main path
# - 1536: K4 wide 1.386 vs K1 block 2.546 (aligner (8192, 1536), 8);
# - 3072: K4 wide 15.737 vs K1 block 42.378 (aligner (16384, 3072), 1024);
# and off it (chip_smoke.py RUNG_OFF_PATH, in a run at 8192 pairs; 2048
# at 768)
# - 64: K1 block 0.280 vs K4 block 0.303 (at 2048 pairs, another run:
#   0.121 vs 0.098; the order flips with the launch size);
# - 96: K1 block 0.492 vs K4 block 0.543;
# - 192: K1 warp 0.854 vs K4 block 1.471 (K1 block 1.346);
# - 256: K1 warp 1.435 vs K4 block 2.145 (K1 block 2.030);
# - 768: K1 block 5.618 vs K4 block 6.366.
FORWARD_KERNEL = {
    64: "nw_fwd_i32",
    96: "nw_fwd_i32",
    128: "nw_fwd_i32",
    192: "nw_fwd_i32",
    256: "nw_fwd_i32",
    384: "nw_fwd_i32",
    512: "nw_fwd_i16x2",
    768: "nw_fwd_i32",
    1024: "nw_fwd_i16x2",
    1536: "nw_fwd_i16x2",
    2048: "nw_fwd_i16x2",
    3072: "nw_fwd_i16x2",
    4096: "nw_fwd_i16x2",
    8192: "nw_fwd_i16x2",
}


def swar_fits(max_len: int) -> bool:
    """True when every cell value a ``max_len`` bucket can produce stays
    strictly below the packed saturation ceiling."""
    return max_len + 2 < BIG16


def use_packed16(max_len: int, band: int) -> bool:
    """Whether a launch at ``(max_len, band)`` takes the int16x2 kernel:
    where the guard holds and ``FORWARD_KERNEL`` names it (or does not
    list the band: the JAX engines' choice), unless ``RACON_TPU_SWAR=0``
    forces the int32 kernel."""
    if not flags.get_bool("RACON_TPU_SWAR"):
        return False  # the A/B switch: K1 everywhere
    return (swar_fits(max_len)
            and FORWARD_KERNEL.get(band, "nw_fwd_i16x2") == "nw_fwd_i16x2")


def swar_choice(max_len: int, stats: dict) -> bool:
    """Whether an aligner chunk of bucket ``max_len`` may upload 2-bit codes
    (``racon_tpu.ops.nw.TpuAligner._swar_choice`` without its availability
    probe, which the port does not have): the overflow guard, then
    ``RACON_TPU_SWAR``. A chunk the guard turns away is counted in
    ``stats["swar_guard_int32"]`` and the metric
    ``aligner.swar_guard_int32``, whatever the flag says, as in JAX. The
    upload form follows this choice and the chunk's alphabet; the forward
    kernel follows :func:`use_packed16`, which also weighs the band."""
    if not swar_fits(max_len):
        stats["swar_guard_int32"] += 1
        metrics.inc("aligner.swar_guard_int32")
        return False
    return flags.get_bool("RACON_TPU_SWAR")


def pack_bases_2bit(codes: np.ndarray) -> np.ndarray:
    """Four codes (each < 4) a byte, the first in the low bits; the length
    padded with code 0 to a multiple of 4 (``racon_tpu.ops.swar.
    pack_bases_2bit``, the same bytes). The aligner writes its blocks with
    ``native.pack_block`` in one pass from the reads; this is its numpy
    statement."""
    codes = np.asarray(codes, dtype=np.uint8)
    pad = (-len(codes)) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    c4 = codes.reshape(-1, 4)
    return (c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4)
            | (c4[:, 3] << 6)).astype(np.uint8)
