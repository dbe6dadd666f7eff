"""Which forward kernel a launch takes: the int16x2 overflow guard (copy of
``racon_tpu.ops.swar.swar_fits``) and the bands where the int32 kernel is
the faster of the two on the card.

The packed forward kernel (``nw_fwd_i16x2``) saturates scores at
``BIG16``; every real cell value of a ``max_len`` bucket is at most
``max_len`` (+1 per step of saturated-source slack), so the packed kernel
is byte-identical to the int32 one exactly where this guard holds. Both
kernels give the same bytes wherever the guard holds, so the choice
between them only moves time.
"""

from __future__ import annotations

BIG16 = 0x4800

# Bands at which the int32 kernel measured faster than the packed one on an
# NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py kernels phase, at the
# shapes the 1 Mbp main path launches): 8.81 vs 15.87 ms at band 512
# (consensus groups, the int32 kernel's one-warp-per-pair body), 57.1 vs
# 111.5 ms at 4096 and 38.4 vs 68.6 ms at 8192 (aligner chunks, its wide
# body). At band 2048 the packed kernel stays ahead (2.65 ms against the
# int32 block body's 2.69); there, and at the other bands, the engines
# keep the packed kernel, the JAX engines' choice. Band 1024, which the
# 1 Mbp run does not reach, measured 2.83 ms on the wide body against the
# packed kernel's 4.19 (the kernels phase's off-path shape); the engines
# still give it the packed kernel.
INT32_FASTER_BANDS = frozenset({512, 4096, 8192})


def swar_fits(max_len: int) -> bool:
    """True when every cell value a ``max_len`` bucket can produce stays
    strictly below the packed saturation ceiling."""
    return max_len + 2 < BIG16


def use_packed16(max_len: int, band: int) -> bool:
    """Whether a launch at ``(max_len, band)`` takes the int16x2 kernel."""
    return swar_fits(max_len) and band not in INT32_FASTER_BANDS
