"""The port's NW kernels: banded wavefront forward pass, traceback walk and
fused walk + vote emission (counterpart of ``racon_tpu/ops/pallas_nw.py``).

Each public function has two bodies:

- a CUDA kernel (``kernels/*.cu``, built by :mod:`._build`) that runs when
  the inputs lie on a CUDA device. It launches or raises; it never falls
  back;
- a plain PyTorch version in this module (``*_plain``) that runs when the
  inputs lie on the CPU, and that ``chip_smoke.py`` holds each kernel
  against on the card.

Layouts are the JAX package's, bit for bit:

- direction matrix ``[B, S, band/8]`` uint8, planar 2-bit codes (lane ``u``
  in byte ``u % RB`` at shift ``2 * (u // RB)``; 0 = M, 1 = I, 2 = D). Rows
  at or past a pair's own ``n + m`` are undefined: no walk reads them;
- walk ops packed 2 bits x 4 per byte in sequential walk order (code 3 after
  the walk ends), as ``racon_tpu.ops.nw._traceback_kernel`` emits them;
- vote stream ``idx`` int32 / ``w`` uint8 ``[B, S]`` as
  ``racon_tpu.ops.poa._vote_from_ops`` emits it.

``LAUNCHES`` counts kernel launches per kernel (plain calls do not count).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build

BIG32 = 1 << 28
# int16 saturation of the packed forward pass (racon_tpu/ops/swar.py BIG16)
BIG16 = 0x4800

# kernel name -> (CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "nw_fwd_i32": ("racon_tpu_torch/ops/kernels/nw_fwd.cu",
                   "racon_tpu/ops/pallas_nw.py:117"),
    "nw_fwd_i16x2": ("racon_tpu_torch/ops/kernels/nw_fwd.cu",
                     "racon_tpu/ops/pallas_nw.py:307"),
    "walk_ops": ("racon_tpu_torch/ops/kernels/walk_ops.cu",
                 "racon_tpu/ops/pallas_nw.py:643"),
    "walk_vote": ("racon_tpu_torch/ops/kernels/walk_vote.cu",
                  "racon_tpu/ops/pallas_nw.py:973"),
    # the overlapper's chain DP (wrapper ops/chain.py chain_dp); it
    # replaces an XLA scan, not a Pallas kernel
    "chain_dp": ("racon_tpu_torch/ops/kernels/chain_dp.cu",
                 "racon_tpu/ops/chain.py:129"),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    BODY_LAUNCHES.clear()


def _check_launch(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t "
                           f"{err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev, f"{name}: tensors on different devices")
        _require(t.is_contiguous(), f"{name}: inputs must be contiguous")


# ------------------------------------------------------------ forward pass

# K1 body -> its C entry
FWD_I32_ENTRIES = {"warp": "rt_nw_fwd_i32_warp", "wide": "rt_nw_fwd_i32_wide",
                   "block": "rt_nw_fwd_i32"}
# the bands rt_nw_fwd_i32_wide instantiates (band / 1024 warps a pair). At
# band 2048 the wide body measured slower than the block body on an NVIDIA
# H100 80GB HBM3 at 700.00 W (2.93 vs 2.69 ms at the aligner's (8192, 2048)
# chunk of 128 pairs, chip_smoke.py), so that band keeps the block body.
WIDE_BANDS = (1024, 4096, 8192)


def fwd_i32_body(band: int) -> str:
    """Which body of the int32 forward kernel (K1) a launch at ``band``
    runs: ``"warp"`` (one warp per pair, ``nw_fwd_i32_warp_kernel``) for
    the bands 128..512 that are multiples of 64, ``"wide"`` (one pair per
    block of ``band / 1024`` warps, ``nw_fwd_i32_wide_kernel``) for
    ``WIDE_BANDS``, ``"block"`` (one block per pair,
    ``nw_fwd_i32_kernel``) for every other band."""
    if band % 64 == 0 and 128 <= band <= 512:
        return "warp"
    if band in WIDE_BANDS:
        return "wide"
    return "block"


# K4 body -> its C entry
FWD_I16X2_ENTRIES = {"wide": "rt_nw_fwd_i16x2_wide",
                     "block": "rt_nw_fwd_i16x2"}
# band -> the bytes a thread owns (BPT) of each nw_fwd_i16x2_wide_kernel
# rt_nw_fwd_i16x2_wide instantiates (band / (256 * BPT) warps a pair)
I16X2_WIDE_BPTS = {512: (2,), 1024: (2, 4), 1536: (2,), 2048: (2, 4, 8),
                   3072: (4,), 4096: (2, 4, 8), 8192: (4, 8)}
# band -> the BPT a launch of B pairs runs: ((most pairs, BPT), ...,
# (None, BPT)), the first entry whose most pairs is at least B. A launch of
# about one pair an SM is latency-bound and runs fastest with the most warps
# a pair (the smaller BPT); a launch that fills the card is issue-bound and
# runs fastest with the most words a thread. chip_smoke.py kernels phase,
# one run on an NVIDIA H100 80GB HBM3 at 700.00 W, ms per launch by BPT
# 2 / 4 / 8 at the consensus groups of 1024-4096 bp windows and their
# prefixes of 132-8448 pairs, and at the aligner's chunks:
# - 1024: 0.431 / 0.565 at 132 pairs, 0.550 / 0.567 at 528, 1.764 / 1.379
#   at 2112, 24.518 / 18.522 at 32768; aligner (4096, 1024) B=512 1.878 /
#   1.992;
# - 2048: 0.911 / 0.978 / 1.561 at 132, 1.918 / 1.472 / 1.571 at 528,
#   6.691 / 4.952 / 4.774 at 2112, 48.938 / 35.646 / 34.364 at 16384;
#   aligner (8192, 2048) B=128 1.588 / 1.785 / 2.822;
# - 4096: 2.263 / 1.980 / 2.878 at 132, 6.856 / 5.211 / 4.936 at 528,
#   25.522 / 18.963 / 19.115 at 2112, 49.145 / 36.386 / 33.794 at 4096;
#   aligner (16384, 4096) B=2048 41.975 / 31.302 / 31.159;
# - 8192: aligner (16384, 8192) B=512 BPT 4 / 8 19.168 / 17.562.
# The band ladder's rungs 1536 and 3072 (NW = 3), on another run of the same
# card and limit: 1536 (8192, 1536) B=8 BPT 2 1.386 (block body 2.447);
# 3072 (16384, 3072) B=1024 BPT 4 15.737, its first 528 and 132 pairs
# 8.309 and 3.788 (BPT 2 at NW = 6: 19.488, 10.631 and 4.314, slower at
# every size, so it is not instantiated; block body 45.003).
# Each limit sits between the two measured launch sizes either side of it.
I16X2_WIDE_BPT = {512: ((None, 2),),
                  1024: ((1024, 2), (None, 4)),
                  1536: ((None, 2),),
                  2048: ((256, 2), (1024, 4), (None, 8)),
                  3072: ((None, 4),),
                  4096: ((256, 4), (None, 8)),
                  8192: ((None, 8),)}


def fwd_i16x2_body(band: int, B: int) -> Tuple[str, Optional[int]]:
    """Which body of the int16x2 forward kernel (K4) a launch of ``B``
    pairs at ``band`` runs: ``("wide", BPT)`` (one pair per block of
    ``band / (256 * BPT)`` warps, ``nw_fwd_i16x2_wide_kernel``) at the
    bands of ``I16X2_WIDE_BPT``, with the BPT it gives ``B`` pairs,
    ``("block", None)`` (one block per pair, ``nw_fwd_i16x2_kernel``) at
    every other band."""
    for most, bpt in I16X2_WIDE_BPT.get(band, ()):
        if most is None or B <= most:
            return "wide", bpt
    return "block", None


def nw_fwd(qrp: torch.Tensor, tp: torch.Tensor, n: torch.Tensor,
           m: torch.Tensor, *, max_len: int, band: int, steps: int = 0,
           packed16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded NW forward pass over ``B`` pairs: ``qrp``/``tp`` uint8
    ``[B, band/2 + max_len + band]`` (reversed query ending at column
    ``band/2 + max_len``, target at ``band/2``), ``n``/``m`` int32 ``[B]``.
    Returns ``(dirs [B, S, band/8] uint8, score [B] int32)`` with
    ``S = steps or 2 * max_len``; a pair with ``n + m > S`` keeps score
    ``1 << 28``. ``packed16`` selects the int16x2 kernel (K4) over the
    int32 one (K1); callers choose it with ``swar.use_packed16``. K1 runs
    the body :func:`fwd_i32_body` names for ``band``, K4 the one
    :func:`fwd_i16x2_body` names."""
    B, width = qrp.shape
    U = band // 2
    S = steps or 2 * max_len
    _require(band % 8 == 0 and U >= 4, f"band {band} must be a multiple "
             f"of 8")
    _require(tp.shape == qrp.shape and width >= U, "row shapes mismatch")
    _require(qrp.dtype == torch.uint8 and tp.dtype == torch.uint8,
             "rows must be uint8")
    _require(n.dtype == torch.int32 and m.dtype == torch.int32,
             "lengths must be int32")
    if qrp.device.type != "cuda":
        return nw_fwd_plain(qrp, tp, n, m, max_len=max_len, band=band,
                            steps=S, packed16=packed16)
    _check_cuda_inputs("nw_fwd", qrp, tp, n, m)
    if packed16:
        body, bpt = fwd_i16x2_body(band, B)
        entry = FWD_I16X2_ENTRIES[body]
    else:
        body, bpt = fwd_i32_body(band), None
        entry = FWD_I32_ENTRIES[body]
    return _launch_fwd(entry, qrp, tp, n, m, max_len=max_len, band=band,
                       steps=S, bpt=bpt)


# forward-pass C entry -> the kernel it counts under
FWD_KERNEL_OF = {**{e: "nw_fwd_i32" for e in FWD_I32_ENTRIES.values()},
                 **{e: "nw_fwd_i16x2" for e in FWD_I16X2_ENTRIES.values()}}
# launches per forward body, "<C entry>" or "<C entry>:<BPT>" (plain calls do
# not count), so a run shows which body each launch took
BODY_LAUNCHES: Dict[str, int] = {}


def _launch_fwd(entry: str, qrp, tp, n, m, *, max_len: int, band: int,
                steps: int, bpt: Optional[int] = None):
    """One launch of the forward-pass C function ``entry`` on checked CUDA
    inputs (``bpt`` for ``rt_nw_fwd_i16x2_wide``); counts it under its
    kernel (``nw_fwd_i16x2`` or ``nw_fwd_i32``, whichever body) and its
    body. The block bodies take one thread a direction byte, so at most
    1024 (band 8192)."""
    B, width = qrp.shape
    if entry in (FWD_I32_ENTRIES["block"], FWD_I16X2_ENTRIES["block"]):
        _require(band // 8 <= 1024,
                 f"band {band} exceeds 1024 threads per block")
    dirs = torch.empty((B, steps, band // 8), dtype=torch.uint8,
                       device=qrp.device)
    score = torch.empty((B,), dtype=torch.int32, device=qrp.device)
    name = FWD_KERNEL_OF[entry]
    fn = _build.function(entry)
    head = (qrp.data_ptr(), tp.data_ptr(), n.data_ptr(), m.data_ptr(),
            dirs.data_ptr(), score.data_ptr(), B, max_len, band)
    if entry == FWD_I16X2_ENTRIES["wide"]:
        err = fn(*head, bpt, width, steps, _stream(qrp))
        key = f"{entry}:{bpt}"
    else:
        err = fn(*head, width, steps, _stream(qrp))
        key = entry
    LAUNCHES[name] += 1
    BODY_LAUNCHES[key] = BODY_LAUNCHES.get(key, 0) + 1
    _check_launch(name, err)
    return dirs, score


def nw_fwd_plain(qrp, tp, n, m, *, max_len: int, band: int,
                 steps: int = 0, packed16: bool = False):
    """Plain PyTorch version of :func:`nw_fwd` (the XLA twin
    ``racon_tpu.ops.nw._nw_wavefront_kernel`` written out in torch).
    Pairs are sorted by ``n + m`` once, so wavefront ``a`` only touches
    the pairs still sweeping; rows past a pair's ``n + m`` stay 0."""
    B, width = qrp.shape
    dev = qrp.device
    c = band // 2
    U = c
    RB = U // 4
    L = max_len
    S = steps or 2 * L
    big = BIG16 if packed16 else BIG32
    i32 = torch.int32
    # the packed pass's values stay below 2^15: int16 lanes, like K4
    vdt = torch.int16 if packed16 else i32
    nm_all = n.to(i32) + m.to(i32)
    dirs = torch.zeros((B, S, RB), dtype=torch.uint8, device=dev)
    score = torch.where(nm_all == 0, 0, big).to(i32)
    order = torch.argsort(torch.clamp(nm_all, max=S), descending=True,
                          stable=True)
    nm_s = torch.clamp(nm_all[order], max=S)
    last = int(nm_s[0]) if B else 0
    # live[a] = pairs whose sweep reaches wavefront a (a prefix of order)
    live = (B - torch.searchsorted(
        nm_s.flip(0).contiguous(),
        torch.arange(last + 1, dtype=i32, device=dev))).tolist()
    qrp = qrp[order]
    tp = tp[order]
    n = n.to(vdt)[order]
    m = m.to(vdt)[order]
    nm = nm_all[order]
    sc = score[order]
    dsort = torch.zeros((B, S, RB), dtype=torch.uint8, device=dev)
    us = torch.arange(U, dtype=vdt, device=dev)
    # rotating wavefront buffers with one BIG lane of padding at each end,
    # so the +-1 lane shifts are plain slices
    bufs = [torch.full((B, U + 2), big, dtype=vdt, device=dev)
            for _ in range(3)]
    p0 = c & 1
    bufs[0][:, 1 + (c - p0) // 2] = 0      # wavefront 0: only (0, 0)
    v1, v2, vb = bufs
    for a in range(1, last + 1):
        k = live[a]
        p = (a + c) & 1
        I0 = (a + c - p) // 2
        J0 = (a - c + p) // 2
        qs = min(max(c + L - I0, 0), width - U)
        ts = min(max(c + J0 - 1, 0), width - U)
        nk, mk = n[:k], m[:k]
        sub = qrp[:k, qs:qs + U] != tp[:k, ts:ts + U]
        cd = v2[:k, 1:U + 1] + sub              # diagonal (i-1, j-1)
        if p == 0:
            ci = v1[:k, 1:U + 1] + 1            # consume query (i-1, j)
            cdel = v1[:k, 0:U] + 1              # consume target (i, j-1)
        else:
            ci = v1[:k, 2:U + 2] + 1
            cdel = v1[:k, 1:U + 1] + 1
        best = torch.minimum(cd, torch.minimum(ci, cdel))
        d = torch.where(cd == best, 0, 2 - (ci == best).to(vdt))
        # interior lanes: 1 <= i <= n and 1 <= j <= m, one lane range
        lo = torch.clamp(I0 - nk, min=max(1 - J0, 0))
        hi = torch.clamp(mk - J0, max=I0 - 1)
        interior = (us >= lo[:, None]) & (us <= hi[:, None])
        v = torch.where(interior, torch.clamp(best, max=big), big)
        if a <= c:   # DP boundary rows/columns only exist here
            i_vec = (I0 - us)[None, :]
            j_vec = (J0 + us)[None, :]
            v = torch.where((i_vec == 0) & (j_vec >= 0)
                            & (j_vec <= mk[:, None]), j_vec, v)
            v = torch.where((j_vec == 0) & (i_vec >= 1)
                            & (i_vec <= nk[:, None]), i_vec, v)
        u_fin = torch.clamp((mk - nk + c - p) // 2, 0, U - 1)
        fin = v.gather(1, u_fin[:, None].long())[:, 0].to(i32)
        sc[:k] = torch.where(nm[:k] == a, fin, sc[:k])
        dsort[:k, a - 1] = (d[:, :RB] | (d[:, RB:2 * RB] << 2)
                            | (d[:, 2 * RB:3 * RB] << 4)
                            | (d[:, 3 * RB:] << 6)).to(torch.uint8)
        vb[:k, 1:U + 1] = v
        v2, v1, vb = v1, vb, v2
    dirs[order] = dsort
    score[order] = sc
    if packed16:
        score = torch.where(score == BIG16, BIG32, score).to(i32)
    return dirs, score


# ------------------------------------------------------------------- walks

# K2's lane decode (kernels/walk_common.cuh walk_locate) divides by band / 8
# with a multiply-high that is exact below this band
WALK_MAX_BAND = 1 << 17

# K2 body -> its C entry
WALK_OPS_ENTRIES = {"warp": "rt_walk_ops", "thread": "rt_walk_ops_thread"}
# the most pairs a K2 launch walks with the warp body (one warp a pair);
# larger launches take the thread body (one thread a pair). Measured with
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, the thread body
# wins from 8192 pairs on at the aligner's bands 384 and 1024 (and the
# consensus band 512) and from 4096 on at band 128, the warp body below
WALK_WARP_MAX_PAIRS = 6144
WALK_WARP_MAX_PAIRS_BAND128 = 3072


def walk_ops_body(B: int, band: int) -> str:
    """Which body of the traceback walk (K2) a launch of ``B`` pairs at
    ``band`` runs: ``"warp"`` (``walk_ops_kernel``, one warp a pair, staged
    windows) up to ``WALK_WARP_MAX_PAIRS`` pairs (at band 128 and below
    ``WALK_WARP_MAX_PAIRS_BAND128``), ``"thread"``
    (``walk_ops_thread_kernel``, one thread a pair) above."""
    top = (WALK_WARP_MAX_PAIRS_BAND128 if band <= 128
           else WALK_WARP_MAX_PAIRS)
    return "warp" if B <= top else "thread"


def walk_ops(dirs: torch.Tensor, n: torch.Tensor, m: torch.Tensor, *,
             band: int):
    """Traceback from ``(n, m)`` over the direction matrix. Returns
    ``(ops_packed [B, S/4] uint8, fi [B] int32, fj [B] int32)`` — the
    output of ``racon_tpu.ops.nw._traceback_kernel``. K2 runs the body
    :func:`walk_ops_body` names for ``B`` and ``band``."""
    B, S, RB = dirs.shape
    _require(RB == band // 8, "dirs width does not match the band")
    _require(8 <= band < WALK_MAX_BAND, f"band {band} out of range")
    _require(S % 4 == 0, f"steps {S} must be a multiple of 4")
    _require(dirs.dtype == torch.uint8, "dirs must be uint8")
    _require(n.dtype == torch.int32 and m.dtype == torch.int32,
             "lengths must be int32")
    if dirs.device.type != "cuda":
        ops, fi, fj = walk_plain(dirs, n, m, band=band)
        return pack_ops(ops), fi, fj
    _check_cuda_inputs("walk_ops", dirs, n, m)
    return _launch_walk(WALK_OPS_ENTRIES[walk_ops_body(B, band)], dirs, n,
                        m, band=band)


def _launch_walk(entry: str, dirs, n, m, *, band: int):
    """One launch of the K2 C function ``entry`` on checked CUDA inputs,
    counted under ``walk_ops`` whichever body it runs."""
    B, S, _ = dirs.shape
    _require(dirs.data_ptr() % 16 == 0,
             "dirs must start on a 16 B boundary (K2 stages rows with 16 B "
             "copies)")
    dev = dirs.device
    ops = torch.empty((B, S // 4), dtype=torch.uint8, device=dev)
    fi = torch.empty((B,), dtype=torch.int32, device=dev)
    fj = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _build.function(entry)
    err = fn(dirs.data_ptr(), n.data_ptr(), m.data_ptr(), ops.data_ptr(),
             fi.data_ptr(), fj.data_ptr(), B, S, band, _stream(dirs))
    LAUNCHES["walk_ops"] += 1
    _check_launch("walk_ops", err)
    return ops, fi, fj


def walk_plain(dirs, n, m, *, band: int):
    """Plain PyTorch traceback (``racon_tpu.ops.nw._walk_ops_kernel``):
    unpacked ops ``[B, S]`` uint8 plus the final ``(fi, fj)``."""
    B, S, RB = dirs.shape
    dev = dirs.device
    c = band // 2
    U = c
    i64 = torch.int64
    flat = dirs.reshape(B, S * RB)
    i = n.to(i64).clone()
    j = m.to(i64).clone()
    ops = torch.full((B, S), 3, dtype=torch.uint8, device=dev)
    for t in range(S):
        a = i + j
        p = (a + c) & 1
        u = (j - i + c - p) // 2
        pos = torch.clamp((a - 1) * RB + u % RB, 0, S * RB - 1)
        byte = flat.gather(1, pos[:, None])[:, 0].to(i64)
        plane = torch.clamp(u // RB, 0, 3)
        d = (byte >> (2 * plane)) & 3
        d = torch.where(i == 0, 2, d)
        d = torch.where((j == 0) & (i > 0), 1, d)
        escaped = (i > 0) & (j > 0) & ((u < 0) | (u >= U))
        done = ((i == 0) & (j == 0)) | escaped
        op = torch.where(done, 3, d)
        ops[:, t] = op.to(torch.uint8)
        i = i - ((op == 0) | (op == 1)).to(i64)
        j = j - ((op == 0) | (op == 2)).to(i64)
        # every pair finished: the rest of the stream is code 3 already
        if t % 64 == 63 and bool(done.all()):
            break
    return ops, i.to(torch.int32), j.to(torch.int32)


def pack_ops(ops: torch.Tensor) -> torch.Tensor:
    """2-bit x 4-per-byte packing of an unpacked op stream."""
    B, S = ops.shape
    o4 = ops.reshape(B, S // 4, 4).to(torch.int32)
    return (o4[:, :, 0] | (o4[:, :, 1] << 2) | (o4[:, :, 2] << 4)
            | (o4[:, :, 3] << 6)).to(torch.uint8)


def unpack_ops(ops_packed: torch.Tensor) -> torch.Tensor:
    B, S4 = ops_packed.shape
    shifts = torch.arange(0, 8, 2, dtype=torch.int32,
                          device=ops_packed.device)
    return ((ops_packed.to(torch.int32)[:, :, None] >> shifts) & 3) \
        .reshape(B, S4 * 4).to(torch.uint8)


def walk_vote(dirs: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
              bg: torch.Tensor, qpw: torch.Tensor, *, band: int, L: int,
              K: int, CH: int, DEL: int):
    """Fused walk + vote emission. ``qpw`` carries the packed
    ``weight << 3 | code`` uint16 query lanes as int16 ``[B, Lq]``; ``bg``
    int32 ``[B]`` is each pair's backbone-span start. Returns ``(idx [B, S]
    int32, w [B, S] uint8, fi, fj)``: the stream of
    ``racon_tpu.ops.nw._walk_ops_kernel`` + ``racon_tpu.ops.poa.
    _vote_from_ops`` (weights above 255 would wrap, as in the Pallas
    kernel; phred weights stay <= 93)."""
    B, S, RB = dirs.shape
    _require(RB == band // 8, "dirs width does not match the band")
    _require(dirs.dtype == torch.uint8, "dirs must be uint8")
    _require(qpw.dtype == torch.int16 and qpw.shape[0] == B,
             "qpw must be int16 [B, Lq]")
    _require(all(x.dtype == torch.int32 for x in (n, m, bg)),
             "n, m, bg must be int32")
    if dirs.device.type != "cuda":
        ops, fi, fj = walk_plain(dirs, n, m, band=band)
        idx, w = vote_from_ops(ops, n, m, qpw, bg, L=L, K=K, CH=CH, DEL=DEL)
        return idx, w, fi, fj
    _check_cuda_inputs("walk_vote", dirs, n, m, bg, qpw)
    dev = dirs.device
    idx = torch.empty((B, S), dtype=torch.int32, device=dev)
    w = torch.empty((B, S), dtype=torch.uint8, device=dev)
    fi = torch.empty((B,), dtype=torch.int32, device=dev)
    fj = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _build.function("rt_walk_vote")
    err = fn(dirs.data_ptr(), n.data_ptr(), m.data_ptr(), bg.data_ptr(),
             qpw.data_ptr(), idx.data_ptr(), w.data_ptr(), fi.data_ptr(),
             fj.data_ptr(), B, S, band, qpw.shape[1], L, K, CH, DEL,
             _stream(dirs))
    LAUNCHES["walk_vote"] += 1
    _check_launch("walk_vote", err)
    return idx, w, fi, fj


def vote_from_ops(ops, n, m, qpw, bg, *, L: int, K: int, CH: int,
                  DEL: int):
    """Plain vote stream from walked ops (``racon_tpu.ops.poa.
    _vote_from_ops``): positions from prefix sums, insertion-run lengths
    from a prefix max, one gather for the packed base/weight lanes."""
    B, S = ops.shape
    dev = ops.device
    i64 = torch.int64
    Lq = qpw.shape[1]
    VOT = L * (1 + K) * CH
    o = ops.to(i64)
    is_M = o == 0
    is_I = o == 1
    is_D = o == 2
    di = (is_M | is_I).to(i64)
    dj = (is_M | is_D).to(i64)
    i_t = n.to(i64)[:, None] - torch.cumsum(di, 1) + di
    j_t = m.to(i64)[:, None] - torch.cumsum(dj, 1) + dj
    t_idx = torch.arange(S, dtype=i64, device=dev)[None, :].expand(B, S)
    last_ni = torch.cummax(torch.where(~is_I, t_idx, -1), dim=1).values
    last_ni_excl = torch.cat(
        [torch.full((B, 1), -1, dtype=i64, device=dev), last_ni[:, :-1]], 1)
    ins_run = t_idx - 1 - last_ni_excl
    slot = torch.clamp(ins_run, max=K - 1)
    qpos = torch.clamp(i_t - 1, 0, Lq - 1)
    pw = qpw.to(i64).gather(1, qpos) & 0xFFFF
    base = pw & 7
    wgt = pw >> 3
    col = bg.to(i64)[:, None] + j_t - 1
    idx = torch.where(is_M, col * CH + base,
                      torch.where(is_D, col * CH + DEL,
                                  (L + col * K + slot) * CH + base))
    valid = ((o < 3) & (j_t >= 1) & (col >= 0) & (col < L)
             & ~(is_I & (ins_run >= K)))
    idx = torch.where(valid, idx, VOT).to(torch.int32)
    w = torch.where(valid, wgt, 0).to(torch.uint8)
    return idx, w
