#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``racon_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments: ``python3
chip_smoke.py``. It needs one CUDA device, ``nvcc``, ``nvidia-smi`` and a
``g++`` that finds zlib's header, and it exits non-zero (printing no
result) when any of them is missing or any phase fails. Phases, one JSON
line each:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — every kernel built from ``racon_tpu_torch/ops/kernels``, one
             ``nvcc`` per source, all at once, and the native host library
             (``racon_tpu_torch/native``, linked with zlib);
3. ptxas   — registers, stack frame and spills of every kernel;
4. sass    — ``cuobjdump -sass`` of every kernel: its instruction count
             and its DPX (VIMNMX, VIMNMX3, VIADDMNMX), local-memory,
             barrier and shuffle instructions; fails unless K4's wide body
             runs VIMNMX;
5. main    — ``create_polisher(..., aligner="cuda", consensus="cuda")``
             polishes a simulated 1 Mbp genome at 30x ONT-like reads
             (seed 23): stage times, kernel launch counts (counted from
             zero just before the run; every kernel the engines route the
             run's launches to must be > 0) and launches per forward body,
             the shape of every launch, host-fallback counts, the aligner's
             band-ladder and occupancy counters (``ladder_narrow``,
             ``band_escalated``, ``lanes_occupied``/``lanes_total``) and the
             bytes it fetched from the card, the consensus stream's
             counters (each group's (Lq, band, pairs, B, steps, rounds,
             stage), stage ``A``, ``in_place``, ``B`` or ``full``; stage-B
             windows, lanes, the band, the rounds run after all of a
             group's windows had converged) and the pipeline's
             ``consensus_feed_s``/``consensus_finish_s``/
             ``pipeline_overlap_saved_s``, the draft's and the polished
             contig's edit distance to the truth, peak device memory, and
             the files the native parser read (``native_parse_calls``:
             the draft and the reads, then the overlaps; the polisher
             parses nothing another way);
6. main_auto — the same polish with ``--overlaps auto``:
             ``create_polisher(reads, "auto", draft, ...)`` on the same
             1 Mbp inputs, so the first-party overlapper (minimizer seeding
             and the seed join, plain PyTorch on the card; the chain DP,
             CUDA kernel ``chain_dp``) streams its rows into the aligner:
             stage times with ``overlap_feed_s``, the overlapper's counters
             (``chain.STATS``), the overlaps kept against the PAF path's,
             the launches of ``chain_dp``, K4, K2 and K3 (counted from zero
             just before the run; each must be > 0), the edit distance with
             the main phase's gate, peak device memory; it fails on a join
             bail-out (the 1 Mbp tables fit the device join) and unless the
             native parser read exactly the two sequence files;
   overlap — on a 0.2 Mbp genome (seed 23), ``chain.find_overlaps`` with
             its tensors on the card and on the CPU (the plain versions):
             every row array equal; then, on the card, the seconds of the
             overlapper's steps on the 1 Mbp inputs (``split_1mbp``);
7. parse   — the main path's inputs (draft, reads, PAF), plain and as
             gzip level 1 copies, parsed by the native parser
             (``io.parsers.parse_*``) and by the Python oracle
             (``_parse_*_py``): the records must be equal; each parse's
             seconds, and whether ``g++`` finds ``zlib.h`` (checked before
             any build); then the main path's ``Polisher._load`` twice
             with its split (targets, reads, overlaps, filter, transmute);
8. kernels — each kernel at every shape the main path or the main_auto
             path launched it at (every consensus (Lq, band) of either at
             its largest and smallest group, K4 and K3 at each, stage-B
             groups included, and the
             stream's 256 bp bucket, ``CONSENSUS_TAIL``, off the main path
             where the run did not launch it; each aligner (max_len,
             band) at the main path's largest chunk, and at main_auto's
             where that is larger or the bucket is main_auto's alone,
             band-ladder rungs included, on pairs drawn like the
             simulator's that the aligner seeds there), held
             bit-exact against its plain PyTorch version on the same card
             inputs (a prefix of the pairs where the plain version would
             take minutes), timed with CUDA events. Every forward body of
             both kernels runs at every forward shape: K1's body for the
             band (``variant``: ``warp`` at 128-512, ``wide`` at 1024, 4096
             and 8192, ``block`` elsewhere; where that is not the block
             body, its ``block`` body too), and K4's body for the band, its
             wide body
             at every other BPT the band instantiates (``bpt``,
             ``smem_bytes``) and its ``block`` body; each row carries its
             time over the other kernel's picked body (``over_nw_fwd_i16x2``
             / ``over_nw_fwd_i32``) and over its own block body
             (``over_block``); K4's wide body runs at every BPT again on
             prefixes of ``BPT_LADDER`` pairs (``pairs``,
             ``engines_pick``). Each K2 shape has a row for each body
             (``variant`` ``warp`` or ``thread``, the one
             ``cuda_nw.walk_ops_body`` picks for it first, with its time
             over the other's, ``over_thread`` or ``over_warp``). Off the
             main path: the forward kernels at (4096, 1024) with 512 pairs
             and at the consensus groups of 1024-4096 bp windows
             (``CONSENSUS_OFF_PATH``) (no walk row); K2 at the consensus group's shape (on the
             direction matrix K3 walks, held against the plain walk K3 is
             held against) and at the aligner buckets whose largest chunks
             take its thread body (``WALK_OFF_PATH``: each bucket's largest
             chunk and smaller launches on a prefix of its pairs; at the
             buckets of ``FWD_OFF_PATH``, (256, 128) and (1024, 384), every
             forward body too); every forward body and K2 at the band
             ladder's rungs the 1 Mbp run does not launch
             (``RUNG_OFF_PATH``: 64, 96, 192, 256, 768); K3 on
             ``VOTE_PAIRS`` pairs (a partial last warp) at the consensus
             geometry; ``chain_dp`` at every (S, B) the main_auto run
             launched it at, on the lanes that run gave it, bit-exact
             against ``chain.chain_dp_plain`` on the same card tensors.
             It fails when a launch of either path falls on a geometry
             not held at a batch at least as large (``unheld``);
9. bp      — at every aligner (max_len, band) of the main path, then at
             main_auto's own buckets, on its
             kernels-phase pairs: ``breaking_points`` rows from the card
             (``CudaAligner._launch_chunk`` + ``_finish_chunk_bp``) equal
             to the host decode of the same walk (``ops_to_cigar`` +
             ``decode_breaking_points_batch``), the card's tables equal to
             ``breaking_points`` on the CPU from the same op stream, and
             its time (CUDA events);
10. agree  — a small genome (0.02 Mbp, 1-2 kbp reads) polished on the
             card through the consensus stream and through the padded path
             (``use_ragged=False``), and with the plain PyTorch kernels on
             the CPU: the three FASTA must be byte-identical;
11. profile — the main path once more under ``torch.profiler``: device
             time by kernel and of the ``breaking_points`` range, and the
             device's idle share.

Then the ``{"kernels": [...]}`` line (``on_main_path`` false for a kernel
the engines give none of the main path's launches: K1 since K4's wide
body measured faster at every band the 1 Mbp run launches), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Details
too long for the end of the output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gzip
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from racon_tpu_torch import native
from racon_tpu_torch.core.backends import NativePoaConsensus
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.ops import _build, chain, cuda_nw, overlap_seed
from racon_tpu_torch.core.overlap import decode_breaking_points_batch
from racon_tpu_torch.io import parsers
from racon_tpu_torch.ops.nw import (CudaAligner, breaking_points, build_rows,
                                    sweep_bound, window_geometry)
from racon_tpu_torch.ops.poa import (BAND, CH, DEL, GROW, K_INS, Q_PAD,
                                     T_PAD, CudaPoaConsensus, bucket_geometry,
                                     sweep_geometry)
from racon_tpu_torch.ops.swar import use_packed16
from racon_tpu_torch.utils.simulate import _mutate, write_inputs

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 rate, and
# the int32 ALU rate — 64 INT32 lanes per SM per clock x 132 SMs x
# 1.98 GHz boost — for the integer DP
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Operations the function needs, counted per step of the algorithm (not
# from the kernels' code), so both forward kernels share one bound.
# A DP cell, with its scores held two to a 32-bit lane (every value fits
# int16, as the packed kernel shows): per pair of cells 3 adds (diagonal +
# mismatch, insertion + 1, deletion + 1), 2 mins with their predicates for
# the best of three and its tie order (Hopper's DPX min-with-predicate gives
# the min of two and which half-words it took in one VIMNMX.S16x2, so each
# is one operation and the direction code needs no equality tests), 1 min
# for the saturation clamp, 1 select for the direction code, 2 range
# compares, 1 and and 1 select for the interior mask = 11 lane operations
# = 5.5 per cell; the mismatch test at 4 byte lanes per operation (0.25) and
# the 2-bit direction packing (1 shift-or per cell) bring it to 6.75.
OPS_PER_CELL = 6.75
# A walk step: the lane index (3), the direction byte's address (3), the
# 2-bit code's extraction (2), the boundary selects (2) and the i/j step (2)
# = 12; the vote stream adds the query lane's weight and code (2), the
# column (1), the M/D/insertion address select (4), the insertion run and
# slot (2) and the validity test (3) = 24.
# Bytes: a step's direction byte is charged as the 32 B sector it pulls.
# The next step reads another row (band/8 bytes on, 64 at band 512), no
# other step of the pair reads that sector, and the matrix (2.4 GB at the
# consensus shape) is far larger than the 50 MB L2, so the least a read can
# move is one sector of device memory.
OPS_PER_STEP = {"walk_ops": 12, "walk_vote": 24}
SECTOR = 32
# operations a step of breaking_points does: decode the 2-bit code (2), the
# two position prefix sums (2), the interval index (subtract, divide, clamp
# = 3), the validity test (2), the packed coordinates (2) and the two
# reductions (2)
OPS_PER_BP_STEP = 13
# The chain DP, per predecessor a live seed is scored against: the two
# coordinate deltas (2), the drift and its absolute value (2), five range
# tests and their four ands (9), the span min(k, dq, dt) (2), the score
# (shift, add, subtract = 3), the strict-> compare and the two selects of
# the best and its offset (3) = 21; per live seed: the floor max, the
# parent select and the best-end compare and two selects (5); per chained
# seed of the walk back: the parent test, the step and the count (3).
OPS_PER_CHAIN_PRED = 21
OPS_PER_CHAIN_SLOT = 5
OPS_PER_CHAIN_BACK = 3
# pairs x lanes x steps a plain-version comparison may cover: the plain
# versions loop over wavefronts in Python and would take minutes at the
# largest aligner chunks, so those are held on a prefix of at least 256 of
# the launch's pairs
PLAIN_CELLS = 12 * 10 ** 9
# the aligner bucket at which K1 takes its wide body with one warp a pair
# (band 1024); the 1 Mbp run's reads do not reach it, so the kernels phase
# drives it on 512 pairs of 3-4 kbp at 15% error
WIDE_1024 = (4096, 1024)
# K2 off the main path, at the aligner buckets whose largest chunks take
# its thread body: bucket -> ((shortest, longest + 1) pair length, error
# rate), the launch sizes timed besides the largest chunk (the two that
# bracket cuda_nw.walk_ops_body's threshold)
WALK_OFF_PATH = {(256, 128): ((150, 250, 0.10), (2048, 4096)),
                 (1024, 384): ((700, 1000, 0.12), (4096, 8192)),
                 (4096, 1024): ((3000, 4000, 0.15), (4096, 8192))}
# the WALK_OFF_PATH buckets at which the kernels phase also holds and
# times every forward body (K1's warp body against K4's block body there)
FWD_OFF_PATH = ((256, 128), (1024, 384))
# the consensus engine's groups at the bands a longer window gives them
# (poa.bucket_geometry: band 512 * ceil(backbone / 512), at most 4096), off
# the main path: band -> pairs of the group (MAX_GROUP_PAIRS at band 1024;
# fewer at 2048 and 4096, where the kernels phase keeps two direction
# matrices of 18 GB), the window as long as the band. At these and at
# every other forward shape K4's wide body runs at every BPT the band
# instantiates, on all the pairs and on their prefixes of BPT_LADDER pairs
# (1, 4, 16 and 64 pairs an SM of the H100's 132), which span launches
# from one pair an SM (latency-bound) to a full card (issue-bound); the
# limits of cuda_nw.I16X2_WIDE_BPT sit between two of them
CONSENSUS_OFF_PATH = {1024: 32768, 2048: 16384, 4096: 4096}
# the consensus stream's 256 bp bucket (Lq 768 at band 512): windows under
# 256 bp, a contig's tail or a short contig. The 1 Mbp run launches it only
# when its draft ends in such a window, so K4 and K3 are held and timed
# there at a group of a few tails and at one of a fragmented assembly's
# many, off the main path where the run did not launch the shape
CONSENSUS_TAIL = ((256 + BAND, BAND, 32), (256 + BAND, BAND, 4096))
BPT_LADDER = (132, 528, 2112, 8448)
# band-ladder rungs (ops.nw.BAND_RUNGS) that the 1 Mbp run does not launch,
# which shorter reads reach: (max_len, band) -> (shortest, longest + 1)
# pair length, error rate, pairs. The kernels phase holds and times every
# forward body there and K2's two bodies (rows of 8 and 12 bytes at 64
# and 96)
RUNG_OFF_PATH = {(256, 64): (20, 90, 0.08, 2048),
                 (256, 96): (40, 160, 0.1, 2048),
                 (1024, 192): (150, 450, 0.1, 2048),
                 (1024, 256): (250, 650, 0.1, 2048),
                 (4096, 768): (1000, 2200, 0.12, 2048)}
# pairs of the K3 row off the main path: not a multiple of the 32 pairs a
# warp of walk_vote_kernel walks
VOTE_PAIRS = 1000
BASES = np.frombuffer(b"ACGT", np.uint8)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound(ops: float, nbytes: float):
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ------------------------------------------------------------ inputs

def mutated_pairs(rng, B, lo, hi, err, alphabet):
    """B (query, target) pairs over ``alphabet``: random targets of length
    in [lo, hi), queries with substitutions, deletions and insertions at
    rate ``err`` split three ways."""
    pairs = []
    for _ in range(B):
        t = alphabet[rng.integers(0, 4, int(rng.integers(lo, hi)))]
        q = t.copy()
        flips = rng.random(len(q)) < err / 3
        q[flips] = alphabet[rng.integers(0, 4, int(flips.sum()))]
        q = q[rng.random(len(q)) >= err / 3]
        ins = rng.random(len(q)) < err / 3
        q = np.insert(q, np.flatnonzero(ins),
                      alphabet[rng.integers(0, 4, int(ins.sum()))])
        pairs.append((q, t))
    return pairs


def consensus_shape_inputs(dev, Lq, band, B, window=500):
    """One consensus group at the geometry (``Lq``, ``band``, ``B`` layer
    pairs) of ``window`` bp windows (the main path's 500 by default):
    window layers of +-6% length at 15% error, rows laid out as
    refine_round builds them (query/target pad codes 6/7)."""
    rng = np.random.default_rng(101)
    Lb = min(Lq - band + GROW, Lq)
    lo, hi = window * 94 // 100, window * 106 // 100
    pairs = mutated_pairs(rng, B, lo, hi, 0.15,
                          np.arange(4, dtype=np.uint8))
    c = band // 2
    width = c + Lq + band
    qrp = np.full((B, width), Q_PAD, np.uint8)
    tp = np.full((B, width), T_PAD, np.uint8)
    n = np.zeros(B, np.int32)
    m = np.zeros(B, np.int32)
    for k, (q, t) in enumerate(pairs):
        q = q[:Lq]
        qrp[k, c + Lq - len(q): c + Lq] = q[::-1]
        tp[k, c: c + len(t)] = t
        n[k], m[k] = len(q), len(t)
    steps, Lq2 = sweep_geometry(Lq, int((n + m).max()) + 65, int(n.max()))
    qpw = ((rng.integers(0, 94, (B, Lq2)).astype(np.uint16) << 3)
           | rng.integers(0, 5, (B, Lq2)).astype(np.uint16))
    bg = rng.integers(0, Lb - hi, B).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(qrp=t(qrp), tp=t(tp), n=t(n), m=t(m), band=band, Lq=Lq,
                Lb=Lb, steps=steps, qpw=t(qpw.view(np.int16)), bg=t(bg),
                shape=f"consensus B={B} Lq={Lq} band={band} steps={steps}")


def aligner_bucket_inputs(dev, shape, B, seed, div_obs):
    """One aligner chunk of ``shape`` (max_len, band) with ``B`` pairs as
    the main path makes them: a truth span of the simulator's read length
    (normal, mean 7 kbp, sd 1.5 kbp, clipped to 2-8 kbp), the read drawn
    from it with the simulator's read errors and the draft span with its
    draft errors, kept when the aligner seeds the pair at ``shape``: its
    bucket, and the band the ladder gives it from the cold estimate or from
    the main run's divergence observations ``div_obs`` (a bucket's own band
    takes the pairs no narrower rung admits). Rows built by
    ops.nw.build_rows; the drawn pairs under ``pairs``."""
    rng = np.random.default_rng(seed)
    cold = CudaAligner(device=dev)
    warm = CudaAligner(device=dev)
    warm._div_obs = list(div_obs)
    max_len, band = shape
    bi = next(i for i, (ml, bb) in enumerate(cold.buckets)
              if ml == max_len and band <= bb)

    def seeds(qlen, tlen):
        err = 1.0 - min(qlen, tlen) / max(qlen, tlen)
        return {al._seed_geometry(qlen, tlen, err, record=False)
                for al in (cold, warm)}

    # truth sizes whose equal-length pair seeds at the shape (5% slack for
    # the read's and the draft's indels), so the draw rejects on size first
    fits = [x for x in range(2000, 8001, 25)
            if any((bi, band) in seeds(y, y)
                   for y in (x * 95 // 100, x, x * 105 // 100))]
    if not fits:
        raise RuntimeError(f"no read length seeds at {shape}")
    lo, hi = min(fits), max(fits)
    pairs = []
    # up to 1000 tries a pair on sizes that fit (a bucket of short reads
    # rejects most sizes first)
    tries = 0
    while len(pairs) < B and tries < 1000 * B:
        size = int(np.clip(rng.normal(7000, 1500), 2000, 8000))
        if not lo <= size <= hi:
            continue
        tries += 1
        truth = BASES[rng.integers(0, 4, size)]
        q = _mutate(truth, rng, 0.03, 0.03, 0.06)[0]
        t = _mutate(truth, rng, 0.02, 0.02, 0.06)[0]
        if (bi, band) in seeds(len(q), len(t)):
            pairs.append((q, t))
    if len(pairs) < B:
        raise RuntimeError(f"could not draw {B} pairs at {shape}")
    out = pair_rows(dev, pairs, max_len, band)
    out["pairs"] = pairs
    return out


def pair_rows(dev, pairs, max_len, band):
    """Device rows of (query, target) ``pairs`` at ``(max_len, band)``, as
    the aligner builds them (ops.nw.build_rows), with the chunk's steps."""
    B = len(pairs)
    qcat = np.zeros(B * max_len, np.uint8)
    tcat = np.zeros(B * max_len, np.uint8)
    n = np.zeros(B, np.int32)
    m = np.zeros(B, np.int32)
    for k, (q, t) in enumerate(pairs):
        qcat[k * max_len: k * max_len + len(q)] = q
        tcat[k * max_len: k * max_len + len(t)] = t
        n[k], m[k] = len(q), len(t)
    steps = sweep_bound(int((n + m).max()), max_len)
    nd = torch.from_numpy(n).to(dev)
    md = torch.from_numpy(m).to(dev)
    qrp, tp = build_rows(torch.from_numpy(qcat).to(dev),
                         torch.from_numpy(tcat).to(dev), nd, md,
                         max_len=max_len, band=band)
    return dict(qrp=qrp, tp=tp, n=nd, m=md, band=band, Lq=max_len,
                steps=steps, shape=f"aligner ({max_len}, {band}) B={B} "
                                   f"steps={steps}")


# ------------------------------------------------------------ checks

def fwd_err(got, ref, n, m) -> int:
    """Largest |kernel - plain| over the scores and the direction bytes
    below each pair's n + m (the rows a walk reads), on the pairs both
    cover (``ref`` and ``got`` each hold a prefix of one launch's pairs).
    Compared 32 pairs at a time."""
    (dirs, score), (dirs_ref, score_ref) = got, ref
    P = min(dirs_ref.shape[0], dirs.shape[0])
    err = int((score[:P].long() - score_ref[:P].long()).abs().max())
    rows = torch.arange(dirs.shape[1], device=dirs.device)[None, :, None]
    for k in range(0, P, 32):
        sl = slice(k, min(k + 32, P))
        live = rows < (n[sl].long() + m[sl].long())[:, None, None]
        diff = (dirs[sl].int() - dirs_ref[sl].int()).abs() * live
        err = max(err, int(diff.max()))
    return err


def plain_pairs(inp) -> int:
    """Pairs the plain versions are held on: all of them, or a prefix
    when pairs x lanes x steps exceeds PLAIN_CELLS."""
    B = inp["n"].shape[0]
    per_pair = (inp["band"] // 2) * inp["steps"]
    return min(B, max(256, PLAIN_CELLS // per_pair))


def i16x2_wide_smem(band: int, bpt: int, width: int) -> int:
    """Dynamic shared memory of a block of K4's wide body, as
    ``launch_i16x2_wide`` (``nw_fwd.cu``) sizes it: each pair's two staged
    rows with 16 B of slack, 4 pairs a block at NW = 1, else one pair and
    the edge ring of 8 * NW + 2 words."""
    nw = band // (256 * bpt)
    rows = 2 * (((width + 15) & ~15) + 16)
    return 4 * rows if nw == 1 else rows + 4 * (8 * nw + 2)


def fwd_rows(inp, reps, ladder=()):
    """The forward kernels at one shape, each body held against its
    kernel's plain version (computed once, on the first ``plain_pairs``
    pairs, for every body of the same kernel) and timed. K1: the body
    ``cuda_nw.fwd_i32_body`` picks (through ``nw_fwd``, its ``variant``)
    and, where that is not the block body, its block body. K4: the body
    ``cuda_nw.fwd_i16x2_body`` picks (through ``nw_fwd``), then its wide
    body at every other BPT the band instantiates (``variant`` ``wide``,
    ``bpt``) and its block body (``block``), through their C entries.
    With ``ladder``, where the band instantiates more than one BPT, K4's
    wide body at each of them again on each shorter prefix of that many
    pairs (``pairs``; ``engines_pick`` marks the BPT
    ``cuda_nw.fwd_i16x2_body`` gives such a launch), after K4's rows. Returns the output of the K4 body the engines pick (the
    walks read it), K1's rows and K4's rows, the picked body's first."""
    args = (inp["qrp"], inp["tp"], inp["n"], inp["m"])
    kw = dict(max_len=inp["Lq"], band=inp["band"], steps=inp["steps"])
    P = plain_pairs(inp)
    B = args[0].shape[0]
    nm = torch.clamp(inp["n"].long() + inp["m"].long(),
                     max=inp["steps"])
    band = inp["band"]
    U, RB = band // 2, band // 8
    width = args[0].shape[1]

    def fwd_bound(b):
        """The bound of a launch over the first ``b`` pairs."""
        live = float(nm[:b].sum())
        return bound(live * U * OPS_PER_CELL,
                     2 * b * width + 8 * b + live * RB + 4 * b)

    bms, by = fwd_bound(B)

    def rows(ref, plain_ms, launches):
        """Each launch held and timed; the first one's output kept (one
        direction matrix alive at a time: 16 GiB at (16384, 4096))."""
        first, out = None, []
        for tags, launch in launches:
            got = launch()
            err = fwd_err(got, ref, inp["n"], inp["m"])
            if first is None:
                first = got
            del got
            out.append(dict(shape=inp["shape"], max_abs_err=err,
                            ms=time_ms(launch, reps), plain_ms=plain_ms,
                            plain_pairs=P, bound_ms=bms, bound_by=by,
                            library_ms=None, **tags))
        return first, out

    body = cuda_nw.fwd_i32_body(band)
    k1_launch = [(dict(variant=body), lambda: cuda_nw.nw_fwd(*args, **kw))]
    if body != "block":
        k1_launch.append((dict(variant="block"),
                          lambda: cuda_nw._launch_fwd(
                              cuda_nw.FWD_I32_ENTRIES["block"], *args,
                              **kw)))
    ref, plain_ms = timed_once(
        lambda: cuda_nw.nw_fwd_plain(*(a[:P] for a in args), **kw))
    _, k1 = rows(ref, plain_ms, k1_launch)
    del ref
    picked, picked_bpt = cuda_nw.fwd_i16x2_body(band, B)
    k4_launch = [(dict(variant=picked, bpt=picked_bpt,
                       **({"smem_bytes": i16x2_wide_smem(band, picked_bpt,
                                                         width)}
                          if picked == "wide" else {})),
                  lambda: cuda_nw.nw_fwd(*args, packed16=True, **kw))]
    for bpt in cuda_nw.I16X2_WIDE_BPTS.get(band, ()):
        if bpt != picked_bpt:
            k4_launch.append((dict(variant="wide", bpt=bpt,
                                   smem_bytes=i16x2_wide_smem(band, bpt,
                                                              width)),
                              lambda bpt=bpt: cuda_nw._launch_fwd(
                                  cuda_nw.FWD_I16X2_ENTRIES["wide"], *args,
                                  bpt=bpt, **kw)))
    if picked != "block":
        k4_launch.append((dict(variant="block", bpt=None),
                          lambda: cuda_nw._launch_fwd(
                              cuda_nw.FWD_I16X2_ENTRIES["block"], *args,
                              **kw)))
    ref, plain_ms = timed_once(lambda: cuda_nw.nw_fwd_plain(
        *(a[:P] for a in args), packed16=True, **kw))
    got, k4 = rows(ref, plain_ms, k4_launch)
    wide = cuda_nw.FWD_I16X2_ENTRIES["wide"]
    if len(cuda_nw.I16X2_WIDE_BPTS.get(band, ())) < 2:
        ladder = ()
    for b in (b for b in ladder if b < B):
        part = tuple(a[:b] for a in args)
        lbms, lby = fwd_bound(b)
        for bpt in cuda_nw.I16X2_WIDE_BPTS[band]:
            launch = lambda bpt=bpt: cuda_nw._launch_fwd(wide, *part,
                                                         bpt=bpt, **kw)
            err = fwd_err(launch(), ref, inp["n"], inp["m"])
            k4.append(dict(
                shape=f"{inp['shape']}, first {b} pairs", pairs=b,
                max_abs_err=err, ms=time_ms(launch, reps),
                plain_ms=plain_ms, plain_pairs=min(P, b), bound_ms=lbms,
                bound_by=lby, library_ms=None, variant="wide", bpt=bpt,
                engines_pick=cuda_nw.fwd_i16x2_body(band, b)[1] == bpt))
    del ref
    # each body's time over the other kernel's picked body and over its
    # own kernel's block body, in this run
    for r in k1:
        r["over_nw_fwd_i16x2"] = r["ms"] / k4[0]["ms"]
    for r in k4:
        if "pairs" not in r:
            r["over_nw_fwd_i32"] = r["ms"] / k1[0]["ms"]
    # the body the engines launch at this shape, of either kernel
    packed16 = use_packed16(inp["Lq"], band)
    for rs, picked in ((k1, not packed16), (k4, packed16)):
        for r in rs:
            r["picked"] = picked and r is rs[0]
    for rs in (k1, k4):
        block = next((r for r in rs if r["variant"] == "block"), None)
        for r in rs:
            if block is not None and r is not block and "pairs" not in r:
                r["over_block"] = r["ms"] / block["ms"]
    return got, k1, k4


def walk_rows(dirs, inp, reps, plain=None):
    """K2 on a forward pass's direction matrix, both bodies (``variant``:
    ``warp`` or ``thread``; the one ``cuda_nw.walk_ops_body`` picks for
    this launch first, launched through ``walk_ops``), each held against
    the plain walk on the first ``plain_pairs`` pairs and timed. ``plain``
    is that walk's ``((ops, fi, fj), ms)`` where the caller already ran it
    on a matrix of which ``dirs`` is a prefix; it is held on the pairs
    both cover."""
    n, m, band = inp["n"], inp["m"], inp["band"]
    B, S = dirs.shape[:2]
    picked = cuda_nw.walk_ops_body(B, band)
    launch = {picked: lambda: cuda_nw.walk_ops(dirs, n, m, band=band)}
    for body, entry in cuda_nw.WALK_OPS_ENTRIES.items():
        launch.setdefault(body, lambda entry=entry: cuda_nw._launch_walk(
            entry, dirs, n, m, band=band))
    if plain is None:
        P = plain_pairs(inp)
        plain = timed_once(lambda: cuda_nw.walk_plain(dirs[:P], n[:P],
                                                      m[:P], band=band))
    (ops, fi, fj), plain_ms = plain
    P = min(B, ops.shape[0])
    ref = (cuda_nw.pack_ops(ops[:P]), fi[:P], fj[:P])
    rows = []
    for body, fn in launch.items():
        got = fn()
        err = max(int((a[:P].int() - b.int()).abs().max())
                  for a, b in zip(got, ref))
        rows.append(dict(shape=inp["shape"], variant=body, max_abs_err=err,
                         ms=time_ms(fn, reps), plain_ms=plain_ms,
                         plain_pairs=P, library_ms=None))
    steps_real = float((cuda_nw.unpack_ops(got[0]) < 3).sum())
    bms, by = bound(steps_real * OPS_PER_STEP["walk_ops"],
                    steps_real * SECTOR + 8 * B + B * S // 4 + 8 * B)
    warp, thread = (next(r for r in rows if r["variant"] == v)
                    for v in ("warp", "thread"))
    warp["over_thread"] = warp["ms"] / thread["ms"]
    thread["over_warp"] = thread["ms"] / warp["ms"]
    for r in rows:
        r.update(bound_ms=bms, bound_by=by)
    return rows


def walk_off_path_rows(dev, bucket, seed):
    """K2 at an aligner bucket the main path does not reach with chunks
    large enough for the thread body: one forward pass over the bucket's
    largest chunk (``CudaAligner._chunk_cap``) of pairs drawn as
    ``WALK_OFF_PATH`` says, then both bodies at each launch size on a
    prefix of its pairs, held against one plain walk. At the buckets of
    ``FWD_OFF_PATH`` that forward pass is ``fwd_rows``' (every body of
    both kernels, held and timed). Returns the walk rows, K1's and K4's."""
    (lo, hi, err), sizes = WALK_OFF_PATH[bucket]
    max_len, band = bucket
    cap = CudaAligner(device=dev)._chunk_cap(sweep_bound(2 * hi, max_len),
                                             band)
    pairs = mutated_pairs(np.random.default_rng(seed), cap, lo, hi, err,
                          BASES)
    inp = pair_rows(dev, pairs, max_len, band)
    k1 = k4 = []
    if bucket in FWD_OFF_PATH:
        inp["shape"] += f", pairs of {lo}-{hi} bp (off the main path)"
        (dirs, _), k1, k4 = fwd_rows(inp, 3)
    else:
        dirs, _ = cuda_nw.nw_fwd(inp["qrp"], inp["tp"], inp["n"], inp["m"],
                                 max_len=max_len, band=band,
                                 steps=inp["steps"])
    P = plain_pairs(inp)
    plain = timed_once(lambda: cuda_nw.walk_plain(
        dirs[:P], inp["n"][:P], inp["m"][:P], band=band))
    rows = []
    for B in sorted({*sizes, cap}):
        part = dict(inp, n=inp["n"][:B], m=inp["m"][:B],
                    shape=f"aligner ({max_len}, {band}) B={B} "
                          f"steps={inp['steps']}, pairs of {lo}-{hi} bp "
                          f"(off the main path)")
        rows += walk_rows(dirs[:B], part, 3, plain)
    return rows, k1, k4


def vote_entry(dirs, inp, reps):
    """K3 on a forward pass's direction matrix. Returns its row and the
    plain walk it was held against, ``((ops, fi, fj), ms)``, on which K2
    is held too."""
    n, m, band = inp["n"], inp["m"], inp["band"]
    P = plain_pairs(inp)
    kw = dict(band=band, L=inp["Lb"], K=K_INS, CH=CH, DEL=DEL)
    vargs = (dirs, n, m, inp["bg"], inp["qpw"])
    got = cuda_nw.walk_vote(*vargs, **kw)
    walked = timed_once(lambda: cuda_nw.walk_plain(dirs[:P], n[:P], m[:P],
                                                   band=band))
    (ops, fi, fj), walk_ms = walked
    (idx, w), vote_ms = timed_once(lambda: cuda_nw.vote_from_ops(
        ops, n[:P], m[:P], inp["qpw"][:P], inp["bg"][:P], L=inp["Lb"],
        K=K_INS, CH=CH, DEL=DEL))
    ref = (idx, w, fi, fj)
    err = max(int((a[:P].long() - b.long()).abs().max())
              for a, b in zip(got, ref))
    ms = time_ms(lambda: cuda_nw.walk_vote(*vargs, **kw), reps)
    B, S = dirs.shape[:2]
    # the walk's real steps (a valid vote or the sink), counted on the
    # plain-held prefix, which is every pair at the K3 shapes
    steps_real = float((ops < 3).sum()) * B / P
    # a real step reads a direction sector and a 2-byte query lane
    bms, by = bound(steps_real * OPS_PER_STEP["walk_vote"],
                    steps_real * (SECTOR + 2) + 16 * B + 5 * B * S + 8 * B)
    return dict(shape=inp["shape"], max_abs_err=err, ms=ms,
                plain_ms=walk_ms + vote_ms, plain_pairs=P, bound_ms=bms,
                bound_by=by, library_ms=None), walked


def consensus_shapes(groups):
    """Every distinct consensus (Lq, band) the main path launched, at its
    largest and its smallest group: ``(Lq, band, B)``, the largest group's
    first."""
    by_geom = {}
    for g in sorted(groups, key=lambda g: -g[3]):
        by_geom.setdefault((g[0], g[1]), []).append(g[3])
    return [(Lq, band, B) for (Lq, band), Bs in by_geom.items()
            for B in sorted({max(Bs), min(Bs)}, reverse=True)]


def aligner_buckets(path) -> dict:
    """(max_len, band) -> (largest padded batch, chunks) of one path's
    aligner launches."""
    out = {}
    for max_len, bnd, _, Bc, _ in path["aligner_chunk_shapes"]:
        big, count = out.get((max_len, bnd), (0, 0))
        out[(max_len, bnd)] = (max(big, Bc), count + 1)
    return out


def unheld_shapes(path, held) -> list:
    """The launches of one path whose geometry the kernels phase did not
    hold at a batch at least as large. ``held`` maps an aligner bucket or
    a consensus (Lq, band) to the largest batch held there; every body of
    every kernel is held at each such shape (K4 at each BPT its band
    instantiates, K2's two bodies), so a launch of B pairs at a geometry
    held at B' >= B pairs runs a body held on more pairs of that
    geometry."""
    shapes = ([("aligner", ml, bnd, Bc) for ml, bnd, _, Bc, _ in
               path["aligner_chunk_shapes"]]
              + [("consensus", g[0], g[1], g[3])
                 for g in path["consensus_group_shapes"]])
    return [sh for sh in shapes if held.get(sh[:3], 0) < sh[3]]


def phase_kernels(dev, main, auto):
    """Both forward kernels and the walk that follows at every shape the
    main path (``main``) and the ``--overlaps auto`` path (``auto``)
    launched: every consensus (Lq, band) of either at its largest and
    smallest group (K3 at each; K2 at the largest group's geometry, off
    the main path), and each aligner bucket at the main path's largest
    chunk there, and again at the auto path's where that is larger or the
    bucket is the auto path's alone;
    then the forward kernels at
    ``WIDE_1024`` when the main path did not launch that bucket and at the
    consensus groups of ``CONSENSUS_OFF_PATH`` (K4's wide body on the
    ``BPT_LADDER`` prefixes of every shape too), every forward body and
    K2 at the ladder rungs of ``RUNG_OFF_PATH``, and K3 on ``VOTE_PAIRS``
    pairs at the consensus geometry. A forward kernel's
    headline row is the first shape at which the engines pick it
    (``swar.use_packed16``), K2's is the bucket with the most chunks, K3's
    the consensus group; the other rows go to ``other_shapes``. Returns
    the entries, the main path's drawn aligner pairs by bucket (and the
    auto path's at its own buckets), and the largest batch held at each
    on-path geometry (``("aligner" | "consensus", dims...) -> B``)."""
    consensus = consensus_shapes(main["consensus_group_shapes"]
                                 + auto["consensus_group_shapes"])
    Lq, band, B = consensus[0]
    chunks = aligner_buckets(main)
    busiest = max(chunks, key=lambda k: chunks[k][1])
    rows = {name: [] for name in cuda_nw.KERNELS if name != "chain_dp"}
    drawn = {}    # aligner shape -> the pairs its rows were built from
    held = {("consensus", *c[:2]): max(b[2] for b in consensus
                                       if b[:2] == c[:2])
            for c in consensus}
    # the aligner's pairs are drawn with seeds 204, 205, ... in the main
    # path's bucket order, then the auto path's, each with its own path's
    # divergence observations
    aligner = [((k, v[0], main["aligner_div_obs"], ""), 204 + i)
               for i, (k, v) in enumerate(sorted(chunks.items()))]
    for k, (Bc, _) in sorted(aligner_buckets(auto).items()):
        if Bc > chunks.get(k, (0, 0))[0]:
            aligner.append(((k, Bc, auto["aligner_div_obs"], " (auto path)"),
                            204 + len(aligner)))
    for (k, Bc, _, _), _ in aligner:
        held[("aligner", *k)] = max(held.get(("aligner", *k), 0), Bc)
    shapes = ([("consensus", c, None) for c in consensus]
              + [("consensus_tail", c, None) for c in CONSENSUS_TAIL
                 if c not in consensus]
              + [("aligner", v, seed) for v, seed in aligner])
    if WIDE_1024 not in chunks:
        shapes.append(("off_path", None, None))
    shapes += [("consensus_off", b, None) for b in CONSENSUS_OFF_PATH]
    for key, val, seed in shapes:
        if key in ("consensus", "consensus_tail"):
            c_Lq, c_band, c_B = val
            inp = consensus_shape_inputs(dev, c_Lq, c_band, c_B,
                                         window=min(500, c_Lq - c_band))
            if key == "consensus_tail":
                inp["shape"] += " (off the main path)"
            reps = 5 if c_B > 4096 else 20
        elif key == "off_path":
            pairs = mutated_pairs(np.random.default_rng(303), 512, 3000,
                                  4000, 0.15, BASES)
            inp = pair_rows(dev, pairs, *WIDE_1024)
            inp["shape"] += " (off the main path)"
            reps = 3
        elif key == "consensus_off":
            c_band, _, c_Lq, _ = bucket_geometry(BAND, val)
            inp = consensus_shape_inputs(dev, c_Lq, c_band,
                                         CONSENSUS_OFF_PATH[val], window=val)
            inp["shape"] += f", {val} bp windows (off the main path)"
            reps = 3
        else:
            bucket, Bc, div_obs, label = val
            inp = aligner_bucket_inputs(dev, bucket, Bc, seed, div_obs)
            inp["shape"] += label
            pairs = inp.pop("pairs")
            if not label or bucket not in chunks:
                drawn[bucket] = pairs
            del pairs
            reps = 3
        (dirs, _), k1, k4 = fwd_rows(inp, reps, BPT_LADDER)
        # headline: the first main-path shape at which the engines pick
        # the kernel
        packed16 = use_packed16(inp["Lq"], inp["band"])
        on_path = key not in ("off_path", "consensus_off", "consensus_tail")
        for k, rs in ((False, k1), (True, k4)):
            for r in rs:
                r["headline"] = on_path and packed16 == k and r is rs[0]
        rows["nw_fwd_i32"] += k1
        rows["nw_fwd_i16x2"] += k4
        if key in ("consensus", "consensus_tail"):
            row, walked = vote_entry(dirs, inp, reps)
            row["headline"] = key == "consensus" and val == consensus[0]
            rows["walk_vote"].append(row)
            if key == "consensus" and val == consensus[0]:
                # K2 at the consensus geometry (the engines give it K3)
                for row in walk_rows(dirs, inp, reps, plain=walked):
                    row["shape"] += " (off the main path)"
                    row["headline"] = False
                    rows["walk_ops"].append(row)
            del walked
        elif on_path:
            k2 = walk_rows(dirs, inp, reps)
            for row in k2:
                row["headline"] = (val[0] == busiest and not val[3]
                                   and row is k2[0])
            rows["walk_ops"] += k2
        del dirs, inp
        torch.cuda.empty_cache()
    for seed, bucket in enumerate(WALK_OFF_PATH, 404):
        for name, rs in zip(("walk_ops", "nw_fwd_i32", "nw_fwd_i16x2"),
                            walk_off_path_rows(dev, bucket, seed)):
            for row in rs:
                row["headline"] = False
            rows[name] += rs
        torch.cuda.empty_cache()
    for seed, (shape, (lo, hi, err, B_r)) in enumerate(
            RUNG_OFF_PATH.items(), 606):
        pairs = mutated_pairs(np.random.default_rng(seed), B_r, lo, hi, err,
                              BASES)
        inp = pair_rows(dev, pairs, *shape)
        inp["shape"] += f", pairs of {lo}-{hi} bp (off the main path)"
        (dirs, _), k1, k4 = fwd_rows(inp, 3)
        for name, rs in (("nw_fwd_i32", k1), ("nw_fwd_i16x2", k4),
                         ("walk_ops", walk_rows(dirs, inp, 3))):
            for row in rs:
                row["headline"] = False
            rows[name] += rs
        del dirs, inp
        torch.cuda.empty_cache()
    inp = consensus_shape_inputs(dev, Lq, band, VOTE_PAIRS)
    dirs, _ = cuda_nw.nw_fwd(inp["qrp"], inp["tp"], inp["n"], inp["m"],
                             max_len=Lq, band=band, steps=inp["steps"])
    row = vote_entry(dirs, inp, 5)[0]
    row["shape"] += " (off the main path)"
    row["headline"] = False
    rows["walk_vote"].append(row)
    entries = {}
    for name, rs in rows.items():
        # off the main path, a shape whose launch the engines give it
        head = next((r for r in rs if r["headline"]), None) or next(
            (r for r in rs if r.get("picked")), rs[0])
        for r in rs:
            del r["headline"]
            r.pop("picked", None)
        entries[name] = dict(head, other_shapes=[r for r in rs
                                                 if r is not head])
        entries[name]["ok"] = all(r["max_abs_err"] == 0 for r in rs)
    return entries, drawn, held


def kernel_name(mangled: str) -> str:
    """``nw_fwd_i16x2_wide_kernel<8,4>`` from a mangled device function
    name of this repo's kernels."""
    head, _, rest = mangled.partition("kernel")
    at = max(head.rfind("nw_fwd_"), head.rfind("walk_"),
             head.rfind("chain_dp_"))
    args = re.match(r"I((?:Li-?\d+E)+)E", rest)
    targs = re.findall(r"Li(-?\d+)E", args.group(1)) if args else []
    return head[at:] + "kernel" + (f"<{','.join(targs)}>" if targs else "")


def ptxas_table(ptxas) -> dict:
    """Registers, stack frame and spills of every kernel, from each
    library's ``nvcc -Xptxas -v`` output."""
    out, cur = {}, None
    for text in ptxas.values():
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                cur = kernel_name(m.group(1)) if "kernel" in m.group(1) \
                    else None
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                out.setdefault(cur, {}).update(
                    stack=int(m.group(1)), spill_stores=int(m.group(2)),
                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


# SASS opcodes counted per kernel: the DPX min/max family, local memory,
# barriers and shuffles
SASS_OPS = ("VIMNMX", "VIMNMX3", "VIADDMNMX", "LDL", "STL", "BAR", "SHFL")


def phase_sass() -> dict:
    """``cuobjdump -sass`` of every kernel library: per kernel, its SASS
    instruction count (staging, set-up and the loop, most of it the loop)
    and the count of each of ``SASS_OPS``. Fails unless K4's wide body
    runs the DPX instructions in hardware (VIMNMX with its predicates)."""
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    table = {}
    for name in _build.SOURCES:
        text = subprocess.run(
            [str(cuobjdump), "-sass", str(_build._lib_path(name))],
            check=True, capture_output=True, text=True).stdout
        cur = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = table.setdefault(kernel_name(m.group(1)),
                                       dict.fromkeys(("instructions",
                                                      *SASS_OPS), 0))
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*)", line)
            if m and cur is not None and m.group(1) not in ("NOP",):
                cur["instructions"] += 1
                op = m.group(1)
                if op in cur:
                    cur[op] += 1
    out = dict(phase="sass", kernels=table)
    emit(out)
    wide = [v for k, v in table.items()
            if k.startswith("nw_fwd_i16x2_wide_kernel")]
    if not wide or not all(v["VIMNMX"] > 0 for v in wide):
        raise RuntimeError("nw_fwd_i16x2_wide_kernel has no VIMNMX in its "
                           "SASS")
    return out


def main_path_kernels(main) -> set:
    """The kernels the engines route the main path's launches to: the
    forward kernel ``swar.use_packed16`` picks at each aligner chunk's and
    consensus group's (max_len, band), then K2 (the aligner's walk) and K3
    (the consensus engine's walk + vote)."""
    shapes = [s[:2] for s in main["aligner_chunk_shapes"]
              + main["consensus_group_shapes"]]
    return {"nw_fwd_i16x2" if use_packed16(*s) else "nw_fwd_i32"
            for s in shapes} | {"walk_ops", "walk_vote"}


def phase_main(dev, mbp=1.0):
    data = ROOT / "build" / "smoke_data"
    t0 = time.perf_counter()
    paths = write_inputs(mbp, str(data), seed=23, coverage=30)
    sim_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_nw.reset_launches()
    native.reset_parse_calls()
    t0 = time.perf_counter()
    polisher = create_polisher(paths["reads"], paths["overlaps"],
                               paths["draft"], num_threads=8,
                               aligner="cuda", consensus="cuda",
                               device=dev)
    polished = polisher.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cuda_nw.LAUNCHES)
    parse_calls = dict(native.PARSE_CALLS)
    body_launches = dict(cuda_nw.BODY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    stages = dict(polisher.timings)
    aligner, consensus = polisher.aligner.stats, polisher.consensus.stats

    truth = fasta_seq(paths["truth"])
    draft = fasta_seq(paths["draft"])
    t0 = time.perf_counter()
    # the two O(n^2 / 64) distances run side by side (ctypes drops the GIL)
    with ThreadPoolExecutor(2) as pool:
        ed_draft, ed_polished = pool.map(
            lambda seq: native.edit_distance(seq, truth),
            [draft, polished[0].data])
    ed_s = time.perf_counter() - t0
    out = dict(phase="main", simulate_s=sim_s, wall_s=wall_s,
               stages_s=stages, launches=launches,
               overlaps=sum(polisher.targets_coverages),
               native_parse_calls=parse_calls,
               n_contigs=len(polished), polished_len=len(polished[0].data),
               truth_len=len(truth), ed_draft=ed_draft,
               fwd_body_launches=body_launches,
               ed_polished=ed_polished, edit_distance_s=ed_s,
               peak_device_bytes=peak,
               aligner_pairs_device=aligner["device"],
               aligner_pairs_host=(aligner["fallback_length"]
                                   + aligner["fallback_band"]),
               aligner_band_escalated=aligner["band_escalated"],
               aligner_ladder_narrow=aligner["ladder_narrow"],
               aligner_lanes_occupied=aligner["lanes_occupied"],
               aligner_lanes_total=aligner["lanes_total"],
               aligner_wavefront_work=aligner["wavefront_work"],
               aligner_fetched_bytes=aligner["fetched_bytes"],
               aligner_div_obs=polisher.aligner._div_obs,
               aligner_chunks=aligner["chunks"],
               aligner_swar_chunks=aligner["swar_chunks"],
               consensus_windows_device=consensus["device_windows"],
               consensus_windows_host=consensus["fallback_windows"],
               consensus_windows_passthrough=consensus["passthrough"],
               consensus_groups=consensus["groups"],
               consensus_wavefront_steps=consensus["wavefront_steps"],
               consensus_stage_b_windows=consensus["stage_b_windows"],
               consensus_lanes_occupied=consensus["lanes_occupied"],
               consensus_lanes_total=consensus["lanes_total"],
               consensus_band=consensus.get("band"),
               consensus_rounds_after_converged=consensus[
                   "rounds_after_converged"],
               consensus_feed_s=stages["consensus_feed_s"],
               consensus_finish_s=stages["consensus_finish_s"],
               pipeline_overlap_saved_s=stages["pipeline_overlap_saved_s"],
               aligner_chunk_shapes=aligner["chunk_shapes"],
               consensus_group_shapes=consensus["group_shapes"])
    emit(out)
    if parse_calls != {"seqfile": 2, "ovlfile": 1}:
        raise RuntimeError(f"the main path did not parse its three files "
                           f"natively: {parse_calls}")
    if len(polished) != 1 or not polished[0].data:
        raise RuntimeError("expected one polished contig")
    if set(polished[0].data) - set(b"ACGTN"):
        raise RuntimeError("polished contig holds non-base bytes")
    if not ed_polished * 4 < ed_draft:
        raise RuntimeError(f"polishing did not cut the edit distance: "
                           f"{ed_draft} -> {ed_polished}")
    return out, paths


def fasta_seq(path):
    lines = pathlib.Path(path).read_bytes().split(b"\n")
    return b"".join(l for l in lines if l and not l.startswith(b">"))


def phase_main_auto(dev, paths, main):
    """The main path with ``--overlaps auto``: the same inputs polished
    with the overlaps computed in-process (seeding, the seed join and the
    chain DP on the card, streamed into the aligner). The chain DP's
    inputs are recorded launch by launch (the wrapper is called through a
    recorder that keeps the card tensors) for the kernels phase."""
    launched = []
    wrapper = chain.chain_dp

    def recorder(ts, qs, ns, *, k):
        launched.append((ts, qs, ns, k))
        return wrapper(ts, qs, ns, k=k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    overlap_seed.clear_table_cache()
    cuda_nw.reset_launches()
    chain.reset_stats()
    native.reset_parse_calls()
    chain.chain_dp = recorder
    try:
        t0 = time.perf_counter()
        polisher = create_polisher(paths["reads"], "auto", paths["draft"],
                                   num_threads=8, aligner="cuda",
                                   consensus="cuda", device=dev)
        polished = polisher.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        chain.chain_dp = wrapper
    launches = dict(cuda_nw.LAUNCHES)
    parse_calls = dict(native.PARSE_CALLS)
    stats = dict(chain.STATS)
    peak = torch.cuda.max_memory_allocated(dev)
    aligner, consensus = polisher.aligner.stats, polisher.consensus.stats
    t0 = time.perf_counter()
    ed_polished = native.edit_distance(polished[0].data,
                                       fasta_seq(paths["truth"]))
    out = dict(phase="main_auto", wall_s=wall_s,
               stages_s=dict(polisher.timings), launches=launches,
               overlapper=stats, overlaps=sum(polisher.targets_coverages),
               overlaps_paf_path=main["overlaps"],
               native_parse_calls=parse_calls, n_contigs=len(polished),
               polished_len=len(polished[0].data), ed_draft=main["ed_draft"],
               ed_polished=ed_polished,
               ed_polished_paf_path=main["ed_polished"],
               edit_distance_s=time.perf_counter() - t0,
               peak_device_bytes=peak,
               aligner_pairs_device=aligner["device"],
               aligner_div_obs=polisher.aligner._div_obs,
               aligner_chunk_shapes=aligner["chunk_shapes"],
               consensus_group_shapes=consensus["group_shapes"])
    emit(out)
    if launches["chain_dp"] <= 0:
        raise RuntimeError("the auto path launched no chain_dp")
    if stats["join_bailouts"] > 0:
        raise RuntimeError(f"the seed join bailed out to the host: {stats}")
    if parse_calls != {"seqfile": 2, "ovlfile": 0}:
        raise RuntimeError(f"the auto path did not parse exactly its two "
                           f"sequence files natively: {parse_calls}")
    if len(polished) != 1 or set(polished[0].data) - set(b"ACGTN"):
        raise RuntimeError("expected one polished contig of bases")
    if not ed_polished * 4 < main["ed_draft"]:
        raise RuntimeError(f"auto polishing did not cut the edit distance: "
                           f"{main['ed_draft']} -> {ed_polished}")
    return out, launched


def overlap_split(dev, paths) -> dict:
    """Where the overlapper's time goes on the main path's 1 Mbp inputs,
    on the card (each step ends in a synchronise): seeding the reads,
    seeding the draft, the seed join, then ``find_overlaps`` whole (its
    draft table from the cache); its chain stage and group emission take
    the whole less the reads' seeding and the join."""
    reads = [r.data for r in parsers.parse_fastq(paths["reads"])]
    draft = [r.data for r in parsers.parse_fasta(paths["draft"])]
    self_t = np.full(len(reads), -1, np.int64)
    qlens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
    overlap_seed.clear_table_cache()
    out = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        return res

    rt = timed("seed_reads_s", lambda: overlap_seed.build_seed_table(
        reads, device=dev))
    tt = timed("seed_draft_s", lambda: overlap_seed.build_seed_table(
        draft, cache=True, device=dev))
    hits, _ = timed("join_s", lambda: chain.join_seeds(
        rt, tt, self_t, qlens, k=overlap_seed.DEFAULT_K,
        max_occ=chain.DEFAULT_MAX_OCC, device=dev))
    timed("find_overlaps_s", lambda: chain.find_overlaps(
        reads, draft, self_t, device=dev))
    out["chain_and_emit_s"] = (out["find_overlaps_s"] - out["seed_reads_s"]
                               - out["join_s"])
    out.update(read_minimizers=int(rt[0].size),
               draft_minimizers=int(tt[0].size), hits=int(hits["q"].size))
    return out


def phase_overlap(dev, paths, mbp=0.2):
    """``chain.find_overlaps`` on a 0.2 Mbp genome (seed 23) with its
    tensors on the card and on the CPU (the plain versions of the seeding,
    the join and the chain DP): every row array must be equal. Then
    :func:`overlap_split` on the main path's inputs."""
    data = ROOT / "build" / "smoke_overlap"
    small = write_inputs(mbp, str(data), seed=23, coverage=30)
    reads = [r.data for r in parsers.parse_fastq(small["reads"])]
    draft = [r.data for r in parsers.parse_fasta(small["draft"])]
    self_t = np.full(len(reads), -1, np.int64)
    rows, seconds, stats = {}, {}, {}
    for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
        overlap_seed.clear_table_cache()
        chain.reset_stats()
        t0 = time.perf_counter()
        rows[name] = chain.find_overlaps(reads, draft, self_t, device=where)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        stats[name] = {k: v for k, v in chain.STATS.items()
                       if k != "chunk_shapes"}
    same = all(np.array_equal(rows["cuda"][k], rows["cpu"][k])
               for k in rows["cpu"])
    out = dict(phase="overlap", mbp=mbp, reads=len(reads),
               rows=int(rows["cuda"]["q_ord"].size), identical=same,
               seconds=seconds, stats=stats,
               split_1mbp=overlap_split(dev, paths))
    emit(out)
    if not same or not rows["cuda"]["q_ord"].size:
        raise RuntimeError("the overlapper's card and CPU rows differ")
    return out


def chain_bound(ns: np.ndarray, n_chained: np.ndarray):
    """The chain DP's least time on this run's lanes: bytes (a live seed's
    two coordinates, each lane's count and its output row) and operations
    (each live seed against its min(i, CHAIN_LOOKBACK) predecessors, the
    seed's own work and the walk back)."""
    H = chain.CHAIN_LOOKBACK
    preds = sum(int(n) * H - H * (H + 1) // 2 if n > H
                else int(n) * (int(n) - 1) // 2 for n in ns)
    ops = (preds * OPS_PER_CHAIN_PRED + int(ns.sum()) * OPS_PER_CHAIN_SLOT
           + int(n_chained.sum()) * OPS_PER_CHAIN_BACK)
    nbytes = 8 * int(ns.sum()) + 28 * ns.size
    return bound(ops, nbytes)


def chain_entry(launched) -> dict:
    """``chain_dp`` at every (S, B) of the auto path, on its own lanes:
    bit-exact against ``chain_dp_plain`` on the same card tensors, timed
    with CUDA events. The headline shape is the one with the most live
    seeds."""
    rows = []
    for ts, qs, ns, k in launched:
        B, S = ts.shape
        got = chain.chain_dp(ts, qs, ns, k=k)
        want, plain_ms = timed_once(
            lambda: chain.chain_dp_plain(ts, qs, ns, k=k))
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ms = time_ms(lambda: chain.chain_dp(ts, qs, ns, k=k), 20)
        ns_np = ns.cpu().numpy()
        bound_ms, bound_by = chain_bound(ns_np, got[:, 1].cpu().numpy())
        rows.append(dict(shape=f"S={S}, B={B}", S=S, B=B,
                         live_seeds=int(ns_np.sum()), max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))
    head = max(rows, key=lambda r: r["live_seeds"])
    entry = dict(head, other_shapes=[r for r in rows if r is not head])
    entry["ok"] = all(r["max_abs_err"] == 0 for r in rows)
    return entry


def zlib_check() -> dict:
    """Whether ``g++`` compiles ``#include <zlib.h>`` (the native parsers
    inflate gzip with zlib), and which ``g++`` it is."""
    proc = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                          input="#include <zlib.h>\n", capture_output=True,
                          text=True)
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True).stdout.splitlines()
    return dict(ok=proc.returncode == 0, gxx=version[0] if version else "",
                stderr=proc.stderr[-1000:])


def phase_parse(dev, paths, zlib):
    """The native parser against the Python oracle on the main path's
    inputs, plain and gzipped (level 1, written here): equal records, and
    each parse's seconds."""
    rows = []
    for key, kind in (("draft", "fasta"), ("reads", "fastq"),
                      ("overlaps", "paf")):
        plain = paths[key]
        gz = plain + ".gz"
        t0 = time.perf_counter()
        with open(plain, "rb") as src, \
                gzip.open(gz, "wb", compresslevel=1) as dst:
            shutil.copyfileobj(src, dst, 1 << 20)
        gzip_s = time.perf_counter() - t0
        for path in (plain, gz):
            t0 = time.perf_counter()
            got = getattr(parsers, f"parse_{kind}")(path)
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = list(getattr(parsers, f"_parse_{kind}_py")(path))
            oracle_s = time.perf_counter() - t0
            rows.append(dict(file=os.path.basename(path), format=kind,
                             gzip=path == gz, bytes=os.path.getsize(path),
                             records=len(got), native_s=native_s,
                             oracle_s=oracle_s, equal=got == want,
                             **({"gzip_write_s": gzip_s}
                                if path == gz else {})))
            del got, want
    # Polisher._load (parse, filter, transmute) of the main path's polisher,
    # twice: its split
    loads = []
    for _ in range(2):
        polisher = create_polisher(paths["reads"], paths["overlaps"],
                                   paths["draft"], num_threads=8,
                                   aligner="cuda", consensus="cuda",
                                   device=dev)
        t0 = time.perf_counter()
        polisher._load()
        loads.append(dict(seconds=time.perf_counter() - t0,
                          **{k: v for k, v in polisher.timings.items()
                             if k.startswith("load_")
                             or k in ("filter_s", "transmute_s")}))
        del polisher
    out = dict(phase="parse", zlib=zlib, files=rows, loads=loads)
    emit(out)
    bad = [r["file"] for r in rows if not r["equal"] or not r["records"]]
    if bad:
        raise RuntimeError(f"native and oracle records differ: {bad}")
    return out


def phase_bp(dev, drawn, w=500):
    """Breaking points on the card at every aligner shape of the main path,
    then at the auto path's own, on the pairs its kernels rows were drawn
    from (its largest chunk), with
    metas of a 1 Mbp draft: one launch in breaking-points mode
    (``CudaAligner._launch_chunk``: forward pass, K2, ``breaking_points``)
    finished by ``_finish_chunk_bp``, one in CIGAR mode for the same walk's
    op stream. Every accepted pair's rows must equal the host decode of
    that walk (``ops_to_cigar`` + ``decode_breaking_points_batch``), the
    accept set must be the CIGAR mode's, and ``breaking_points`` on the CPU
    must give the card's tables from the same op stream. Timed with CUDA
    events (``ms``) and on the CPU (``cpu_ms``)."""
    rows = []
    for seed, (shape, drawn_pairs) in enumerate(drawn.items(), 505):
        max_len, band = shape
        rng = np.random.default_rng(seed)
        pairs = [(q.tobytes(), t.tobytes()) for q, t in drawn_pairs]
        C = len(pairs)
        metas = [(int(rng.integers(0, 1_000_000 - len(t))),
                  int(rng.integers(0, 500))) for _, t in pairs]
        chunk = list(range(C))
        al = CudaAligner(device=dev)
        bp_meta = (w, metas)
        launched = al._launch_chunk(pairs, chunk, max_len, band, bp_meta)
        got, reject = [None] * C, []
        al._finish_chunk_bp(launched, band, got, reject, bp_meta)
        cig_al = CudaAligner(device=dev)
        walked = cig_al._launch_chunk(pairs, chunk, max_len, band)
        _, _, n, m, (ops_d, _, _, _) = walked
        cigars, cig_reject = [None] * C, []
        cig_al._finish_chunk(walked, band, cigars, cig_reject)
        ok = sorted(reject) == sorted(cig_reject)
        accepted = [k for k in chunk
                    if got[k] is not None and cigars[k] is not None]
        t0 = time.perf_counter()
        host = decode_breaking_points_batch(
            [cigars[k] for k in accepted], [metas[k][1] for k in accepted],
            [metas[k][0] for k in accepted],
            [metas[k][0] + len(pairs[k][1]) for k in accepted], w, 8)
        decode_s = time.perf_counter() - t0
        ok &= all(np.array_equal(got[k], h) for k, h in zip(accepted, host))
        # the same op stream through breaking_points on the card and on
        # the CPU
        first_rel, nb = window_geometry(
            np.array([mt[0] for mt in metas]), m, w)
        NW = max_len // w + 2
        host_in = [torch.from_numpy(a) for a in (n, m, first_rel, nb)]
        dev_in = [a.to(dev) for a in host_in]
        card = breaking_points(ops_d, *dev_in, w=w, NW=NW)
        ops_h = ops_d.cpu()
        t0 = time.perf_counter()
        cpu = breaking_points(ops_h, *host_in, w=w, NW=NW)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        same_cpu = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
        ms = time_ms(lambda: breaking_points(ops_d, *dev_in, w=w, NW=NW), 5)
        B, S4 = ops_d.shape
        steps_all = B * S4 * 4
        bms, by = bound(steps_all * OPS_PER_BP_STEP,
                        B * S4 + 16 * B + 8 * B * NW)
        rows.append(dict(
            shape=f"aligner ({max_len}, {band}) B={B} steps={4 * S4}",
            pairs=C, accepted=len(accepted), rows=sum(len(h) for h in host),
            rows_equal_host_decode=ok, cpu_tables_equal=same_cpu, ms=ms,
            cpu_ms=cpu_ms, bound_ms=bms, bound_by=by,
            host_cigar_decode_s=decode_s,
            fetched_bytes=al.stats["fetched_bytes"],
            op_stream_bytes=C * S4))
        del launched, walked, ops_d, card
        torch.cuda.empty_cache()
    out = dict(phase="bp", window_length=w, shapes=rows,
               ok=all(r["rows_equal_host_decode"] and r["cpu_tables_equal"]
                      for r in rows))
    emit(out)
    if not out["ok"]:
        raise RuntimeError("device breaking points disagree with the host "
                           "decode or the CPU")
    return out


def phase_agree(dev):
    """The card against the plain PyTorch kernels end to end: a small
    simulated genome (0.02 Mbp, 1-2 kbp reads, seed 11) polished with both
    device engines on the card, once through the consensus stream and once
    through its padded path (``use_ragged=False``), and on the CPU must
    give the same FASTA bytes (the CPU side is held byte-identical to the
    JAX package by tests/test_torch_pipeline.py)."""
    from racon_tpu_torch.utils.simulate import simulate
    reads, paf, draft, _ = simulate(0.02, seed=11, mean_read=1500,
                                    max_read=2000, min_read=1000)
    data = ROOT / "build" / "smoke_small"
    data.mkdir(parents=True, exist_ok=True)
    paths = {}
    for key, name, blob in (("reads", "reads.fastq", reads),
                            ("overlaps", "ovl.paf", paf),
                            ("draft", "draft.fasta", draft)):
        paths[key] = str(data / name)
        pathlib.Path(paths[key]).write_bytes(blob)
    fasta, seconds = {}, {}
    for name, where, ragged in (("cuda", dev, True),
                                ("cuda_padded", dev, False),
                                ("cpu", torch.device("cpu"), True)):
        t0 = time.perf_counter()
        consensus = CudaPoaConsensus(
            3, -5, -4, fallback=NativePoaConsensus(3, -5, -4, 8),
            use_ragged=ragged, device=where)
        out = create_polisher(paths["reads"], paths["overlaps"],
                              paths["draft"], num_threads=8,
                              aligner="cuda", consensus=consensus,
                              device=where).run()
        seconds[name] = time.perf_counter() - t0
        fasta[name] = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                               for s in out)
    same = fasta["cuda"] == fasta["cuda_padded"] == fasta["cpu"]
    out = dict(phase="agree", fasta_bytes=len(fasta["cuda"]),
               identical=same, seconds=seconds)
    emit(out)
    if not same:
        raise RuntimeError("stream, padded and plain-kernel FASTA differ")
    return out


def phase_profile(dev, paths):
    """The main path once more under torch.profiler: device time by
    kernel and the device's idle share of the run's wall time (one
    stream, so busy time is the sum of device events)."""
    from torch.profiler import ProfilerActivity, profile
    polisher = create_polisher(paths["reads"], paths["overlaps"],
                               paths["draft"], num_threads=8,
                               aligner="cuda", consensus="cuda",
                               device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        polisher.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows, bp_s, bp_calls = [], 0.0, 0
    for e in prof.key_averages():
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        if e.key == "breaking_points":
            # the record_function range: on the host, with the device time
            # of the kernels launched inside it; on the device, the range
            # itself (no kernel of its own)
            if not on_device:
                bp_s += (getattr(e, "device_time_total", None)
                         or getattr(e, "cuda_time_total", 0)) / 1e6
                bp_calls += e.count
            continue
        # device-side events only (kernels, copies): host ops report the
        # device time of the kernels they launched as well
        if not on_device:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in rows) / 1e6
    # a kernel's device functions: <name>_kernel, K1's warp and wide
    # bodies <name>_warp_kernel<LPT>, <name>_wide_kernel<NW>, K2's thread
    # body walk_ops_thread_kernel
    ours = {name: sum(us for key, us, _ in rows
                      if any(f"{name}{body}_kernel" in key
                             for body in ("", "_warp", "_wide", "_thread")))
            / 1e6 for name in cuda_nw.KERNELS}
    out = dict(phase="profile", wall_s=wall_s, stages_s=polisher.timings,
               device_busy_s=busy_s,
               breaking_points_device_s=bp_s,
               breaking_points_calls=bp_calls,
               idle_share=(1.0 - busy_s / wall_s) if busy_s else None,
               kernel_device_s=ours,
               top=[dict(name=k[:80], device_s=us / 1e6, count=c)
                    for k, us, c in rows[:12]])
    emit({k: v for k, v in out.items() if k != "top"})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    record = {}
    t_start = time.perf_counter()

    line = gpu_line()
    record["device"] = dict(phase="device", nvidia_smi=line,
                            name=torch.cuda.get_device_name(0),
                            count=torch.cuda.device_count(),
                            torch=torch.__version__,
                            cuda=torch.version.cuda)
    emit(record["device"])
    zlib = zlib_check()
    if not zlib["ok"]:
        raise RuntimeError(f"g++ does not find zlib.h, which the native "
                           f"parsers need: {zlib}")

    t0 = time.perf_counter()
    _build.build_all(force=True, verbose_ptxas=True)
    cuda_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    # the parsers, and the host engines the device ones fall back to
    native.build(force=True)
    record["build"] = dict(phase="build", cuda_s=cuda_s,
                           native_s=time.perf_counter() - t1,
                           per_source={k: v["seconds"] for k, v in
                                       _build.build_log.items()})
    emit(record["build"])
    ptxas = {k: v["ptxas"] for k, v in _build.build_log.items()}
    record["ptxas"] = dict(phase="ptxas", kernels=ptxas_table(ptxas))
    emit(record["ptxas"])
    record["sass"] = phase_sass()

    t0 = time.perf_counter()
    record["main"], paths = phase_main(dev)
    record["main"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["main_auto"], launched = phase_main_auto(dev, paths,
                                                    record["main"])
    record["main_auto"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["overlap"] = phase_overlap(dev, paths)
    record["overlap"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["parse"] = phase_parse(dev, paths, zlib)
    record["parse"]["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    entries, drawn, held = phase_kernels(dev, record["main"],
                                         record["main_auto"])
    entries["chain_dp"] = chain_entry(launched)
    del launched
    record["kernels"] = dict(phase="kernels",
                             seconds=time.perf_counter() - t0,
                             kernels=entries)
    emit(record["kernels"])
    bad = [k for k, e in entries.items() if not e["ok"]]
    on_path = main_path_kernels(record["main"])
    missing = [k for k in on_path if record["main"]["launches"][k] <= 0]
    # the auto path: the chain DP, then the kernels its aligner and
    # consensus shapes route to
    on_auto = main_path_kernels(record["main_auto"]) | {"chain_dp"}
    missing += [f"{k} (auto)" for k in on_auto
                if record["main_auto"]["launches"][k] <= 0]
    # every shape either path launched, held at a batch at least as large
    unheld = {p: unheld_shapes(record[p], held)
              for p in ("main", "main_auto")}
    record["kernels"]["unheld"] = unheld

    t0 = time.perf_counter()
    record["bp"] = phase_bp(dev, drawn)
    record["bp"]["seconds"] = time.perf_counter() - t0
    del drawn

    record["agree"] = phase_agree(dev)
    record["profile"] = phase_profile(dev, paths)

    kernels = []
    for name, e in entries.items():
        source, replaces = cuda_nw.KERNELS[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=record["main_auto" if name == "chain_dp"
                            else "main"]["launches"][name],
            on_main_path=name in on_path | on_auto,
            max_abs_err=e["max_abs_err"], ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            shape=e["shape"], ok=e["ok"],
            **{k: e[k] for k in ("variant", "bpt", "over_nw_fwd_i16x2",
                                 "over_nw_fwd_i32", "over_block",
                                 "over_thread", "over_warp")
               if k in e},
            other_shapes=e.get("other_shapes", [])))
    record["total_s"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(record, summary=kernels, ptxas_text=ptxas), indent=1))
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    if any(unheld.values()):
        raise RuntimeError(f"launched shapes the kernels phase did not "
                           f"hold against the plain versions: {unheld}")
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: "
                           f"{missing}")
    emit({"kernels": kernels})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
