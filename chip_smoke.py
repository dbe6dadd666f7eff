#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``racon_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments: ``python3
chip_smoke.py``. It needs one CUDA device, ``nvcc`` and ``nvidia-smi``,
and it exits non-zero (printing no result) when any of them is missing or
any phase fails. Phases, one JSON line each:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — every kernel built from ``racon_tpu_torch/ops/kernels``, one
             ``nvcc`` per source, all at once;
3. main    — ``create_polisher(..., aligner="cuda", consensus="cuda")``
             polishes a simulated 1 Mbp genome at 30x ONT-like reads
             (seed 23): stage times, kernel launch counts (counted from
             zero just before the run; all must be > 0), the shape of every
             launch, host-fallback counts, the draft's and the polished
             contig's edit distance to the truth, peak device memory;
4. kernels — each kernel at every shape the main path launched it at (its
             largest consensus group; each aligner bucket at its largest
             chunk, on pairs drawn like the simulator's), held bit-exact
             against its plain PyTorch version on the same card inputs (a
             prefix of the pairs where the plain version would take
             minutes), timed with CUDA events. Each ``nw_fwd_i32`` row
             names the K1 body that ran (``variant``: ``warp`` at the bands
             128-512, ``wide`` at 1024, 4096 and 8192, ``block`` at the
             others) and its time over K4's at that shape
             (``over_nw_fwd_i16x2``); at a ``wide`` shape one more row
             times the ``block`` body against the same plain reference,
             and the wide row carries ``over_block``. Each K2 shape has a
             row for each body (``variant`` ``warp`` or ``thread``, the
             one ``cuda_nw.walk_ops_body`` picks for it first, with its
             time over the other's, ``over_thread`` or ``over_warp``).
             One more shape the main path does not reach, (4096, 1024)
             with 512 pairs, holds the wide body at band 1024 the same way
             (no walk row). K2 runs off the main path at the consensus
             group's shape (on the direction matrix K3 walks, held against
             the plain walk K3 is held against) and at the aligner buckets
             whose largest chunks take its thread body (``WALK_OFF_PATH``:
             each bucket's largest chunk and smaller launches on a prefix
             of its pairs), and K3 runs once more off the main path on
             ``VOTE_PAIRS`` pairs (a partial last warp) at the consensus
             geometry;
5. agree   — a small genome (0.02 Mbp, 1-2 kbp reads) polished on the
             card and with the plain PyTorch kernels on the CPU: the FASTA
             bytes must be identical;
6. profile — the main path once more under ``torch.profiler``: device
             time by kernel and the device's idle share.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Details too long for the end of the
output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from racon_tpu_torch import native
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.ops import _build, cuda_nw
from racon_tpu_torch.ops.nw import CudaAligner, build_rows, sweep_bound
from racon_tpu_torch.ops.poa import (CH, DEL, GROW, K_INS, Q_PAD, T_PAD,
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
# mismatch, insertion + 1, deletion + 1), 3 mins (best of three, the
# saturation clamp), 2 equality tests and 1 select for the direction code,
# 2 range compares, 1 and and 1 select for the interior mask = 13 lane
# operations = 6.5 per cell; the mismatch test at 4 byte lanes per operation
# (0.25) and the 2-bit direction packing (1 shift-or per cell) bring it to 8.
OPS_PER_CELL = 8
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


def consensus_shape_inputs(dev, Lq, band, B):
    """One consensus group at the main path's geometry (``Lq``, ``band``,
    ``B`` layer pairs): ~500 bp window layers at 15% error, rows laid out
    as refine_round builds them (query/target pad codes 6/7)."""
    rng = np.random.default_rng(101)
    Lb = min(Lq - band + GROW, Lq)
    pairs = mutated_pairs(rng, B, 470, 530, 0.15,
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
    bg = rng.integers(0, Lb - 530, B).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(qrp=t(qrp), tp=t(tp), n=t(n), m=t(m), band=band, Lq=Lq,
                Lb=Lb, steps=steps, qpw=t(qpw.view(np.int16)), bg=t(bg),
                shape=f"consensus B={B} Lq={Lq} band={band} steps={steps}")


def aligner_bucket_inputs(dev, bucket, B, seed):
    """One aligner chunk of ``bucket`` (max_len, band) with ``B`` pairs as
    the main path makes them: a truth span of the simulator's read length
    (normal, mean 7 kbp, sd 1.5 kbp, clipped to 2-8 kbp), the read drawn
    from it with the simulator's read errors and the draft span with its
    draft errors, kept when the aligner puts the pair in ``bucket``; rows
    built by ops.nw.build_rows."""
    rng = np.random.default_rng(seed)
    aligner = CudaAligner(device=dev)
    bi = aligner.buckets.index(bucket)
    max_len, band = bucket
    pairs = []
    for _ in range(1000 * B):
        if len(pairs) == B:
            break
        size = int(np.clip(rng.normal(7000, 1500), 2000, 8000))
        truth = BASES[rng.integers(0, 4, size)]
        q = _mutate(truth, rng, 0.03, 0.03, 0.06)[0]
        t = _mutate(truth, rng, 0.02, 0.02, 0.06)[0]
        if aligner._bucket_index(len(q), len(t)) == bi:
            pairs.append((q, t))
    if len(pairs) < B:
        raise RuntimeError(f"could not draw {B} pairs of bucket {bucket}")
    return pair_rows(dev, pairs, max_len, band)


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
    below each pair's n + m (the rows a walk reads); ``ref`` covers a
    prefix of ``got``'s pairs. Compared 32 pairs at a time."""
    (dirs, score), (dirs_ref, score_ref) = got, ref
    P = dirs_ref.shape[0]
    err = int((score[:P].long() - score_ref.long()).abs().max())
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


def fwd_rows(inp, reps):
    """The forward kernels at one shape, each held against its plain
    version (computed once, on the first ``plain_pairs`` pairs, for every
    body of the same kernel) and timed: K1 through ``nw_fwd`` (the body
    ``cuda_nw.fwd_i32_body`` picks, its ``variant``), at a wide band K1's
    block body too (``variant`` ``block``, launched through its C entry),
    then K4. Returns K4's output (the walks read it) and the rows."""
    args = (inp["qrp"], inp["tp"], inp["n"], inp["m"])
    kw = dict(max_len=inp["Lq"], band=inp["band"], steps=inp["steps"])
    P = plain_pairs(inp)
    B = args[0].shape[0]
    nm = torch.clamp(inp["n"].long() + inp["m"].long(),
                     max=inp["steps"])
    U, RB = inp["band"] // 2, inp["band"] // 8
    cells = float(nm.sum()) * U
    nbytes = 2 * args[0].numel() + 8 * B + float(nm.sum()) * RB + 4 * B
    bms, by = bound(cells * OPS_PER_CELL, nbytes)

    def row(launch, ref, plain_ms):
        got = launch()
        err = fwd_err(got, ref, inp["n"], inp["m"])
        ms = time_ms(launch, reps)
        return got, dict(shape=inp["shape"], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, plain_pairs=P, bound_ms=bms,
                         bound_by=by, library_ms=None)

    body = cuda_nw.fwd_i32_body(inp["band"])
    k1_launch = {body: lambda: cuda_nw.nw_fwd(*args, **kw)}
    if body == "wide":
        k1_launch["block"] = lambda: cuda_nw._launch_fwd(
            cuda_nw.FWD_I32_ENTRIES["block"], *args, **kw)
    ref, plain_ms = timed_once(
        lambda: cuda_nw.nw_fwd_plain(*(a[:P] for a in args), **kw))
    k1 = {variant: dict(row(launch, ref, plain_ms)[1], variant=variant)
          for variant, launch in k1_launch.items()}
    del ref
    ref, plain_ms = timed_once(lambda: cuda_nw.nw_fwd_plain(
        *(a[:P] for a in args), packed16=True, **kw))
    got, k4 = row(lambda: cuda_nw.nw_fwd(*args, packed16=True, **kw), ref,
                  plain_ms)
    del ref
    # K1's time over K4's and over its block body's, in this run
    for r in k1.values():
        r["over_nw_fwd_i16x2"] = r["ms"] / k4["ms"]
    if body == "wide":
        k1["wide"]["over_block"] = k1["wide"]["ms"] / k1["block"]["ms"]
    return got, list(k1.values()), k4


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
    prefix of its pairs, held against one plain walk."""
    (lo, hi, err), sizes = WALK_OFF_PATH[bucket]
    max_len, band = bucket
    cap = CudaAligner(device=dev)._chunk_cap(sweep_bound(2 * hi, max_len),
                                             band)
    pairs = mutated_pairs(np.random.default_rng(seed), cap, lo, hi, err,
                          BASES)
    inp = pair_rows(dev, pairs, max_len, band)
    dirs, _ = cuda_nw.nw_fwd(inp["qrp"], inp["tp"], inp["n"], inp["m"],
                             max_len=max_len, band=band, steps=inp["steps"])
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
    return rows


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


def phase_kernels(dev, main):
    """Both forward kernels and the walk that follows at every shape the
    main path launched: its largest consensus group, and each aligner
    bucket at its largest chunk; then the forward kernels at
    ``WIDE_1024`` when the main path did not launch that bucket, and K3 on
    ``VOTE_PAIRS`` pairs at the consensus geometry. A forward kernel's
    headline row is the first shape at which the engines pick it
    (``swar.use_packed16``), K2's is the bucket with the most chunks, K3's
    the consensus group; the other rows go to ``other_shapes``."""
    Lq, band, _, B, _ = max(main["consensus_group_shapes"],
                            key=lambda g: g[3])
    chunks = {}   # bucket -> (largest padded batch, chunks launched)
    for max_len, bnd, _, Bc, _ in main["aligner_chunk_shapes"]:
        big, count = chunks.get((max_len, bnd), (0, 0))
        chunks[(max_len, bnd)] = (max(big, Bc), count + 1)
    busiest = max(chunks, key=lambda k: chunks[k][1])
    rows = {name: [] for name in cuda_nw.KERNELS}
    shapes = [("consensus", None)] + sorted(chunks.items())
    if WIDE_1024 not in chunks:
        shapes.append(("off_path", None))
    for seed, (key, val) in enumerate(shapes):
        if key == "consensus":
            inp = consensus_shape_inputs(dev, Lq, band, B)
            reps = 5
        elif key == "off_path":
            pairs = mutated_pairs(np.random.default_rng(303), 512, 3000,
                                  4000, 0.15, BASES)
            inp = pair_rows(dev, pairs, *WIDE_1024)
            inp["shape"] += " (off the main path)"
            reps = 3
        else:
            inp = aligner_bucket_inputs(dev, key, val[0], 202 + seed)
            reps = 3
        (dirs, _), k1, k4 = fwd_rows(inp, reps)
        # headline: the first main-path shape at which the engines pick
        # the kernel
        packed16 = use_packed16(inp["Lq"], inp["band"])
        on_path = key != "off_path"
        for r in k1:
            r["headline"] = (on_path and not packed16
                             and r["variant"] != "block")
        k4["headline"] = on_path and packed16
        rows["nw_fwd_i32"] += k1
        rows["nw_fwd_i16x2"].append(k4)
        if key == "consensus":
            row, walked = vote_entry(dirs, inp, reps)
            row["headline"] = True
            rows["walk_vote"].append(row)
            # K2 at the consensus geometry (the engines give it K3)
            for row in walk_rows(dirs, inp, reps, plain=walked):
                row["shape"] += " (off the main path)"
                row["headline"] = False
                rows["walk_ops"].append(row)
            del walked
        elif on_path:
            k2 = walk_rows(dirs, inp, reps)
            for row in k2:
                row["headline"] = key == busiest and row is k2[0]
            rows["walk_ops"] += k2
        del dirs, inp
        torch.cuda.empty_cache()
    for seed, bucket in enumerate(WALK_OFF_PATH, 404):
        for row in walk_off_path_rows(dev, bucket, seed):
            row["headline"] = False
            rows["walk_ops"].append(row)
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
        head = next((r for r in rs if r["headline"]), rs[0])
        for r in rs:
            del r["headline"]
        entries[name] = dict(head, other_shapes=[r for r in rs
                                                 if r is not head])
        entries[name]["ok"] = all(r["max_abs_err"] == 0 for r in rs)
    return entries


def phase_main(dev, mbp=1.0):
    data = ROOT / "build" / "smoke_data"
    t0 = time.perf_counter()
    paths = write_inputs(mbp, str(data), seed=23, coverage=30)
    sim_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_nw.reset_launches()
    t0 = time.perf_counter()
    polisher = create_polisher(paths["reads"], paths["overlaps"],
                               paths["draft"], num_threads=8,
                               aligner="cuda", consensus="cuda",
                               device=dev)
    polished = polisher.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cuda_nw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    stages = dict(polisher.timings)
    aligner, consensus = polisher.aligner.stats, polisher.consensus.stats

    def fasta_seq(path):
        lines = pathlib.Path(path).read_bytes().split(b"\n")
        return b"".join(l for l in lines if l and not l.startswith(b">"))

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
               n_contigs=len(polished), polished_len=len(polished[0].data),
               truth_len=len(truth), ed_draft=ed_draft,
               ed_polished=ed_polished, edit_distance_s=ed_s,
               peak_device_bytes=peak,
               aligner_pairs_device=aligner["device"],
               aligner_pairs_host=(aligner["fallback_length"]
                                   + aligner["fallback_band"]),
               aligner_band_escalated=aligner["band_escalated"],
               aligner_chunks=aligner["chunks"],
               aligner_swar_chunks=aligner["swar_chunks"],
               consensus_windows_device=consensus["device_windows"],
               consensus_windows_host=consensus["fallback_windows"],
               consensus_windows_passthrough=consensus["passthrough"],
               consensus_groups=consensus["groups"],
               consensus_wavefront_steps=consensus["wavefront_steps"],
               aligner_chunk_shapes=aligner["chunk_shapes"],
               consensus_group_shapes=consensus["group_shapes"])
    emit(out)
    if len(polished) != 1 or not polished[0].data:
        raise RuntimeError("expected one polished contig")
    if set(polished[0].data) - set(b"ACGTN"):
        raise RuntimeError("polished contig holds non-base bytes")
    if not ed_polished * 4 < ed_draft:
        raise RuntimeError(f"polishing did not cut the edit distance: "
                           f"{ed_draft} -> {ed_polished}")
    return out, paths


def phase_agree(dev):
    """The card against the plain PyTorch kernels end to end: a small
    simulated genome (0.02 Mbp, 1-2 kbp reads, seed 11) polished with both
    device engines on the card and on the CPU must give the same FASTA
    bytes (the CPU side is held byte-identical to the JAX package by
    tests/test_torch_pipeline.py)."""
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
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        out = create_polisher(paths["reads"], paths["overlaps"],
                              paths["draft"], num_threads=8,
                              aligner="cuda", consensus="cuda",
                              device=where).run()
        seconds[where.type] = time.perf_counter() - t0
        fasta[where.type] = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                                     for s in out)
    same = fasta["cuda"] == fasta["cpu"]
    out = dict(phase="agree", fasta_bytes=len(fasta["cuda"]),
               identical=same, seconds=seconds)
    emit(out)
    if not same:
        raise RuntimeError("card and plain-kernel FASTA differ")
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
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): host ops report the
        # device time of the kernels they launched as well
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
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

    t0 = time.perf_counter()
    _build.build_all(force=True, verbose_ptxas=True)
    cuda_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    native.build(force=True)   # the host engines the device ones fall back to
    record["build"] = dict(phase="build", cuda_s=cuda_s,
                           native_s=time.perf_counter() - t1,
                           per_source={k: v["seconds"] for k, v in
                                       _build.build_log.items()})
    emit(record["build"])
    ptxas = {k: v["ptxas"] for k, v in _build.build_log.items()}

    t0 = time.perf_counter()
    record["main"], paths = phase_main(dev)
    record["main"]["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    entries = phase_kernels(dev, record["main"])
    record["kernels"] = dict(phase="kernels",
                             seconds=time.perf_counter() - t0,
                             kernels=entries)
    emit(record["kernels"])
    bad = [k for k, e in entries.items() if not e["ok"]]
    missing = [k for k, v in record["main"]["launches"].items() if v <= 0]

    record["agree"] = phase_agree(dev)
    record["profile"] = phase_profile(dev, paths)

    kernels = []
    for name, e in entries.items():
        source, replaces = cuda_nw.KERNELS[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=record["main"]["launches"][name],
            max_abs_err=e["max_abs_err"], ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            shape=e["shape"], ok=e["ok"],
            **{k: e[k] for k in ("variant", "over_nw_fwd_i16x2",
                                 "over_block", "over_thread", "over_warp")
               if k in e},
            other_shapes=e.get("other_shapes", [])))
    record["total_s"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(record, summary=kernels, ptxas=ptxas), indent=1))
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
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
