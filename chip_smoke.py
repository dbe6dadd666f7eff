#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``racon_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments: ``python3
chip_smoke.py``. It needs one CUDA device, ``nvcc``, ``nvidia-smi`` and a
``g++`` that finds zlib's header, and it exits non-zero (printing no
result) when any of them is missing or any phase fails. (``python3
chip_smoke.py --chain-ab SRC`` runs only :func:`chain_ab`, which times
another ``chain_dp.cu`` against this tree's; ``--multihost-rank`` is
the multihost phase's child.) Phases, one JSON line each:

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
             ``pipeline_overlap_saved_s``, peak device memory, and
             the files the native parser read (``native_parse_calls``:
             the draft and the reads, then the overlaps; the polisher
             parses nothing another way);
   resident — the main phase's polish again with ``RACON_TPU_RESIDENT=1``
             (the resident dataflow): each accepted align
             chunk keeps its breaking-point tables on the card, the layer
             rows are derived there (``nw.derive_layer_rows``), one stable
             sort by window runs there and one table comes back
             (``nw.finalize_layer_table``), and every consensus group
             gathers its lanes from the pool on the card
             (``poa.gather_qpw_rows``). It fails unless the FASTA's
             SHA-256 equals the main phase's, the ``dataflow.resident``
             gauge is 1 with no bail-out, ``lanes_device_groups`` equals
             the consensus groups, K4, K2 and K3 launched
             (counted from zero just before the run), and the card's
             memory in use is back within 1 MB of its level before the
             phase once the run's polisher is dropped (printed, both). It
             prints ``lane_upload_saved_bytes`` and
             ``lane_upload_saved_s``, the
             ``dataflow`` counters (``bytes_fetched``, ``bytes_avoided``,
             ``fallback_pairs``) beside the bytes the main phase's aligner
             fetched, ``window_derive_s``, ``layer_store_s`` and
             ``build_windows_s`` (the producer's time in the
             ``build.windows`` span) beside the main phase's, the wall and
             peak device bytes beside the main phase's, the pool
             upload's bytes and seconds, and, at the run's
             largest chunk, the CUDA-event ms of ``derive_layer_rows`` and
             of the run's ``finalize_layer_table``, and at the largest
             group ``gather_qpw_rows``'s, with their byte bounds;
             the card's derived rows, table and lanes must equal the same
             functions on the CPU from the fetched tables and the pool.
             Its launch shapes join the kernels phase's ``unheld`` check;
6. main_auto — the same polish with ``--overlaps auto``:
             ``create_polisher(reads, "auto", draft, ...)`` on the same
             1 Mbp inputs, so the first-party overlapper (minimizer seeding
             and the seed join, plain PyTorch on the card; the chain DP,
             CUDA kernel ``chain_dp``) streams its rows into the aligner:
             stage times with ``overlap_feed_s``, the overlapper's counters
             (``chain.STATS``), the overlaps kept against the PAF path's,
             the launches of ``chain_dp``, K4, K2 and K3 (counted from zero
             just before the run; each must be > 0), peak device memory;
             it fails on a join
             bail-out (the 1 Mbp tables fit the device join) and unless the
             native parser read exactly the two sequence files;
   resident_auto — the main_auto polish again with
             ``RACON_TPU_RESIDENT=1`` and the span timers on: each seed
             batch compacted on the card (``overlap_seed.
             compact_selected``), the join's seed coordinates kept there
             and each chain arena gathered from them
             (``chain.gather_pairs``). It fails unless the SHA-256 equals
             main_auto's, ``chain_dp`` launched and equals
             ``chain_dp_plain`` on every gathered arena, every consensus
             group gathered its lanes on the card, no join bail-out, and
             the largest ``compact_selected`` and ``gather_pairs`` calls
             equal the CPU's; it prints their CUDA-event ms with byte
             bounds, the ``dataflow`` and overlapper counters, the
             seeding, join and chain spans and ``overlap_feed_s`` beside
             main_auto's. Its launch shapes join the ``unheld`` check;
   obs     — the PAF main path once more through the port's CLI
             (``cli.main`` in this process, ``-t 8 -c 1
             --cudaaligner-batches 1``) with ``--trace``, ``--run-report``
             and ``--profile``, and the sanitizer on with every K4 chunk
             and group shadowed by K1 (``RACON_TPU_SANITIZE=1``,
             ``RACON_TPU_SANITIZE_SAMPLE=1``): the FASTA's SHA-256 (it must
             equal the main phase's), the report (it must pass
             ``obs.report.validate_report``), the timers of
             ``align.dispatch``/``align.fetch``/``poa.pack``/
             ``poa.dispatch``/``poa.fetch`` and the top span timers, the
             shadows per engine (each > 0; a mismatch raises), K1's
             launches (> 0), ``compiles.post_warm`` (0), peak device
             bytes, the wall beside the main phase's; then
             ``RACON_TPU_FAULTS=align.dispatch:oom`` on a 0.02 Mbp genome:
             the polish must raise and ``faults.classify`` must say
             ``device-oom``;
   shards  — the shard runner (``racon_tpu_torch.exec``) on the card: the
             1 Mbp genome (seed 23) cut into 4 contigs of 250 kbp, polished
             single-shot (``create_polisher``, both device engines) and by
             ``ShardRunner(n_shards=4, device="cuda")`` with its work dir
             kept: the two SHA-256 must be equal; each shard's row
             (``wall_s``, ``extract_s``, ``timings``, ``engine``), the two
             walls, the ``exec.index``/``plan``/``extract``/``merge``
             seconds, peak RSS and device bytes, and the K4, K2 and K3
             launches of the sharded run (counted from zero; each > 0);
             the run resumed (every shard skipped: no part touched, no
             engine built, no launch); the run again with
             ``RACON_TPU_FAULTS=exec.polish:oom@1`` (shard 0 records one
             ``device-oom`` attempt, action ``reduce-capacity``; every
             shard ends ``primary``; both engines at ``capacity_scale`` 2;
             the same bytes; the halved launches' shapes); and the main
             phase's input through ``cli.main`` with ``--shards 1`` (the
             main phase's SHA-256, its one shard ``primary`` with no
             attempt, its K4, K2 and K3 launches > 0). Before that,
             ``RACON_TPU_FAULTS=exec.polish:err@1*`` through ``cli.main
             --shards 4`` on the 4 contigs: every shard quarantined after
             one attempt on the card (no CPU rung, no host engine built,
             no launch), and the CLI exits 1. It fails on a quarantined
             shard or one on ``cpu-retry`` in a run without an injected
             fault, and
             every launch shape of the phase joins the kernels phase's
             ``unheld`` check;
   workers — the shards phase's inputs through ``python -m
             racon_tpu_torch -t 8 -c 1 --cudaaligner-batches 1 --shards 4``
             in child processes on the card: ``--workers 2`` (this CLI and
             the secondary it starts; the wall, the shards each worker
             finished, the card's memory in use from ``nvidia-smi`` and
             each child's peak device bytes); worker A with
             ``RACON_TPU_FAULTS=worker.kill:kill@2`` (it must exit -9 with
             one shard ``running`` and one ``done``), then worker B with
             ``--resume`` (exactly one ``reclaimed`` shard,
             ``lease.reclaimed`` >= 1 in its report); two workers launched
             at once with ``--resume`` on an empty directory
             (``RACON_TPU_EXEC_SLEEP_S=0.5``). Every merged FASTA must
             have the single shot's SHA-256, every manifest the shards
             phase's plan with each shard ``done`` on ``primary``, the
             report at ``--run-report`` must be the primary's, and no
             child may build a library (its report's ``compiles``, the
             libraries' mtimes). A ``sitecustomize`` on the children's
             path (``HOOK_SOURCE``) writes each child's kernel launches
             (from zero at its start; K4, K2 and K3 > 0 in the
             ``--workers 2`` run and in the phase), its engines' launch
             shapes (they join the kernels phase's shapes and its
             ``unheld`` check) and its peak device bytes at exit;
   wrapper — ``python -m racon_tpu_torch.wrapper`` with the device
             engines and racon's scores on the same inputs: ``--split`` at
             the largest contig's bytes (one contig a shard; the single
             shot's SHA-256), then ``--legacy-split`` at that size (one
             ``rampler split`` and one CLI process a chunk, each launching
             K4, K2 and K3 on the card; the single shot's contig names, and
             its summed edit distance to the truth contigs under a quarter
             of the draft's); launches and shapes as in ``workers``;
   serve   — the resident polishing service in child processes on the
             card: ``python -m racon_tpu_torch --serve SOCK --serve-dir
             DIR -t 8 -c 1 --cudaaligner-batches 1 --workers 2`` (the
             seconds from its start to the first ``ping``); the main
             phase's 1 Mbp PAF job twice, one after the other, through
             ``python -m racon_tpu_torch --submit SOCK --run-report ...``
             (each job's SHA-256 must be the main phase's; the server's
             ``wall_s``, ``compile_s`` and build count and the client's
             wall, job 2's wall over the main phase's in-process polish);
             the 1 Mbp job and the shards phase's 4-contig genome at once
             on the two slots (each its one-shot SHA-256; both walls,
             ``nvidia-smi``'s memory in use, the server's peak device
             bytes; these two and the next through a ``ServiceClient``
             of the smoke, no client process); a ``-m 5`` job rejected
             with the profile mismatch; a
             server on a fresh directory with
             ``RACON_TPU_FAULTS=server.kill:kill@1`` killed (-9) at the
             start of a job submitted under an idempotency key, and the
             server restarted on that directory without the fault: the
             same key resumes the job, which comes back with the main
             phase's SHA-256 and ``recovery.requeued_jobs`` 1 (the restart
             to result wall); then ``shutdown {"mode": "drain"}``: exit 0
             with the journal compacted to nothing. Every job's report
             must show aligner chunks and consensus groups (K4, K2 and K3
             launched for it) and 0 builds; each stopped server's exit
             record must show K4, K2 and K3 launches, no child may build
             a library, the server logs' ``device_mem=`` lines (the card's
             allocated bytes after the warm pool and after each job) are
             printed, and the shapes join the ``unheld`` check (the killed
             server writes no record: its job runs again, whole, in the
             restarted server);
   fleet   — two card hosts behind one gateway, in child processes:
             ``python -m racon_tpu_torch --gateway 127.0.0.1:PORT
             --fleet-dir D`` (``RACON_TPU_FLEET_TENANTS=alpha:3,beta:1``,
             a 3 s host TTL, a 0.1 s poll) and two ``--serve SOCK
             --fleet-dir D --workers 1 -t 8 -c 1 --cudaaligner-batches 1``
             hosts, started together (the seconds until the gateway's
             ``ping`` counts both alive); the 1 Mbp job (tenant alpha) and
             the shards phase's 4-contig genome (tenant beta) at once
             through ``ServiceClient``s of the smoke on the TCP address,
             one on each host (each its one-shot SHA-256, a host named in
             its header, K4/K2/K3 work and 0 builds in its report); a
             third host wedged by ``RACON_TPU_FAULTS=serve.polish:io@1*``
             and a 120 s backoff; h0 stopped by SIGTERM (drain, exit 0);
             the 1 Mbp job placed on the wedged host (its name sorts
             first), which is SIGKILLed once the gateway holds the
             placement: the job comes back from h1 with the main phase's
             SHA-256 (the seconds from the kill to the result), and
             ``stats`` counts the migration and the dead host; then
             SIGTERM on the gateway and h1 (drain, exit 0).
             ``nvidia-smi``'s compute apps before the first job and after
             the last (the gateway's pid must not be among them, and its
             exit record must show CUDA never initialised), the hosts'
             ``device_mem=`` lines, no host builds a library, and each
             stopped host's exit record must show K4, K2 and K3 launches
             (``launches_fleet``; its shapes join the ``unheld`` check);
   chips   — one process on several cards, with the device list
             ``[cuda:0, cuda:0]``: (a) the main phase's 1 Mbp polish with
             both engines on ``get_mesh(devices=[cuda:0, cuda:0])`` (the
             bucketed aligner through ``sharded_align``, the padded
             consensus through ``sharded_refine_loop``; SHA-256 = the main
             phase's); (b) ``ShardRunner(chips=2)`` on the shards phase's
             4-contig genome with ``topology.local_devices`` substituted by
             ``[cuda:0, cuda:0]`` in the phase (the single shot's bytes,
             manifest ``device`` 0 and 1, workers ``#chip0`` and
             ``#chip1``, ``devices`` rows 0 and 1); (c) the 1 Mbp genome
             through two chip workers, whose plan marks its one dominant
             contig ``MESH_DEVICE`` (the main phase's bytes, a ``mesh``
             row). Each leg's wall, launches (counted from zero just
             before it; K4, K2, K3 and ``breaking_points`` must be > 0)
             and peak device bytes (under 80 GB); with several cards (a)
             and (b) again over the real ones, else the line says they did
             not run. Its shard-local launch shapes join the ``unheld``
             check (``launches_chips``);
   multihost — two processes, one mesh: two children of this script
             (``--multihost-rank``) each call ``parallel.distributed_init``
             (gloo on ``127.0.0.1``) and polish the main phase's 1 Mbp
             inputs through ``create_polisher`` with both ``cuda`` engines
             and no mesh given, so ``_auto_mesh`` engages the global mesh:
             two slots on this card, one a process. Each child launches its
             own slot's shards, the shards' outputs are all-gathered on the
             host, and every child writes the whole FASTA. It fails unless
             both children's SHA-256 equal the main phase's, both engines'
             meshes have 2 slots with 1 addressable, K4, K2, K3 and
             ``breaking_points`` launched in each child (counted from
             zero), and both exit 0 within the limit; it prints each
             child's wall, launches, peak device bytes and the bytes and
             seconds of its all-gathers. A second physical card and a
             second host are not shown. Its shard-local shapes join the
             ``unheld`` check (``launches_multihost``);
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
8. kernels — each kernel at every shape the main path, the main_auto
             path or the shards phase launched it at (every consensus
             (Lq, band) of any at
             its largest and smallest group, K4 and K3 at each, stage-B
             groups included, and the
             stream's 256 bp bucket, ``CONSENSUS_TAIL``, off the main path
             where the run did not launch it; each aligner (max_len,
             band) at the main path's largest chunk, and once more at
             the largest chunk any other path launched there where that
             is larger or the bucket is not the main path's,
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
             launched it at, on the lanes that run gave it, and on the
             synthetic adversarial arenas of ``CHAIN_ADVERSARIAL`` (ties,
             ``ns`` of 0, 1, 15, 16, 17 and S, the gap limits; an arena
             past the shared-memory parents), bit-exact against
             ``chain.chain_dp_plain`` on the same card tensors.
             It fails when a launch of any of them falls on a geometry
             not held at a batch at least as large (``unheld``);
9. bp      — at every aligner (max_len, band) any path launched, on the
             pairs of its largest kernels row: ``breaking_points`` rows
             from the card (``CudaAligner._launch_chunk`` +
             ``_finish_chunk_bp``) equal to the host decode of the same
             walk (``ops_to_cigar`` + ``decode_breaking_points_batch``);
             the CUDA kernel ``breaking_points`` equal bit for bit to
             ``breaking_points_plain`` on the same card tensors and to
             ``breaking_points`` on the CPU from the same op stream, one
             launch a call; the kernel's and the plain version's time
             (CUDA events) beside the bound. Every path's aligner chunks
             join ``unheld`` under ``breaking_points``;
10. agree  — a small genome (0.02 Mbp, 1-2 kbp reads) polished on the
             card through the consensus stream and through the padded path
             (``use_ragged=False``), and with the plain PyTorch kernels on
             the CPU: the three FASTA must be byte-identical;
11. profile — the main path once more under ``torch.profiler``: device
             time by kernel and of the ``breaking_points`` range, and the
             device's idle share;
12. accuracy — the draft's and the main and main_auto polishes' edit
             distances to the truth, three native distances side by side
             on three threads started before the kernels phase, once the
             phases with child processes are over (each thread times its
             own); each polish must cut the draft's distance to under a
             quarter.

Then the ``{"kernels": [...]}`` line (``breaking_points`` from the bp
phase; ``on_main_path`` false for a kernel the engines give none of the
main path's launches: K1 since K4's wide body measured faster at every
band the 1 Mbp run launches), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Details
too long for the end of the output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import gzip
import hashlib
import io
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import racon_tpu_torch.exec as exec_pkg
from racon_tpu_torch import cli, contracts, faults, native, obs, rampler
from racon_tpu_torch.core.backends import NativePoaConsensus
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.ops import _build, chain, cuda_nw, overlap_seed
from racon_tpu_torch.ops import nw as nw_ops
from racon_tpu_torch.ops import poa as poa_ops
from racon_tpu_torch.core.overlap import decode_breaking_points_batch
from racon_tpu_torch.io import parsers
from racon_tpu_torch.exec.planner import MESH_DEVICE
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.ops.nw import (CudaAligner, breaking_points,
                                    breaking_points_plain, build_rows,
                                    sweep_bound, window_geometry)
from racon_tpu_torch.ops.poa import (BAND, CH, DEL, GROW, K_INS, Q_PAD,
                                     T_PAD, CudaPoaConsensus, bucket_geometry,
                                     sweep_geometry)
from racon_tpu_torch.ops.swar import use_packed16
from racon_tpu_torch import parallel
from racon_tpu_torch.parallel import get_mesh, topology
from racon_tpu_torch.utils.simulate import (_mutate, adversarial_chain_arena,
                                            write_inputs)

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
# operations a step of breaking_points needs: decode the 2-bit code (2),
# the two position updates (2), the match test (1), the boundary compare
# (1), the packed coordinates (shift, or = 2) and the interval's min and
# max (2) = 10. Positions only fall along a row, so the interval index
# changes, and the tpos < 0 and qpos < 0 tails begin, only where a
# position crosses a boundary known in advance: one compare a step stands
# for the divide, the clamp and the sign tests, which run once a crossing.
OPS_PER_BP_STEP = 10
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


def phase_kernels(dev, main, auto, shards, resident, resident_auto,
                  workers, wrapper, serve, fleet, chips, multihost):
    """Both forward kernels and the walk that follows at every shape the
    main path (``main``), the ``--overlaps auto`` path (``auto``) and the
    shards phase (``shards``), the resident phases (``resident``,
    ``resident_auto``) and the child processes of the workers, wrapper,
    serve and fleet phases (``workers``, ``wrapper``, ``serve``,
    ``fleet``) and the chips and multihost phases' shard-local launches
    (``chips``, ``multihost``) launched: every
    consensus (Lq, band) of any at its largest and smallest group (K3 at
    each; K2 at the largest group's geometry, off the main path), and each
    aligner bucket at the main path's largest chunk there, and once more
    at the largest chunk of any other path where that is larger or the
    bucket is new;
    then the forward kernels at
    ``WIDE_1024`` when the main path did not launch that bucket and at the
    consensus groups of ``CONSENSUS_OFF_PATH`` (K4's wide body on the
    ``BPT_LADDER`` prefixes of every shape too), every forward body and
    K2 at the ladder rungs of ``RUNG_OFF_PATH``, and K3 on ``VOTE_PAIRS``
    pairs at the consensus geometry. A forward kernel's
    headline row is the first shape at which the engines pick it
    (``swar.use_packed16``), K2's is the bucket with the most chunks, K3's
    the consensus group; the other rows go to ``other_shapes``. Returns
    the entries, the drawn aligner pairs by bucket, and the largest batch
    held at each
    on-path geometry (``("aligner" | "consensus", dims...) -> B``); the
    drawn pairs are those of each bucket's largest row."""
    consensus = consensus_shapes(main["consensus_group_shapes"]
                                 + auto["consensus_group_shapes"]
                                 + shards["consensus_group_shapes"]
                                 + resident["consensus_group_shapes"]
                                 + resident_auto["consensus_group_shapes"]
                                 + workers["consensus_group_shapes"]
                                 + wrapper["consensus_group_shapes"]
                                 + serve["consensus_group_shapes"]
                                 + fleet["consensus_group_shapes"]
                                 + chips["consensus_group_shapes"]
                                 + multihost["consensus_group_shapes"])
    Lq, band, B = consensus[0]
    chunks = aligner_buckets(main)
    busiest = max(chunks, key=lambda k: chunks[k][1])
    rows = {name: [] for name in cuda_nw.KERNELS
            if name not in ("chain_dp", "breaking_points")}
    # aligner shape -> the pairs of its largest row (the bp phase holds
    # breaking_points there)
    drawn = {}
    held = {("consensus", *c[:2]): max(b[2] for b in consensus
                                       if b[:2] == c[:2])
            for c in consensus}
    # the aligner's pairs are drawn with seeds 204, 205, ... in the main
    # path's bucket order, then the auto path's, then the shards phase's,
    # each with its own path's divergence observations
    aligner = [((k, v[0], main["aligner_div_obs"], ""), 204 + i)
               for i, (k, v) in enumerate(sorted(chunks.items()))]
    largest = {k: v[0] for k, v in chunks.items()}
    # beyond the main path's rows, one row a bucket: at the largest batch
    # any other path launched there (a row held at B holds every smaller
    # batch of its geometry), with that path's divergence observations
    extra = {}
    for path, label in ((auto, " (auto path)"),
                        (shards, " (shards phase)"),
                        (resident, " (resident phase)"),
                        (resident_auto, " (resident auto phase)"),
                        (workers, " (workers phase)"),
                        (wrapper, " (wrapper phase)"),
                        (serve, " (serve phase)"),
                        (fleet, " (fleet phase)"),
                        (chips, " (chips phase)"),
                        (multihost, " (multihost phase)")):
        for k, (Bc, _) in sorted(aligner_buckets(path).items()):
            if Bc > largest.get(k, 0):
                extra[k] = (Bc, path["aligner_div_obs"], label)
                largest[k] = Bc
    for k, (Bc, div_obs, label) in sorted(extra.items()):
        aligner.append(((k, Bc, div_obs, label), 204 + len(aligner)))
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
            # rows come in order of growing batch a bucket
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
             head.rfind("chain_dp_"), head.rfind("breaking_points_"))
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", rest)
    targs = re.findall(r"L[ib](-?\d+)E", args.group(1)) if args else []
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
    consensus group's (max_len, band), then K2 (the aligner's walk),
    ``breaking_points`` (its per-window tables) and K3 (the consensus
    engine's walk + vote)."""
    shapes = [s[:2] for s in main["aligner_chunk_shapes"]
              + main["consensus_group_shapes"]]
    return {"nw_fwd_i16x2" if use_packed16(*s) else "nw_fwd_i32"
            for s in shapes} | {"walk_ops", "breaking_points", "walk_vote"}


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

    fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                     for s in polished)
    out = dict(phase="main", simulate_s=sim_s, wall_s=wall_s,
               card=gpu_line(),
               fasta_sha256=hashlib.sha256(fasta).hexdigest(),
               stages_s=stages, launches=launches,
               overlaps=sum(polisher.targets_coverages),
               native_parse_calls=parse_calls,
               n_contigs=len(polished), polished_len=len(polished[0].data),
               fwd_body_launches=body_launches,
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
    return out, paths, polished[0].data


def _largest(record, args, size):
    """Keep in ``record["args"]`` the arguments of the call with the
    largest ``size``, and count every call in ``record["calls"]``."""
    record["calls"] += 1
    if "args" not in record or size > record["size"]:
        record.update(args=args, size=size)


def device_memory(dev) -> int:
    """Bytes held by live tensors on the card, after a collection."""
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(dev)


def phase_resident(dev, paths, main):
    """The main phase's polish with the resident dataflow on (see the
    module docstring). The derive of every chunk, the run's finalize and
    every consensus group's lane gather are recorded as they run, so the
    largest chunk's derive, the finalize and the largest group's gather
    are timed and held against the CPU on the run's own inputs."""
    derives, finals, n_derives = [], [], [0]
    derive0 = nw_ops._DevChunkBp.derive
    finalize0 = nw_ops.finalize_layer_table
    gathers = {"calls": 0}
    gather0 = poa_ops.gather_qpw_rows

    def gather(pool, src0, lens, Lq):
        _largest(gathers, (pool, src0, lens, Lq),
                 src0.shape[0] * Lq)
        return gather0(pool, src0, lens, Lq)

    def derive(chunk, *args):
        out = derive0(chunk, *args)
        n_derives[0] += 1
        if not derives or chunk.B * chunk.max_len > \
                derives[0][0].B * derives[0][0].max_len:
            derives[:] = [(chunk, args)]
        return out

    def finalize(parts, host_flat, src):
        finals.append((list(parts), host_flat, src))
        return finalize0(parts, host_flat, src)

    mem_before = device_memory(dev)
    torch.cuda.reset_peak_memory_stats()
    cuda_nw.reset_launches()
    metrics.clear("dataflow.")
    nw_ops._DevChunkBp.derive = derive
    nw_ops.finalize_layer_table = finalize
    poa_ops.gather_qpw_rows = gather
    try:
        with _env(RACON_TPU_RESIDENT="1"):
            t0 = time.perf_counter()
            polisher = create_polisher(paths["reads"], paths["overlaps"],
                                       paths["draft"], num_threads=8,
                                       aligner="cuda", consensus="cuda",
                                       device=dev)
            polished = polisher.run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        nw_ops._DevChunkBp.derive = derive0
        nw_ops.finalize_layer_table = finalize0
        poa_ops.gather_qpw_rows = gather0
    launches = dict(cuda_nw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    dataflow = metrics.dataflow_summary()
    stages = dict(polisher.timings)
    consensus = dict(polisher.consensus.stats)
    aligner_stats = dict(polisher.aligner.stats)
    aligner_div_obs = polisher.aligner._div_obs
    resident_info = dict(polisher._resident_info)
    fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                     for s in polished)
    del polisher, polished

    # the largest chunk's derive on the card, timed, and on the CPU from
    # the chunk's fetched tables and the pool copied back
    chunk, args = derives[0]
    card_rows = chunk.derive(*args)
    derive_ms = time_ms(lambda: chunk.derive(*args), 5)
    fp, lp = chunk.fetch()
    cpu_chunk = nw_ops._DevChunkBp(
        torch.from_numpy(fp.astype(np.int32)),
        torch.from_numpy(lp.astype(np.int32)), chunk.w, chunk.max_len)
    cpu_rows = cpu_chunk.derive(args[0].cpu(), *args[1:])
    B, NW, Lq = chunk.B, chunk.NW, chunk.max_len
    # bytes: both tables and each lane's pool span read, the rows written
    d_bound, d_by = bound(0, 8 * B * NW + 2 * B * Lq + 24 * B * NW)
    parts, host_flat, src = finals[0]
    table = finalize0(parts, host_flat, src)
    fin_ms = time_ms(lambda: finalize0(parts, host_flat, src), 5)
    cpu_table = finalize0([p.cpu() for p in parts], host_flat, src)
    T = len(src)
    # bytes: src and the gathered rows read, the sorted table written
    f_bound, f_by = bound(0, 8 * T + 24 * T + 24 * T)
    # the largest group's lane gather on the card, timed, and on the CPU
    # from the pool copied back; bytes: the lanes written, each pair's
    # pool span and its 16 bytes of gather rows read
    pool, src0, lens, Lq = gathers["args"]
    card_lanes = gather0(pool, src0, lens, Lq)
    gather_ms = time_ms(lambda: gather0(pool, src0, lens, Lq), 20)
    cpu_lanes = gather0(pool.cpu(), src0.cpu(), lens.cpu(), Lq)
    G = src0.shape[0]
    span = 2 * int(torch.clamp(lens, max=Lq).sum())
    g_bound, g_by = bound(0, 2 * G * Lq + span + 16 * G)
    gather_entry = dict(shape=f"B={G} Lq={Lq}", calls=gathers["calls"],
                        ms=gather_ms, bound_ms=g_bound, bound_by=g_by,
                        pool_elements=int(pool.numel()),
                        cpu_equal=torch.equal(card_lanes.cpu(), cpu_lanes))
    del gathers, pool, src0, lens, card_lanes, cpu_lanes
    out = dict(
        phase="resident", wall_s=wall_s, main_wall_s=main["wall_s"],
        card=gpu_line(), fasta_sha256=hashlib.sha256(fasta).hexdigest(),
        main_fasta_sha256=main["fasta_sha256"], dataflow=dataflow,
        main_aligner_fetched_bytes=main["aligner_fetched_bytes"],
        aligner_fetched_bytes=aligner_stats["fetched_bytes"],
        window_derive_s=stages.get("window_derive_s"),
        layer_store_s=stages.get("layer_store_s"),
        build_windows_s=stages["build_windows_s"],
        main_build_windows_s=main["stages_s"]["build_windows_s"],
        stages_s=stages, peak_device_bytes=peak,
        main_peak_device_bytes=main["peak_device_bytes"],
        pool_upload=resident_info, launches=launches,
        derive=dict(shape=f"B={B} NW={NW} Lq={Lq}", calls=n_derives[0],
                    ms=derive_ms, bound_ms=d_bound, bound_by=d_by,
                    cpu_equal=torch.equal(card_rows.cpu(), cpu_rows)),
        finalize=dict(rows_in=sum(p.shape[0] for p in parts) + len(host_flat),
                      rows=T, ms=fin_ms, bound_ms=f_bound, bound_by=f_by,
                      cpu_equal=bool(np.array_equal(table, cpu_table))),
        gather_qpw_rows=gather_entry,
        consensus_groups=consensus["groups"],
        lane_upload_saved_bytes=consensus["lane_upload_saved_bytes"],
        lane_upload_saved_s=stages.get("lane_upload_saved_s"),
        aligner_chunk_shapes=aligner_stats["chunk_shapes"],
        consensus_group_shapes=consensus["group_shapes"],
        aligner_div_obs=aligner_div_obs)
    del derives, finals, parts, card_rows, chunk, args, cpu_chunk
    out["device_bytes_before"] = mem_before
    out["device_bytes_after"] = device_memory(dev)
    emit(out)
    if out["fasta_sha256"] != main["fasta_sha256"]:
        raise RuntimeError("the resident dataflow did not polish the main "
                           "phase's bytes")
    if dataflow["resident"] != 1 or dataflow["resident_bailouts"] != 0:
        raise RuntimeError(f"the resident dataflow did not run: {dataflow}")
    idle = [k for k in ("nw_fwd_i16x2", "walk_ops", "walk_vote")
            if launches[k] <= 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the resident path: "
                           f"{idle}")
    if not (out["derive"]["cpu_equal"] and out["finalize"]["cpu_equal"]
            and gather_entry["cpu_equal"]):
        raise RuntimeError("the card's derived rows, layer table or "
                           "gathered lanes differ from the CPU's")
    if dataflow["lanes_device_groups"] != consensus["groups"]:
        raise RuntimeError(f"consensus groups took the host lane gather: "
                           f"{dataflow['lanes_device_groups']} of "
                           f"{consensus['groups']} on the device")
    if out["device_bytes_after"] - mem_before > 1 << 20:
        raise RuntimeError(f"the finished resident run left "
                           f"{out['device_bytes_after'] - mem_before} B "
                           f"on the card")
    return out


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
    fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                     for s in polished)
    out = dict(phase="main_auto", wall_s=wall_s, card=gpu_line(),
               fasta_sha256=hashlib.sha256(fasta).hexdigest(),
               stages_s=dict(polisher.timings), launches=launches,
               overlapper=stats, overlaps=sum(polisher.targets_coverages),
               overlaps_paf_path=main["overlaps"],
               native_parse_calls=parse_calls, n_contigs=len(polished),
               polished_len=len(polished[0].data),
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
    return out, launched, polished[0].data


def phase_resident_auto(dev, paths, main_auto):
    """The main_auto polish again with the resident dataflow on (see the
    module docstring), span timers armed: the FASTA must equal
    main_auto's; every ``chain_dp`` launch ran on an arena gathered on
    the card, and is held against ``chain_dp_plain`` there; the largest
    call of ``compact_selected`` and of ``gather_pairs`` is timed and held
    against the same function on the CPU."""
    launched = []
    compacts = {"calls": 0}
    gathers = {"calls": 0}
    dp0 = chain.chain_dp
    compact0 = overlap_seed.compact_selected
    gather0 = chain.gather_pairs

    def dp(ts, qs, ns, *, k):
        launched.append((ts, qs, ns, k))
        return dp0(ts, qs, ns, k=k)

    def compact(h, strand, sel):
        _largest(compacts, (h, strand, sel), h.numel())
        return compact0(h, strand, sel)

    def gather(tp, qc, starts, counts, S):
        _largest(gathers, (tp, qc, starts, counts, S),
                 starts.shape[0] * S)
        return gather0(tp, qc, starts, counts, S)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    overlap_seed.clear_table_cache()
    cuda_nw.reset_launches()
    chain.reset_stats()
    obs.begin()
    obs.trace.activate(tracing=False)
    chain.chain_dp, chain.gather_pairs = dp, gather
    overlap_seed.compact_selected = compact
    try:
        with _env(RACON_TPU_RESIDENT="1"):
            t0 = time.perf_counter()
            polisher = create_polisher(paths["reads"], "auto",
                                       paths["draft"], num_threads=8,
                                       aligner="cuda", consensus="cuda",
                                       device=dev)
            polished = polisher.run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        chain.chain_dp, chain.gather_pairs = dp0, gather0
        overlap_seed.compact_selected = compact0
        obs.trace.deactivate()
    launches = dict(cuda_nw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    dataflow = metrics.dataflow_summary()
    overlap = metrics.overlap_summary()
    spans = {k: metrics.timer_s(k) for k in (
        "overlap.seed", "overlap.seed.dispatch", "overlap.seed.fetch",
        "overlap.match", "overlap.chain", "poa.pack")}
    stages = dict(polisher.timings)
    consensus = dict(polisher.consensus.stats)
    aligner_shapes = list(polisher.aligner.stats["chunk_shapes"])
    aligner_div_obs = polisher.aligner._div_obs
    fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                     for s in polished)
    del polisher, polished

    # the chain DP on every arena the run gathered on the card
    dp_ok = all(torch.equal(dp0(ts, qs, ns, k=k), chain.chain_dp_plain(
        ts, qs, ns, k=k)) for ts, qs, ns, k in launched)
    n_launched = len(launched)
    del launched
    # compact_selected at its largest batch; bytes: the hash words,
    # strands and mask read, 10 bytes a selected entry written
    h, strand, sel = compacts["args"]
    card = compact0(h, strand, sel)
    c_ms = time_ms(lambda: compact0(h, strand, sel), 10)
    cpu = compact0(h.cpu(), strand.cpu(), sel.cpu())
    n = int(card[4])
    c_bound, c_by = bound(0, 6 * h.numel() + 10 * n)
    compact_entry = dict(
        shape=f"B={h.shape[0]} P={h.shape[1]}", calls=compacts["calls"],
        selected=n, ms=c_ms, bound_ms=c_bound, bound_by=c_by,
        cpu_equal=all(torch.equal(a[:n].cpu(), b[:n])
                      for a, b in zip(card[:4], cpu[:4]))
        and n == int(cpu[4]))
    # gather_pairs at its largest arena; bytes: the live hits' two
    # coordinates and 16 bytes a lane read, the arena written
    tp, qc, starts, counts, S = gathers["args"]
    card = gather0(tp, qc, starts, counts, S)
    g_ms = time_ms(lambda: gather0(tp, qc, starts, counts, S), 20)
    cpu = gather0(tp.cpu(), qc.cpu(), starts.cpu(), counts.cpu(), S)
    B = starts.shape[0]
    g_bound, g_by = bound(0, 8 * int(counts.sum()) + 16 * B + 8 * B * S)
    gather_entry = dict(
        shape=f"S={S} B={B}", calls=gathers["calls"], ms=g_ms,
        bound_ms=g_bound, bound_by=g_by,
        cpu_equal=all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)))
    del compacts, gathers, h, strand, sel, tp, qc, starts, counts, card, cpu
    out = dict(phase="resident_auto", wall_s=wall_s,
               main_auto_wall_s=main_auto["wall_s"], card=gpu_line(),
               fasta_sha256=hashlib.sha256(fasta).hexdigest(),
               main_auto_fasta_sha256=main_auto["fasta_sha256"],
               dataflow=dataflow, overlap=overlap, spans_s=spans,
               stages_s=stages,
               overlap_feed_s=stages.get("overlap_feed_s"),
               main_auto_overlap_feed_s=main_auto["stages_s"].get(
                   "overlap_feed_s"),
               launches=launches, chain_dp_launches_held=n_launched,
               chain_dp_equal=dp_ok, compact_selected=compact_entry,
               gather_pairs=gather_entry,
               consensus_groups=consensus["groups"],
               lane_upload_saved_bytes=consensus["lane_upload_saved_bytes"],
               peak_device_bytes=peak,
               main_auto_peak_device_bytes=main_auto["peak_device_bytes"],
               aligner_chunk_shapes=aligner_shapes,
               aligner_div_obs=aligner_div_obs,
               consensus_group_shapes=consensus["group_shapes"])
    emit(out)
    if out["fasta_sha256"] != main_auto["fasta_sha256"]:
        raise RuntimeError("the resident auto path did not polish "
                           "main_auto's bytes")
    if launches["chain_dp"] <= 0 or not dp_ok:
        raise RuntimeError("chain_dp did not run, or disagreed with its "
                           "plain version, on the gathered arenas")
    if not (compact_entry["cpu_equal"] and gather_entry["cpu_equal"]):
        raise RuntimeError("compact_selected or gather_pairs on the card "
                           "differs from the CPU's")
    if dataflow["lanes_device_groups"] != consensus["groups"] \
            or overlap["join_bailouts"] > 0:
        raise RuntimeError(f"the resident auto path took a host path: "
                           f"{dataflow} {overlap}")
    return out


def start_accuracy(paths, main_seq, auto_seq) -> dict:
    """Start the main and main_auto paths' edit distances to the truth,
    and the draft's: three O(n^2 / 64) native distances on three threads
    (ctypes drops the GIL), started once every child-process phase is over
    so they share the host only with the kernels phase's single launching
    thread (its CUDA events time the device). Each thread times its own
    distance."""
    truth = fasta_seq(paths["truth"])

    def timed(seq):
        t0 = time.perf_counter()
        return native.edit_distance(seq, truth), time.perf_counter() - t0

    pool = ThreadPoolExecutor(3)
    futures = [pool.submit(timed, seq) for seq in
               (fasta_seq(paths["draft"]), main_seq, auto_seq)]
    pool.shutdown(wait=False)
    return dict(truth_len=len(truth), futures=futures)


def phase_accuracy(record, started) -> dict:
    """The three distances of :func:`start_accuracy`; each polish must cut
    the draft's distance to under a quarter."""
    (ed_draft, s_draft), (ed_main, s_main), (ed_auto, s_auto) = (
        f.result() for f in started["futures"])
    out = dict(phase="accuracy", truth_len=started["truth_len"],
               ed_draft=ed_draft, ed_polished=ed_main,
               ed_polished_auto=ed_auto,
               edit_distance_s=max(s_draft, s_main, s_auto))
    record["main"].update(ed_draft=ed_draft, ed_polished=ed_main)
    record["main_auto"].update(ed_draft=ed_draft, ed_polished=ed_auto,
                               ed_polished_paf_path=ed_main)
    emit(out)
    for name, ed in (("main", ed_main), ("main_auto", ed_auto)):
        if not ed * 4 < ed_draft:
            raise RuntimeError(f"the {name} polish did not cut the edit "
                               f"distance: {ed_draft} -> {ed}")
    return out


# the spans the obs phase prints the timers of (the report's dispatch/fetch
# split reads them)
OBS_SPANS = ("align.dispatch", "align.fetch", "poa.pack", "poa.dispatch",
             "poa.fetch")


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_obs(dev, paths, main, line):
    """The PAF main path through ``cli.main`` with every observability
    output and the sanitizer at full sampling, then one injected fault
    (see the module docstring)."""
    out_dir = OUT_DIR / "obs"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    # the torch profile of a whole run is large: it stays on the machine
    prof_dir = ROOT / "build" / "obs_profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    argv = ["-t", "8", "-c", "1", "--cudaaligner-batches", "1",
            "--trace", str(out_dir / "trace.json"),
            "--run-report", str(out_dir / "run_report.json"),
            "--profile", str(prof_dir),
            paths["reads"], paths["overlaps"], paths["draft"]]
    stdout = io.TextIOWrapper(io.BytesIO())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_nw.reset_launches()
    try:
        with _env(RACON_TPU_SANITIZE="1", RACON_TPU_SANITIZE_SAMPLE="1"), \
                contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        # later phases time the main path with spans off
        obs.trace.deactivate()
    launches = dict(cuda_nw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    fasta = stdout.buffer.getvalue()
    rep = json.loads((out_dir / "run_report.json").read_text())
    errors = obs.report.validate_report(rep)
    timers = rep["metrics"]["timers"]
    counters = rep["metrics"]["counters"]
    spans = {k: v for k, v in timers.items()
             if k in contracts.SPANS}
    top = sorted(spans.items(), key=lambda kv: -kv[1])[:10]
    shadows = {"aligner": counters.get("align.shadow_chunks", 0),
               "consensus": counters.get("consensus.shadow_groups", 0)}
    fault = phase_obs_fault(dev)
    out = dict(phase="obs", rc=rc, wall_s=wall_s, main_wall_s=main["wall_s"],
               card=line, fasta_sha256=hashlib.sha256(fasta).hexdigest(),
               main_fasta_sha256=main["fasta_sha256"],
               report_errors=errors, span_timers_s={
                   k: timers.get(k, 0.0) for k in OBS_SPANS},
               top_spans_s=top, shadows=shadows,
               aligner_swar_chunks=counters.get("aligner.swar_chunks", 0),
               consensus_groups=counters.get("consensus.groups", 0),
               launches=launches, k1_launches=launches["nw_fwd_i32"],
               compiles=rep["compiles"], peak_device_bytes=peak,
               main_peak_device_bytes=main["peak_device_bytes"],
               dispatch_fetch=rep["dispatch_fetch"], queue=rep["queue"],
               profile_stop_s=timers.get("trace.profile_stop_s", 0.0),
               trace_bytes=(out_dir / "trace.json").stat().st_size,
               profile_bytes=sum(f.stat().st_size
                                 for f in prof_dir.glob("*.json")),
               fault=fault)
    emit(out)
    if rc != 0 or out["fasta_sha256"] != main["fasta_sha256"]:
        raise RuntimeError(f"the CLI with observability on (rc {rc}) did "
                           f"not polish the main phase's bytes")
    if errors:
        raise RuntimeError(f"the run report is not valid: {errors}")
    if min(shadows.values()) <= 0 or launches["nw_fwd_i32"] <= 0:
        raise RuntimeError(f"the sanitizer shadowed nothing: {shadows}, "
                           f"K1 launches {launches['nw_fwd_i32']}")
    if rep["compiles"]["post_warm"] != 0:
        raise RuntimeError(f"kernel builds after the first launch: "
                           f"{rep['compiles']}")
    if not all(out["span_timers_s"][k] > 0 for k in OBS_SPANS):
        raise RuntimeError(f"span timers missing: {out['span_timers_s']}")
    return out


def phase_obs_fault(dev) -> dict:
    """``RACON_TPU_FAULTS=align.dispatch:oom`` on a 0.02 Mbp genome: the
    polish must raise, with ``faults.classify`` ``device-oom``. No raise
    (bytes were polished) or another class fails the smoke."""
    small = write_inputs(0.02, str(ROOT / "build" / "smoke_fault"),
                         seed=11)
    polisher = create_polisher(small["reads"], small["overlaps"],
                               small["draft"], num_threads=8,
                               aligner="cuda", consensus="cuda", device=dev)
    faults.reset()
    try:
        with _env(RACON_TPU_FAULTS="align.dispatch:oom"):
            polished = polisher.run()
    except faults.DeviceOOMError as e:
        cls = faults.classify(e)
        if cls != faults.CLASS_OOM:
            raise RuntimeError(f"the injected OOM classified {cls}") from e
        return dict(site="align.dispatch", exception=type(e).__name__,
                    classify=cls, message=str(e))
    finally:
        faults.reset()
    raise RuntimeError(f"align.dispatch:oom did not raise: "
                       f"{len(polished)} sequences polished")


# the runner's own spans, printed beside the polish
EXEC_SPANS = ("exec.index", "exec.plan", "exec.extract", "exec.merge")


@contextlib.contextmanager
def _runners_made():
    """Every ``ShardRunner`` built inside (``cli._run_sharded`` included,
    which imports it from ``racon_tpu_torch.exec`` at the call), so their
    engines' launch shapes can be read after."""
    made = []
    base = exec_pkg.ShardRunner

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    exec_pkg.ShardRunner = Recording
    try:
        yield made
    finally:
        exec_pkg.ShardRunner = base


def _engine_shapes(engine_pairs) -> dict:
    """The launch shapes of the given (aligner, consensus) pairs."""
    return dict(
        aligner_chunk_shapes=[s for a, _ in engine_pairs
                              for s in a.stats["chunk_shapes"]],
        consensus_group_shapes=[s for _, c in engine_pairs
                                for s in c.stats["group_shapes"]])


def _shard_rows(summary) -> list:
    return [{k: e.get(k) for k in ("id", "contigs", "engine", "wall_s",
                                   "extract_s", "attempts", "timings")}
            for e in summary["shards"]]


def phase_shards(dev, main, paths):
    """The shard runner on the card (see the module docstring)."""
    data = ROOT / "build" / "smoke_shards"
    work = ROOT / "build" / "shards_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sim = write_inputs(1.0, str(data), seed=23, coverage=30, n_contigs=4)
    triple = (sim["reads"], sim["overlaps"], sim["draft"])
    faults.reset()
    # single shot
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = create_polisher(*triple, num_threads=8, aligner="cuda",
                             consensus="cuda", device=dev)
    single_fa = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                         for s in single.run())
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    pairs = [(single.aligner, single.consensus)]

    def sharded(name, **kw):
        runner = exec_pkg.ShardRunner(
            *triple, num_threads=8, aligner="cuda", consensus="cuda",
            n_shards=4, device=dev, work_dir=str(work / name),
            keep_work_dir=True, **kw)
        buf = io.BytesIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = runner.run(buf)
        torch.cuda.synchronize()
        return runner, summary, buf.getvalue(), time.perf_counter() - t0

    # the sharded run, its launches counted from zero
    torch.cuda.reset_peak_memory_stats()
    cuda_nw.reset_launches()
    runner, summary, fa, wall = sharded("run")
    launches = dict(cuda_nw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    spans = {k: metrics.timer_s(k) for k in EXEC_SPANS}
    pairs.append(runner.engines)
    # resume: every shard skipped, no part touched, no engine built
    parts = sorted((work / "run").glob("part_*.fasta"))
    mtimes = [p.stat().st_mtime_ns for p in parts]
    cuda_nw.reset_launches()
    resumed, r_summary, r_fa, r_wall = sharded("run", resume=True)
    resume = dict(wall_s=r_wall, sha256=hashlib.sha256(r_fa).hexdigest(),
                  engines_built=resumed.engines is not None,
                  launches=sum(cuda_nw.LAUNCHES.values()),
                  parts_touched=[p.stat().st_mtime_ns for p in parts]
                  != mtimes, n_parts=len(parts),
                  skipped=len(resumed._initially_done))
    # device-OOM backpressure at the first shard's first attempt
    with _env(RACON_TPU_FAULTS="exec.polish:oom@1"):
        faults.reset()
        oom, o_summary, o_fa, o_wall = sharded("oom")
    faults.reset()
    pairs.append(oom.engines)
    oom_out = dict(
        wall_s=o_wall, sha256=hashlib.sha256(o_fa).hexdigest(),
        attempts=o_summary["shards"][0].get("attempts"),
        engines=[e["engine"] for e in o_summary["shards"]],
        capacity_scale=[eng.capacity_scale for eng in oom.engines],
        halved_shapes=_engine_shapes([oom.engines]),
        halvings=o_summary["faults"].get("backpressure_halvings"))
    # a fault on the card's engines quarantines its shard (no CPU rung)
    # and fails the CLI's run; the fault fires before any launch
    q_argv = ["-t", "8", "-c", "1", "--cudaaligner-batches", "1",
              "--shards", "4", "--shard-dir", str(work / "quarantine"),
              *triple]
    with _env(RACON_TPU_FAULTS="exec.polish:err@1*"), \
            _runners_made() as q_made, \
            contextlib.redirect_stdout(io.TextIOWrapper(io.BytesIO())):
        faults.reset()
        cuda_nw.reset_launches()
        q_rc = cli.main(q_argv)
    faults.reset()
    q_shards = [e for r in q_made for e in r.summary.get("shards", [])]
    quarantine = dict(
        rc=q_rc, runners=len(q_made),
        status=[e["status"] for e in q_shards],
        attempts=[[(a["engine"], a["class"], a["action"])
                   for a in e.get("attempts", [])] for e in q_shards],
        cpu_engines_built=any(r.cpu_engines is not None for r in q_made),
        launches=sum(cuda_nw.LAUNCHES.values()))
    # --shards 1 through the CLI on the main phase's input, its launches
    # counted from zero
    argv = ["-t", "8", "-c", "1", "--cudaaligner-batches", "1",
            "--shards", "1", "--shard-dir", str(work / "cli"),
            paths["reads"], paths["overlaps"], paths["draft"]]
    stdout = io.TextIOWrapper(io.BytesIO())
    cuda_nw.reset_launches()
    with _runners_made() as made, contextlib.redirect_stdout(stdout):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        cli_wall = time.perf_counter() - t0
    cli_launches = dict(cuda_nw.LAUNCHES)
    pairs += [r.engines for r in made if r.engines is not None]
    cli_sha = hashlib.sha256(stdout.buffer.getvalue()).hexdigest()
    cli_summary = {"shards": [e for r in made
                              for e in r.summary.get("shards", [])]}
    # later phases time the main path with spans off
    obs.trace.deactivate()
    out = dict(phase="shards", card=gpu_line(), mbp=1.0, n_contigs=4,
               inputs=sim,
               single_wall_s=single_wall, wall_s=wall,
               single_sha256=hashlib.sha256(single_fa).hexdigest(),
               sha256=hashlib.sha256(fa).hexdigest(),
               shards=_shard_rows(summary), spans_s=spans,
               peak_rss_bytes=summary["peak_rss_bytes"],
               peak_device_bytes=peak, launches=launches,
               resume=resume, oom=oom_out,
               cli=dict(rc=rc, wall_s=cli_wall, sha256=cli_sha,
                        main_sha256=main["fasta_sha256"],
                        launches=cli_launches,
                        shards=_shard_rows(cli_summary)),
               quarantine=quarantine,
               aligner_div_obs=runner.engines[0]._div_obs,
               **_engine_shapes(pairs))
    emit({k: v for k, v in out.items()
          if k not in ("aligner_chunk_shapes", "consensus_group_shapes")})
    if out["sha256"] != out["single_sha256"]:
        raise RuntimeError("the sharded run did not polish the single "
                           "shot's bytes")
    clean = [summary, r_summary, cli_summary]
    if len(cli_summary["shards"]) != 1 or any(
            e["status"] != "done" or e.get("engine") != "primary"
            or e.get("attempts") for s in clean for e in s["shards"]):
        raise RuntimeError("a shard of a run without faults was "
                           "quarantined, retried or moved to the CPU")
    for name, counts in (("the sharded run", launches),
                         ("--shards 1 through the CLI", cli_launches)):
        if min(counts[k] for k in ("nw_fwd_i16x2", "walk_ops",
                                   "walk_vote")) <= 0:
            raise RuntimeError(f"{name} missed a kernel: {counts}")
    if (quarantine["rc"] != 1 or quarantine["runners"] != 1
            or quarantine["status"] != ["quarantined"] * 4
            or quarantine["attempts"] != [[("primary",
                                            "deterministic-compute",
                                            "quarantine")]] * 4
            or quarantine["cpu_engines_built"] or quarantine["launches"]):
        raise RuntimeError(f"a fault on the card's engines did not "
                           f"quarantine its shard and fail the run: "
                           f"{quarantine}")
    if (resume["sha256"] != out["sha256"] or resume["engines_built"]
            or resume["launches"] or resume["parts_touched"]
            or resume["skipped"] != 4):
        raise RuntimeError(f"the resume did not skip every shard: "
                           f"{resume}")
    att = oom_out["attempts"] or []
    if (oom_out["sha256"] != out["sha256"] or len(att) != 1
            or (att[0]["class"], att[0]["action"])
            != ("device-oom", "reduce-capacity")
            or oom_out["engines"] != ["primary"] * 4
            or oom_out["capacity_scale"] != [2, 2]
            or any(e.get("attempts") for e in o_summary["shards"][1:])):
        raise RuntimeError(f"the injected OOM did not take the "
                           f"reduce-capacity rung to the same bytes: "
                           f"{oom_out}")
    if rc != 0 or cli_sha != main["fasta_sha256"]:
        raise RuntimeError(f"--shards 1 through the CLI (rc {rc}) did not "
                           f"polish the main phase's bytes")
    return out


# -------------------------------------------- several workers, the wrapper

# The workers and wrapper phases drive the port through its entry points in
# child processes (``python -m racon_tpu_torch``, ``.wrapper``, and the
# processes those start). This ``sitecustomize`` is put on the children's
# path: at exit each child writes its kernel launches (counted from zero at
# its start), its device engines' launch shapes and divergence
# observations, its builds and its peak device bytes to
# ``$CHIP_SMOKE_HOOK_DIR/hook.<pid>.json``. A ``sitecustomize`` it shadows
# runs too.
HOOK_SOURCE = r'''
import atexit, importlib.abc, importlib.util, json, os, sys

_OUT = os.environ.get("CHIP_SMOKE_HOOK_DIR", "")
_ENGINES = []
_CLASSES = {"racon_tpu_torch.ops.nw": "CudaAligner",
            "racon_tpu_torch.ops.poa": "CudaPoaConsensus"}


def _register(cls):
    init = cls.__init__

    def __init__(self, *a, **kw):
        init(self, *a, **kw)
        _ENGINES.append(self)
    cls.__init__ = __init__


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name not in _CLASSES:
            return None
        sys.meta_path.remove(self)
        try:
            spec = importlib.util.find_spec(name)
        finally:
            sys.meta_path.insert(0, self)
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            _register(getattr(module, _CLASSES[name]))
        spec.loader.exec_module = exec_module
        return spec


def _dump():
    mods = sys.modules
    rec = {"pid": os.getpid(), "argv": sys.argv[1:]}
    nw = mods.get("racon_tpu_torch.ops.cuda_nw")
    rec["launches"] = dict(nw.LAUNCHES) if nw else {}
    al = [e for e in _ENGINES if type(e).__name__ == "CudaAligner"]
    co = [e for e in _ENGINES if type(e).__name__ == "CudaPoaConsensus"]
    rec["aligner_chunk_shapes"] = [list(x) for e in al
                                   for x in e.stats["chunk_shapes"]]
    rec["consensus_group_shapes"] = [list(x) for e in co
                                     for x in e.stats["group_shapes"]]
    rec["aligner_div_obs"] = [sum(e._div_obs[k] for e in al)
                              for k in range(3)]
    build = mods.get("racon_tpu_torch.ops._build")
    rec["nvcc_builds"] = sorted(build.build_log) if build else []
    met = mods.get("racon_tpu_torch.obs.metrics")
    rec["compile_builds"] = met.counter("compile.builds") if met else 0
    torch = mods.get("torch")
    rec["cuda_initialized"] = bool(torch is not None
                                   and torch.cuda.is_initialized())
    try:
        if torch is not None and torch.cuda.is_initialized():
            rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
            rec["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    except Exception as e:
        rec["device_error"] = repr(e)
    with open(os.path.join(_OUT, f"hook.{os.getpid()}.json"), "w") as f:
        json.dump(rec, f)


def _chain():
    here = os.path.dirname(os.path.abspath(__file__))
    for entry in sys.path:
        cand = os.path.join(entry or ".", "sitecustomize.py")
        if os.path.abspath(entry or ".") != here and os.path.isfile(cand):
            spec = importlib.util.spec_from_file_location(
                "_shadowed_sitecustomize", cand)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
            return


if _OUT:
    sys.meta_path.insert(0, _Finder())
    atexit.register(_dump)
_chain()
'''


class DeviceMemorySampler:
    """``nvidia-smi``'s memory in use on the card (MiB), sampled every
    0.25 s from :meth:`start` to :meth:`stop`: its level before and its
    peak (each child's own peak comes from its exit record)."""

    def __init__(self):
        self.samples = []
        self.errors = []
        self._stop = False
        self.baseline = self._used()

    @staticmethod
    def _used():
        return int(subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=10).stdout.split()[0])

    def _loop(self):
        while not self._stop:
            try:
                self.samples.append(self._used())
            except (OSError, ValueError, IndexError,
                    subprocess.SubprocessError) as e:
                self.errors.append(repr(e))
            time.sleep(0.25)

    def start(self):
        import threading
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop = True
        self._thread.join()
        peak = max(self.samples, default=self.baseline)
        return dict(baseline_mib=self.baseline, peak_mib=peak,
                    above_baseline_mib=peak - self.baseline,
                    samples=len(self.samples), errors=self.errors[:3])


def _child_env(hook_dir=None, **extra):
    """The smoke's environment for a child: no ``RACON_TPU_*`` setting of
    an earlier phase, the hook (if any) on the path, the checkout
    importable."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RACON_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        ([str(hook_dir)] if hook_dir else []) + [str(ROOT)]
        + [p for p in [os.environ.get("PYTHONPATH", "")] if p])
    if hook_dir:
        env["CHIP_SMOKE_HOOK_DIR"] = str(hook_dir)
    return dict(env, **extra)


def _spawn(args, cwd, env, out_path=None):
    """A child ``python -m`` run; its stdout goes to ``out_path`` (or a
    pipe), its stderr to a pipe."""
    stdout = open(out_path, "wb") if out_path else subprocess.PIPE
    try:
        # a session of its own: a child that outlives its time limit is
        # killed with the processes it started
        return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd,
                                env=env, stdout=stdout,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
    finally:
        if out_path:
            stdout.close()


def _finish(procs, timeout=300):
    """Wait for every child, then kill what is left of its session (all
    of it when a child outlives ``timeout``); (rc, stdout, stderr) of
    each."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e.decode(errors="replace")))
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, 9)
            except ProcessLookupError:
                pass
            p.wait()
    return out


def _hook_records(hook_dir) -> list:
    """The children's exit records written since the last call (and
    removes them)."""
    recs = []
    for f in sorted(pathlib.Path(hook_dir).glob("hook.*.json")):
        recs.append(json.loads(f.read_text()))
        f.unlink()
    return recs


def _merge_children(recs) -> dict:
    """One path's record from its children's: launches summed, shapes
    concatenated, divergence observations pooled."""
    launches = {k: sum(r["launches"].get(k, 0) for r in recs)
                for k in cuda_nw.LAUNCHES}
    return dict(
        processes=len(recs), launches=launches,
        aligner_chunk_shapes=[s for r in recs
                              for s in r["aligner_chunk_shapes"]],
        consensus_group_shapes=[s for r in recs
                                for s in r["consensus_group_shapes"]],
        aligner_div_obs=[sum(r["aligner_div_obs"][k] for r in recs)
                         for k in range(3)],
        nvcc_builds=sorted({b for r in recs for b in r["nvcc_builds"]}),
        compile_builds=sum(r["compile_builds"] for r in recs),
        peak_device_bytes=[r.get("peak_device_bytes") for r in recs])


def _libraries() -> dict:
    """mtime of every built library: a rebuild in a child changes one."""
    return {str(p): p.stat().st_mtime_ns
            for p in (ROOT / "build").glob("**/*.so")}


def _names(fasta: bytes) -> list:
    return [line[1:].split(None, 1)[0] for line in fasta.split(b"\n")
            if line.startswith(b">")]


def phase_workers(shards):
    """Several workers on the shards phase's inputs (see the module
    docstring)."""
    inputs = shards["inputs"]
    triple = [inputs["reads"], inputs["overlaps"], inputs["draft"]]
    base = ROOT / "build" / "smoke_workers"
    shutil.rmtree(base, ignore_errors=True)
    hook = base / "hook"
    hook.mkdir(parents=True)
    (hook / "sitecustomize.py").write_text(HOOK_SOURCE)
    gc.collect()
    torch.cuda.empty_cache()
    libs = _libraries()
    want = shards["single_sha256"]
    plan = [r["contigs"] for r in shards["shards"]]
    cli_args = ["racon_tpu_torch", "-t", "8", "-c", "1",
                "--cudaaligner-batches", "1", "--shards", "4"]
    env = _child_env(hook)

    def manifest_rows(work):
        m = exec_pkg.load_manifest(str(work))
        return [{k: e.get(k) for k in ("id", "contigs", "status", "worker",
                                       "engine", "reclaimed", "wall_s")}
                for e in m["shards"]]

    def report(path):
        rep = json.loads(pathlib.Path(path).read_text())
        return dict(kind=rep["kind"], argv=rep["argv"],
                    compile_builds=rep["compiles"]["count"],
                    align_chunks=rep["pack"]["align_chunks"],
                    consensus_groups=rep["pack"]["groups"],
                    faults=rep["faults"], wall_s=rep["wall_s"])

    # 1. --workers 2: this CLI and one secondary it starts
    mem = DeviceMemorySampler().start()
    t0 = time.perf_counter()
    (rc, _, err), = _finish([_spawn(
        [*cli_args, "--workers", "2", "--shard-dir", str(base / "w2"),
         "--run-report", str(base / "w2.json"), *triple], base, env,
        out_path=base / "w2.fasta")])
    w2_wall = time.perf_counter() - t0
    w2_mem = mem.stop()
    w2_fa = (base / "w2.fasta").read_bytes()
    w2_children = _hook_records(hook)
    w2 = dict(rc=rc, wall_s=w2_wall,
              sha256=hashlib.sha256(w2_fa).hexdigest(),
              shards=manifest_rows(base / "w2") if rc == 0 else None,
              report=report(base / "w2.json") if rc == 0 else None,
              device_memory=w2_mem,
              peak_device_bytes=[r.get("peak_device_bytes")
                                 for r in w2_children],
              stderr=err[-3000:] if rc else "")
    w2_path = _merge_children(w2_children)
    # 2. chaos: worker A kills itself at its second shard; B reclaims it
    chaos_dir = base / "chaos"
    (a_rc, _, a_err), = _finish([_spawn(
        [*cli_args, "--resume", "--shard-dir", str(chaos_dir), *triple],
        base, dict(env, RACON_TPU_FAULTS="worker.kill:kill@2",
                   RACON_TPU_WORKER="chaos-a"))])
    after_a = manifest_rows(chaos_dir)
    t0 = time.perf_counter()
    (b_rc, b_fa, b_err), = _finish([_spawn(
        [*cli_args, "--resume", "--shard-dir", str(chaos_dir),
         "--run-report", str(base / "chaos_b.json"), *triple], base,
        dict(env, RACON_TPU_WORKER="chaos-b"))])
    chaos = dict(a_rc=a_rc, b_rc=b_rc, b_wall_s=time.perf_counter() - t0,
                 after_a=[(e["id"], e["status"], e["worker"])
                          for e in after_a],
                 sha256=hashlib.sha256(b_fa).hexdigest(),
                 shards=manifest_rows(chaos_dir) if b_rc == 0 else None,
                 report=report(base / "chaos_b.json") if b_rc == 0
                 else None,
                 reclaimed_msg="reclaiming shard" in b_err,
                 stderr=b_err[-3000:] if b_rc else "")
    chaos_children = _hook_records(hook)
    # 3. two workers launched at once on an empty directory
    mem = DeviceMemorySampler().start()
    t0 = time.perf_counter()
    race_out = _finish([_spawn(
        [*cli_args, "--resume", "--shard-dir", str(base / "race"),
         "--run-report", str(base / f"race_{k}.json"), *triple], base,
        dict(env, RACON_TPU_WORKER=f"race-{k}",
             RACON_TPU_EXEC_SLEEP_S="0.5")) for k in range(2)])
    race_wall = time.perf_counter() - t0
    race_mem = mem.stop()
    race_children = _hook_records(hook)
    race = dict(rc=[r[0] for r in race_out], wall_s=race_wall,
                sha256=[hashlib.sha256(r[1]).hexdigest() for r in race_out],
                shards=manifest_rows(base / "race")
                if all(r[0] == 0 for r in race_out) else None,
                reports=[report(base / f"race_{k}.json") for k in range(2)]
                if all(r[0] == 0 for r in race_out) else None,
                device_memory=race_mem,
                peak_device_bytes=[r.get("peak_device_bytes")
                                   for r in race_children],
                stderr=[r[2][-3000:] for r in race_out if r[0]])
    path = _merge_children(w2_children + chaos_children + race_children)
    rebuilt = [k for k, v in _libraries().items() if libs.get(k) != v]
    out = dict(phase="workers", card=gpu_line(), workers2=w2, chaos=chaos,
               race=race, launches=path["launches"],
               launches_workers2=w2_path["launches"],
               processes=path["processes"], rebuilt_libraries=rebuilt,
               child_nvcc_builds=path["nvcc_builds"],
               child_compile_builds=path["compile_builds"],
               single_sha256=want, single_wall_s=shards["single_wall_s"],
               one_worker_wall_s=shards["wall_s"],
               **{k: path[k] for k in ("aligner_chunk_shapes",
                                       "consensus_group_shapes",
                                       "aligner_div_obs")})
    emit({k: v for k, v in out.items()
          if k not in ("aligner_chunk_shapes", "consensus_group_shapes")})
    if w2["rc"] != 0 or w2["sha256"] != want:
        raise RuntimeError(f"--workers 2 (rc {w2['rc']}) did not polish the "
                           f"single shot's bytes: {w2['stderr']}")
    for name, rows in (("--workers 2", w2["shards"]),
                       ("the chaos run", chaos["shards"]),
                       ("the race", race["shards"])):
        if rows is None or [r["contigs"] for r in rows] != plan or any(
                r["status"] != "done" or r["engine"] != "primary"
                for r in rows):
            raise RuntimeError(f"{name} did not run the shards phase's "
                               f"plan to done on the card: {rows}")
    if (a_rc != -9 or sorted(s for _, s, _ in chaos["after_a"])
            != ["done", "pending", "pending", "running"]
            or chaos["b_rc"] != 0 or chaos["sha256"] != want
            or sum(1 for r in chaos["shards"] if r["reclaimed"]) != 1
            or chaos["report"]["faults"].get("lease.reclaimed", 0) < 1
            or not chaos["reclaimed_msg"]):
        raise RuntimeError(f"the kill and reclaim did not end in the single "
                           f"shot's bytes: {chaos} {a_err[-2000:]}")
    if race["rc"] != [0, 0] or race["sha256"] != [want, want]:
        raise RuntimeError(f"the racing workers failed: {race}")
    reports = [w2["report"], chaos["report"], *race["reports"]]
    if (rebuilt or path["nvcc_builds"] or path["compile_builds"]
            or any(r["compile_builds"] for r in reports)):
        raise RuntimeError(f"a worker rebuilt a library: {rebuilt} "
                           f"{path['nvcc_builds']} {reports}")
    if "--exec-secondary" in w2["report"]["argv"] or w2_path["processes"] != 2:
        raise RuntimeError("the report left at --run-report is not the "
                           "primary's, or the secondary did not run")
    for name, counts in (("--workers 2", w2_path["launches"]),
                         ("the workers phase", path["launches"])):
        if min(counts[k] for k in ("nw_fwd_i16x2", "walk_ops",
                                   "walk_vote")) <= 0:
            raise RuntimeError(f"{name} missed a kernel: {counts}")
    out["names"] = [n.decode() for n in _names(w2_fa)]
    return out


def phase_wrapper(shards, workers):
    """``racon_tpu_torch.wrapper`` on the shards phase's inputs (see the
    module docstring)."""
    inputs = shards["inputs"]
    triple = [inputs["reads"], inputs["overlaps"], inputs["draft"]]
    base = ROOT / "build" / "smoke_wrapper"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    hook = ROOT / "build" / "smoke_workers" / "hook"
    env = _child_env(hook)
    libs = _libraries()
    draft = parsers.parse_fasta(inputs["draft"])
    largest = max(len(r.data) for r in draft)
    # the racon scores (the wrapper's own defaults are 5/-4/-8)
    args = ["racon_tpu_torch.wrapper", "-t", "8", "-c", "1",
            "--cudaaligner-batches", "1", "-m", "3", "-x", "-5", "-g", "-4",
            "--split", str(largest)]
    plan = rampler.plan(*triple, split_bytes=largest)
    t0 = time.perf_counter()
    (rc, fa, err), = _finish([_spawn([*args, *triple], base, env)])
    split_wall = time.perf_counter() - t0
    split_children = _hook_records(hook)
    t0 = time.perf_counter()
    (l_rc, l_fa, l_err), = _finish([_spawn(
        [*args, "--legacy-split", *triple], base, env)], timeout=600)
    legacy_wall = time.perf_counter() - t0
    legacy_children = _hook_records(hook)
    truth = {r.name: r.data for r in parsers.parse_fasta(inputs["truth"])}
    polished = {}
    for line_pair in re.findall(rb">(\S+)[^\n]*\n([^\n]*)\n", l_fa):
        polished[line_pair[0]] = line_pair[1]
    t0 = time.perf_counter()
    jobs = [(r.data, truth[r.name]) for r in draft] + [
        (polished[n], truth[n]) for n in sorted(polished) if n in truth]
    with ThreadPoolExecutor(8) as pool:
        eds = list(pool.map(lambda ab: native.edit_distance(*ab), jobs))
    ed_draft, ed_legacy = sum(eds[:len(draft)]), sum(eds[len(draft):])
    path = _merge_children(split_children + legacy_children)
    rebuilt = [k for k, v in _libraries().items() if libs.get(k) != v]
    out = dict(phase="wrapper", card=gpu_line(), split_bytes=largest,
               plan=[s["contigs"] for s in plan["shards"]],
               split=dict(rc=rc, wall_s=split_wall,
                          sha256=hashlib.sha256(fa).hexdigest(),
                          plan_line=[ln for ln in err.splitlines()
                                     if "plan:" in ln],
                          launches=_merge_children(split_children)["launches"],
                          stderr=err[-3000:] if rc else ""),
               legacy=dict(rc=l_rc, wall_s=legacy_wall,
                           processes=len(legacy_children),
                           names=[n.decode() for n in _names(l_fa)],
                           ed_draft=ed_draft, ed_polished=ed_legacy,
                           edit_distance_s=time.perf_counter() - t0,
                           launches=_merge_children(
                               legacy_children)["launches"],
                           stderr=l_err[-3000:] if l_rc else ""),
               launches=path["launches"], rebuilt_libraries=rebuilt,
               child_nvcc_builds=path["nvcc_builds"],
               child_compile_builds=path["compile_builds"],
               peak_device_bytes=path["peak_device_bytes"],
               single_sha256=shards["single_sha256"],
               **{k: path[k] for k in ("aligner_chunk_shapes",
                                       "consensus_group_shapes",
                                       "aligner_div_obs")})
    emit({k: v for k, v in out.items()
          if k not in ("aligner_chunk_shapes", "consensus_group_shapes")})
    if rc != 0 or out["split"]["sha256"] != shards["single_sha256"]:
        raise RuntimeError(f"wrapper --split (rc {rc}) did not polish the "
                           f"single shot's bytes: {err[-2000:]}")
    if sorted(len(c) for c in out["plan"]) != [1] * len(draft) or not any(
            f"-> {len(draft)} shards (mode=split)" in ln
            for ln in out["split"]["plan_line"]):
        raise RuntimeError(f"the --split plan is not one contig a shard: "
                           f"{out['plan']} {out['split']['plan_line']}")
    legacy = out["legacy"]
    if (l_rc != 0 or legacy["names"] != workers["names"]
            or not ed_legacy * 4 < ed_draft):
        raise RuntimeError(f"wrapper --legacy-split failed: {legacy}")
    # one rampler process and one CLI process a chunk, each on the card
    chunk_runs = [r for r in legacy_children if "--device" in r["argv"]]
    if len(chunk_runs) != len(draft) or any(
            min(r["launches"].get(k, 0) for k in ("nw_fwd_i16x2",
                                                  "walk_ops", "walk_vote"))
            <= 0 for r in chunk_runs + split_children):
        raise RuntimeError(f"a wrapper run missed a kernel: "
                           f"{[r['launches'] for r in legacy_children]}")
    if rebuilt or path["nvcc_builds"] or path["compile_builds"]:
        raise RuntimeError(f"a wrapper child rebuilt a library: {rebuilt}")
    return out


# ----------------------------------------------------- the resident service

def _server_proc(sock, serve_dir, log_path, env,
                 extra=("--workers", "2")):
    """A ``python -m racon_tpu_torch --serve`` child on the card: crash-safe
    in ``serve_dir`` when one is given, with ``extra``'s options (two
    slots unless they say otherwise); its stderr goes to ``log_path`` (the
    polisher's progress lines would fill a pipe)."""
    args = ["--serve-dir", str(serve_dir), *extra] if serve_dir \
        else list(extra)
    log = open(log_path, "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch", "--serve", str(sock),
             "-t", "8", "-c", "1", "--cudaaligner-batches", "1", *args],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=log,
            start_new_session=True)
    finally:
        log.close()


def _await_ping(proc, sock, timeout=180.0) -> float:
    """Seconds from now until the server answers ``ping``."""
    from racon_tpu_torch.serve.client import ServiceClient
    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"the server exited {proc.returncode} "
                               f"before its first ping")
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError("the server did not answer ping in time")
        try:
            with ServiceClient(str(sock), timeout_s=10, retries=0) as c:
                if c.ping().get("ok"):
                    return time.perf_counter() - t0
        except (OSError, ConnectionError):
            time.sleep(0.2)


def _stop_group(proc, log_path, timeout=120):
    """Wait for a server child, then kill what is left of its session. A
    child past ``timeout`` gets SIGABRT first, so its fault handler writes
    every thread's stack to its log, whose tail the error carries."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.kill(proc.pid, signal.SIGABRT)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            pass
        tail = pathlib.Path(log_path).read_text(errors="replace")[-12000:]
        raise RuntimeError(f"a server did not exit within {timeout} s; "
                           f"its log ends:\n{tail}") from None
    finally:
        try:
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
        proc.wait()
    return proc.returncode


def phase_serve(main, shards, paths):
    """The resident polishing service on the card (see the module
    docstring)."""
    import tempfile
    from racon_tpu_torch.serve.client import ServiceClient
    base = ROOT / "build" / "smoke_serve"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    hook = ROOT / "build" / "smoke_workers" / "hook"
    hook.mkdir(parents=True, exist_ok=True)
    (hook / "sitecustomize.py").write_text(HOOK_SOURCE)
    _hook_records(hook)
    libs = _libraries()
    # AF_UNIX paths end near 107 bytes: the socket lives in a short
    # temporary directory
    sock_dir = pathlib.Path(tempfile.mkdtemp(prefix="rsv"))
    sock = sock_dir / "s.sock"
    if len(str(sock)) > 100:
        raise RuntimeError(f"socket path too long for AF_UNIX: {sock}")
    # a fault handler in each server: SIGABRT dumps every thread's stack
    server_env = dict(_child_env(hook), PYTHONFAULTHANDLER="1")
    client_env = {k: v for k, v in server_env.items()
                  if k != "CHIP_SMOKE_HOOK_DIR"}
    main_triple = [paths["reads"], paths["overlaps"], paths["draft"]]
    inputs = shards["inputs"]
    four_triple = [inputs["reads"], inputs["overlaps"], inputs["draft"]]
    want_main, want_four = main["fasta_sha256"], shards["single_sha256"]
    procs = []

    def submit(name, triple):
        with open(base / f"{name}.fasta", "wb") as out:
            return subprocess.Popen(
                [sys.executable, "-m", "racon_tpu_torch", "-t", "8",
                 "--submit", str(sock), "--run-report",
                 str(base / f"{name}.json"), *triple], cwd=ROOT,
                env=client_env, stdout=out, stderr=subprocess.PIPE,
                start_new_session=True)

    def job_row(name, ok, fasta, wall, rep, want, detail=""):
        """One job's row from its FASTA and its report; the job must give
        its one-shot SHA-256, show aligner chunks and consensus groups (K4,
        K2 and K3 launched for it) and build nothing."""
        row = dict(client_wall_s=wall,
                   sha256=hashlib.sha256(fasta).hexdigest())
        if ok:
            row.update(wall_s=rep["wall_s"],
                       compile_s=rep["dispatch_fetch"]["compile_s"],
                       builds=rep["compiles"]["count"],
                       post_warm=rep["compiles"]["post_warm"],
                       align_chunks=rep["pack"]["align_chunks"],
                       consensus_groups=rep["pack"]["groups"],
                       align_dispatch_s=rep["dispatch_fetch"][
                           "align_dispatch_s"])
        if (not ok or row["sha256"] != want or row["builds"]
                or not row["align_chunks"]
                or not row["consensus_groups"]):
            raise RuntimeError(f"serve job {name} failed or differs from "
                               f"its one-shot run: {row} {detail}")
        return row

    def finish(name, proc, t0, want):
        """A ``--submit`` client's job."""
        _, err = proc.communicate(timeout=300)
        ok = proc.returncode == 0
        return job_row(
            name, ok, (base / f"{name}.fasta").read_bytes(),
            time.perf_counter() - t0,
            json.loads((base / f"{name}.json").read_text()) if ok
            else None, want,
            f"rc {proc.returncode}: {err.decode(errors='replace')[-1500:]}")

    def direct(name, triple, want, t0):
        """A job through a ``ServiceClient`` of this process."""
        spec = {"sequences": triple[0], "overlaps": triple[1],
                "target_sequences": triple[2], "threads": 8}
        with ServiceClient(str(sock), timeout_s=600) as c:
            sub = c.submit(spec)
            header, payload = c.result(sub["job"], timeout_s=550) \
                if sub.get("ok") else (sub, None)
        return job_row(name, payload is not None, payload or b"",
                       time.perf_counter() - t0, header.get("report"),
                       want, str({k: v for k, v in header.items()
                                  if k != "report"}))

    def device_lines(log_path):
        return [ln for ln in pathlib.Path(log_path).read_text(
            errors="replace").splitlines() if "device_mem=" in ln]

    try:
        # 1. the server, two slots on the card
        t0 = time.perf_counter()
        server = _server_proc(sock, base / "sd1", base / "server_a.log",
                              server_env)
        procs.append(server)
        _await_ping(server, sock)
        start_s = time.perf_counter() - t0
        # 2. two sequential jobs
        jobs = {}
        for name in ("job1", "job2"):
            t0 = time.perf_counter()
            jobs[name] = finish(name, submit(name, main_triple), t0,
                                want_main)
        # 3. two jobs at once on the two slots, from clients in this
        # process (no client process start in the pair's wall)
        mem = DeviceMemorySampler().start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            pair = [pool.submit(direct, "pair_main", main_triple,
                                want_main, t0),
                    pool.submit(direct, "pair_four", four_triple,
                                want_four, t0)]
            jobs["pair_main"], jobs["pair_four"] = (f.result()
                                                    for f in pair)
        pair_wall = time.perf_counter() - t0
        pair_mem = mem.stop()
        # 4. admission: scores the resident engines were not built for
        with ServiceClient(str(sock), timeout_s=60) as c:
            rej = c.submit({"sequences": main_triple[0],
                            "overlaps": main_triple[1],
                            "target_sequences": main_triple[2],
                            "match": 5})
            stats_a = c.stats()
            c.shutdown(mode="now")
        if rej.get("ok") or "engine profile mismatch" not in \
                rej.get("error", ""):
            raise RuntimeError(f"-m 5 was not rejected with the profile "
                               f"mismatch: {rej}")
        a_rc = _stop_group(server, base / "server_a.log")
        server_a = _hook_records(hook)
        a_mem_lines = device_lines(base / "server_a.log")
        # 5. kill at the job's start, then restart on the same directory
        kill_dir = base / "sd2"
        spec = {"sequences": paths["reads"], "overlaps": paths["overlaps"],
                "target_sequences": paths["draft"], "threads": 8}
        server = _server_proc(sock, kill_dir, base / "server_b.log",
                              dict(server_env,
                                   RACON_TPU_FAULTS="server.kill:kill@1"))
        procs.append(server)
        _await_ping(server, sock)
        with ServiceClient(str(sock), timeout_s=60) as c:
            killed_job = c.submit(spec, key="smoke-kill")
        b_rc = _stop_group(server, base / "server_b.log", timeout=300)
        journal = [json.loads(ln) for ln in (kill_dir / "journal.jsonl")
                   .read_text().splitlines() if ln.strip()]
        if b_rc != -9 or [r["rec"] for r in journal] != ["submitted",
                                                         "running"]:
            raise RuntimeError(f"server.kill:kill@1 did not kill the "
                               f"server at the job's start: rc {b_rc}, "
                               f"{journal}")
        if sock.exists():
            sock.unlink()
        t0 = time.perf_counter()
        server = _server_proc(sock, kill_dir, base / "server_c.log",
                              server_env)
        procs.append(server)
        restart_ping_s = _await_ping(server, sock)
        with ServiceClient(str(sock), timeout_s=600) as c:
            again = c.submit(spec, key="smoke-kill")
            header, payload = c.result(again["job"], timeout_s=550)
        restart_wall = time.perf_counter() - t0
        recovered = dict(
            job=killed_job.get("job"), existing=again.get("existing"),
            ok=header.get("ok"), restart_to_result_s=restart_wall,
            restart_ping_s=restart_ping_s, wall_s=header.get("wall_s"),
            attempts=header.get("attempts"),
            sha256=hashlib.sha256(payload or b"").hexdigest(),
            recovery=(header.get("report") or {}).get("recovery"),
            align_chunks=(header.get("report") or {}).get(
                "pack", {}).get("align_chunks"),
            consensus_groups=(header.get("report") or {}).get(
                "pack", {}).get("groups"),
            builds=(header.get("report") or {}).get(
                "compiles", {}).get("count"))
        if (not header.get("ok") or not again.get("existing")
                or recovered["sha256"] != want_main
                or (recovered["recovery"] or {}).get("requeued_jobs") != 1
                or not recovered["align_chunks"]
                or not recovered["consensus_groups"]
                or recovered["builds"]):
            raise RuntimeError(f"the restarted server did not recover the "
                               f"killed job: {recovered}")
        # 6. drain
        with ServiceClient(str(sock), timeout_s=60) as c:
            drain = c.shutdown(mode="drain")
        c_rc = _stop_group(server, base / "server_c.log", timeout=300)
        server_c = _hook_records(hook)
        c_mem_lines = device_lines(base / "server_c.log")
        left = (kill_dir / "journal.jsonl").read_bytes()
        spool_left = sorted(os.listdir(kill_dir / "spool"))
        if (a_rc != 0 or c_rc != 0 or drain.get("state") != "draining"
                or left or spool_left):
            raise RuntimeError(f"a server did not stop cleanly: rc "
                               f"{a_rc}/{c_rc}, {drain}, journal "
                               f"{left[:200]!r}, spool {spool_left}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, 9)
                except ProcessLookupError:
                    pass
                proc.wait()
        shutil.rmtree(sock_dir, ignore_errors=True)
    path = _merge_children(server_a + server_c)
    rebuilt = [k for k, v in _libraries().items() if libs.get(k) != v]
    out = dict(phase="serve", card=gpu_line(), start_to_ping_s=start_s,
               jobs=jobs, main_wall_s=main["wall_s"],
               job2_over_main=jobs["job2"]["wall_s"] / main["wall_s"],
               shards_single_wall_s=shards["single_wall_s"],
               pair_wall_s=pair_wall, pair_device_memory=pair_mem,
               stats=stats_a, rejected=rej.get("error"),
               recovered=recovered,
               server_device_lines=a_mem_lines + c_mem_lines,
               launches=path["launches"], processes=path["processes"],
               peak_device_bytes=path["peak_device_bytes"],
               rebuilt_libraries=rebuilt,
               child_nvcc_builds=path["nvcc_builds"],
               child_compile_builds=path["compile_builds"],
               **{k: path[k] for k in ("aligner_chunk_shapes",
                                       "consensus_group_shapes",
                                       "aligner_div_obs")})
    emit({k: v for k, v in out.items()
          if k not in ("aligner_chunk_shapes", "consensus_group_shapes")})
    if rebuilt or path["nvcc_builds"] or path["compile_builds"]:
        raise RuntimeError(f"a server rebuilt a library: {rebuilt} "
                           f"{path['nvcc_builds']}")
    if path["processes"] != 2:
        raise RuntimeError(f"expected the exit records of the two servers "
                           f"that stopped, got {path['processes']}")
    for rec in server_a + server_c:
        if min(rec["launches"].get(k, 0) for k in ("nw_fwd_i16x2",
                                                   "walk_ops",
                                                   "walk_vote")) <= 0:
            raise RuntimeError(f"a server missed a kernel: "
                               f"{rec['launches']}")
    return out


# ------------------------------------------------------------- the fleet

def _compute_apps() -> list:
    """``nvidia-smi``'s processes holding a context on the card, as
    ``pid, used_memory`` lines."""
    return [ln.strip() for ln in subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.splitlines() if ln.strip()]


def phase_fleet(main, shards, paths):
    """Two card hosts behind one gateway (see the module docstring)."""
    import tempfile
    from racon_tpu_torch.serve.client import ServiceClient
    base = ROOT / "build" / "smoke_fleet"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    fleet_dir = base / "fleet"
    hook = ROOT / "build" / "smoke_workers" / "hook"
    hook.mkdir(parents=True, exist_ok=True)
    (hook / "sitecustomize.py").write_text(HOOK_SOURCE)
    _hook_records(hook)
    libs = _libraries()
    # member names come from the sockets' basenames; AF_UNIX paths end
    # near 107 bytes, so the sockets live in a short temporary directory
    sock_dir = pathlib.Path(tempfile.mkdtemp(prefix="rfl"))
    socks = {name: sock_dir / f"{name}.sock"
             for name in ("h0", "h1", "a_wedged")}
    address = f"127.0.0.1:{_free_port()}"
    ttl = dict(RACON_TPU_FLEET_HOST_TTL_S="3")
    host_env = dict(_child_env(hook, **ttl), PYTHONFAULTHANDLER="1")
    gateway_env = dict(_child_env(hook, **ttl), PYTHONFAULTHANDLER="1",
                       RACON_TPU_FLEET_TENANTS="alpha:3,beta:1",
                       RACON_TPU_FLEET_POLL_S="0.1")
    member = ("--fleet-dir", str(fleet_dir), "--workers", "1")
    inputs = shards["inputs"]
    jobs_in = {"main": ([paths["reads"], paths["overlaps"], paths["draft"]],
                        "alpha", main["fasta_sha256"]),
               "four": ([inputs["reads"], inputs["overlaps"],
                         inputs["draft"]], "beta", shards["single_sha256"])}
    procs, logs = {}, {}

    def client(timeout_s=60):
        return ServiceClient(address, timeout_s=timeout_s, retries=0)

    def alive_hosts():
        with client() as c:
            return c.ping()["hosts"]["alive"]

    def wait_alive(n, timeout=300.0):
        t0 = time.perf_counter()
        while True:
            for name, proc in procs.items():
                if proc.poll() is not None and name not in stopped:
                    raise RuntimeError(f"fleet process {name} exited "
                                       f"{proc.returncode}: "
                                       + logs[name].read_text(
                                           errors="replace")[-3000:])
            try:
                if alive_hosts() == n:
                    return time.perf_counter() - t0
            except (OSError, ConnectionError):
                pass
            if time.perf_counter() - t0 > timeout:
                raise RuntimeError(f"the gateway never saw {n} hosts")
            time.sleep(0.2)

    def run_job(name, t0):
        """One job through the gateway from a client of this process; its
        SHA-256 must be its one-shot run's, its header must name a host,
        and its report show K4, K2 and K3 work and no build."""
        triple, tenant, want = jobs_in[name.split("_")[0]]
        spec = {"sequences": triple[0], "overlaps": triple[1],
                "target_sequences": triple[2], "threads": 8,
                "tenant": tenant}
        with ServiceClient(address, timeout_s=600) as c:
            sub = c.submit(spec)
            header, payload = c.result(sub["job"], timeout_s=550) \
                if sub.get("ok") else (sub, None)
        rep = header.get("report") or {}
        row = dict(job=sub.get("job"), tenant=tenant,
                   host=header.get("host"), wall_s=header.get("wall_s"),
                   client_wall_s=time.perf_counter() - t0,
                   migrations=header.get("migrations", 0),
                   sha256=hashlib.sha256(payload or b"").hexdigest(),
                   builds=rep.get("compiles", {}).get("count"),
                   post_warm=rep.get("compiles", {}).get("post_warm"),
                   align_chunks=rep.get("pack", {}).get("align_chunks"),
                   consensus_groups=rep.get("pack", {}).get("groups"))
        if (payload is None or row["sha256"] != want or not row["host"]
                or row["builds"] or not row["align_chunks"]
                or not row["consensus_groups"]):
            raise RuntimeError(f"fleet job {name} failed or differs from "
                               f"its one-shot run: {row} "
                               f"{ {k: v for k, v in header.items() if k != 'report'} }")
        return row

    stopped = set()
    try:
        # 1. the gateway and two card hosts, started together
        t0 = time.perf_counter()
        for name in ("h0", "h1"):
            logs[name] = base / f"{name}.log"
            procs[name] = _server_proc(socks[name], None, logs[name],
                                       host_env, member)
        logs["gateway"] = base / "gateway.log"
        with open(logs["gateway"], "ab") as log:
            procs["gateway"] = subprocess.Popen(
                [sys.executable, "-m", "racon_tpu_torch", "--gateway",
                 address, "--fleet-dir", str(fleet_dir)],
                cwd=ROOT, env=gateway_env, stdout=subprocess.DEVNULL,
                stderr=log, start_new_session=True)
        wait_alive(2)
        start_s = time.perf_counter() - t0
        apps_before = _compute_apps()
        # 2. the 1 Mbp genome (tenant alpha) and the 4-contig genome
        # (tenant beta) at once, one on each host
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(run_job, name, t0)
                    for name in ("main", "four")]
            jobs = {name: f.result() for name, f in zip(("main", "four"),
                                                        futs)}
        pair_wall = time.perf_counter() - t0
        if {jobs["main"]["host"], jobs["four"]["host"]} != {"h0", "h1"}:
            raise RuntimeError(f"the two jobs did not go one to each "
                               f"host: {jobs}")
        # 3. a third host, wedged: every polish attempt faults into a
        # 120 s backoff. Its name sorts before h1's, so with one free slot
        # each it takes the next job
        t0 = time.perf_counter()
        logs["a_wedged"] = base / "a_wedged.log"
        procs["a_wedged"] = _server_proc(
            socks["a_wedged"], None, logs["a_wedged"],
            dict(host_env, RACON_TPU_FAULTS="serve.polish:io@1*",
                 RACON_TPU_EXEC_BACKOFF_S="120"), member)
        wait_alive(3)
        wedged_start_s = time.perf_counter() - t0
        # 4. h0 stops by drain (SIGTERM): its beacon is withdrawn
        t0 = time.perf_counter()
        procs["h0"].send_signal(signal.SIGTERM)
        h0_rc = _stop_group(procs["h0"], logs["h0"], timeout=120)
        h0_drain_s = time.perf_counter() - t0
        stopped.add("h0")
        wait_alive(2)
        # 5. the 1 Mbp job goes to the wedged host; once the gateway's
        # journal shows it running there the host is SIGKILLed, and the
        # job comes back from h1
        box = {}

        def migrate_job():
            box["row"] = run_job("main_migrated", time.perf_counter())

        submit_t = time.perf_counter()
        worker = ThreadPoolExecutor(1)
        fut = worker.submit(migrate_job)
        journal = fleet_dir / "journal.jsonl"
        while True:
            recs = [json.loads(ln) for ln in journal.read_text()
                    .splitlines() if ln.strip()] if journal.exists() \
                else []
            if any(r.get("rec") == "running"
                   and r.get("host") == "a_wedged" for r in recs):
                break
            if fut.done() or time.perf_counter() - submit_t > 120:
                worker.shutdown(wait=True)
                raise RuntimeError(f"the job was never placed on the "
                                   f"wedged host: {recs[-4:]} "
                                   f"{fut.exception() if fut.done() else ''}")
            time.sleep(0.1)
        while True:
            # the host acknowledged the placement (the journal's record
            # comes before the submit)
            with client() as c:
                if c.stats().get("placed"):
                    break
            if fut.done() or time.perf_counter() - submit_t > 120:
                worker.shutdown(wait=True)
                raise RuntimeError("the wedged host never took the job")
            time.sleep(0.1)
        placed_s = time.perf_counter() - submit_t
        time.sleep(0.5)   # its first attempt faults into the backoff
        kill_t = time.perf_counter()
        os.killpg(procs["a_wedged"].pid, signal.SIGKILL)
        wedged_rc = procs["a_wedged"].wait(timeout=60)
        stopped.add("a_wedged")
        fut.result(timeout=600)
        worker.shutdown(wait=True)
        migrated = box["row"]
        migration_s = time.perf_counter() - kill_t
        if migrated["host"] != "h1" or migrated["migrations"] < 1:
            raise RuntimeError(f"the job did not migrate to h1: "
                               f"{migrated}")
        with client() as c:
            stats = c.stats()
        fleet = stats.get("fleet", {})
        if fleet.get("jobs_migrated", 0) < 1 or \
                fleet.get("hosts_dead", 0) < 1:
            raise RuntimeError(f"stats do not show the migration: "
                               f"{stats}")
        recs = [json.loads(ln) for ln in journal.read_text().splitlines()
                if ln.strip()]
        kinds = {}
        for r in recs:
            if r.get("job") == migrated["job"]:
                kinds[r["rec"]] = kinds.get(r["rec"], 0) + 1
        if kinds.get("submitted") != 1 or kinds.get("done") != 1 or \
                kinds.get("running", 0) < 2:
            raise RuntimeError(f"the migrated job's journal: {kinds}")
        apps_after = _compute_apps()
        # 6. SIGTERM: the gateway and h1 drain and exit 0
        t0 = time.perf_counter()
        for name in ("gateway", "h1"):
            procs[name].send_signal(signal.SIGTERM)
        rcs = {name: _stop_group(procs[name], logs[name], timeout=120)
               for name in ("gateway", "h1")}
        final_drain_s = time.perf_counter() - t0
        stopped.update(rcs)
        rcs.update(h0=h0_rc, a_wedged=wedged_rc)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, 9)
                except ProcessLookupError:
                    pass
                proc.wait()
        shutil.rmtree(sock_dir, ignore_errors=True)
    recs = _hook_records(hook)
    gateway_pid = procs["gateway"].pid
    gw_recs = [r for r in recs if r["pid"] == gateway_pid]
    host_recs = [r for r in recs if r["pid"] != gateway_pid]
    path = _merge_children(host_recs)
    rebuilt = [k for k, v in _libraries().items() if libs.get(k) != v]
    logs_text = {n: p.read_text(errors="replace") for n, p in logs.items()}
    out = dict(phase="fleet", card=gpu_line(), start_to_alive_s=start_s,
               jobs=dict(jobs, migrated=migrated), pair_wall_s=pair_wall,
               wedged_start_s=wedged_start_s,
               placed_on_wedged_s=placed_s, migration_s=migration_s,
               h0_drain_s=h0_drain_s, final_drain_s=final_drain_s,
               stats=stats, rcs=rcs, gateway_pid=gateway_pid,
               compute_apps_before=apps_before,
               compute_apps_after=apps_after,
               gateway_cuda_initialized=[r.get("cuda_initialized")
                                         for r in gw_recs],
               host_device_lines={n: [ln for ln in t.splitlines()
                                      if "device_mem=" in ln]
                                  for n, t in logs_text.items()},
               launches=path["launches"], processes=path["processes"],
               peak_device_bytes=path["peak_device_bytes"],
               rebuilt_libraries=rebuilt,
               child_nvcc_builds=path["nvcc_builds"],
               child_compile_builds=path["compile_builds"],
               **{k: path[k] for k in ("aligner_chunk_shapes",
                                       "consensus_group_shapes",
                                       "aligner_div_obs")})
    emit({k: v for k, v in out.items()
          if k not in ("aligner_chunk_shapes", "consensus_group_shapes")})
    if rcs != {"gateway": 0, "h1": 0, "h0": 0, "a_wedged": -9}:
        raise RuntimeError(f"a fleet process did not stop as it should: "
                           f"{rcs}")
    if "fleet member a_wedged registered" not in logs_text["a_wedged"]:
        raise RuntimeError("the wedged host never registered")
    if rebuilt or path["nvcc_builds"] or path["compile_builds"]:
        raise RuntimeError(f"a fleet host rebuilt a library: {rebuilt} "
                           f"{path['nvcc_builds']}")
    if len(gw_recs) != 1 or gw_recs[0].get("cuda_initialized") is not \
            False or any(sum(r["launches"].values()) for r in gw_recs):
        raise RuntimeError(f"the gateway touched the card: {gw_recs}")
    if any(ln.split(",")[0].strip() == str(gateway_pid)
           for ln in apps_before + apps_after):
        raise RuntimeError(f"the gateway holds a CUDA context: "
                           f"{apps_before} {apps_after}")
    if path["processes"] != 2:
        raise RuntimeError(f"expected the exit records of the two hosts "
                           f"that stopped, got {path['processes']}")
    for rec in host_recs:
        if min(rec["launches"].get(k, 0) for k in ("nw_fwd_i16x2",
                                                   "walk_ops",
                                                   "walk_vote")) <= 0:
            raise RuntimeError(f"a fleet host missed a kernel: "
                               f"{rec['launches']}")
    return out


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
    prm = chain.resolve_params()
    hits, _ = timed("join_s", lambda: chain.join_seeds(
        rt, tt, self_t, qlens, k=prm.k, max_occ=prm.max_occ, device=dev))
    timed("find_overlaps_s", lambda: chain.find_overlaps(
        reads, draft, self_t, device=dev))
    out["chain_and_emit_s"] = (out["find_overlaps_s"] - out["seed_reads_s"]
                               - out["join_s"])
    out.update(read_minimizers=int(rt[0].size),
               draft_minimizers=int(tt[0].size), hits=int(hits["q"].size))
    return out


# ------------------------------------------------------------ several cards

# the kernels the chips phase's legs must launch (the main path's, on the
# mesh path's and the chip workers' shapes)
CHIPS_KERNELS = ("nw_fwd_i16x2", "walk_ops", "walk_vote", "breaking_points")


def _shard_local(shapes, nd: int) -> list:
    """A mesh aligner's chunk shapes at the batch each shard launches:
    (max_len, band, pairs, B / nd, steps)."""
    return [(ml, bnd, c, B // nd, steps) for ml, bnd, c, B, steps in shapes]


@contextlib.contextmanager
def _local_devices(devs):
    """``topology.local_devices`` substituted by ``devs`` (restored
    after): the chip workers and the mesh of slot 0 then run on them."""
    saved = topology.local_devices
    topology.local_devices = lambda: list(devs)
    try:
        yield
    finally:
        topology.local_devices = saved


def _chips_leg(dev, name, fn):
    """One leg of the chips phase: launches counted from zero just before
    it and read just after, its wall and the card's peak bytes."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_nw.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    out.update(leg=name, wall_s=time.perf_counter() - t0,
               launches=dict(cuda_nw.LAUNCHES),
               peak_device_bytes=torch.cuda.max_memory_allocated(dev))
    return out


def _mesh_polish(dev, paths, mesh):
    """(a): the 1 Mbp polish with both engines on ``mesh``."""
    polisher = create_polisher(paths["reads"], paths["overlaps"],
                               paths["draft"], num_threads=8,
                               aligner="cuda", consensus="cuda", device=dev,
                               mesh=mesh)
    fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                     for s in polisher.run())
    al, co = polisher.aligner, polisher.consensus
    nd = len(mesh.devices)
    return dict(sha256=hashlib.sha256(fasta).hexdigest(),
                mesh=[str(d) for d in mesh.devices],
                aligner_mesh=len(al.mesh.devices),
                consensus_mesh=len(co.mesh.devices),
                aligner_chunks=al.stats["chunks"],
                aligner_pairs_device=al.stats["device"],
                consensus_groups=co.stats["groups"],
                consensus_windows_device=co.stats["device_windows"],
                aligner_chunk_shapes=_shard_local(al.stats["chunk_shapes"],
                                                  nd),
                consensus_group_shapes=list(co.stats["group_shapes"]),
                aligner_div_obs=al._div_obs)


def _chip_workers(triple, work, dev, chips):
    """(b) and (c): ``ShardRunner(chips=...)`` on ``triple``."""
    shutil.rmtree(work, ignore_errors=True)
    runner = exec_pkg.ShardRunner(*triple, num_threads=8, aligner="cuda",
                                  consensus="cuda", device=dev,
                                  work_dir=str(work), keep_work_dir=True,
                                  chips=chips)
    buf = io.BytesIO()
    summary = runner.run(buf)
    slots = runner._chip_slots()
    pinned = [s.engines for s in slots if s.engines is not None]
    meshed = [s.mesh_engines for s in slots if s.mesh_engines is not None]
    nd = len(slots)
    shapes = _engine_shapes(pinned)
    for al, co in meshed:
        shapes["aligner_chunk_shapes"] += _shard_local(
            al.stats["chunk_shapes"], nd)
        shapes["consensus_group_shapes"] += co.stats["group_shapes"]
    manifest = exec_pkg.load_manifest(str(work))
    return dict(sha256=hashlib.sha256(buf.getvalue()).hexdigest(),
                chips=summary["chips"], mode=summary["mode"],
                plan_devices=list(runner.plan.devices),
                workers=sorted({e.get("worker", "").rsplit("#", 1)[-1]
                                for e in manifest["shards"]}),
                manifest_devices=[e.get("device")
                                  for e in manifest["shards"]],
                engines=[e.get("engine") for e in manifest["shards"]],
                devices_rows={k: {m: v[m] for m in ("shards", "mbp",
                                                    "polish_s") if m in v}
                              for k, v in summary["devices"].items()},
                aligner_div_obs=(pinned or meshed)[0][0]._div_obs,
                **shapes)


def phase_chips(dev, main, shards, paths):
    """One process on several cards (see the module docstring): (a) the 1
    Mbp polish on a mesh naming this card twice, (b) two chip workers on
    the shards phase's 4-contig genome, (c) the 1 Mbp genome through two
    chip workers, whose plan mesh-marks its one dominant contig; then (a)
    and (b) over the real cards when there are several."""
    devs = [dev, dev]
    mesh = get_mesh(devices=devs)
    work = ROOT / "build" / "chips_work"
    sim = shards["inputs"]
    four = (sim["reads"], sim["overlaps"], sim["draft"])
    one = (paths["reads"], paths["overlaps"], paths["draft"])
    t0 = time.perf_counter()
    legs = [_chips_leg(dev, "mesh", lambda: _mesh_polish(dev, paths, mesh))]
    with _local_devices(devs):
        legs.append(_chips_leg(dev, "chip_workers", lambda: _chip_workers(
            four, work / "workers", dev, 2)))
        legs.append(_chips_leg(dev, "mesh_dominant", lambda: _chip_workers(
            one, work / "dominant", dev, 2)))
    n_real = torch.cuda.device_count()
    if n_real > 1:
        real = get_mesh()
        legs.append(_chips_leg(dev, "mesh_real", lambda: _mesh_polish(
            dev, paths, real)))
        legs.append(_chips_leg(dev, "chip_workers_real",
                               lambda: _chip_workers(four,
                                                     work / "workers_real",
                                                     dev, n_real)))
    out = dict(phase="chips", card=gpu_line(), devices=[str(d) for d in devs],
               real_devices=n_real,
               real_devices_run=n_real > 1,
               note=("one card: (a) and (b) ran on [cuda:0, cuda:0] only; "
                     "a second physical card's bytes are not shown"
                     if n_real < 2 else
                     f"(a) and (b) also ran over the {n_real} real cards"),
               direction_budget=nw_ops.MAX_DIRS_BYTES,
               seconds=time.perf_counter() - t0, legs=legs,
               launches={k: sum(leg["launches"][k] for leg in legs)
                         for k in cuda_nw.KERNELS},
               peak_device_bytes=max(leg["peak_device_bytes"]
                                     for leg in legs),
               aligner_chunk_shapes=[s for leg in legs
                                     for s in leg["aligner_chunk_shapes"]],
               consensus_group_shapes=[s for leg in legs
                                       for s in leg[
                                           "consensus_group_shapes"]],
               aligner_div_obs=legs[0]["aligner_div_obs"])
    emit({k: v for k, v in out.items()
          if k not in ("aligner_chunk_shapes", "consensus_group_shapes")}
         | {"legs": [{k: v for k, v in leg.items()
                      if not k.endswith("_shapes") and k != "aligner_div_obs"}
                     for leg in legs]})
    by = {leg["leg"]: leg for leg in legs}
    want = {"mesh": main["fasta_sha256"],
            "mesh_real": main["fasta_sha256"],
            "chip_workers": shards["single_sha256"],
            "chip_workers_real": shards["single_sha256"],
            "mesh_dominant": main["fasta_sha256"]}
    for leg in legs:
        if leg["sha256"] != want[leg["leg"]]:
            raise RuntimeError(f"chips phase: the {leg['leg']} leg did not "
                               f"polish the single-device bytes")
        missed = [k for k in CHIPS_KERNELS if leg["launches"][k] <= 0]
        if missed:
            raise RuntimeError(f"chips phase: the {leg['leg']} leg "
                               f"launched no {missed}")
    cw = by["chip_workers"]
    if (cw["chips"] != 2 or cw["mode"] != "chips"
            or set(cw["manifest_devices"]) != {0, 1}
            or cw["workers"] != ["chip0", "chip1"]
            or set(cw["devices_rows"]) != {"0", "1"}):
        raise RuntimeError(f"chips phase: two chip workers did not both "
                           f"run shards: {cw}")
    dom = by["mesh_dominant"]
    if (dom["plan_devices"] != [MESH_DEVICE]
            or dom["manifest_devices"] != [MESH_DEVICE]
            or "mesh" not in dom["devices_rows"]):
        raise RuntimeError(f"chips phase: the dominant contig did not run "
                           f"mesh-sharded: {dom}")
    if out["peak_device_bytes"] >= 80 * 10 ** 9:
        raise RuntimeError("chips phase: the card's peak passed 80 GB")
    # later phases time the main path with spans off (the runner's legs
    # turned them on)
    obs.trace.deactivate()
    return out


# ------------------------------------------------- several processes

# a child's limit: its start, a cold build check and the mesh polish
MULTIHOST_TIMEOUT_S = 300


def _free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_child(rank: int, world: int, port: int, out_path: str,
                    reads: str, overlaps: str, draft: str) -> int:
    """One rank of the multihost phase: join the group, polish the 1 Mbp
    inputs with no mesh given (``_auto_mesh`` engages the global mesh)
    and write this rank's record to ``out_path``."""
    parallel.distributed_init(f"127.0.0.1:{port}", world, rank)
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_nw.reset_launches()
    metrics.clear("parallel.")
    t0 = time.perf_counter()
    polisher = create_polisher(reads, overlaps, draft, num_threads=8,
                               aligner="cuda", consensus="cuda",
                               device="cuda")
    polished = polisher.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                     for s in polished)
    al, co = polisher.aligner, polisher.consensus
    nd = parallel.mesh_size(al.mesh)
    rec = dict(rank=rank, wall_s=wall_s,
               sha256=hashlib.sha256(fasta).hexdigest(),
               launches=dict(cuda_nw.LAUNCHES),
               peak_device_bytes=torch.cuda.max_memory_allocated(dev),
               gathers=dict(
                   calls=metrics.counter("parallel.gather_calls"),
                   bytes=metrics.counter("parallel.gather_bytes"),
                   seconds=metrics.timer_s("parallel.gather_s")),
               meshes=[[parallel.mesh_size(e.mesh), len(e.mesh.addressable()),
                        list(e.mesh.owners)] for e in (al, co)],
               aligner_chunks=al.stats["chunks"],
               consensus_groups=co.stats["groups"],
               aligner_chunk_shapes=_shard_local(al.stats["chunk_shapes"],
                                                 nd),
               consensus_group_shapes=list(co.stats["group_shapes"]),
               aligner_div_obs=al._div_obs)
    pathlib.Path(out_path).write_text(json.dumps(rec))
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def phase_multihost(main, paths):
    """Two processes polishing over one global mesh (see the module
    docstring)."""
    work = ROOT / "build" / "smoke_multihost"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    port = _free_port()
    env = _child_env()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-rank",
         str(rank), "2", str(port), str(work / f"rank{rank}.json"),
         paths["reads"], paths["overlaps"], paths["draft"]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True) for rank in range(2)]
    done = _finish(procs, timeout=MULTIHOST_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for rank, (rc, out, err) in enumerate(done):
        if rc != 0:
            raise RuntimeError(f"multihost phase: rank {rank} exited {rc}:"
                               f"\n{out.decode(errors='replace')[-2000:]}"
                               f"\n{err[-4000:]}")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    out = dict(phase="multihost", card=gpu_line(), seconds=seconds,
               processes=2, mesh_devices=["cuda:0", "cuda:0"],
               note=("two processes on one card, a slot each; a second "
                     "physical card and a second host are not shown"),
               ranks=[{k: v for k, v in r.items()
                       if not k.endswith("_shapes")
                       and k != "aligner_div_obs"} for r in ranks],
               launches={k: sum(r["launches"][k] for r in ranks)
                         for k in cuda_nw.KERNELS},
               peak_device_bytes=max(r["peak_device_bytes"] for r in ranks),
               aligner_chunk_shapes=[s for r in ranks
                                     for s in r["aligner_chunk_shapes"]],
               consensus_group_shapes=[s for r in ranks for s in r[
                   "consensus_group_shapes"]],
               aligner_div_obs=ranks[0]["aligner_div_obs"])
    emit({k: v for k, v in out.items()
          if k not in ("aligner_chunk_shapes", "consensus_group_shapes",
                       "aligner_div_obs")})
    for r in ranks:
        if r["sha256"] != main["fasta_sha256"]:
            raise RuntimeError(f"multihost phase: rank {r['rank']} did not "
                               f"polish the main phase's bytes")
        if r["meshes"] != [[2, 1, [0, 1]]] * 2:
            raise RuntimeError(f"multihost phase: rank {r['rank']}'s "
                               f"engines are not on the global mesh: "
                               f"{r['meshes']}")
        missed = [k for k in CHIPS_KERNELS if r["launches"][k] <= 0]
        if missed:
            raise RuntimeError(f"multihost phase: rank {r['rank']} "
                               f"launched no {missed}")
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


# chain_dp's synthetic adversarial arenas (simulate.adversarial_chain_arena),
# (S, B, k): the auto path's widest arena, one past chain.CHAIN_SMEM_SLOTS
# (its parent offsets spill to device memory), one whose S and B are not
# multiples of 16 (k None: the run's k), and one whose scores need the
# kernel's 64-bit keys ((S + 1) k GAP_UNIT >= 2^26)
CHAIN_ADVERSARIAL = ((256, 4096, None), (4096, 512, None), (40, 999, None),
                     (1024, 64, 4096))


def chain_arena_tensors(dev, seed, S, B):
    return tuple(torch.from_numpy(a).to(dev) for a in
                 adversarial_chain_arena(np.random.default_rng(seed), S, B))


def chain_entry(launched, dev) -> dict:
    """``chain_dp`` at every (S, B) of the auto path, on its own lanes,
    then on the synthetic arenas of ``CHAIN_ADVERSARIAL``: bit-exact
    against ``chain_dp_plain`` on the same card tensors, timed with CUDA
    events. The headline shape is the auto path's with the most live
    seeds."""
    rows = []
    run_k = chain.resolve_params().k
    arenas = [(ts, qs, ns, kk, "") for ts, qs, ns, kk in launched]
    for seed, (S, B, k) in enumerate(CHAIN_ADVERSARIAL, 707):
        arenas.append((*chain_arena_tensors(dev, seed, S, B),
                       run_k if k is None else k,
                       " (synthetic adversarial arena"
                       + ("" if k is None else f", k={k}") + ")"))
    for ts, qs, ns, k, label in arenas:
        B, S = ts.shape
        got = chain.chain_dp(ts, qs, ns, k=k)
        want, plain_ms = timed_once(
            lambda: chain.chain_dp_plain(ts, qs, ns, k=k))
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ms = time_ms(lambda: chain.chain_dp(ts, qs, ns, k=k), 20)
        ns_np = ns.cpu().numpy()
        bound_ms, bound_by = chain_bound(ns_np, got[:, 1].cpu().numpy())
        rows.append(dict(shape=f"S={S}, B={B}{label}", S=S, B=B,
                         live_seeds=int(ns_np.sum()), max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         synthetic=bool(label)))
    head = max((r for r in rows if not r["synthetic"]),
               key=lambda r: r["live_seeds"])
    entry = dict(head, other_shapes=[r for r in rows if r is not head])
    entry["ok"] = all(r["max_abs_err"] == 0 for r in rows)
    entry["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return entry


def chain_ab(dev, src: pathlib.Path) -> int:
    """``python3 chip_smoke.py --chain-ab SRC``: ``rt_chain_dp`` built from
    SRC (another ``chain_dp.cu`` with this tree's C entry, such as an
    earlier version unpacked under ``build/``) against this tree's, on the
    arenas of ``CHAIN_ADVERSARIAL``: both held bit for bit against
    ``chain_dp_plain``, their C entries timed with CUDA events in turns
    (other, this, this, other). One JSON line an arena, then the
    ``nvidia-smi`` line; non-zero when either disagrees. No other phase
    runs."""
    emit(dict(phase="device", nvidia_smi=gpu_line()))
    this = _build.function("rt_chain_dp")
    lib = ROOT / "build" / "chain_ab" / "libchain_dp_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", str(src),
                    "-o", str(lib)], check=True)
    other = ctypes.CDLL(str(lib)).rt_chain_dp
    other.restype = ctypes.c_int
    other.argtypes = _build.SIGNATURES["rt_chain_dp"][1]
    run_k = chain.resolve_params().k
    ok = True
    for seed, (S, B, k) in enumerate(CHAIN_ADVERSARIAL, 707):
        k = run_k if k is None else k
        ts, qs, ns = chain_arena_tensors(dev, seed, S, B)
        want = chain.chain_dp_plain(ts, qs, ns, k=k)
        parent = (torch.empty((S, B), dtype=torch.uint8, device=dev)
                  if S > chain.CHAIN_SMEM_SLOTS else None)
        outs = {n: torch.empty((B, 6), dtype=torch.int32, device=dev)
                for n in ("other", "this")}

        def run(fn, out):
            err = fn(ts.data_ptr(), qs.data_ptr(), ns.data_ptr(),
                     None if parent is None else parent.data_ptr(),
                     out.data_ptr(), B, S, k, chain.CHAIN_SMEM_SLOTS,
                     cuda_nw._stream(ts))
            if err:
                raise RuntimeError(f"rt_chain_dp: CUDA error {err}")

        fns = {"other": other, "this": this}
        for n, fn in fns.items():
            run(fn, outs[n])
        errs = {n: int((o.to(torch.int64) - want.to(torch.int64))
                       .abs().max()) for n, o in outs.items()}
        ms = [time_ms(lambda n=n: run(fns[n], outs[n]), 50)
              for n in ("other", "this", "this", "other")]
        ok = ok and not any(errs.values())
        emit(dict(phase="chain_ab", S=S, B=B, k=k,
                  live_seeds=int(ns.sum()), max_abs_err=errs,
                  other_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]]))
    print(gpu_line(), flush=True)
    return 0 if ok else 1


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
    """Breaking points on the card at every aligner bucket any path
    launched, on the pairs of its largest kernels row (``drawn``), with
    metas of a 1 Mbp draft: one launch in breaking-points mode
    (``CudaAligner._launch_chunk``: forward pass, K2, ``breaking_points``)
    finished by ``_finish_chunk_bp``, one in CIGAR mode for the same walk's
    op stream. Every accepted pair's rows must equal the host decode of
    that walk (``ops_to_cigar`` + ``decode_breaking_points_batch``), the
    accept set must be the CIGAR mode's, the kernel's tables must equal
    ``breaking_points_plain`` on the same card tensors bit for bit, and
    ``breaking_points`` on the CPU must give them too. One call of the
    wrapper must count one launch. Timed with CUDA events (``ms``, the
    plain version's ``plain_ms``) and on the CPU (``cpu_ms``). Returns the
    phase record with the kernel's entry for the kernels line (``entry``:
    the row with the most steps, the others under ``other_shapes``) and
    the largest batch held at each bucket (``held``)."""
    rows, held = [], {}
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
        _, _, n, m, (ops_d, _, _, _), _ = walked
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
        # the same op stream through the kernel and the plain version on
        # the card, and the plain version on the CPU
        first_rel, nb = window_geometry(
            np.array([mt[0] for mt in metas]), m, w)
        NW = max_len // w + 2
        host_in = [torch.from_numpy(a) for a in (n, m, first_rel, nb)]
        dev_in = [a.to(dev) for a in host_in]
        before = cuda_nw.LAUNCHES["breaking_points"]
        card = breaking_points(ops_d, *dev_in, w=w, NW=NW)
        torch.cuda.synchronize()
        launches = cuda_nw.LAUNCHES["breaking_points"] - before
        plain, plain_ms = timed_once(
            lambda: breaking_points_plain(ops_d, *dev_in, w=w, NW=NW))
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(card, plain))
        ops_h = ops_d.cpu()
        t0 = time.perf_counter()
        cpu = breaking_points(ops_h, *host_in, w=w, NW=NW)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        same_cpu = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
        ms = time_ms(lambda: breaking_points(ops_d, *dev_in, w=w, NW=NW), 20)
        B, S4 = ops_d.shape
        held[shape] = max(held.get(shape, 0), B)
        steps_all = B * S4 * 4
        bms, by = bound(steps_all * OPS_PER_BP_STEP,
                        B * S4 + 16 * B + 8 * B * NW)
        rows.append(dict(
            shape=f"aligner ({max_len}, {band}) B={B} steps={4 * S4}",
            B=B, steps=4 * S4, NW=NW, pairs=C, accepted=len(accepted),
            rows=sum(len(h) for h in host), rows_equal_host_decode=ok,
            cpu_tables_equal=same_cpu, launches_per_call=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None, cpu_ms=cpu_ms,
            host_cigar_decode_s=decode_s,
            fetched_bytes=al.stats["fetched_bytes"],
            op_stream_bytes=C * S4))
        del launched, walked, ops_d, card, plain
        torch.cuda.empty_cache()
    head = max(rows, key=lambda r: r["B"] * r["steps"])
    entry = dict(head, other_shapes=[r for r in rows if r is not head])
    entry["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    entry["ok"] = all(r["max_abs_err"] == 0 and r["launches_per_call"] == 1
                      for r in rows)
    out = dict(phase="bp", window_length=w, shapes=rows,
               ok=all(r["rows_equal_host_decode"] and r["cpu_tables_equal"]
                      for r in rows) and entry["ok"])
    emit(out)
    out["entry"], out["held"] = entry, held
    if not out["ok"]:
        raise RuntimeError("device breaking points disagree with the host "
                           "decode, the plain version or the CPU")
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
    if sys.argv[1:2] == ["--chain-ab"] and len(sys.argv) == 3:
        return chain_ab(dev, pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--multihost-rank"] and len(sys.argv) == 9:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        return multihost_child(rank, world, port, *sys.argv[5:9])
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
    record["main"], paths, main_seq = phase_main(dev)
    record["main"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["resident"] = phase_resident(dev, paths, record["main"])
    record["resident"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["main_auto"], launched, auto_seq = phase_main_auto(
        dev, paths, record["main"])
    record["main_auto"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["resident_auto"] = phase_resident_auto(dev, paths,
                                                  record["main_auto"])
    record["resident_auto"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["obs"] = phase_obs(dev, paths, record["main"], line)
    record["obs"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["shards"] = phase_shards(dev, record["main"], paths)
    record["shards"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["workers"] = phase_workers(record["shards"])
    record["workers"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["wrapper"] = phase_wrapper(record["shards"], record["workers"])
    record["wrapper"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["serve"] = phase_serve(record["main"], record["shards"], paths)
    record["serve"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["fleet"] = phase_fleet(record["main"], record["shards"], paths)
    record["fleet"]["seconds"] = time.perf_counter() - t0
    record["chips"] = phase_chips(dev, record["main"], record["shards"],
                                  paths)
    record["multihost"] = phase_multihost(record["main"], paths)
    t0 = time.perf_counter()
    record["overlap"] = phase_overlap(dev, paths)
    record["overlap"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["parse"] = phase_parse(dev, paths, zlib)
    record["parse"]["seconds"] = time.perf_counter() - t0

    accuracy = start_accuracy(paths, main_seq, auto_seq)
    del main_seq, auto_seq
    t0 = time.perf_counter()
    entries, drawn, held = phase_kernels(dev, record["main"],
                                         record["main_auto"],
                                         record["shards"],
                                         record["resident"],
                                         record["resident_auto"],
                                         record["workers"],
                                         record["wrapper"],
                                         record["serve"],
                                         record["fleet"],
                                         record["chips"],
                                         record["multihost"])
    entries["chain_dp"] = chain_entry(launched, dev)
    del launched
    record["kernels"] = dict(phase="kernels",
                             seconds=time.perf_counter() - t0,
                             kernels=entries)
    emit(record["kernels"])
    on_path = main_path_kernels(record["main"])
    missing = [k for k in on_path if record["main"]["launches"][k] <= 0]
    # the auto path: the chain DP, then the kernels its aligner and
    # consensus shapes route to
    on_auto = main_path_kernels(record["main_auto"]) | {"chain_dp"}
    missing += [f"{k} (auto)" for k in on_auto
                if record["main_auto"]["launches"][k] <= 0]
    # every shape any path launched, held at a batch at least as large
    unheld = {p: unheld_shapes(record[p], held)
              for p in ("main", "main_auto", "shards", "resident",
                        "resident_auto", "workers", "wrapper", "serve",
                        "fleet", "chips", "multihost")}
    record["kernels"]["unheld"] = unheld

    t0 = time.perf_counter()
    record["bp"] = phase_bp(dev, drawn)
    record["bp"]["seconds"] = time.perf_counter() - t0
    del drawn
    entries["breaking_points"] = record["bp"].pop("entry")
    held_bp = record["bp"].pop("held")
    # every path's aligner chunks run breaking_points at their shape
    unheld["breaking_points"] = {
        p: [sh for sh in record[p]["aligner_chunk_shapes"]
            if held_bp.get(tuple(sh[:2]), 0) < sh[3]]
        for p in unheld}
    bad = [k for k, e in entries.items() if not e["ok"]]

    record["agree"] = phase_agree(dev)
    record["profile"] = phase_profile(dev, paths)
    record["accuracy"] = phase_accuracy(record, accuracy)

    kernels = []
    for name, e in entries.items():
        source, replaces = cuda_nw.KERNELS[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=record["main_auto" if name == "chain_dp"
                            else "main"]["launches"][name],
            # the PAF main path with the sanitizer's K1 shadows
            launches_sanitized=record["obs"]["launches"][name],
            # the 4-shard run of the shards phase
            launches_shards=record["shards"]["launches"][name],
            # the child processes of the workers and wrapper phases
            launches_workers=record["workers"]["launches"][name],
            launches_wrapper=record["wrapper"]["launches"][name],
            # the two servers of the serve phase that stopped
            launches_serve=record["serve"]["launches"][name],
            # the two card hosts of the fleet phase that stopped
            launches_fleet=record["fleet"]["launches"][name],
            # the chips phase's legs: the mesh on this card twice, two
            # chip workers, the mesh-dominant plan
            launches_chips=record["chips"]["launches"][name],
            # the two ranks of the multihost phase, summed
            launches_multihost=record["multihost"]["launches"][name],
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
    if any(v for k, v in unheld.items() if k != "breaking_points") or \
            any(unheld["breaking_points"].values()):
        raise RuntimeError(f"launched shapes the kernels and bp phases did "
                           f"not hold against the plain versions: {unheld}")
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
