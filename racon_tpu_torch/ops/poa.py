"""Batched window consensus on the card (counterpart of
``racon_tpu/ops/poa.py``'s ``TpuPoaConsensus`` on one device).

Every layer of a window group is aligned to its backbone span with the
banded forward kernel, the fused walk + vote kernel emits each step's vote
address and weight, the votes accumulate into per-window matrices, and the
consensus rule picks column/insertion winners; the emitted consensus
becomes the next round's backbone on the device (:func:`refine_round`),
for up to ``rounds`` rounds (:func:`refine_loop`). Windows the device
cannot take (too few layers, oversize, no successful round) go to the host
POA engine, as in the JAX package.

The default path is the JAX default: the ragged streaming session
(:class:`_ConsensusStream`) buckets each window by its own power-of-two
lane width, greedy-fills groups against a fixed lane arena, enqueues each
full group's rounds without waiting for the card, and fetches a group
(two device-to-host copies, :func:`fetch_pack`) only when the in-flight
budget forces it or at ``finish``; groups dispatched while more work is
expected run ``STAGE_A_ROUNDS`` and then either continue in place or
repack their unconverged windows into small stage-B groups.
``use_ragged=False`` packs every window to one geometry (the padded path,
the parity oracle); both give the same bytes.

What the JAX package does for the TPU and the port does not copy: the
one-hot/int8-limb matmul vote reduction and its compaction routing (an
integer ``index_add_`` into int64 is exact in any order here) and the mesh
split (a later slice). ``reduce_capacity``
(device-OOM backpressure) halves the pair arena and the group size.
Nor does it copy the Pallas probe, the int32 retry or the refetch on a
fault: a kernel fault raises.

The resident lane ingest (``RACON_TPU_RESIDENT=1``): when every layer of
a group comes from one layer store whose packed pool the resident
dataflow left on the engine's device (``LayerStore.dev_qpw``), and no
window of the group is hand-built, :func:`pack_group` returns 16 bytes of
gather rows a pair instead of the ``[B, Lq]`` host lane block, and
:func:`gather_qpw_rows` builds the block on the device; the group counts
``lane_upload_saved_bytes`` (``2 * B * Lq``), ``dataflow.bytes_avoided``
and ``dataflow.lanes_device_groups``. Any other group gathers its lanes
on the host and counts nothing.

A group's packing is the span ``poa.pack``, its enqueued rounds
``poa.dispatch`` (and the fault site ``consensus.dispatch``), its fetch
``poa.fetch``, the stage-B repack ``poa.stage_b``; the ``consensus.*``
counters mirror ``stats``. Under the sanitizer a sampled group whose
forward passes take K4 runs its whole refine loop again from the same
state with K1, and the ten state arrays must be equal; every fetched group
passes the consensus canaries.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import cuda_nw
from .swar import use_packed16
from .. import faults, flags, obs, sanitize
from ..core.window import WindowType
from ..device import resolve
from ..obs import metrics
from ..parallel import mesh_size, partition_balanced, sharded_refine_loop
from ..params import (DEFAULT_GAP, DEFAULT_MATCH, DEFAULT_MISMATCH, PARAMS,
                      STATE_NAMES, refine_state_to_torch, upload)
from ..utils.logger import warn

BAND = PARAMS.band
K_INS = PARAMS.k_ins
GROW = PARAMS.grow
CH = PARAMS.ch
# pairs per device group (the JAX engine's group cap)
MAX_GROUP_PAIRS = 32768
# ragged lane arena: a group greedy-fills windows until its pair rows x
# lane width reach this budget (1024 lanes: the w=500 bucket's Lq)
ARENA_LANES = MAX_GROUP_PAIRS * 1024
# windows a group may hold: the vote matrices grow with the window count
MAX_GROUP_WINDOWS = 4096
# bytes of dispatched but unfetched groups (inputs and per-window state)
# before the stream fetches the oldest
MAX_INFLIGHT_BYTES = 4 * 1024 * 1024 * 1024
# rounds a group runs at full size before the stage-B decision, and the
# survivor fraction above which it continues in place instead of
# repacking its unconverged windows
STAGE_A_ROUNDS = 2
STAGE_B_MAX_SURVIVOR_FRAC = 0.5
# slots past the vote matrices that the steps casting no vote add 0 into
SPREAD = 4096
N_CODE, DEL = 4, 5   # channels 0-3 are A C G T
Q_PAD, T_PAD = 6, 7
DEFAULT_SCORES = (DEFAULT_MATCH, DEFAULT_MISMATCH, DEFAULT_GAP)

_CODE_LUT = np.full(256, N_CODE, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
_BYTE_LUT = np.frombuffer(b"ACGTN-", dtype=np.uint8)


# --------------------------------------------------------------- voting

def accumulate_votes(idx, w, ok, win_of, span_m, bg, n, score, *,
                     n_windows: int, L: int, K: int,
                     scores=DEFAULT_SCORES):
    """Per-window vote matrices from the vote stream (the result of
    ``racon_tpu.ops.poa._accumulate_votes``): for every accepted pair and
    every non-sink step, weight ``w * alpha`` (capped at 8191) adds into
    ``[win_of, idx]`` and a vote of positive weight adds 1 to its count.
    Integer ``index_add_`` into int64, then cast: exact in any order.
    Returns ``(weighted [nW, L*(1+K)*CH] float32, counts int32)``."""
    dev = idx.device
    VOT = L * (1 + K) * CH
    i64 = torch.int64
    idx64 = idx.to(i64)
    w64 = w.to(i64)
    if tuple(scores) == DEFAULT_SCORES:
        wa = w64 * 64
    else:
        # per-layer score weight alpha (q6 fixed point, 64 == 1.0)
        ms, xs, gs = scores
        col_flag = idx64 < L * CH
        ins_flag = (idx64 >= L * CH) & (idx64 < VOT)
        gaps = (ins_flag | (col_flag & ((idx64 & (CH - 1)) == DEL))) \
            .to(i64).sum(1)
        mis = torch.clamp(score.to(i64) - gaps, min=0)
        mat = torch.clamp((n.to(i64) + span_m.to(i64) - gaps) // 2 - mis,
                          min=0)
        f32 = torch.float32
        s_cli = (ms * mat + xs * mis + gs * gaps).to(f32)
        s_def = (DEFAULT_MATCH * mat + DEFAULT_MISMATCH * mis
                 + DEFAULT_GAP * gaps).to(f32)
        alpha = torch.clamp(torch.round(
            64.0 * torch.clamp(s_cli, min=0.0)
            / torch.clamp(s_def, min=1.0)).to(i64), 1, 88)
        wa = w64 * alpha[:, None]
    wa = torch.clamp(wa, max=(1 << 13) - 1)
    live = (idx64 < VOT) & ok[:, None]
    # no boolean-mask compaction (its element count is a host read): the
    # other steps add 0 past the matrices, spread over SPREAD slots so
    # their atomics do not queue on one address
    B, S = idx.shape
    sink = n_windows * VOT
    spread = sink + (torch.arange(B * S, device=dev).view(B, S)
                     & (SPREAD - 1))
    addr = torch.where(live, win_of.to(i64)[:, None] * VOT + idx64,
                       spread).reshape(-1)
    val = torch.where(live, wa, 0).reshape(-1)
    weighted = torch.zeros(sink + SPREAD, dtype=i64, device=dev)
    weighted.index_add_(0, addr, val)
    counts = torch.zeros(sink + SPREAD, dtype=i64, device=dev)
    counts.index_add_(0, addr, (val > 0).to(i64))
    return (weighted[:sink].view(n_windows, VOT).to(torch.float32),
            counts[:sink].view(n_windows, VOT).to(torch.int32))


def _fold(x):
    """Left-to-right float32 sum over the last axis: the summation order
    is fixed, so the non-integer backbone weight rounds the same way on
    every run and every device."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def consensus_kernel(weighted, unweighted, bcodes, bweights, blen,
                     ins_theta: float, del_beta: float, *, L: int, K: int):
    """Add the backbone's own votes, then pick per-column and insertion
    winners (``racon_tpu.ops.poa._consensus_kernel``). Returns ``(winner,
    coverage, ins_winner, ins_emit, ins_cov)``."""
    dev = weighted.device
    f32 = torch.float32
    nW = weighted.shape[0]
    w = weighted.reshape(nW, L * (1 + K), CH)
    uw = unweighted.reshape(nW, L * (1 + K), CH)
    ins_votes = w[:, L:, :].reshape(nW, L, K, CH)
    ins_unw = uw[:, L:, :].reshape(nW, L, K, CH)
    cols = torch.arange(L, device=dev)
    in_range = cols[None, :] < blen[:, None]
    onehot = torch.nn.functional.one_hot(bcodes.long(), CH).to(f32)
    # dummy-quality backbones still win columns with no layer votes; the
    # float32 constants are CPU scalars, which a card reads without a copy
    eps_w = torch.maximum(bweights, torch.tensor(0.01, dtype=f32))
    col_votes = w[:, :L, :] + onehot * (eps_w * in_range.to(f32))[..., None]
    col_unw = uw[:, :L, :] + (onehot * in_range[..., None].to(f32)) \
        .to(torch.int32)
    theta = torch.tensor(ins_theta, dtype=f32)
    beta = torch.tensor(del_beta, dtype=f32)

    base = col_votes[:, :, :N_CODE + 1]
    base_winner = torch.argmax(base, dim=-1)
    base_total = _fold(base)
    del_w = col_votes[:, :, DEL]
    winner = torch.where(del_w > beta * base_total, DEL, base_winner)
    coverage = col_unw.gather(-1, winner[..., None])[..., 0]
    col_total = _fold(col_votes)

    ins_base = ins_votes[:, :, :, :N_CODE + 1]
    ins_winner = torch.argmax(ins_base, dim=-1)
    ins_total = _fold(ins_base)
    ins_cov = ins_unw.gather(-1, ins_winner[..., None])[..., 0]
    ins_emit = ins_total > theta * col_total[:, :, None]
    return winner, coverage, ins_winner, ins_emit, ins_cov


# ---------------------------------------------------------- refinement

def refine_round(n, qpw, win_of, real, bg, ed, bcodes, bweights, blen,
                 covs, ever, frozen, conv, dropped, ins_theta, del_beta, *,
                 n_windows: int, max_len: int, band: int, Lb: int, K: int,
                 steps: int = 0, packed16: bool = False, Lq2: int = 0,
                 scores=DEFAULT_SCORES):
    """One refinement round (``racon_tpu.ops.poa.refine_round``): align
    every layer to its current backbone span, vote, pick winners, rebuild
    the backbone rows and remap every layer span through the emitted-column
    map. Tensors take the dtypes of ``params.STATE_DTYPES``; on CUDA
    tensors the forward pass and the walk run as kernels."""
    dev = qpw.device
    i32, i64 = torch.int32, torch.int64
    Lq = max_len
    Lq2 = Lq2 or Lq
    c = band // 2
    width = c + Lq + band
    B = qpw.shape[0]
    qcodes = (qpw & 7).to(torch.uint8)
    # converged/frozen windows stop realigning: n = m = 0
    conv_p = (conv | frozen)[win_of]
    n = torch.where(conv_p, 0, n).to(i32)
    m = torch.where(conv_p, 0, ed - bg + 1).to(i32)

    # reversed query rows ending at column c + Lq
    keep = (Lq - 1 - torch.arange(Lq, device=dev))[None, :] < n[:, None]
    core = torch.where(keep, torch.flip(qcodes, [1]), Q_PAD).to(torch.uint8)
    qrp = torch.cat([torch.full((B, c), Q_PAD, dtype=torch.uint8,
                                device=dev), core,
                     torch.full((B, band), Q_PAD, dtype=torch.uint8,
                                device=dev)], 1).contiguous()
    # target rows: the backbone from column bg, at offset c, masked to m
    cols = torch.arange(width, device=dev) - c
    src = torch.clamp(cols[None, :] + bg.to(i64)[:, None], 0, Lb - 1)
    y = bcodes[win_of].gather(1, src)
    tmask = (cols[None, :] >= 0) & (cols[None, :] < m[:, None])
    tp = torch.where(tmask, y, T_PAD).to(torch.uint8).contiguous()

    packed, score = cuda_nw.nw_fwd(qrp, tp, n, m, max_len=Lq, band=band,
                                   steps=steps, packed16=packed16)
    idx, w8, fi, fj = cuda_nw.walk_vote(
        packed, n, m, bg.to(i32).contiguous(),
        qpw[:, :Lq2].contiguous(), band=band, L=Lb, K=K, CH=CH, DEL=DEL)
    okp = (fi == 0) & (fj == 0) & (score < band // 2)
    weighted, unweighted = accumulate_votes(
        idx, w8, okp, win_of, m, bg, n, score, n_windows=n_windows, L=Lb,
        K=K, scores=scores)
    winner, coverage, ins_winner, ins_emit, ins_cov = consensus_kernel(
        weighted, unweighted, bcodes, bweights, blen, ins_theta, del_beta,
        L=Lb, K=K)
    # telemetry: rejected alignments, sweep-truncated spans, insertion
    # overflows (none here: the scatter is uncapped), executed steps
    nm = n.to(i64) + m.to(i64)
    head = torch.stack([((~okp) & real).sum(), (real & (nm > steps)).sum(),
                        torch.zeros((), dtype=i64, device=dev),
                        torch.where(real, torch.clamp(nm, max=steps),
                                    0).sum()]).to(i64)
    dropped = dropped + torch.cat(
        [head, torch.zeros(n_windows, dtype=i64, device=dev)])[None, :]

    # rebuild backbone rows from emitted columns/slots: a column's base
    # first, then its insertion slots high-to-low (the walk is backwards)
    colr = torch.arange(Lb, device=dev)[None, :]
    in_range = colr < blen[:, None]
    base_emit = (winner <= N_CODE) & in_range
    ins_e = ins_emit & in_range[:, :, None]
    ent_emit = torch.cat([base_emit[:, :, None], torch.flip(ins_e, [2])], 2)
    ent_code = torch.cat([torch.clamp(winner, 0, N_CODE)[:, :, None],
                          torch.flip(ins_winner, [2])], 2)
    ent_cov = torch.cat([coverage[:, :, None], torch.flip(ins_cov, [2])], 2)
    E = Lb * (1 + K)
    fe = ent_emit.reshape(n_windows, E).to(i64)
    pos = torch.cumsum(fe, 1) - fe
    new_len = fe.sum(1)
    c2n = pos[:, ::(1 + K)]
    epay = ((ent_cov.reshape(n_windows, E).to(i64) << 3)
            | ent_code.reshape(n_windows, E).to(i64))
    dest = torch.where(fe > 0, pos, E)
    ecomp = torch.zeros((n_windows, E + 1), dtype=i64, device=dev)
    ecomp.scatter_(1, dest, torch.where(fe > 0, epay, 0))
    nb_mat = (ecomp[:, :Lb] & 7).to(torch.uint8)
    nc_mat = (ecomp[:, :Lb] >> 3).to(i32)

    ok_upd = (~frozen) & (~conv) & (new_len > 0) & (new_len <= Lb)
    frozen = frozen | (new_len > Lb)
    same = torch.where(in_range, nb_mat == bcodes, True).all(1)
    conv = conv | (ok_upd & (new_len == blen) & same)
    bcodes = torch.where(ok_upd[:, None], nb_mat, bcodes)
    covs = torch.where(ok_upd[:, None], nc_mat, covs)
    bweights = torch.where(ok_upd[:, None], 0.0, bweights)
    ever = ever | ok_upd

    # remap layer spans through the emitted-column map
    blen_g = blen.to(i64)[win_of]
    nl_g = new_len[win_of]
    c2n_flat = c2n.reshape(-1)

    def lookup(col):
        cl = torch.minimum(col.to(i64), blen_g)
        v = c2n_flat[win_of * Lb + torch.clamp(cl, 0, Lb - 1)]
        return torch.where(cl >= blen_g, nl_g, v)

    nb = lookup(bg)
    ne = torch.maximum(nb + 1, lookup(ed.to(i64) + 1) - 1)
    nb = torch.minimum(nb, nl_g - 1)
    ne = torch.minimum(ne, nl_g - 1)
    upd_p = ok_upd[win_of]
    bg = torch.where(upd_p, nb, bg).to(i32)
    ed = torch.where(upd_p, ne, ed).to(i32)
    blen = torch.where(ok_upd, new_len, blen).to(i32)
    return (bg, ed, bcodes, bweights, blen, covs, ever, frozen, conv,
            dropped)


def refine_loop(n, qpw, win_of, real, bg, ed, bcodes, bweights, blen,
                covs, ever, frozen, conv, dropped, ins_theta, del_beta, *,
                rounds: int, early_exit: bool = True, idle=None, **kw):
    """Up to ``rounds`` refinement rounds (``racon_tpu.ops.poa.
    refine_loop``). With ``early_exit`` the loop stops once every window
    with real pairs is converged or frozen, which reads a flag back from
    the device each round; without it every round is enqueued and nothing
    is read. The two give the same state: a converged or frozen window
    refuses updates and its gated pairs (n = m = 0) emit no votes and no
    telemetry. ``idle``, an int64 scalar tensor, gains one for each round
    run after that point."""
    nW = bcodes.shape[0]
    win_real = torch.zeros(nW, dtype=torch.int32, device=bcodes.device) \
        .index_add_(0, win_of, real.to(torch.int32)) > 0
    state = (bg, ed, bcodes, bweights, blen, covs, ever, frozen, conv,
             dropped)
    for _ in range(rounds):
        done = (state[7] | state[8] | ~win_real).all()
        if early_exit and bool(done):
            break
        if idle is not None:
            idle += done
        state = refine_round(n, qpw, win_of, real, *state, ins_theta,
                             del_beta, **kw)
    return state


def fetch_pack(bcodes, blen, covs, ever, frozen, conv, dropped, bg, ed,
               idle):
    """A group's results as two tensors, fetched with two copies
    (``racon_tpu.ops.poa._fetch_pack``): ``mat = covs << 3 | bcodes``
    int32 ``[nWp, Lb]`` and ``meta`` int64, the concatenation of ``blen,
    ever, frozen, conv`` (``nWp`` each), ``dropped`` (``4 + nWp``), ``bg,
    ed`` (``B`` each) and ``idle``."""
    i64 = torch.int64
    mat = (covs << 3) | bcodes.to(torch.int32)
    meta = torch.cat([blen.to(i64), ever.to(i64), frozen.to(i64),
                      conv.to(i64), dropped.reshape(-1), bg.to(i64),
                      ed.to(i64), idle.reshape(1)])
    return mat, meta


def gather_qpw_rows(pool: torch.Tensor, src0: torch.Tensor,
                    lens: torch.Tensor, Lq: int) -> torch.Tensor:
    """A group's ``[B, Lq]`` int16 ``weight << 3 | code`` lane block
    gathered from the device-resident pool (``racon_tpu.ops.poa.
    _gather_qpw_rows``; plain PyTorch on the pool's device): pair ``b``
    reads ``pool[src0[b] + min(pos, max(lens[b] - 1, 0))]`` and is zero
    from ``lens[b]`` on, so the block is bit for bit the host's
    ``LayerStore.gather_qpw`` (a dead pair, ``lens`` 0, reads slot
    ``src0`` and keeps zeros). The index is int64: JAX's int32 ``src0``
    wraps on a pool past 2^31 elements, where the port stays exact.
    Bound: ``2 * B * Lq`` bytes written, the pairs' pool spans and 16
    bytes a pair read."""
    pos = torch.arange(Lq, dtype=torch.int64, device=pool.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    idx = src0.to(torch.int64)[:, None] + torch.minimum(
        pos, torch.clamp(lens - 1, min=0))
    return torch.where(pos < lens, pool[idx],
                       torch.zeros((), dtype=pool.dtype, device=pool.device))


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t`` lies on ``dev`` (an unindexed ``cuda`` is the current
    card)."""
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda":
        return True
    want = dev.index if dev.index is not None else torch.cuda.current_device()
    return t.device.index == want


# ---------------------------------------------------------------- engine

class _Work:
    """Per-window packing view (layers capped at ``max_depth``): columnar
    windows keep row indices into their layer store, hand-built windows
    keep their bytes layers."""

    __slots__ = ("win", "backbone", "bqual", "layers", "n_seqs", "store",
                 "rows", "lens", "begins", "ends", "n_layers",
                 "max_layer_len")

    def __init__(self, win, max_depth, stats):
        self.win = win
        self.backbone = win.backbone
        self.bqual = win.backbone_quality
        total = win.layer_count
        over = total - max_depth
        if over > 0:
            stats["dropped_layers"] += over
            metrics.inc("consensus.dropped_layers", over)
        depth = min(total, max_depth)
        self.n_seqs = total + 1
        self.n_layers = depth
        store, r0, _ = win.layer_view
        self.store = store
        if store is not None:
            self.rows = np.arange(r0, r0 + depth, dtype=np.int64)
            self.lens = store.length[r0:r0 + depth]
            self.begins = store.begin[r0:r0 + depth]
            self.ends = store.end[r0:r0 + depth]
            self.layers = None
        else:
            self.layers = []  # (seq, qual, begin, end)
            for li in range(1, depth + 1):
                b, e = win.positions[li]
                self.layers.append((win.sequences[li], win.qualities[li],
                                    b, e))
            self.lens = np.array([len(s) for s, _, _, _ in self.layers],
                                 np.int64)
            self.begins = np.array([b for _, _, b, _ in self.layers],
                                   np.int64)
            self.ends = np.array([e for _, _, _, e in self.layers],
                                 np.int64)
            self.rows = None
        self.max_layer_len = int(self.lens.max()) if depth else 0


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < max(1, x):
        p *= 2
    return p


def bucket_geometry(band0: int, max_bb: int):
    """(band, L, Lq, Lb) from the longest backbone: the band scales with
    the window length, Lq = L + band query lanes, Lb = L + GROW backbone
    columns (``TpuPoaConsensus._bucket_geometry``)."""
    band = min(band0 * -(-max_bb // 512), 4096)
    max_dev_L = (1 << 18) // (K_INS * CH) - GROW
    L = max(256, min(-(-max_bb // 256) * 256, max_dev_L))
    Lq = L + band
    Lb = min(L + GROW, Lq)
    return band, L, Lq, Lb


def sweep_geometry(Lq: int, max_nm: int, max_n: int):
    """(steps, Lq2): the sweep bound and the vote kernel's query width,
    multiples of 128 (``TpuPoaConsensus._sweep_geometry``)."""
    steps = -(-min(-(-max_nm // 128) * 128, 2 * Lq) // 128) * 128
    Lq2 = min(Lq, -(-max_n // 128) * 128)
    return steps, Lq2


def pack_group(items, Lq: int, Lb: int, overrides=None, allow_dev=None,
               B: Optional[int] = None, nWp: Optional[int] = None):
    """Pack one group's windows into the refine-loop state as numpy arrays
    (``TpuPoaConsensus._pack_shard``): pair rows padded to a power of two
    (or to ``B``) vote into the sink window ``nWp - 1`` (``nWp`` a power of
    two above the window count, unless given: the shards of a mesh group
    pack to the largest shard's sizes). ``overrides`` (a stage-B
    repack) maps a window's result index to its fetched stage-A state
    ``(bcodes row, blen, covs row, ever, bg, ed)``, so it resumes from its
    refined backbone and remapped spans. Returns ``(state, B, nWp)`` with
    ``state`` keyed by ``params.STATE_NAMES``.

    ``allow_dev`` is the device the group will run on, or None. When it
    is given, every layer of the group comes from one layer store whose
    ``dev_qpw`` lies on it, and no window is hand-built, the lanes are
    not gathered on the host: ``state["qpw"]`` is None and
    ``state["qpw_rows"]`` is ``(dev_qpw, src0, lens)``, full-``B`` int64
    gather rows for :func:`gather_qpw_rows` (zeros past the real pairs);
    ``_pack_shard(allow_dev=True)`` in the JAX package."""
    counts = np.array([w.n_layers for _, w in items], np.int64)
    k = int(counts.sum())
    B = _pow2_at_least(k) if B is None else B
    nWp = _pow2_at_least(len(items) + 1) if nWp is None else nWp
    by_store = {}
    legacy = []
    for wi, (_, w) in enumerate(items):
        if not w.n_layers:
            continue
        if w.store is not None:
            by_store.setdefault(id(w.store), []).append(wi)
        else:
            legacy.append(wi)
    dev_store = None
    if allow_dev is not None and len(by_store) == 1 and not legacy:
        store = items[next(iter(by_store.values()))[0]][1].store
        if store.dev_qpw is not None and _on_device(store.dev_qpw,
                                                    allow_dev):
            dev_store = store
    n = np.ones(B, np.int32)
    qpw = None if dev_store is not None else np.zeros((B, Lq), np.uint16)
    qpw_rows = None
    bg = np.zeros(B, np.int32)
    ed = np.zeros(B, np.int32)
    win_of = np.full(B, nWp - 1, np.int64)
    real = np.zeros(B, bool)
    if k:
        offs = np.zeros(len(items) + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        lens = np.concatenate([w.lens for _, w in items])
        bb_len = np.repeat([len(w.backbone) for _, w in items], counts)
        n[:k] = lens
        bg[:k] = np.minimum(np.concatenate([w.begins for _, w in items]),
                            bb_len - 1)
        ed[:k] = np.minimum(np.concatenate([w.ends for _, w in items]),
                            bb_len - 1)
        win_of[:k] = np.repeat(np.arange(len(items)), counts)
        real[:k] = True
        for wis in by_store.values():
            store = items[wis[0]][1].store
            rows = np.concatenate([items[wi][1].rows for wi in wis])
            dest = np.concatenate(
                [np.arange(offs[wi], offs[wi + 1]) for wi in wis])
            if store is dev_store:
                # 16 bytes of gather rows a pair, not 2 * Lq of lanes
                src0 = np.zeros(B, np.int64)
                lens_full = np.zeros(B, np.int64)
                src0[dest] = store.src[rows]
                lens_full[dest] = store.length[rows]
                qpw_rows = (store.dev_qpw, src0, lens_full)
            else:
                qpw[dest] = store.gather_qpw(rows, Lq)
        if legacy:
            lay = [(s, q) for wi in legacy
                   for s, q, _, _ in items[wi][1].layers]
            cat = np.frombuffer(b"".join(s for s, _ in lay), np.uint8)
            codes_cat = _CODE_LUT[cat]
            llens = np.array([len(s) for s, _ in lay], np.int64)
            starts = np.concatenate(([0], np.cumsum(llens)[:-1]))
            pos = np.arange(Lq)[None, :]
            valid = pos < llens[:, None]
            src = starts[:, None] + np.minimum(pos, llens[:, None] - 1)
            qual_cat = np.frombuffer(
                b"".join((q if q is not None else b"\x22" * len(s))
                         for s, q in lay), np.uint8)
            # phred-33 weights (clipped at 0), or 1 for no-quality layers
            weights = np.maximum(qual_cat[src].astype(np.int16) - 33, 0)
            has_q = np.array([q is not None for _, q in lay])
            weights = np.where(has_q[:, None], weights, 1)
            dest = np.concatenate(
                [np.arange(offs[wi], offs[wi + 1]) for wi in legacy])
            qpw[dest] = np.where(
                valid, (weights.astype(np.uint16) << 3) | codes_cat[src],
                0).astype(np.uint16)

    bcodes = np.zeros((nWp, Lb), np.uint8)
    bweights = np.zeros((nWp, Lb), np.float32)
    blen = np.zeros(nWp, np.int32)
    for wi, (_, w) in enumerate(items):
        bb = w.backbone
        bcodes[wi, :len(bb)] = _CODE_LUT[np.frombuffer(bb, np.uint8)]
        if w.bqual is not None:
            # x64: layer votes carry the q6 alpha scale (64 == 1.0)
            bweights[wi, :len(bb)] = 64.0 * (
                np.frombuffer(w.bqual, np.uint8).astype(np.float32) - 33.0)
        blen[wi] = len(bb)
    covs = np.zeros((nWp, Lb), np.int32)
    ever = np.zeros(nWp, bool)
    if overrides:
        off = 0
        for wi, (ri, w) in enumerate(items):
            kw = w.n_layers
            st = overrides.get(ri)
            if st is not None:
                st_bc, st_bl, st_cov, st_ever, st_bg, st_ed = st
                bcodes[wi] = st_bc
                blen[wi] = st_bl
                covs[wi] = st_cov
                ever[wi] = st_ever
                if st_ever:
                    bweights[wi] = 0.0   # a refined backbone has no phred
                bg[off:off + kw] = st_bg
                ed[off:off + kw] = st_ed
            off += kw
    state = {"n": n, "qpw": qpw, "win_of": win_of, "real": real, "bg": bg,
             "ed": ed, "bcodes": bcodes, "bweights": bweights,
             "blen": blen, "covs": covs, "ever": ever,
             "frozen": np.zeros(nWp, bool), "conv": np.zeros(nWp, bool),
             "dropped": np.zeros((1, 4 + nWp), np.int64)}
    if qpw_rows is not None:
        state["qpw_rows"] = qpw_rows
    return state, B, nWp


class _ConsensusStream:
    """Ragged streaming consensus session (``racon_tpu.ops.poa.
    _ConsensusStream``).

    Windows arrive through :meth:`feed` in any number of batches; live
    windows bucket by the power-of-two lane width their own backbone and
    layers need (:meth:`_bucket_L`), and every bucket greedy-fills groups
    against the ``ARENA_LANES`` pair arena. A full group is dispatched the
    moment it closes: packed, uploaded through pinned memory and its
    rounds enqueued, with nothing read back. Groups are fetched only when
    the in-flight byte budget forces it or at :meth:`finish`.

    The band is frozen at the first dispatch from the windows seen so far
    and the caller's ``band_hint``, with the padded path's reject caps
    from the same moment: the band changes alignment outcomes (the
    ``score < band // 2`` accept gate), so a window's consensus must not
    depend on the batch it came in. Windows are independent and the vote
    accumulation is exact, so the bytes equal the padded path's.

    Groups dispatched while more work is expected (or a bucket's later
    groups) run ``STAGE_A_ROUNDS`` and collect their unconverged windows;
    :meth:`finish` repacks each bucket's stragglers into stage-B groups.
    A bucket whose only group is its last runs the full round budget."""

    def __init__(self, eng: "CudaPoaConsensus", trim: bool,
                 band_hint: int = 0):
        self.eng = eng
        self.trim = trim
        self.band_hint = band_hint
        self.windows: List = []            # every fed window, feed order
        self.results: List[Optional[bool]] = []
        self.buffer: List = []             # live works awaiting the band
        self.buffered_pairs = 0
        self.max_bb_live = 0
        self.band: Optional[int] = None    # frozen at first dispatch
        self._Lq_pad = 0                   # padded-path reject caps, set
        self._Lb_pad = 0                   # when the band freezes
        self.pending: dict = {}            # bucket L -> [(slot, work)]
        self.bucket_state: dict = {}       # bucket L -> {groups,steps,Lq2}
        self.survivors: dict = {}          # bucket L -> stage-B collect
        self.inflight: List[dict] = []
        self.inflight_bytes = 0
        self.fetched = 0
        self.progress = None
        self._done = False
        self._dropped_before = eng.stats["dropped_layers"]

    def feed(self, windows) -> None:
        """Add a window range; packs and dispatches every group that
        fills. Only the in-flight byte budget makes it wait on the
        device."""
        if self._done:
            raise RuntimeError("stream already finished")
        eng = self.eng
        for win in windows:
            self.windows.append(win)
            if win.layer_count + 1 < 3:
                win.consensus = win.backbone
                self.results.append(False)
                eng.stats["passthrough"] += 1
                continue
            self.results.append(None)      # host fallback unless a group
            slot = len(self.results) - 1   # on the device resolves it
            w = _Work(win, eng.max_depth, eng.stats)
            if w.n_layers < 2:
                continue
            self.buffer.append((slot, w))
            self.buffered_pairs += w.n_layers
            self.max_bb_live = max(self.max_bb_live, len(w.backbone))
        self._flush(final=False)

    def _bucket_L(self, w: _Work, band: int) -> Optional[int]:
        """The window's power-of-two lane-width bucket, or None when it
        exceeds every device bucket (host fallback, the padded path's
        reject set)."""
        max_dev_L = (1 << 18) // (K_INS * CH) - GROW
        bb = len(w.backbone)
        if bb > max_dev_L:
            # the padded geometry admits backbones into the GROW margin at
            # the device ceiling (bb <= Lb = min(L + GROW, L + band))
            if bb > max_dev_L + min(GROW, band):
                return None
            bb = max_dev_L
        return self.eng.bucket_L_for(max(256, bb, w.max_layer_len - band))

    def _flush(self, final: bool) -> None:
        eng = self.eng
        if self.band is None:
            # freeze once a group's worth of work is buffered (or at
            # finish): one feed of everything sees its global maximum
            if not self.buffer:
                return
            if not final and self.buffered_pairs < eng.group_pairs_cap:
                return
            max_bb = max(self.max_bb_live, self.band_hint)
            self.band, _, self._Lq_pad, self._Lb_pad = bucket_geometry(
                eng.band, max_bb)
            eng.stats["band"] = self.band
        band = self.band
        for slot, w in self.buffer:
            if (w.max_layer_len > self._Lq_pad
                    or len(w.backbone) > self._Lb_pad):
                continue                   # host fallback (results None)
            L = self._bucket_L(w, band)
            if L is None:
                continue
            self.pending.setdefault(L, []).append((slot, w))
        self.buffer = []
        self.buffered_pairs = 0

        for L in list(self.pending):
            items = self.pending[L]
            cap = eng.cap_pairs_for(L, band)
            while items:
                total = sum(w.n_layers for _, w in items)
                if (total < cap and len(items) <= MAX_GROUP_WINDOWS
                        and not final):
                    break                  # wait for more windows
                group: List = []
                pairs = 0
                while items and len(group) < MAX_GROUP_WINDOWS:
                    _, w = items[0]
                    if group and pairs + w.n_layers > cap:
                        break
                    pairs += w.n_layers
                    group.append(items.pop(0))
                self._dispatch(L, group,
                               more_expected=bool(items) or not final)
            if not items:
                del self.pending[L]

    def _dispatch(self, L: int, group: List, more_expected: bool) -> None:
        eng = self.eng
        band = self.band
        Lq = L + band
        Lb = min(L + GROW, Lq)
        max_nm = max(
            int(np.max(w.lens + np.minimum(w.ends - w.begins + 65, Lb)))
            for _, w in group)
        max_n = max(w.max_layer_len for _, w in group)
        steps, Lq2 = sweep_geometry(Lq, max_nm, max_n)
        bk = self.bucket_state.setdefault(
            L, {"groups": 0, "steps": 0, "Lq2": 0})
        bk["steps"] = max(bk["steps"], steps)
        bk["Lq2"] = max(bk["Lq2"], Lq2)
        two_stage = (eng.rounds > STAGE_A_ROUNDS
                     and (more_expected or bk["groups"] > 0))
        la = eng._dispatch_group(
            group, (Lq, Lb, steps, Lq2), band,
            STAGE_A_ROUNDS if two_stage else eng.rounds,
            "A" if two_stage else "full")
        la["bucket"] = L
        # resident bytes of the launch (packed pair inputs, per-window
        # state and fetch arrays): the in-flight budget's unit
        la["bytes"] = (2 * Lq + 24) * la["B"] + 16 * Lb * la["nWp"]
        bk["groups"] += 1
        self.inflight.append(la)
        self.inflight_bytes += la["bytes"]
        while (len(self.inflight) > eng.num_batches
               and self.inflight_bytes > MAX_INFLIGHT_BYTES):
            self._finish_oldest()

    def _finish_oldest(self) -> None:
        la = self.inflight.pop(0)
        self.inflight_bytes -= la["bytes"]
        collect = (self.survivors.setdefault(la["bucket"], [])
                   if la["stage"] == "A" else None)
        self.eng._finish_group(la, self.trim, self.results, collect=collect)
        self.fetched += 1
        if self.progress is not None:
            self.progress(self.fetched, self.fetched + len(self.inflight)
                          + 1)

    def finish(self, progress=None) -> List[bool]:
        """Dispatch the partial groups, drain the in-flight groups, run
        stage B per bucket and the host fallback; flags for every fed
        window, in feed order."""
        if self._done:
            raise RuntimeError("stream already finished")
        self._done = True
        eng = self.eng
        if progress is not None:
            self.progress = progress
        self._flush(final=True)
        while self.inflight:
            self._finish_oldest()
        for L, surv in self.survivors.items():
            if surv:
                Lq = L + self.band
                bk = self.bucket_state[L]
                eng._run_stage_b(surv, self.trim, self.results,
                                 (Lq, min(L + GROW, Lq), bk["steps"],
                                  bk["Lq2"]), self.band)
        eng._host_fallback(self.windows, self.results, self.trim)
        if self.progress is not None:
            self.progress(1, 1)
        eng._warn_dropped(self._dropped_before)
        return [bool(r) for r in self.results]


class CudaPoaConsensus:
    """Batched device consensus with host fallback for rejected windows
    (counterpart of ``racon_tpu.ops.poa.TpuPoaConsensus``). ``run`` goes
    through the ragged stream (:meth:`stream`) unless ``use_ragged`` is
    False (default ``RACON_TPU_RAGGED``) or a ``mesh`` is given: then it
    packs every window to one geometry in groups of at most
    ``MAX_GROUP_PAIRS`` pairs binned by :func:`partition_balanced`, each
    running the full round budget (the padded path, the parity oracle).
    Under a mesh each group's windows are binned over the mesh's devices
    and its rounds run through :func:`racon_tpu_torch.parallel.
    sharded_refine_loop`. ``device`` pins the engine to one device instead
    (``cuda``, the default, is the current card); ``pinned`` marks a chip
    worker's engine, whose groups never gather their lanes from a layer
    store's device pool (as a JAX engine with a device). Windows are
    independent, so neither the path nor the grouping changes a byte.

    Every group goes through :meth:`_launch_group` (pack, pinned upload),
    :meth:`_rounds` (its rounds enqueued; on a card nothing is read back)
    and :meth:`_finish_group` (the one place that waits for the device:
    two copies, the stage-A decision, decoding)."""

    # pipelined-polish range sizing (Polisher.run): about one group's
    # worth of layer pairs per range
    group_pairs_hint = MAX_GROUP_PAIRS

    def __init__(self, match: int, mismatch: int, gap: int, fallback=None,
                 band: int = BAND, num_batches: int = 1,
                 rounds: int = PARAMS.rounds, use_ragged=None,
                 device=None, mesh=None, pinned: bool = False):
        if mesh is not None and device is not None:
            raise ValueError("a consensus engine takes a mesh or a device "
                             "pin, not both")
        self.mesh = mesh
        self.pinned = pinned
        # the home device: uploads land here, a mesh group's merged state
        # comes back here
        self.device = resolve(mesh.devices[0] if mesh is not None
                              else "cuda" if device is None else device)
        self.fallback = fallback
        self.max_depth = PARAMS.max_depth
        self.band = band
        self.rounds = rounds
        self.use_ragged = (flags.get_bool("RACON_TPU_RAGGED")
                           if use_ragged is None else use_ragged)
        self.ins_theta, self.del_beta = PARAMS.thresholds(match, gap)
        self.scores = (match, mismatch, gap)
        self.num_batches = max(1, num_batches)
        # lanes_occupied / lanes_total: real layer lanes of every launched
        # pair arena over its padded B x Lq; group_shapes: (Lq, band, real
        # pairs, B, steps, rounds, stage) of every enqueued loop, stage A,
        # in_place (a stage-A group's remaining rounds), B or full;
        # rounds_after_converged: rounds a group ran once all its windows
        # were converged or frozen (no-ops the loop runs without its exit
        # test)
        self.stats = {"device_windows": 0, "fallback_windows": 0,
                      "dropped_layers": 0, "sweep_truncated": 0,
                      "ins_overflow": 0, "passthrough": 0,
                      "stage_b_windows": 0,
                      "wavefront_steps": 0, "lanes_occupied": 0,
                      "lanes_total": 0, "groups": 0, "group_windows": 0,
                      "rounds_after_converged": 0, "group_shapes": [],
                      "lane_upload_saved_bytes": 0}
        # the per-window attribution of stats["ins_overflow"], keyed by
        # result index, from the fetched tail of ``dropped`` (the JAX
        # engine's; kept out of ``stats``, as there)
        self.ins_overflow_by_window: dict = {}
        # the sanitizer's pick of the K4 groups it shadows with K1
        self._shadow = sanitize.ShadowSampler()
        # device-OOM backpressure: the shard runner's ladder doubles this
        # (reduce_capacity) and re-dispatches; 1 is full capacity
        self.capacity_scale = 1

    # groups stop shrinking here: a 16x cut is already 94% of the working
    # set, and smaller groups would pay their fixed costs (the fetch)
    # over too few pairs
    _MAX_CAPACITY_SCALE = 16

    @property
    def group_pairs_cap(self) -> int:
        """Pairs per device group under the backpressure scale
        (``MAX_GROUP_PAIRS`` at 1), floored at 2048 (never above the
        configured cap)."""
        return max(min(2048, MAX_GROUP_PAIRS),
                   MAX_GROUP_PAIRS // self.capacity_scale)

    @property
    def arena_lanes_cap(self) -> int:
        """The ragged lane-arena budget under the backpressure scale
        (``ARENA_LANES`` at 1), floored at 2048 * 1024 lanes (never above
        the configured arena)."""
        return max(min(2048 * 1024, ARENA_LANES),
                   ARENA_LANES // self.capacity_scale)

    def reduce_capacity(self) -> bool:
        """Halve the pair arena and the group size (device-OOM
        backpressure, the shard runner's ``reduce-capacity`` rung). False
        once at ``_MAX_CAPACITY_SCALE``. Windows are independent and the
        vote accumulation is exact, so smaller groups polish the same
        bytes."""
        if self.capacity_scale >= self._MAX_CAPACITY_SCALE:
            return False
        self.capacity_scale *= 2
        metrics.set_gauge("consensus.capacity_scale", self.capacity_scale)
        metrics.inc("faults.backpressure_halvings")
        return True

    def cap_pairs_for(self, L: int, band: int) -> int:
        """Greedy-fill pair budget of a ragged bucket: the lane arena over
        the bucket's lane width, so short windows pack more pairs."""
        return max(2048, min(self.arena_lanes_cap // (L + band),
                             4 * self.group_pairs_cap))

    @staticmethod
    def bucket_L_for(L_req: int) -> Optional[int]:
        """The smallest power-of-two lane width >= ``L_req`` (at least
        256), capped at the device's insertion-payload ceiling; None when
        it cannot fit."""
        max_dev_L = (1 << 18) // (K_INS * CH) - GROW
        L = 256
        while L < L_req:
            if L >= max_dev_L:
                return None
            L = min(L * 2, max_dev_L)
        return L

    # -------------------------------------------------------------- public

    def run(self, windows, trim: bool, progress=None) -> List[bool]:
        if self.use_ragged and self.mesh is None:
            sess = self.stream(trim)
            sess.feed(windows)
            return sess.finish(progress=progress)
        before = self.stats["dropped_layers"]
        out = self._run_padded(windows, trim, progress)
        self._warn_dropped(before)
        return out

    def stream(self, trim: bool, band_hint: int = 0):
        """Open a ragged streaming session: ``feed()`` dispatches full
        groups as window ranges arrive, ``finish()`` drains them, runs
        stage B and the host fallback and returns the flags of every fed
        window in feed order. None without ``use_ragged`` or under a mesh
        (callers then make one :meth:`run` call a range). ``band_hint``
        bounds the backbone length when the band freezes before every
        window is fed."""
        if not self.use_ragged or self.mesh is not None:
            return None
        return _ConsensusStream(self, trim, band_hint)

    def _warn_dropped(self, before: int) -> None:
        d = self.stats["dropped_layers"] - before
        if d > 0:
            warn(f"consensus: {d} layer alignments dropped this run "
                 f"(voting depth cap {self.max_depth} and/or rejected "
                 f"alignments) — see consensus stats dropped_layers")

    def _host_fallback(self, windows, results, trim) -> None:
        """Every window still without a result goes to the host engine."""
        cpu_idx = [i for i, r in enumerate(results) if r is None]
        if not cpu_idx:
            return
        self.stats["fallback_windows"] += len(cpu_idx)
        metrics.inc("consensus.fallback_windows", len(cpu_idx))
        if self.fallback is None:
            raise RuntimeError(
                f"{len(cpu_idx)} windows rejected, no host fallback")
        flags = self.fallback.run([windows[i] for i in cpu_idx], trim)
        for i, f in zip(cpu_idx, flags):
            results[i] = f

    def _run_padded(self, windows, trim: bool, progress=None) -> List[bool]:
        results: List[Optional[bool]] = [None] * len(windows)
        works = []
        for i, win in enumerate(windows):
            if win.layer_count + 1 < 3:
                win.consensus = win.backbone
                results[i] = False
                self.stats["passthrough"] += 1
            else:
                works.append((i, _Work(win, self.max_depth, self.stats)))
        live = [(i, w) for i, w in works if w.n_layers >= 2]
        if live:
            max_bb = max(len(w.backbone) for _, w in live)
            band, L, Lq, Lb = bucket_geometry(self.band, max_bb)
            self.stats["band"] = band
            live = [(i, w) for i, w in live
                    if w.max_layer_len <= Lq and len(w.backbone) <= Lb]
        if live:
            max_nm = max(int(np.max(w.lens + np.minimum(
                w.ends - w.begins + 65, Lb))) for _, w in live)
            max_n = max(w.max_layer_len for _, w in live)
            geom = (Lq, Lb) + sweep_geometry(Lq, max_nm, max_n)
            groups = self._groups(live)
            inflight = []
            for gi, group in enumerate(groups):
                inflight.append(self._dispatch_group(
                    group, geom, band, self.rounds, "full"))
                if len(inflight) > self.num_batches:
                    self._finish_group(inflight.pop(0), trim, results)
                if progress is not None:
                    progress(gi + 1, len(groups) + 1)
            for la in inflight:
                self._finish_group(la, trim, results)
        self._host_fallback(windows, results, trim)
        if progress is not None:
            progress(1, 1)
        return [bool(r) for r in results]

    def _groups(self, live):
        """At least ``num_batches`` groups, and enough that each holds
        about ``group_pairs_cap`` pairs: the windows binned by
        :func:`partition_balanced` on their layer counts (one group holds
        them all when one is enough)."""
        total = sum(w.n_layers for _, w in live)
        n_groups = max(self.num_batches, -(-total // self.group_pairs_cap))
        if n_groups == 1:
            return [list(live)]
        bins = partition_balanced([w.n_layers for _, w in live], n_groups)
        return [[live[i] for i in b] for b in bins if b]

    # -------------------------------------------------------------- device

    def _dispatch_group(self, items, geom, band: int, rounds: int,
                        stage: str, overrides=None) -> dict:
        """:meth:`_launch_group` then :meth:`_rounds`."""
        la = self._launch_group(items, geom[0], geom[1], overrides)
        la.update(geom=geom, band=band, rounds=rounds, stage=stage)
        self._rounds(la)
        return la

    def _launch_group(self, items, Lq: int, Lb: int, overrides=None):
        """:meth:`_launch_group_impl` as the span ``poa.pack``."""
        with obs.span("poa.pack", windows=len(items)):
            return self._launch_group_impl(items, Lq, Lb, overrides)

    def _launch_group_impl(self, items, Lq: int, Lb: int, overrides=None):
        """Pack one group (:func:`pack_group`) and upload it, through
        pinned memory to a card; records the occupancy counters. Under a
        mesh the group's windows are binned over its devices by
        :func:`partition_balanced` (a window's pairs never leave its
        shard), every shard packs to the largest shard's ``B`` and ``nWp``,
        and the shards stack in shard order. A single-shard group of an
        unpinned engine whose layers lie in a store with its pool on this
        engine's device gathers its lanes there (:func:`gather_qpw_rows`)
        and uploads only the gather rows. Returns the launch handle: its
        device state, the works and the sizes."""
        nd = mesh_size(self.mesh)
        if nd == 1:
            shards = [list(items)]
        else:
            bins = partition_balanced([w.n_layers for _, w in items], nd)
            shards = [[items[i] for i in b] for b in bins]
        B = _pow2_at_least(max(sum(w.n_layers for _, w in sh)
                               for sh in shards))
        nWp = _pow2_at_least(max(len(sh) for sh in shards) + 1)
        allow_dev = (self.device if nd == 1 and self.mesh is None
                     and not self.pinned else None)
        packs = [pack_group(sh, Lq, Lb, overrides, allow_dev=allow_dev,
                            B=B, nWp=nWp)[0] for sh in shards]
        state_np = packs[0] if nd == 1 else {
            k: np.concatenate([p[k] for p in packs]) for k in packs[0]}
        rows = state_np.pop("qpw_rows", None)
        if rows is not None:
            pool, src0, lens = rows
            state_np["qpw"] = gather_qpw_rows(
                pool, upload(src0, self.device), upload(lens, self.device),
                Lq)
            saved = 2 * B * Lq
            self.stats["lane_upload_saved_bytes"] += saved
            metrics.inc("dataflow.bytes_avoided", saved)
            metrics.inc("dataflow.lanes_device_groups")
        real = state_np["real"]
        occupied = int(state_np["n"][real].sum())
        self.stats["lanes_occupied"] += occupied
        self.stats["lanes_total"] += nd * B * Lq
        self.stats["groups"] += 1
        self.stats["group_windows"] += len(items)
        metrics.inc("consensus.lanes_occupied", occupied)
        metrics.inc("consensus.lanes_total", nd * B * Lq)
        metrics.inc("consensus.groups")
        metrics.inc("consensus.group_windows", len(items))
        st = refine_state_to_torch(state_np, self.device)
        return {"items": [it for sh in shards for it in sh],
                "shards": shards, "nd": nd, "B": B, "nWp": nWp,
                "pairs": int(real.sum()),
                "static": [st[k] for k in STATE_NAMES[:4]],
                "state": [st[k] for k in STATE_NAMES[4:]],
                "idle": torch.zeros((), dtype=torch.int64,
                                    device=self.device)}

    def _rounds(self, launch) -> None:
        """:meth:`_rounds_impl` as the fault site ``consensus.dispatch``
        and the span ``poa.dispatch``."""
        faults.check("consensus.dispatch")
        with obs.span("poa.dispatch", pairs=launch["B"]):
            self._rounds_impl(launch)

    def _refine(self, launch, state, packed16: bool, idle):
        """The launch's rounds from ``state``: one loop, or one a shard
        through :func:`sharded_refine_loop` under a mesh."""
        Lq, Lb, steps, Lq2 = launch["geom"]
        kw = dict(rounds=launch["rounds"],
                  early_exit=self.device.type != "cuda", idle=idle,
                  max_len=Lq, band=launch["band"], Lb=Lb, K=K_INS,
                  steps=steps, packed16=packed16, Lq2=Lq2,
                  scores=self.scores)
        if launch["nd"] > 1:
            return sharded_refine_loop(
                self.mesh, launch["static"], state, self.ins_theta,
                self.del_beta, n_windows_local=launch["nWp"], **kw)
        return refine_loop(*launch["static"], *state, self.ins_theta,
                           self.del_beta, n_windows=launch["nWp"], **kw)

    def _rounds_impl(self, launch) -> None:
        """Enqueue the launch's ``rounds`` from its current state, then
        its fetch arrays (:func:`fetch_pack`). On a card nothing is read
        back; on the CPU the loop stops at convergence (the check costs
        nothing there and skips the plain kernels' no-op rounds). A K4
        group the sanitizer samples runs the rounds again from the same
        state with K1, and the ten state arrays must be equal."""
        Lq, _, steps, _ = launch["geom"]
        band = launch["band"]
        packed16 = use_packed16(Lq, band)
        out = self._refine(launch, launch["state"], packed16, launch["idle"])
        if packed16 and self._shadow.should_shadow():
            shadow = self._refine(launch, launch["state"], False, None)
            metrics.inc("consensus.shadow_groups")
            sanitize.shadow_compare(
                out, shadow, STATE_NAMES[4:],
                f"consensus K4 group (Lq={Lq}, band={band}, "
                f"steps={steps})")
        launch["state"] = list(out)
        bg, ed, bcodes, _, blen, covs, ever, frozen, conv, dropped = out
        launch["fetch"] = fetch_pack(bcodes, blen, covs, ever, frozen,
                                     conv, dropped, bg, ed, launch["idle"])
        self.stats["group_shapes"].append(
            (Lq, band, launch["pairs"], launch["B"], steps,
             launch["rounds"], launch["stage"]))

    def _finish_group(self, launch, trim: bool, results,
                      collect=None) -> None:
        """:meth:`_finish_group_impl` as the span ``poa.fetch`` (a group
        that continues in place nests its rounds and fetch under it)."""
        with obs.span("poa.fetch", windows=launch["nWp"]):
            self._finish_group_impl(launch, trim, results, collect)

    def _finish_group_impl(self, launch, trim: bool, results,
                           collect=None) -> None:
        """Fetch a group (two copies) and decode its consensus bytes. With
        ``collect`` (a stage-A group) its unconverged windows are appended
        there for stage B and stay pending, unless more than
        ``STAGE_B_MAX_SURVIVOR_FRAC`` of them survive: then the group runs
        its remaining rounds in place and is decoded after them."""
        items, nWp, B = launch["items"], launch["nWp"], launch["B"]
        nd = launch["nd"]
        mat, meta = (t.cpu().numpy() for t in launch["fetch"])
        bcodes = (mat & 7).astype(np.uint8)
        covs = mat >> 3
        nWr = nd * nWp
        blen, ever, frozen, conv, dropped, bg, ed, idle = np.split(
            meta, np.cumsum([nWr, nWr, nWr, nWr, nd * (4 + nWp), nd * B,
                             nd * B]))
        dropped = dropped.reshape(nd, 4 + nWp)
        # each window's row and first pair row in the stacked state, in
        # items order (shard s holds rows s * nWp .. and pairs s * B ..)
        rows, pair0 = [], []
        for s, sh in enumerate(launch["shards"]):
            off = s * B
            for wi, (_, w) in enumerate(sh):
                rows.append(s * nWp + wi)
                pair0.append(off)
                off += w.n_layers
        if sanitize.enabled():
            sanitize.check_consensus_canaries(
                bcodes, blen, covs, Lb=launch["geom"][1],
                context=f"consensus group (nWp={nWp})")
        unconverged = (conv[rows] == 0) & (frozen[rows] == 0)
        if (collect is not None and unconverged.sum()
                > STAGE_B_MAX_SURVIVOR_FRAC * len(items)):
            launch.update(rounds=self.rounds - STAGE_A_ROUNDS,
                          stage="in_place")
            self._rounds(launch)
            self._finish_group(launch, trim, results)
            return
        head = dropped[:, :4].sum(axis=0)
        self.stats["dropped_layers"] += int(head[0])
        self.stats["sweep_truncated"] += int(head[1])
        self.stats["ins_overflow"] += int(head[2])
        self.stats["wavefront_steps"] += int(head[3])
        self.stats["rounds_after_converged"] += int(idle[0])
        metrics.inc("consensus.dropped_layers", int(head[0]))
        metrics.inc("consensus.sweep_truncated", int(head[1]))
        metrics.inc("consensus.ins_overflow", int(head[2]))
        metrics.inc("consensus.wavefront_steps", int(head[3]))
        # columns [4:] attribute the overflow counter to each shard's
        # window rows (accumulated over its rounds)
        ovf_tail = dropped[:, 4:].reshape(-1)
        for k, (row, (i, w)) in enumerate(zip(rows, items)):
            ovf = int(ovf_tail[row])
            if ovf:
                self.ins_overflow_by_window[i] = \
                    self.ins_overflow_by_window.get(i, 0) + ovf
                metrics.inc("consensus.ins_overflow_windows")
            kw = w.n_layers
            p0 = pair0[k]
            if collect is not None and unconverged[k]:
                collect.append((i, w, (
                    bcodes[row].copy(), int(blen[row]), covs[row].copy(),
                    bool(ever[row]), bg[p0:p0 + kw].copy(),
                    ed[p0:p0 + kw].copy())))
                continue
            if not ever[row]:
                results[i] = None   # no successful round -> host fallback
                continue
            bl = int(blen[row])
            consensus = _BYTE_LUT[bcodes[row, :bl]].tobytes()
            if w.win.type == WindowType.TGS and trim:
                # threshold on the voted depth (layers past max_depth
                # never vote)
                avg_cov = min(w.n_seqs - 1, self.max_depth) // 2
                good = np.flatnonzero(covs[row, :bl] >= avg_cov)
                if len(good) and good[0] < good[-1]:
                    consensus = consensus[good[0]:good[-1] + 1]
            w.win.consensus = consensus
            results[i] = True
            self.stats["device_windows"] += 1

    def _run_stage_b(self, survivors, trim, results, geom, band) -> None:
        """:meth:`_run_stage_b_impl` as the span ``poa.stage_b``."""
        with obs.span("poa.stage_b", windows=len(survivors)):
            self._run_stage_b_impl(survivors, trim, results, geom, band)

    def _run_stage_b_impl(self, survivors, trim, results, geom,
                          band) -> None:
        """The remaining rounds for the stage-A stragglers of one bucket
        (``[(result index, work, fetched state), ...]`` from every stage-A
        group), repacked from their fetched state into groups of at most
        ``group_pairs_cap`` pairs."""
        live = [(i, w) for i, w, _ in survivors]
        overrides = {i: st for i, _, st in survivors}
        self.stats["stage_b_windows"] += len(live)
        total = sum(w.n_layers for _, w in live)
        n_groups = max(1, -(-total // self.group_pairs_cap))
        if n_groups == 1:
            groups = [live]
        else:
            bins = partition_balanced([w.n_layers for _, w in live],
                                      n_groups)
            groups = [[live[i] for i in b] for b in bins if b]
        inflight = []
        for g in groups:
            inflight.append(self._dispatch_group(
                g, geom, band, self.rounds - STAGE_A_ROUNDS, "B",
                overrides))
            if len(inflight) > self.num_batches:
                self._finish_group(inflight.pop(0), trim, results)
        for la in inflight:
            self._finish_group(la, trim, results)
