"""Batched window consensus on the card (counterpart of
``racon_tpu/ops/poa.py``, its padded path ``run`` -> ``_run_padded``).

Every layer of a window group is aligned to its backbone span with the
banded forward kernel, the fused walk + vote kernel emits each step's vote
address and weight, the votes accumulate into per-window matrices, and the
consensus rule picks column/insertion winners; the emitted consensus
becomes the next round's backbone on the device (:func:`refine_round`),
for up to ``rounds`` rounds (:func:`refine_loop`). Windows the device
cannot take (too few layers, oversize, no successful round) go to the host
POA engine, as in the JAX package.

What the JAX package does for the TPU and the port does not copy: the
one-hot/int8-limb matmul vote reduction and its compaction routing
(an integer ``index_add_`` into int64 is exact in any order here), the
ragged streaming path, stage-B repacking and the resident dataflow
(each is output-invariant in the JAX package; they come in later slices).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import cuda_nw
from .swar import use_packed16
from ..core.window import WindowType
from ..device import resolve
from ..params import DEFAULT_GAP, DEFAULT_MATCH, DEFAULT_MISMATCH, PARAMS
from ..utils.logger import warn

BAND = PARAMS.band
K_INS = PARAMS.k_ins
GROW = PARAMS.grow
CH = PARAMS.ch
# pairs per device group (the JAX engine's group cap)
MAX_GROUP_PAIRS = 32768
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
    addr = (win_of.to(i64)[:, None] * VOT + idx64)[live]
    val = wa[live]
    weighted = torch.zeros(n_windows * VOT, dtype=i64, device=dev)
    weighted.index_add_(0, addr, val)
    counts = torch.zeros(n_windows * VOT, dtype=i64, device=dev)
    counts.index_add_(0, addr, (val > 0).to(i64))
    return (weighted.view(n_windows, VOT).to(torch.float32),
            counts.view(n_windows, VOT).to(torch.int32))


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
    # dummy-quality backbones still win columns with no layer votes
    eps_w = torch.maximum(bweights, torch.tensor(0.01, dtype=f32,
                                                 device=dev))
    col_votes = w[:, :L, :] + onehot * (eps_w * in_range.to(f32))[..., None]
    col_unw = uw[:, :L, :] + (onehot * in_range[..., None].to(f32)) \
        .to(torch.int32)
    theta = torch.tensor(ins_theta, dtype=f32, device=dev)
    beta = torch.tensor(del_beta, dtype=f32, device=dev)

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
                rounds: int, **kw):
    """Up to ``rounds`` refinement rounds, stopping once every window with
    real pairs is converged or frozen (later rounds would be no-ops), as
    ``racon_tpu.ops.poa.refine_loop`` does."""
    nW = bcodes.shape[0]
    win_real = torch.zeros(nW, dtype=torch.bool, device=bcodes.device)
    win_real[win_of[real]] = True
    state = (bg, ed, bcodes, bweights, blen, covs, ever, frozen, conv,
             dropped)
    r = 0
    while r < rounds and not bool((state[7] | state[8] | ~win_real).all()):
        state = refine_round(n, qpw, win_of, real, *state, ins_theta,
                             del_beta, **kw)
        r += 1
    return state


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


def pack_group(items, Lq: int, Lb: int):
    """Pack one group's windows into the refine-loop state as numpy arrays
    (``TpuPoaConsensus._pack_shard``): pair rows padded to a power of two
    vote into the sink window ``nWp - 1``. Returns ``(state, B, nWp)`` with
    ``state`` keyed by ``params.STATE_NAMES``."""
    counts = np.array([w.n_layers for _, w in items], np.int64)
    k = int(counts.sum())
    B = _pow2_at_least(k)
    nWp = _pow2_at_least(len(items) + 1)
    n = np.ones(B, np.int32)
    qpw = np.zeros((B, Lq), np.uint16)
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
        by_store = {}
        legacy = []
        for wi, (_, w) in enumerate(items):
            if not w.n_layers:
                continue
            if w.store is not None:
                by_store.setdefault(id(w.store), []).append(wi)
            else:
                legacy.append(wi)
        for wis in by_store.values():
            store = items[wis[0]][1].store
            rows = np.concatenate([items[wi][1].rows for wi in wis])
            dest = np.concatenate(
                [np.arange(offs[wi], offs[wi + 1]) for wi in wis])
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
    state = {"n": n, "qpw": qpw, "win_of": win_of, "real": real, "bg": bg,
             "ed": ed, "bcodes": bcodes, "bweights": bweights,
             "blen": blen, "covs": np.zeros((nWp, Lb), np.int32),
             "ever": np.zeros(nWp, bool), "frozen": np.zeros(nWp, bool),
             "conv": np.zeros(nWp, bool),
             "dropped": np.zeros((1, 4 + nWp), np.int64)}
    return state, B, nWp


class CudaPoaConsensus:
    """Batched device consensus with host fallback for rejected windows
    (counterpart of ``racon_tpu.ops.poa.TpuPoaConsensus`` on its padded
    path). Groups of at most ``MAX_GROUP_PAIRS`` layer pairs run their
    whole refinement loop on the device; windows are independent, so the
    grouping never changes a byte of output."""

    def __init__(self, match: int, mismatch: int, gap: int, fallback=None,
                 band: int = BAND, num_batches: int = 1, device="cuda"):
        self.device = resolve(device)
        self.fallback = fallback
        self.max_depth = PARAMS.max_depth
        self.band = band
        self.rounds = PARAMS.rounds
        self.ins_theta, self.del_beta = PARAMS.thresholds(match, gap)
        self.scores = (match, mismatch, gap)
        self.num_batches = max(1, num_batches)
        self.stats = {"device_windows": 0, "fallback_windows": 0,
                      "dropped_layers": 0, "sweep_truncated": 0,
                      "passthrough": 0, "wavefront_steps": 0, "groups": 0,
                      "group_shapes": []}

    def run(self, windows, trim: bool, progress=None) -> List[bool]:
        before = self.stats["dropped_layers"]
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
            live = [(i, w) for i, w in live
                    if w.max_layer_len <= Lq and len(w.backbone) <= Lb]
        if live:
            max_nm = max(int(np.max(w.lens + np.minimum(
                w.ends - w.begins + 65, Lb))) for _, w in live)
            max_n = max(w.max_layer_len for _, w in live)
            steps, Lq2 = sweep_geometry(Lq, max_nm, max_n)
            groups = self._groups(live)
            for gi, group in enumerate(groups):
                self._run_group(group, trim, results, band, Lq, Lb, steps,
                                Lq2)
                if progress is not None:
                    progress(gi + 1, len(groups) + 1)
        cpu_idx = [i for i, r in enumerate(results) if r is None]
        if cpu_idx:
            self.stats["fallback_windows"] += len(cpu_idx)
            if self.fallback is None:
                raise RuntimeError(
                    f"{len(cpu_idx)} windows rejected, no host fallback")
            flags = self.fallback.run([windows[i] for i in cpu_idx], trim)
            for i, f in zip(cpu_idx, flags):
                results[i] = f
        if progress is not None:
            progress(1, 1)
        d = self.stats["dropped_layers"] - before
        if d > 0:
            warn(f"consensus: {d} layer alignments dropped this run "
                 f"(voting depth cap {self.max_depth} and/or rejected "
                 f"alignments) — see consensus stats dropped_layers")
        return [bool(r) for r in results]

    def _groups(self, live):
        """Consecutive window runs of at most MAX_GROUP_PAIRS pairs (at
        least ``num_batches`` groups when there are enough windows)."""
        total = sum(w.n_layers for _, w in live)
        n_groups = max(self.num_batches, -(-total // MAX_GROUP_PAIRS))
        cap = -(-total // n_groups)
        groups, cur, cur_pairs = [], [], 0
        for item in live:
            k = item[1].n_layers
            if cur and cur_pairs + k > cap:
                groups.append(cur)
                cur, cur_pairs = [], 0
            cur.append(item)
            cur_pairs += k
        if cur:
            groups.append(cur)
        return groups

    def _run_group(self, items, trim, results, band, Lq, Lb, steps,
                   Lq2) -> None:
        from ..params import refine_state_to_torch
        state_np, B, nWp = pack_group(items, Lq, Lb)
        st = refine_state_to_torch(state_np, self.device)
        packed16 = use_packed16(Lq, band)
        out = refine_loop(
            st["n"], st["qpw"], st["win_of"], st["real"], st["bg"],
            st["ed"], st["bcodes"], st["bweights"], st["blen"], st["covs"],
            st["ever"], st["frozen"], st["conv"], st["dropped"],
            self.ins_theta, self.del_beta, rounds=self.rounds,
            n_windows=nWp, max_len=Lq, band=band,
            Lb=Lb, K=K_INS, steps=steps, packed16=packed16, Lq2=Lq2,
            scores=self.scores)
        (_, _, bcodes, _, blen, covs, ever, _, _, dropped) = out
        bcodes = bcodes.cpu().numpy()
        blen = blen.cpu().numpy()
        covs = covs.cpu().numpy()
        ever = ever.cpu().numpy()
        dropped = dropped.cpu().numpy()
        self.stats["groups"] += 1
        # (Lq, band, real pairs, padded batch, sweep steps) of each group
        self.stats["group_shapes"].append(
            (Lq, band, int(state_np["real"].sum()), B, steps))
        self.stats["dropped_layers"] += int(dropped[:, 0].sum())
        self.stats["sweep_truncated"] += int(dropped[:, 1].sum())
        self.stats["wavefront_steps"] += int(dropped[:, 3].sum())
        for row, (i, w) in enumerate(items):
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
