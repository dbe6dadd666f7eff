"""The fused walk + vote kernel's lane and tile map (``walk_vote_kernel``
in ``racon_tpu_torch/ops/kernels/walk_vote.cu``), mirrored in numpy and
checked on the CPU.

The kernel runs one pair per lane, 32 pairs a warp, ``WARPS`` warps a
block:

- lane ``l`` of the warp whose pair 0 is ``b0`` walks pair ``b0 + l``;
  lanes past ``B`` stay in the warp with ``live = false`` from the start;
- the warp walks in lockstep chunks of 32 steps while ``t0 < S`` and
  ``__any_sync(live)``. In step ``t0 + k`` a live lane decodes the next op
  (``walk_decode``) and computes its vote address and weight; a lane whose
  walk has ended writes the sink ``VOT`` and 0. Every lane writes column
  ``k`` of its row ``l`` of two shared tiles, ``sidx`` (rows of
  ``IDX_ROW`` words) and ``sw`` (rows of ``W_ROW`` bytes);
- after the chunk the tile goes out transposed: for each of the warp's
  pairs ``p < B``, lane ``l`` stores step ``t0 + l`` of pair ``b0 + p``
  (``t0 + l < S``);
- after the last chunk the lanes fill ``[t0, S)`` of each of the warp's
  pairs with ``VOT`` and 0, lane ``l`` at ``t0 + l, t0 + l + 32, ...``;
- each live step hints the byte of row ``a - 1 - PREFETCH_ROWS`` into L2,
  ``a = i + j``, its lane predicted from ``j - i`` and that row's parity,
  the row clamped to ``>= 0`` and the address to the pair's own cells;
  a launch hints only when the share of ``n + m > 0`` among 32 pairs
  spread over the batch (pair ``(l * B // 32 + l) % B`` for lane ``l``),
  scaled to ``B``, is at most ``PREFETCH_MAX_WALKS``.

The constants are read from the kernel's source. The mirror follows the
kernel step for step and is held against ``cuda_nw.walk_vote``'s plain
path (``walk_plain`` + ``vote_from_ops``). The card holds the kernel
itself against the same plain path (``tests/test_torch_cuda.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import cuda_nw

SOURCE = (pathlib.Path(cuda_nw.__file__).parent / "kernels"
          / "walk_vote.cu").read_text()
CONST = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                             SOURCE).group(1))
         for name in ("WARPS", "IDX_ROW", "W_ROW", "PREFETCH_ROWS",
                      "PREFETCH_MAX_WALKS")}
WARP = 32
LANES = np.arange(WARP)
K, CH, DEL = 4, 8, 5
BASES = np.arange(4, dtype=np.uint8)
POISON = -(1 << 40)


def cdiv2(x):
    """C's ``x / 2`` (truncation toward zero)."""
    q = np.abs(x) // 2
    return np.where(x < 0, -q, q)


def decode(flat, i, j, c, U, RB, cells):
    """``walk_decode`` for each lane: (op, position read or -1)."""
    a = i + j
    p = (a + c) & 1
    u = cdiv2(j - i + c - p)
    inside = (u >= 0) & (u < U)
    uc = np.clip(u, 0, U - 1)
    pos = np.clip((a - 1) * RB + uc % RB, 0, cells - 1)
    byte = flat[LANES, pos]
    code = (byte >> (2 * (uc // RB))) & 3
    op = np.where(i == 0, np.where(j == 0, 3, 2),
                  np.where(j == 0, 1, np.where(inside, code, 3)))
    reads = (i > 0) & (j > 0) & inside
    return op, np.where(reads, pos, -1)


def prefetch_pos(i, j, c, U, RB, cells):
    """The byte each lane hints into L2 (the kernel's prefetch block)."""
    ap = i + j - CONST["PREFETCH_ROWS"]
    pp = (ap + c) & 1
    up = np.clip(cdiv2(j - i + c - pp), 0, U - 1)
    row = np.maximum(ap - 1, 0)
    return np.minimum(row * RB + up % RB, cells - 1)


def launch_hints(n, m):
    """Whether a launch over ``len(n)`` pairs hints (every warp decides
    alike): the walking share of 32 pairs spread over the batch, scaled to
    ``B``, against ``PREFETCH_MAX_WALKS``."""
    B = len(n)
    ps = (LANES * B // WARP + LANES) % B
    walks = int((n[ps].astype(np.int64) + m[ps] > 0).sum()) * B // WARP
    return walks <= CONST["PREFETCH_MAX_WALKS"]


def mirror_walk_vote(dirs, n, m, bg, qpw, *, band, L):
    """The kernel's chunk loop on numpy arrays, one warp at a time (warps
    share nothing). Returns ``(idx, w, fi, fj, writes, prefetches,
    reads)``: ``writes`` counts the stores to each ``(pair, step)``,
    ``prefetches`` and ``reads`` are per pair the hinted and the read
    direction-byte positions."""
    B, S, RB = dirs.shape
    Lq = qpw.shape[1]
    c = U = band // 2
    VOT = L * (1 + K) * CH
    cells = S * RB
    IDX_ROW, W_ROW = CONST["IDX_ROW"], CONST["W_ROW"]
    flat_all = dirs.reshape(B, cells).astype(np.int64)
    q_all = qpw.view(np.uint16).astype(np.int64)
    idx = np.full((B, S), POISON, np.int64)
    w = np.full((B, S), POISON, np.int64)
    writes = np.zeros((B, S), np.int64)
    fi = np.zeros(B, np.int64)
    fj = np.zeros(B, np.int64)
    prefetches = [[] for _ in range(B)]
    reads = [[] for _ in range(B)]
    hint = launch_hints(n, m)
    for b0 in range(0, B, WARP):
        b = b0 + LANES
        live = b < B
        bb = np.where(live, b, 0)
        flat, qrow = flat_all[bb], q_all[bb]
        bgv = np.where(live, bg[bb], 0).astype(np.int64)
        i = np.where(live, n[bb], 0).astype(np.int64)
        j = np.where(live, m[bb], 0).astype(np.int64)
        run = np.zeros(WARP, np.int64)
        t0 = 0
        while t0 < S and live.any():
            kn = min(WARP, S - t0)
            sidx = np.full(WARP * IDX_ROW, POISON, np.int64)
            sw = np.full(WARP * W_ROW, POISON, np.int64)
            for k in range(kn):
                was = live.copy()
                pw = qrow[LANES, np.clip(i - 1, 0, Lq - 1)]
                pf = prefetch_pos(i, j, c, U, RB, cells)
                op, rd = decode(flat, i, j, c, U, RB, cells)
                for l in np.flatnonzero(was):
                    if hint:
                        prefetches[b[l]].append(int(pf[l]))
                    if rd[l] >= 0:
                        reads[b[l]].append(int(rd[l]))
                live = was & (op != 3)
                step = live
                col = bgv + j - 1
                slot = np.minimum(run, K - 1)
                a = np.where(op == 0, col * CH + (pw & 7),
                             np.where(op == 2, col * CH + DEL,
                                      (L + col * K + slot) * CH + (pw & 7)))
                valid = (step & (j >= 1) & (col >= 0) & (col < L)
                         & ~((op == 1) & (run >= K)))
                sidx[LANES * IDX_ROW + k] = np.where(valid, a, VOT)
                sw[LANES * W_ROW + k] = np.where(valid, (pw >> 3) & 0xff, 0)
                run = np.where(step, np.where(op == 1, run + 1, 0), run)
                i = np.where(step & (op != 2), i - 1, i)
                j = np.where(step & (op != 1), j - 1, j)
            # the transposed store: lane l, step t0 + l of pair b0 + p
            ok = LANES[LANES < kn]
            for p in range(min(WARP, B - b0)):
                idx[b0 + p, t0 + ok] = sidx[p * IDX_ROW + ok]
                w[b0 + p, t0 + ok] = sw[p * W_ROW + ok]
                writes[b0 + p, t0 + ok] += 1
            t0 += WARP
        # the tail: lane l fills t0 + l, t0 + l + 32, ... of every pair
        for p in range(min(WARP, B - b0)):
            for l in LANES:
                ts = np.arange(t0 + l, S, WARP)
                idx[b0 + p, ts] = VOT
                w[b0 + p, ts] = 0
                writes[b0 + p, ts] += 1
        real = b < B
        fi[b[real]] = i[real]
        fj[b[real]] = j[real]
    return idx, w, fi, fj, writes, prefetches, reads


# ------------------------------------------------------------ inputs

def _mutate(rng, t, err):
    q = t.copy()
    flips = rng.random(len(q)) < err / 3
    q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
    q = q[rng.random(len(q)) >= err / 3]
    ins = rng.random(len(q)) < err / 3
    return np.insert(q, np.flatnonzero(ins),
                     BASES[rng.integers(0, 4, int(ins.sum()))])


GRIDS = {
    # name: seed, B pairs of target length in [lo, hi) at error rate err,
    # (max_len, band) rows, steps (0: 2 * max_len), and the features of
    # _features the grid must show. Options: empty = every how many pairs
    # one is n = m = 0; ins = the length of one inserted run in every
    # query; cut = the longest run deleted from every query (50 bases up
    # to it: some put (n, m) outside the band); random = direction bytes
    # drawn at random instead of from a forward pass
    "partial_warps": dict(seed=1, B=45, lo=60, hi=200, err=0.15,
                          max_len=256, band=128, steps=0,
                          shows={"partial_warp"}),
    "odd_steps": dict(seed=2, B=40, lo=60, hi=160, err=0.15, max_len=160,
                      band=128, steps=301, shows={"odd_steps"}),
    "converged": dict(seed=3, B=37, lo=100, hi=200, err=0.15, max_len=256,
                      band=128, steps=0, empty=3, shows={"empty"}),
    "escapes": dict(seed=4, B=24, lo=150, hi=250, err=0.15, max_len=256,
                    band=128, steps=0, cut=90, shows={"escape"}),
    "truncated": dict(seed=5, B=40, lo=80, hi=250, err=0.15, max_len=256,
                      band=128, steps=250, shows={"truncated"}),
    "long_insertions": dict(seed=6, B=33, lo=100, hi=200, err=0.1,
                            max_len=256, band=128, steps=0, ins=12,
                            shows={"long_insertion"}),
    "random_dirs": dict(seed=7, B=70, lo=0, hi=120, err=0.0, max_len=128,
                        band=64, steps=203, random=True,
                        shows={"partial_warp", "odd_steps", "escape",
                               "escape_mid_walk", "truncated"}),
    # the consensus band, S not a multiple of 32, a ragged last warp
    "consensus_band": dict(seed=8, B=35, lo=400, hi=600, err=0.15,
                           max_len=1024, band=512, steps=1187, empty=5,
                           shows={"partial_warp", "odd_steps", "empty"}),
}


def _inputs(g):
    rng = np.random.default_rng(g["seed"])
    B, max_len, band = g["B"], g["max_len"], g["band"]
    S = g["steps"] or 2 * max_len
    if g.get("random"):
        dirs = rng.integers(0, 256, (B, S, band // 8)).astype(np.uint8)
        n = rng.integers(g["lo"], g["hi"], B).astype(np.int32)
        m = rng.integers(g["lo"], g["hi"], B).astype(np.int32)
        dirs_t = torch.from_numpy(dirs)
    else:
        c = band // 2
        width = c + max_len + band
        qrp = np.full((B, width), 6, np.uint8)
        tp = np.full((B, width), 7, np.uint8)
        n = np.zeros(B, np.int32)
        m = np.zeros(B, np.int32)
        every = g.get("empty", 0)
        for k in range(B):
            if every and k % every == 0:
                continue
            t = BASES[rng.integers(0, 4, int(rng.integers(g["lo"],
                                                          g["hi"])))]
            q = _mutate(rng, t, g["err"])
            if g.get("ins"):
                at = int(rng.integers(10, len(q) - 10))
                q = np.insert(q, at, BASES[rng.integers(0, 4, g["ins"])])
            if g.get("cut"):
                at = int(rng.integers(10, len(q) - 100))
                q = np.delete(q, np.arange(at, at + int(rng.integers(
                    50, g["cut"]))))
            q = q[:max_len]
            qrp[k, c + max_len - len(q): c + max_len] = q[::-1]
            tp[k, c: c + len(t)] = t
            n[k], m[k] = len(q), len(t)
        dirs_t, _ = cuda_nw.nw_fwd(*(torch.from_numpy(a) for a in
                                     (qrp, tp, n, m)),
                                   max_len=max_len, band=band, steps=S)
    qpw = ((rng.integers(0, 94, (B, max_len)).astype(np.uint16) << 3)
           | rng.integers(0, 5, (B, max_len)).astype(np.uint16))
    bg = rng.integers(0, 8, B).astype(np.int32)
    return dirs_t.numpy(), n, m, bg, qpw.view(np.int16)


def _features(dirs, n, m, fi, fj, band):
    B, S, _ = dirs.shape
    ops, _, _ = cuda_nw.walk_plain(torch.from_numpy(dirs),
                                   torch.from_numpy(n), torch.from_numpy(m),
                                   band=band)
    ops = ops.numpy()
    longest = 0
    for row in ops:
        r = 0
        for o in row:
            r = r + 1 if o == 1 else 0
            longest = max(longest, r)
    nm = n.astype(np.int64) + m
    escaped = (nm <= S) & ((fi != 0) | (fj != 0))
    return {name for name, on in (
        ("partial_warp", B % WARP != 0),
        ("odd_steps", S % WARP != 0),
        ("empty", (nm == 0).any()),
        ("escape", escaped.any()),
        ("escape_mid_walk", (escaped & ((fi != n) | (fj != m))).any()),
        ("truncated", (nm > S).any()),
        ("long_insertion", longest > K)) if on}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_mirror_matches_plain(grid):
    """The mirrored chunk loop, tiles, transposed store and tail give the
    plain path's stream bit for bit; every (pair, step) is stored once;
    every prefetch stays in its own pair's cells."""
    g = GRIDS[grid]
    dirs, n, m, bg, qpw = _inputs(g)
    L = g["max_len"]
    idx, w, fi, fj, writes, prefetches, reads = mirror_walk_vote(
        dirs, n, m, bg, qpw, band=g["band"], L=L)
    want = cuda_nw.walk_vote(*(torch.from_numpy(a) for a in
                               (dirs, n, m, bg, qpw)),
                             band=g["band"], L=L, K=K, CH=CH, DEL=DEL)
    for got, ref in zip((idx, w, fi, fj), want):
        assert np.array_equal(got, ref.numpy().astype(np.int64))
    assert (writes == 1).all()
    cells = dirs.shape[1] * dirs.shape[2]
    for pf in prefetches:
        assert all(0 <= x < cells for x in pf)
    assert sum(map(len, reads)) > 0
    assert g["shows"] <= _features(dirs, n, m, fi, fj, g["band"])


def test_prefetch_hits_the_rows_a_diagonal_walk_reads():
    """On a path that keeps to its diagonal (query == target: all M), every
    hinted byte of a row the walk reaches is the byte it reads there."""
    rng = np.random.default_rng(9)
    B, max_len, band = 5, 256, 128
    c = band // 2
    width = c + max_len + band
    qrp = np.full((B, width), 6, np.uint8)
    tp = np.full((B, width), 7, np.uint8)
    n = np.zeros(B, np.int32)
    for k in range(B):
        t = BASES[rng.integers(0, 4, int(rng.integers(100, 250)))]
        qrp[k, c + max_len - len(t): c + max_len] = t[::-1]
        tp[k, c: c + len(t)] = t
        n[k] = len(t)
    dirs, _ = cuda_nw.nw_fwd(*(torch.from_numpy(a) for a in
                               (qrp, tp, n, n)), max_len=max_len, band=band)
    qpw = np.zeros((B, max_len), np.int16)
    bg = np.zeros(B, np.int32)
    *_, prefetches, reads = mirror_walk_vote(dirs.numpy(), n, n, bg, qpw,
                                             band=band, L=max_len)
    RB = band // 8
    D = CONST["PREFETCH_ROWS"]
    for k in range(B):
        ahead = [x for x in prefetches[k] if x >= RB]   # rows >= 1
        assert len(ahead) == n[k] - D // 2
        assert set(ahead) <= set(reads[k])


@pytest.mark.parametrize("B,window,walk_every,hints", [
    (1000, 1, 1, True),        # a partial warp, every pair walking
    (12288, 1, 1, True),       # at the limit
    (16384, 1, 1, False),
    (32768, 1, 1, False),      # a full consensus group in its first round
    (32768, 1, 4, True),       # a quarter walking, spread out
    (32768, 1, 16, True),
    # later rounds: converged windows' layers (runs of 30 pairs) empty,
    # one window in 4 or in 12 still walking
    (32768, 30, 4, True),
    (32768, 30, 12, True),
    (32768, 30, 2, False),     # half the windows walking
])
def test_launch_hints_only_while_few_walks_run(B, window, walk_every,
                                              hints):
    walking = (np.arange(B) // window) % walk_every == 0
    n = np.where(walking, 500, 0).astype(np.int32)
    assert launch_hints(n, n) == hints


def test_tiles_are_free_of_bank_conflicts():
    """A step's column writes and a pair's row reads of both tiles touch 32
    distinct banks (several bytes of one word are one access), and the
    block's tiles fit the 48 KB of static shared memory."""
    IDX_ROW, W_ROW = CONST["IDX_ROW"], CONST["W_ROW"]

    def conflict_free(byte_offsets):
        words = byte_offsets // 4
        banks = {}
        for word in set(words.tolist()):
            banks.setdefault(word % 32, set()).add(word)
        return all(len(ws) == 1 for ws in banks.values())

    for k in range(WARP):
        assert conflict_free(4 * (LANES * IDX_ROW + k))
        assert conflict_free(LANES * W_ROW + k)
    for p in range(WARP):
        assert conflict_free(4 * (p * IDX_ROW + LANES))
        assert conflict_free(p * W_ROW + LANES)
    assert CONST["PREFETCH_ROWS"] % 2 == 0
    assert CONST["WARPS"] * WARP * (4 * IDX_ROW + W_ROW) <= 48 * 1024
