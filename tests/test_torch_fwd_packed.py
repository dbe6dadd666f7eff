"""The wide body of the int16x2 forward kernel (K4,
``nw_fwd_i16x2_wide_kernel<NW, BPT>`` in
``racon_tpu_torch/ops/kernels/nw_fwd.cu``), mirrored in numpy and checked
on the CPU.

One pair per block of ``NW`` warps (at ``NW = 1`` one pair a warp), ``T =
32 * NW`` threads, ``RB = BPT * T`` bytes a direction row, ``U = 4 * RB``
lanes, ``band = 2 * U = 256 * BPT * NW``:

- thread ``tg`` owns the direction bytes ``BPT * tg .. BPT * tg + BPT -
  1``: for plane ``q`` the lanes ``u = q * RB + BPT * tg + k``, held as
  ``W = BPT / 2`` words, slot ``k`` in word ``k // 2``, the low half for
  even ``k``;
- the +-1 lane shifts are ``__byte_perm(x, y, 0x5432)`` of neighbouring
  words; a run's edge word comes by shuffle (at ``NW = 1`` a rotation over
  the warp in which thread 31 / thread 0 hands over the plane before /
  after) and, at a warp's edge when ``NW > 1``, from a ring of words in
  shared memory (run ``(q, w)`` at ``q * NW + w``, a BIG sentinel at each
  end);
- the cell step is two DPX min-with-predicate steps,
  ``__vibmin_s16x2(isrc, dsrc)`` (predicate ``isrc <= dsrc``: consume
  query before consume target) and ``__vibmin_s16x2(cd, m0 + 1)``
  (predicate ``cd <= min``: the diagonal first), modelled as the CUDA
  headers document them: per-halfword signed min, predicate ``a <= b``;
- wavefronts are of two kinds, uniform over the pair: those whose range
  of computed lanes (the interior and the DP boundary ``i == 0`` or ``j
  == 0``, which the step itself fills with ``j`` and ``i``) covers every
  lane (``FULL``: the clamp alone) and the rest (``EDGE``: the mask, from
  two biased lane words and one ``__vimax3_s16x2``);
- the characters are aligned words (``__funnelshift_r``), xor-ed and
  tested four bytes at a time, spread into half-words with
  ``__byte_perm``.

The mirror follows the kernel step for step and is held against
``nw_fwd_plain(packed16=True)`` on the same inputs. The card holds the
kernel itself against the plain version (``tests/test_torch_cuda.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import cuda_nw, swar
from test_torch_fwd_lanes import planar_row

WARP = 32
BIG16 = cuda_nw.BIG16
BIG32 = cuda_nw.BIG32
M32 = 0xFFFFFFFF
ONES = 0x00010001
BIGW = BIG16 * ONES
EDGE, FULL = 0, 1
# every (band, BPT) the kernel instantiates
BODIES = [(band, bpt) for band, bpts in cuda_nw.I16X2_WIDE_BPTS.items()
          for bpt in bpts]
# an unwritten ring entry; a read of one would show in the mirror's output
RING_UNSET = -7777


# ------------------------------------------------------- intrinsics

def byte_perm(x, y, s):
    """``__byte_perm(x, y, s)``: byte i of the result is byte
    ``(s >> 4i) & 7`` of the eight bytes ``y:x``."""
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    both = (y << 32) | x
    out = np.zeros(np.broadcast(x, y).shape, np.int64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((both >> (8 * sel)) & 0xFF) << (8 * i)
    return out


def funnelshift_r(lo, hi, sh):
    """``__funnelshift_r(lo, hi, sh)``: the low word of ``hi:lo >> sh``."""
    return (((np.asarray(hi, np.int64) << 32) | lo) >> (sh & 31)) & M32


def halves(w):
    """Signed (lo, hi) halves of 32-bit words."""
    w = np.asarray(w, np.int64)
    lo, hi = w & 0xFFFF, (w >> 16) & 0xFFFF
    return lo - ((lo & 0x8000) << 1), hi - ((hi & 0x8000) << 1)


def words(lo, hi):
    return (np.asarray(lo, np.int64) & 0xFFFF) | (
        (np.asarray(hi, np.int64) & 0xFFFF) << 16)


def vibmin_s16x2(a, b):
    """``__vibmin_s16x2(a, b, &pred_hi, &pred_lo)``: the per-halfword
    signed min and the per-halfword predicates ``a <= b``."""
    al, ah = halves(a)
    bl, bh = halves(b)
    return (words(np.minimum(al, bl), np.minimum(ah, bh)),
            ah <= bh, al <= bl)


def vimax3_s16x2(a, b, c):
    al, ah = halves(a)
    bl, bh = halves(b)
    cl, ch = halves(c)
    return words(np.maximum(np.maximum(al, bl), cl),
                 np.maximum(np.maximum(ah, bh), ch))


def vmins2(a, b):
    al, ah = halves(a)
    bl, bh = halves(b)
    return words(np.minimum(al, bl), np.minimum(ah, bh))


# ------------------------------------------------------- geometry

def geometry(band, bpt):
    """(NW, T, RB, U, W) of the body at (band, BPT)."""
    nw = band // (256 * bpt)
    T = WARP * nw
    RB = bpt * T
    return nw, T, RB, 4 * RB, bpt // 2


def slot_lanes(band, bpt):
    """[T, 4, W, 2] lane of each (thread, plane, word, half)."""
    _, T, RB, _, W = geometry(band, bpt)
    return (np.arange(4)[None, :, None, None] * RB
            + bpt * np.arange(T)[:, None, None, None]
            + 2 * np.arange(W)[None, None, :, None]
            + np.arange(2)[None, None, None, :])


def lane_words(vals, band, bpt):
    """[..., T, 4, W] words of per-lane values ``vals [..., U]``."""
    lanes = slot_lanes(band, bpt)
    return words(vals[..., lanes[..., 0]], vals[..., lanes[..., 1]])


def row_bytes(dirw, bpt):
    """The direction row a block stores from each thread's direction
    words ``[..., T, NX]`` (slot k at byte k, little-endian): thread tg's
    BPT bytes at ``BPT * tg``."""
    b = (dirw[..., None] >> (8 * np.arange(4))) & 0xFF
    b = b.reshape(*dirw.shape[:-1], -1)[..., :bpt]
    return b.reshape(*dirw.shape[:-2], -1).astype(np.uint8)


# ------------------------------------------------------- the kernel's steps

def edges(prev, P, ring, nw):
    """[B, T, 4] edge word of each (thread, plane) in a wavefront of
    parity ``P`` (``prev [B, T, 4, W]``): P 0 the word whose high half is
    lane u-1 of the run's first lane, P 1 the word whose low half is lane
    u+1 of its last."""
    B, T = prev.shape[:2]
    t = np.arange(T) % WARP
    if P == 0:
        src = prev[:, :, :, -1].copy()
        if nw == 1:
            # thread 31 hands thread 0 the plane before's last word
            src[:, 31, 1:] = prev[:, 31, :-1, -1]
            edge = np.roll(src, 1, axis=1)   # __shfl_sync from t - 1
            edge[:, 0, 0] = BIGW
            return edge
        edge = np.roll(src.reshape(B, nw, WARP, 4), 1, axis=2).reshape(
            B, T, 4)                         # __shfl_up_sync by 1
        at = np.arange(4)[None, :] * nw + (np.arange(T) // WARP)[:, None]
        from_ring = ring["r"][:, at]         # ring_r[q*NW + w - 1]
        edge = np.where((t == 0)[None, :, None], from_ring, edge)
    else:
        src = prev[:, :, :, 0].copy()
        if nw == 1:
            # thread 0 hands thread 31 the plane after's first word
            src[:, 0, :-1] = prev[:, 0, 1:, 0]
            edge = np.roll(src, -1, axis=1)  # __shfl_sync from t + 1
            edge[:, 31, 3] = BIGW
            return edge
        edge = np.roll(src.reshape(B, nw, WARP, 4), -1, axis=2).reshape(
            B, T, 4)                         # __shfl_down_sync by 1
        at = np.arange(4)[None, :] * nw + (np.arange(T) // WARP)[:, None]
        from_ring = ring["l"][:, at + 1]     # ring_l[q*NW + w + 1]
        edge = np.where((t == WARP - 1)[None, :, None], from_ring, edge)
    assert not (edge == RING_UNSET).any(), "read an unwritten ring entry"
    return edge


def shifted(prev, edge, P):
    """(isrc, dsrc) words [B, T, 4, W]: P 0 dsrc = lanes u-1, P 1 isrc =
    lanes u+1, by __byte_perm(x, y, 0x5432) of neighbouring words."""
    if P == 0:
        left = np.concatenate([edge[..., None], prev[..., :-1]], axis=-1)
        return prev, byte_perm(left, prev, 0x5432)
    right = np.concatenate([prev[..., 1:], edge[..., None]], axis=-1)
    return byte_perm(prev, right, 0x5432), prev


def run_chars(rows, addr, bpt):
    """[B, T, 4, NX] the runs' characters as words: the aligned words
    around each run (``rows`` [B, row] staged rows with slack, ``addr``
    [T, 4] the runs' first bytes) funnel-shifted to the run."""
    def word_at(a):   # little-endian 32-bit loads
        return sum(rows[:, a + i].astype(np.int64) << (8 * i)
                   for i in range(4))

    return np.stack([funnelshift_r(word_at((addr & ~3) + 4 * i),
                                   word_at((addr & ~3) + 4 * i + 4),
                                   8 * (addr & 3))
                     for i in range(max(1, bpt // 4))], axis=-1)


def run_mismatch(qx, tx, bpt):
    """[B, T, 4, W] mismatch words of each run from its query and target
    character words: xor, bit 7 of a byte set where it differs, spread into
    half-words."""
    x = qx ^ tx
    f = (((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080
    sub = np.stack([byte_perm(f, 0, 0x4140) >> 7,
                    byte_perm(f, 0, 0x4342) >> 7], axis=-1)
    return sub.reshape(*f.shape[:-1], -1)[..., :bpt // 2]


def cell_step(isrc, dsrc, diag, sub):
    """One word of cells: (best, code_lo, code_hi) by the kernel's two
    min-with-predicate steps and its code select."""
    cd = (diag + sub) & M32
    m0, ih, il = vibmin_s16x2(isrc, dsrc)
    best, mh, ml = vibmin_s16x2(cd, (m0 + ONES) & M32)
    code_lo = np.where(ml, 0, np.where(il, 1, 2))
    code_hi = np.where(mh, 0, np.where(ih, 1, 2))
    return best, code_lo, code_hi


def interior_words(lo, hi1, u_words):
    """The kernel's biased lane words: lane u's half of ``el`` is 0x8000
    + u - lo, of ``eh`` 0x8000 + hi1 - 1 - u (``lo``/``hi1`` [B])."""
    el = (u_words[None] + ((0x8000 - lo) * ONES)[:, None, None, None]) & M32
    eh = (((0x8000 + hi1 - 1) * ONES)[:, None, None, None]
          - u_words[None]) & M32
    return el, eh


def lane_range(a, c, n, m):
    """[B] range [lo, hi1) of the lanes the DP computes at wavefront a:
    1 <= i <= n, 1 <= j <= m and the DP boundary i == 0 or j == 0."""
    P = a & 1
    I0, J0 = (a + c - P) // 2, (a - c + P) // 2
    return np.maximum(I0 - n, -J0), np.minimum(m - J0, I0) + 1


def wavefront_kind(U, lo, hi1):
    """[B] kind of a wavefront: FULL where [lo, hi1) covers every lane."""
    return np.where((lo <= 0) & (hi1 >= U), FULL, EDGE)


def i16_wide_mirror(qrp, tp, n, m, *, max_len, band, bpt, steps,
                    seed=0, kinds=None):
    """``nw_fwd_i16x2_wide_kernel<band / (256 * BPT), BPT>`` in numpy over
    all pairs at once: registers [B, T, 4, W], the shuffles and the ring,
    the characters, the DPX steps, the two wavefront kinds, the row words
    and the score select. ``kinds`` (a dict) counts
    the wavefronts of each kind."""
    B, width = qrp.shape
    nw, T, RB, U, W = geometry(band, bpt)
    c, L, S = U, max_len, steps
    rng = np.random.default_rng(seed)
    # staged rows: the row, then slack the run loads may read (garbage)
    sq = np.concatenate([qrp, rng.integers(0, 256, (B, 16))], axis=1)
    st = np.concatenate([tp, rng.integers(0, 256, (B, 16))], axis=1)
    lanes = slot_lanes(band, bpt)
    u_words = words(lanes[..., 0], lanes[..., 1])
    run0 = (np.arange(4)[None, :] * RB + bpt * np.arange(T)[:, None])
    n = n.astype(np.int64)
    m = m.astype(np.int64)
    nm = n + m
    last = np.minimum(nm, S)
    dirs = np.zeros((B, S, RB), np.uint8)
    score = np.where(nm == 0, 0, BIG32).astype(np.int64)
    v1 = np.full((B, T, 4, W), BIGW, np.int64)
    v2 = np.full((B, T, 4, W), BIGW, np.int64)
    v1[:, 0, 2, 0] = BIGW & 0xFFFF0000   # wavefront 0: lane c/2 = 2 RB
    ring = {"r": np.full((B, 4 * nw + 1), RING_UNSET, np.int64),
            "l": np.full((B, 4 * nw + 1), RING_UNSET, np.int64)}
    ring["r"][:, 0] = ring["l"][:, -1] = BIGW
    ring["l"][:, :-1] = v1[:, ::WARP, :, 0].transpose(0, 2, 1).reshape(
        B, -1)
    for a in range(1, int(last.max(initial=0)) + 1):
        P = a & 1
        I0, J0 = (a + c - P) // 2, (a - c + P) // 2
        qs = min(max(c + L - I0, 0), width - U)
        ts = min(max(c + J0 - 1, 0), width - U)
        lo, hi1 = lane_range(a, c, n, m)
        kind = wavefront_kind(U, lo, hi1)
        if kinds is not None:
            for k in np.unique(kind[a <= last]):
                kinds[int(k)] = kinds.get(int(k), 0) + 1
        edge = edges(v1, P, ring, nw)
        isrc, dsrc = shifted(v1, edge, P)
        if P == 1:   # a turn's two wavefronts read the same target run
            tx, ts_turn = run_chars(st, ts + run0, bpt), ts
        assert ts == ts_turn
        sub = run_mismatch(run_chars(sq, qs + run0, bpt), tx, bpt)
        best, code_lo, code_hi = cell_step(isrc, dsrc, v2, sub)
        el, eh = interior_words(np.clip(lo, 0, U), np.clip(hi1, 0, U),
                                u_words)
        masked = vmins2(vimax3_s16x2(best, el, eh), BIGW)
        v = np.where((kind == FULL)[:, None, None, None],
                     vmins2(best, BIGW), masked)
        # direction words: slot k at byte k, plane q at bit 2q
        nx = (bpt + 3) // 4
        dirw = np.zeros((B, T, nx), np.int64)
        for q in range(4):
            for j in range(W):
                sh = 8 * ((2 * j) % 4) + 2 * q
                dirw[:, :, (2 * j) // 4] |= (
                    (code_lo[:, :, q, j] << sh)
                    | (code_hi[:, :, q, j] << (sh + 8)))
        live = a <= last
        dirs[live, a - 1] = row_bytes(dirw[live], bpt)
        fin = nm == a
        if fin.any():
            uf = np.clip((m - n + c - P) // 2, 0, U - 1)
            for b in np.flatnonzero(fin):
                u = int(uf[b])
                k = u % bpt
                lo_h, hi_h = halves(v[b, (u % RB) // bpt, u // RB, k // 2])
                s = int(hi_h if k & 1 else lo_h)
                score[b] = BIG32 if s == BIG16 else s
        if nw > 1:
            if P == 1:
                ring["r"][:, 1:] = v[:, WARP - 1::WARP, :, -1].transpose(
                    0, 2, 1).reshape(B, -1)
            else:
                ring["l"][:, :-1] = v[:, ::WARP, :, 0].transpose(
                    0, 2, 1).reshape(B, -1)
        v2, v1 = v1, v
    return dirs, score


def _pairs(band, seed, max_len, specs):
    """Rows as the engines lay them out (query reversed, pads 6/7): one
    pair a spec ``(length, error, shift)``; ``shift`` moves the target's
    length away from the query's, towards the band's edge."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    c = band // 2
    width = c + max_len + band
    qrp = np.full((len(specs), width), 6, np.uint8)
    tp = np.full((len(specs), width), 7, np.uint8)
    n = np.zeros(len(specs), np.int32)
    m = np.zeros(len(specs), np.int32)
    for k, (ln, err, shift) in enumerate(specs):
        t = bases[rng.integers(0, 4, ln)]
        q = t.copy()
        flips = rng.random(ln) < err
        q[flips] = bases[rng.integers(0, 4, int(flips.sum()))]
        q = q[:max(0, min(max_len, ln - shift))]
        qrp[k, c + max_len - len(q): c + max_len] = q[::-1]
        tp[k, c: c + len(t)] = t
        n[k], m[k] = len(q), len(t)
    return qrp, tp, n, m


# ------------------------------------------------------- tests

@pytest.mark.parametrize("band,bpt", BODIES)
def test_every_lane_has_one_slot_and_row_byte_one_writer(band, bpt):
    nw, T, RB, U, W = geometry(band, bpt)
    assert 1 <= nw <= 8 and band == 256 * bpt * nw and U == band // 2
    # one aligned base and one shift serve the four planes' characters
    assert RB % 4 == 0
    lanes = slot_lanes(band, bpt)
    assert np.array_equal(np.sort(lanes.ravel()), np.arange(U))
    # a lane's (byte, plane) is the planar layout's: thread tg's bytes
    # BPT*tg .. + BPT-1, plane q at bit 2q
    tg = np.arange(T)[:, None, None, None]
    k = 2 * np.arange(W)[None, None, :, None] + np.arange(2)
    assert np.array_equal(lanes % RB, np.broadcast_to(bpt * tg + k,
                                                      lanes.shape))
    assert np.array_equal(lanes // RB, np.broadcast_to(
        np.arange(4)[None, :, None, None], lanes.shape))
    rng = np.random.default_rng(band + bpt)
    for _ in range(5):
        codes = rng.integers(0, 3, U)
        c = codes[lanes]
        dirw = np.zeros((T, (bpt + 3) // 4), np.int64)
        for q in range(4):
            for j in range(W):
                sh = 8 * ((2 * j) % 4) + 2 * q
                dirw[:, (2 * j) // 4] |= ((c[:, q, j, 0] << sh)
                                          | (c[:, q, j, 1] << (sh + 8)))
        assert np.array_equal(row_bytes(dirw, bpt), planar_row(codes))


@pytest.mark.parametrize("band,bpt", BODIES)
def test_shifted_words_are_neighbour_lanes(band, bpt):
    """isrc/dsrc of every half through the byte_perm shifts, the shuffles
    and (NW > 1) the ring as the previous wavefront left it: lane u+1 (P 1)
    or u-1 (P 0), BIG16 past either end of the band."""
    nw, T, RB, U, W = geometry(band, bpt)
    prev = lane_words(np.arange(U), band, bpt)[None]
    lanes = slot_lanes(band, bpt)
    for P in (0, 1):
        ring = {"r": np.full((1, 4 * nw + 1), RING_UNSET, np.int64),
                "l": np.full((1, 4 * nw + 1), RING_UNSET, np.int64)}
        ring["r"][:, 0] = ring["l"][:, -1] = BIGW
        if P == 0:   # written by the wavefront before, of parity 1
            ring["r"][:, 1:] = prev[:, WARP - 1::WARP, :, -1].transpose(
                0, 2, 1).reshape(1, -1)
        else:
            ring["l"][:, :-1] = prev[:, ::WARP, :, 0].transpose(
                0, 2, 1).reshape(1, -1)
        isrc, dsrc = shifted(prev, edges(prev, P, ring, nw), P)
        moved, kept = (isrc, dsrc) if P else (dsrc, isrc)
        want = lanes + (1 if P else -1)
        want = np.where((want < 0) | (want >= U), BIG16, want)
        got = np.stack(halves(moved[0]), axis=-1)
        assert np.array_equal(got, want)
        assert np.array_equal(np.stack(halves(kept[0]), axis=-1), lanes)


VALUES = [0, 1, 2, 3, 7, BIG16 - 2, BIG16 - 1, BIG16, BIG16 + 1]


def test_min_with_predicate_keeps_the_tie_order():
    """The two __vibmin_s16x2 steps give the plain version's best and
    code on every combination of values a cell can see, ties included
    (diagonal first, then consume query, then consume target), and the
    clamp keeps the saturation class."""
    d, i, x, s = np.meshgrid(VALUES, VALUES, VALUES, [0, 1], indexing="ij")
    d, i, x, s = (a.ravel().astype(np.int64) for a in (d, i, x, s))
    cd, ci, cdel = d + s, i + 1, x + 1
    best = np.minimum(cd, np.minimum(ci, cdel))
    want = np.where(cd == best, 0, 2 - (ci == best))
    # lane pairs: low half and high half from two different combinations
    r = np.roll(np.arange(len(d)), 7)
    got_best, lo, hi = cell_step(words(i, i[r]), words(x, x[r]),
                                 words(d, d[r]), words(s, s[r]))
    assert np.array_equal(lo, want) and np.array_equal(hi, want[r])
    assert np.array_equal(np.stack(halves(got_best)),
                          np.stack([best, best[r]]))
    clamped = np.stack(halves(vmins2(got_best, BIGW)))
    assert np.array_equal(clamped, np.minimum(np.stack([best, best[r]]),
                                              BIG16))
    assert (want == 0).any() and (want == 1).any() and (want == 2).any()


@pytest.mark.parametrize("band,bpt", [(512, 2), (2048, 8), (8192, 4)])
def test_interior_words_mask_outside_lanes(band, bpt):
    """min(max3(best, el, eh), BIG16) is min(best, BIG16) inside [lo,
    hi1) and BIG16 outside, for clamped ranges at and past either end."""
    _, _, _, U, _ = geometry(band, bpt)
    lanes = slot_lanes(band, bpt)
    u_words = words(lanes[..., 0], lanes[..., 1])
    rng = np.random.default_rng(band)
    lo = np.array([0, 0, U, 3, U // 2, 0, 1])
    hi1 = np.array([U, 0, U, U - 3, U // 2 + 5, 1, U - 1])
    best_lanes = rng.integers(0, BIG16 + 2, (len(lo), U))
    best = lane_words(best_lanes, band, bpt)
    el, eh = interior_words(lo, hi1, u_words)
    v = vmins2(vimax3_s16x2(best, el, eh), BIGW)
    inside = (lanes[None] >= lo[:, None, None, None, None]) & (
        lanes[None] < hi1[:, None, None, None, None])
    want = np.where(inside, np.minimum(best_lanes[:, lanes], BIG16), BIG16)
    assert np.array_equal(np.stack(halves(v), axis=-1), want)


@pytest.mark.parametrize("bpt", [2, 4, 8])
def test_run_mismatch_words(bpt):
    """Mismatch words at every alignment of the two runs, on any bytes
    (0-255, so the per-byte test cannot lean on ASCII)."""
    rng = np.random.default_rng(bpt)
    B, width = 3, 64
    sq = rng.integers(0, 256, (B, width + 16))
    st = sq.copy()
    flip = rng.random(st.shape) < 0.4
    st[flip] = rng.integers(0, 256, int(flip.sum()))
    qa = np.arange(16)[:, None] + 8 * np.arange(4)[None, :]   # [T=16, 4]
    ta = (qa + 5) % 29
    got = run_mismatch(run_chars(sq, qa, bpt), run_chars(st, ta, bpt), bpt)
    for k in range(bpt):
        want = sq[:, qa + k] != st[:, ta + k]
        half = (got[..., k // 2] >> (16 * (k & 1))) & 0xFFFF
        assert np.array_equal(half, want.astype(np.int64))


def _held(band, bpt, max_len, specs, steps, seed):
    qrp, tp, n, m = _pairs(band, seed, max_len, specs)
    kinds = {}
    dirs, score = i16_wide_mirror(qrp, tp, n, m, max_len=max_len,
                                  band=band, bpt=bpt, steps=steps,
                                  seed=seed, kinds=kinds)
    want_dirs, want_score = cuda_nw.nw_fwd_plain(
        *(torch.from_numpy(x) for x in (qrp, tp, n, m)), max_len=max_len,
        band=band, steps=steps, packed16=True)
    nm = n + m
    assert (nm > steps).any() and (nm == 0).any() and (n == 0).any()
    assert np.array_equal(score, want_score.numpy())
    # both leave the rows at and past a pair's n + m at 0
    assert np.array_equal(dirs, want_dirs.numpy())
    return kinds


# (length, error, shift): an empty pair, a query cut to nothing (n = 0),
# pairs at 10% and 40% error (the latter leaves the band), a pair whose
# target outruns its query towards the band's edge, and pairs longer than
# the sweep (n + m > steps)
SPECS = [(0, 0.0, 0), (40, 0.1, 40), (120, 0.1, 0), (200, 0.4, 0),
         (180, 0.05, 60), (250, 0.1, 3), (240, 0.2, 0)]


@pytest.mark.parametrize("band,bpt", BODIES)
def test_wide_i16_mirror_matches_plain(band, bpt):
    kinds = _held(band, bpt, 256, SPECS, 384, seed=band + bpt)
    assert kinds.get(EDGE)


# band -> (max_len, specs, steps): pairs longer than c = 256, 512 and 1024,
# so the FULL and EDGE wavefronts run (at NW 1, 2 and 4: the ring over more
# than two warps and its barrier on FULL wavefronts), one of the pairs cut
# by the sweep
LONG_SPECS = [(0, 0.0, 0), (30, 0.1, 30), (700, 0.1, 0), (560, 0.3, 0),
              (650, 0.05, 150), (760, 0.1, 0)]
LONG = {512: (768, LONG_SPECS, 1280), 1024: (768, LONG_SPECS, 1280),
        2048: (1280, [(0, 0.0, 0), (30, 0.1, 30), (1200, 0.1, 0),
                      (1100, 0.3, 0), (1150, 0.05, 100), (1270, 0.1, 0)],
               2400)}


@pytest.mark.parametrize("band,bpt", [(512, 2), (1024, 2), (2048, 2)])
def test_wide_i16_mirror_matches_plain_past_the_border(band, bpt):
    max_len, specs, steps = LONG[band]
    kinds = _held(band, bpt, max_len, specs, steps, seed=band * bpt)
    assert kinds.get(FULL) and kinds.get(EDGE)


def test_fwd_i16x2_body_and_instantiations():
    """fwd_i16x2_body names an instantiated (band, BPT) at the bands it
    covers, for every launch size, and the block body elsewhere; each
    band's limits rise and end in a catch-all, so a BPT covers one run of
    launch sizes; rt_nw_fwd_i16x2_wide instantiates exactly
    I16X2_WIDE_BPTS."""
    src = (pathlib.Path(cuda_nw.__file__).parent / "kernels"
           / "nw_fwd.cu").read_text()
    inst = {(int(b), int(p)) for b, p in
            re.findall(r"^\s*RT_I16X2_WIDE\((\d+), (\d+)\)", src, re.M)}
    assert inst == set(BODIES)
    for band, steps in cuda_nw.I16X2_WIDE_BPT.items():
        limits = [most for most, _ in steps]
        assert limits[-1] is None and limits[:-1] == sorted(limits[:-1])
        for k, (most, bpt) in enumerate(steps):
            low = limits[k - 1] + 1 if k else 1
            for B in {low, most or 1 << 20}:
                assert cuda_nw.fwd_i16x2_body(band, B) == ("wide", bpt)
    for band in (128, 256, 384, 512, 768, 1024, 2048, 4096, 8192, 16384):
        for B in (1, 128, 2048, 32768):
            body, bpt = cuda_nw.fwd_i16x2_body(band, B)
            if band in cuda_nw.I16X2_WIDE_BPT:
                assert body == "wide" and (band, bpt) in inst
            else:
                assert (body, bpt) == ("block", None)
    assert set(cuda_nw.I16X2_WIDE_BPT) == set(cuda_nw.I16X2_WIDE_BPTS)


def test_use_packed16_follows_the_table():
    """use_packed16 takes K4 exactly where the guard holds and the table
    names it (or does not list the band), whatever the bucket's length."""
    assert set(swar.FORWARD_KERNEL.values()) <= {"nw_fwd_i32",
                                                 "nw_fwd_i16x2"}
    for band in (64, 128, 384, 512, 1024, 2048, 4096, 8192, 16384):
        want = swar.FORWARD_KERNEL.get(band, "nw_fwd_i16x2") == \
            "nw_fwd_i16x2"
        assert swar.use_packed16(16384, band) == want
        assert not swar.use_packed16(BIG16 - 2, band)   # guard fails
