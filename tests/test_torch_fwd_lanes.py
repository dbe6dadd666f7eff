"""The lane maps of the int32 forward kernel's warp and wide bodies
(``nw_fwd_i32_warp_kernel<LPT>`` and ``nw_fwd_i32_wide_kernel<NW>`` in
``racon_tpu_torch/ops/kernels/nw_fwd.cu``), mirrored in Python and checked
on the CPU.

The warp body runs one pair per warp at the bands 128..512 that are
multiples of 64 (``cuda_nw.fwd_i32_body``). With ``LPT = band / 64`` lanes
a thread and ``U = 32 * LPT`` lanes a wavefront:

- thread ``t`` owns the lanes ``u = LPT * t + k``, ``k = 0 .. LPT - 1``;
- a direction row has ``RB = 8 * LPT`` bytes, lane ``u`` in byte
  ``u % RB`` at shift ``2 * (u // RB)`` (the planar layout of
  ``cuda_nw.nw_fwd_plain``), so thread ``t``'s lanes sit in plane
  ``t // 8`` at bytes ``LPT * (t % 8) + k``;
- each thread packs its codes one to a byte, shifted to its plane, ORs the
  words of its shuffle-xor partners ``t ^ 8`` and ``t ^ 16``, and threads
  0-7 store ``LPT`` bytes each, as chunks of ``G`` bytes (``G`` the largest
  power of two dividing ``LPT``) at ``G``-aligned offsets.

The wide body runs one pair per block of ``NW = band / 1024`` warps at the
bands ``cuda_nw.WIDE_BANDS`` (1024, 4096 and 8192). With ``T = 32 * NW =
RB / 4`` threads:

- thread ``tg`` owns the direction bytes ``4 * tg .. 4 * tg + 3``: for
  plane ``q`` and slot ``k`` (both 0..3) the lane ``u = q * RB + 4 * tg +
  k``, one 4-lane run per plane;
- its word of a row is ``d0 | d1 << 2 | d2 << 4 | d3 << 6``, ``dq`` the
  plane's four codes one to a byte, stored as one little-endian 32-bit word
  at byte ``4 * tg``;
- a run's edge lane comes by shuffle inside a warp; thread 0 and thread 31
  of a warp read it from a ring in shared memory that holds run ``(q, w)``
  at ``q * NW + w``, with one BIG sentinel at each end. A wavefront of
  parity 1 writes the runs' last lanes (``ring_r``) for the next one, a
  wavefront of parity 0 their first lanes (``ring_l``).

The mirrors below follow the kernels step for step (shuffles and the ring
included) and are held against ``nw_fwd_plain`` on the same inputs. The
card holds the kernels themselves against ``nw_fwd_plain``
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import cuda_nw

WARP = 32
BIG = cuda_nw.BIG32
WARP_BANDS = [128, 192, 256, 320, 384, 448, 512]
THREADS = np.arange(WARP)


def lanes_per_thread(band):
    return band // 64


def thread_lanes(lpt):
    """[32, LPT] lane of each (thread, slot)."""
    return lpt * THREADS[:, None] + np.arange(lpt)[None, :]


def thread_bytes(lpt):
    """[32, LPT] (byte, plane) of each (thread, slot)'s direction code."""
    byte = lpt * (THREADS[:, None] % 8) + np.arange(lpt)[None, :]
    plane = np.broadcast_to((THREADS // 8)[:, None], byte.shape)
    return byte, plane


def store_chunks(lpt):
    """(offset, size) of every store threads 0-7 make in one row."""
    g = lpt & -lpt
    return [(lpt * t + g * j, g) for t in range(8) for j in range(lpt // g)]


def assemble_row(codes):
    """The kernel's direction row from the codes ``[32, LPT]`` of each
    (thread, slot): per-thread words, the two shuffle-xor ORs, the chunked
    stores of threads 0-7."""
    lpt = codes.shape[1]
    shifts = 8 * np.arange(lpt, dtype=np.uint64)
    words = (codes.astype(np.uint64) << shifts[None, :]).sum(axis=1)
    words = words << (2 * (THREADS // 8)).astype(np.uint64)
    for mask in (8, 16):
        words = words | words[THREADS ^ mask]
    row = np.zeros(8 * lpt, np.uint8)
    for off, g in store_chunks(lpt):
        chunk = int(words[off // lpt]) >> (8 * (off % lpt))
        for x in range(g):
            row[off + x] = (chunk >> (8 * x)) & 0xFF
    return row


def planar_row(codes_by_lane):
    """``nw_fwd_plain``'s packing of one row of lane codes ``[U]``."""
    rb = len(codes_by_lane) // 4
    d = codes_by_lane.astype(np.int64)
    return (d[:rb] | (d[rb:2 * rb] << 2) | (d[2 * rb:3 * rb] << 4)
            | (d[3 * rb:] << 6)).astype(np.uint8)


def warp_fwd_mirror(qrp, tp, n, m, *, max_len, band, steps):
    """``nw_fwd_i32_warp_kernel<band / 64>`` in numpy, one pair at a time:
    per-thread register arrays ``[32, LPT]``, the edge shuffles, the
    interior range, the boundary lanes, the row assembly and the score
    select."""
    B, width = qrp.shape
    lpt = lanes_per_thread(band)
    U, c, L, S = WARP * lpt, band // 2, max_len, steps
    kk = np.arange(lpt)[None, :]
    u_t = lpt * THREADS[:, None]
    dirs = np.zeros((B, S, U // 4), np.uint8)
    score = np.zeros(B, np.int64)
    for b in range(B):
        nb, mb = int(n[b]), int(m[b])
        nm = nb + mb
        v1 = np.where(u_t + kk == c // 2, 0, BIG)
        v2 = np.full((WARP, lpt), BIG)
        if nm == 0 or nm > S:
            score[b] = 0 if nm == 0 else BIG
        for a in range(1, min(nm, S) + 1):
            p = a & 1
            I0, J0 = (a + c - p) // 2, (a - c + p) // 2
            qs = min(max(c + L - I0, 0), width - U) + u_t
            ts = min(max(c + J0 - 1, 0), width - U) + u_t
            # the interior lanes as a per-thread bit mask
            lo = np.clip(max(I0 - nb, 1 - J0) - u_t, 0, lpt)
            hi1 = np.clip(min(mb - J0, I0 - 1) + 1 - u_t, 0, lpt)
            inner = ((1 << hi1) - 1) & ~((1 << lo) - 1)
            if p == 0:   # __shfl_up_sync of slot LPT-1; thread 0 gets BIG
                edge = np.roll(v1[:, -1], 1)
                edge[0] = BIG
                dsrc = np.concatenate([edge[:, None], v1[:, :-1]], axis=1)
                isrc = v1
            else:        # __shfl_down_sync of slot 0; thread 31 gets BIG
                edge = np.roll(v1[:, 0], -1)
                edge[-1] = BIG
                dsrc = v1
                isrc = np.concatenate([v1[:, 1:], edge[:, None]], axis=1)
            sub = (qrp[b][qs + kk] != tp[b][ts + kk]).astype(np.int64)
            cd, ci, cdel = v2 + sub, isrc + 1, dsrc + 1
            best = np.minimum(cd, np.minimum(ci, cdel))
            d = np.where(cd == best, 0, np.where(ci == best, 1, 2))
            v = np.where((inner >> kk) & 1, np.minimum(best, BIG), BIG)
            if a <= c:
                kI = I0 - u_t if a <= mb else -1
                kJ = -J0 - u_t if a <= nb else -1
                v = np.where((kk == kI) | (kk == kJ), a, v)
            dirs[b, a - 1] = assemble_row(d)
            if a == nm:
                uf = min(max((mb - nb + c - p) // 2, 0), U - 1)
                score[b] = v[uf // lpt, uf % lpt]
            v2, v1 = v1, v
    return dirs, score


WIDE_BANDS = list(cuda_nw.WIDE_BANDS)
# an unwritten ring entry; a read of one would show in the mirror's output
RING_UNSET = -7777


def wide_threads(band):
    """T = 32 * NW = RB / 4 threads a block (NW = band / 1024 warps)."""
    return band // 32


def wide_lanes(band):
    """[T, 4, 4] lane of each (thread, plane, slot): q * RB + 4 * tg + k."""
    T, RB = wide_threads(band), band // 8
    return (np.arange(4)[None, :, None] * RB
            + 4 * np.arange(T)[:, None, None] + np.arange(4)[None, None, :])


def wide_ring(T):
    """The kernel's edge ring, unwritten: ``r`` with its BIG sentinel in
    front (run (q, w) at 1 + q * NW + w), ``l`` with its sentinel behind
    (run (q, w) at q * NW + w)."""
    NW = T // WARP
    r = np.full(4 * NW + 1, RING_UNSET, np.int64)
    ring_l = np.full(4 * NW + 1, RING_UNSET, np.int64)
    r[0] = ring_l[-1] = BIG
    return {"r": r, "l": ring_l}


def wide_ring_write(ring, cur, P):
    """End of a wavefront of parity ``P``: thread 31 of each warp writes its
    runs' last lanes (P == 1), thread 0 their first lanes (P == 0)."""
    if P == 1:
        ring["r"][1:] = cur[WARP - 1::WARP, :, 3].T.ravel()
    else:
        ring["l"][:-1] = cur[::WARP, :, 0].T.ravel()


def wide_edges(prev, P, ring):
    """[T, 4] edge value of each (thread, plane) in a wavefront of parity
    ``P``: ``__shfl_up_sync`` of slot 3 (P == 0) or ``__shfl_down_sync`` of
    slot 0 (P == 1) inside each warp, the ring at thread 0 / thread 31."""
    T = prev.shape[0]
    NW = T // WARP
    t = np.arange(T) % WARP
    w = np.arange(T) // WARP
    at = np.arange(4)[None, :] * NW + w[:, None]   # run (q, w) in the ring
    if P == 0:
        lanes = prev[:, :, 3].reshape(NW, WARP, 4)
        edge = np.roll(lanes, 1, axis=1).reshape(T, 4)
        # ring_r[q * NW + w - 1]: the sentinel sits at -1, so 1 + that
        from_ring = ring["r"][at]
        edge = np.where((t == 0)[:, None], from_ring, edge)
    else:
        lanes = prev[:, :, 0].reshape(NW, WARP, 4)
        edge = np.roll(lanes, -1, axis=1).reshape(T, 4)
        from_ring = ring["l"][at + 1]
        edge = np.where((t == WARP - 1)[:, None], from_ring, edge)
    assert not (edge == RING_UNSET).any(), "read an unwritten ring entry"
    return edge


def wide_row_words(codes):
    """[T] 32-bit row words from the codes [T, 4, 4] of each (thread,
    plane, slot): byte k of thread tg's word = OR over q of code << 2q."""
    shifts = (8 * np.arange(4)[None, :] + 2 * np.arange(4)[:, None])
    return (codes.astype(np.uint32) << shifts.astype(np.uint32)[None]
            ).sum(axis=(1, 2)).astype(np.uint32)


def wide_row(codes):
    """The direction row the block stores: the words little-endian, thread
    tg's at byte 4 * tg."""
    return wide_row_words(codes).astype("<u4").view(np.uint8)


def wide_fwd_mirror(qrp, tp, n, m, *, max_len, band, steps):
    """``nw_fwd_i32_wide_kernel<band / 1024>`` in numpy, one pair at a
    time: registers [T, 4, 4], the shuffles and the ring, the per-plane
    interior masks and boundary slots, the row words and the score
    select."""
    B, width = qrp.shape
    T = wide_threads(band)
    RB, U = band // 8, band // 2
    c, L, S = U, max_len, steps
    lanes = wide_lanes(band)
    kk = np.arange(4)[None, None, :]
    u_tq = lanes[:, :, :1]   # each run's first lane, [T, 4, 1]
    dirs = np.zeros((B, S, RB), np.uint8)
    score = np.zeros(B, np.int64)
    for b in range(B):
        nb, mb = int(n[b]), int(m[b])
        nm = nb + mb
        v1 = np.where(lanes == c // 2, 0, BIG)
        v2 = np.full((T, 4, 4), BIG)
        ring = wide_ring(T)
        wide_ring_write(ring, v1, 0)   # wavefront 1 reads the first lanes
        if nm == 0 or nm > S:
            score[b] = 0 if nm == 0 else BIG
        for a in range(1, min(nm, S) + 1):
            P = a & 1
            I0, J0 = (a + c - P) // 2, (a - c + P) // 2
            qs = min(max(c + L - I0, 0), width - U) + lanes
            ts = min(max(c + J0 - 1, 0), width - U) + lanes
            # each run's interior slots as a bit mask
            lo = np.clip(max(I0 - nb, 1 - J0) - u_tq, 0, 4)
            hi1 = np.clip(min(mb - J0, I0 - 1) + 1 - u_tq, 0, 4)
            inner = ((1 << hi1) - 1) & ~((1 << lo) - 1)
            edge = wide_edges(v1, P, ring)[:, :, None]
            if P == 0:
                dsrc = np.concatenate([edge, v1[:, :, :-1]], axis=2)
                isrc = v1
            else:
                dsrc = v1
                isrc = np.concatenate([v1[:, :, 1:], edge], axis=2)
            sub = (qrp[b][qs] != tp[b][ts]).astype(np.int64)
            cd, ci, cdel = v2 + sub, isrc + 1, dsrc + 1
            best = np.minimum(cd, np.minimum(ci, cdel))
            d = np.where(cd == best, 0, np.where(ci == best, 1, 2))
            v = np.where((inner >> kk) & 1, np.minimum(best, BIG), BIG)
            if a <= c:
                kI = I0 - u_tq if a <= mb else -1
                kJ = -J0 - u_tq if a <= nb else -1
                v = np.where((kk == kI) | (kk == kJ), a, v)
            dirs[b, a - 1] = wide_row(d)
            if a == nm:
                uf = min(max((mb - nb + c - P) // 2, 0), U - 1)
                score[b] = v[(uf % RB) // 4, uf // RB, uf % 4]
            wide_ring_write(ring, v, P)
            v2, v1 = v1, v
    return dirs, score


# (length, error) of the pairs _pairs_inputs lays out
SPECS = [(0, 0.0), (120, 0.1), (200, 0.4), (250, 0.1), (90, 0.25)]


def _pairs_inputs(band, seed, max_len=256, specs=SPECS):
    """Rows as the engines lay them out (query reversed, pads 6/7): by
    default an empty pair, pairs at 10% and 40% error (the latter leaves
    the band) and long pairs whose ``n + m`` passes ``steps``."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    c = band // 2
    width = c + max_len + band
    qrp = np.full((len(specs), width), 6, np.uint8)
    tp = np.full((len(specs), width), 7, np.uint8)
    n = np.zeros(len(specs), np.int32)
    m = np.zeros(len(specs), np.int32)
    for k, (ln, err) in enumerate(specs):
        t = bases[rng.integers(0, 4, ln)]
        q = t.copy()
        flips = rng.random(ln) < err
        q[flips] = bases[rng.integers(0, 4, int(flips.sum()))]
        ins = 3 if ln else 0
        q = np.insert(q, rng.integers(0, len(q) + 1, ins),
                      bases[rng.integers(0, 4, ins)])[:max_len]
        qrp[k, c + max_len - len(q): c + max_len] = q[::-1]
        tp[k, c: c + len(t)] = t
        n[k], m[k] = len(q), len(t)
    return qrp, tp, n, m, max_len


@pytest.mark.parametrize("band", WARP_BANDS)
def test_every_lane_has_one_thread_slot(band):
    lpt = lanes_per_thread(band)
    lanes = thread_lanes(lpt).ravel()
    U = band // 2
    assert U == WARP * lpt
    assert np.array_equal(np.sort(lanes), np.arange(U))


@pytest.mark.parametrize("band", WARP_BANDS)
def test_every_row_byte_plane_written_once(band):
    lpt = lanes_per_thread(band)
    U, RB = band // 2, band // 8
    lanes = thread_lanes(lpt)
    byte, plane = thread_bytes(lpt)
    # the kernel's (byte, plane) of a lane is the planar layout's
    assert np.array_equal(byte, lanes % RB)
    assert np.array_equal(plane, lanes // RB)
    cells = np.bincount((plane * RB + byte).ravel(), minlength=4 * RB)
    assert cells.shape == (4 * RB,) and (cells == 1).all()
    # threads 0-7's chunked stores cover the row's bytes once, each at an
    # offset aligned to its size
    covered = np.zeros(RB, np.int64)
    for off, g in store_chunks(lpt):
        assert off % g == 0
        covered[off:off + g] += 1
    assert (covered == 1).all()
    assert U == 4 * RB


@pytest.mark.parametrize("band", WARP_BANDS)
def test_shift_and_or_matches_planar_packing(band):
    lpt = lanes_per_thread(band)
    rng = np.random.default_rng(band)
    lanes = thread_lanes(lpt)
    for _ in range(20):
        codes_by_lane = rng.integers(0, 3, band // 2)
        got = assemble_row(codes_by_lane[lanes])
        assert np.array_equal(got, planar_row(codes_by_lane))


@pytest.mark.parametrize("band", WARP_BANDS)
def test_warp_mirror_matches_plain(band):
    qrp, tp, n, m, max_len = _pairs_inputs(band, seed=band + 7)
    steps = 384   # below n + m for the long pairs
    dirs, score = warp_fwd_mirror(qrp, tp, n, m, max_len=max_len,
                                  band=band, steps=steps)
    want_dirs, want_score = cuda_nw.nw_fwd_plain(
        *(torch.from_numpy(x) for x in (qrp, tp, n, m)), max_len=max_len,
        band=band, steps=steps)
    assert (n + m > steps).any() and (n + m == 0).any()
    assert np.array_equal(score, want_score.numpy())
    # both leave the rows at and past a pair's n + m at 0
    assert np.array_equal(dirs, want_dirs.numpy())


@pytest.mark.parametrize("band", WIDE_BANDS)
def test_wide_every_lane_has_one_thread_plane_slot(band):
    T, U = wide_threads(band), band // 2
    assert T == WARP * (band // 1024) and T == band // 8 // 4
    lanes = wide_lanes(band).ravel()
    assert np.array_equal(np.sort(lanes), np.arange(U))


@pytest.mark.parametrize("band", WIDE_BANDS)
def test_wide_every_row_byte_has_one_writer(band):
    RB, T = band // 8, wide_threads(band)
    lanes = wide_lanes(band)
    # thread tg's (plane q, slot k) is the planar layout's byte u % RB =
    # 4 * tg + k at plane u // RB = q
    tg = np.arange(T)[:, None, None]
    assert np.array_equal(lanes % RB, np.broadcast_to(
        4 * tg + np.arange(4)[None, None, :], lanes.shape))
    assert np.array_equal(lanes // RB, np.broadcast_to(
        np.arange(4)[None, :, None], lanes.shape))
    # the threads' aligned 32-bit words cover each byte of a row once
    covered = np.zeros(RB, np.int64)
    for x in range(T):
        covered[4 * x: 4 * x + 4] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("band", WIDE_BANDS)
def test_wide_edges_are_neighbour_lanes(band):
    """The edge each (thread, plane) receives is lane u - 1 of its run's
    first lane (P 0) or u + 1 of its last (P 1), through the shuffles and
    the ring as the previous wavefront left it; BIG only at lanes 0 and
    U - 1."""
    U, T = band // 2, wide_threads(band)
    lanes = wide_lanes(band)
    for P in (0, 1):
        ring = wide_ring(T)
        wide_ring_write(ring, lanes, 1 - P)   # the previous wavefront's side
        edge = wide_edges(lanes, P, ring)
        if P == 0:
            want = lanes[:, :, 0] - 1
            want = np.where(want < 0, BIG, want)
        else:
            want = lanes[:, :, 3] + 1
            want = np.where(want >= U, BIG, want)
        assert np.array_equal(edge, want)
        assert (edge == BIG).sum() == 1


@pytest.mark.parametrize("band", WIDE_BANDS)
def test_wide_row_words_match_planar_packing(band):
    rng = np.random.default_rng(band)
    lanes = wide_lanes(band)
    for _ in range(10):
        codes_by_lane = rng.integers(0, 3, band // 2)
        got = wide_row(codes_by_lane[lanes])
        assert np.array_equal(got, planar_row(codes_by_lane))


# pairs shorter than c and, at band 1024, longer (the wavefronts past c
# drop the boundary tests), an empty pair, a pair at 40% error that leaves
# the band
WIDE_SPECS = [(0, 0.0), (120, 0.1), (700, 0.1), (600, 0.4), (300, 0.25),
              (760, 0.05)]


# one warp (the ring links its own planes) and four (it links the warps)
@pytest.mark.parametrize("band", [1024, 4096])
def test_wide_mirror_matches_plain(band):
    qrp, tp, n, m, max_len = _pairs_inputs(band, seed=band + 11,
                                           max_len=768, specs=WIDE_SPECS)
    steps = 1024   # below n + m for the long pairs
    dirs, score = wide_fwd_mirror(qrp, tp, n, m, max_len=max_len,
                                  band=band, steps=steps)
    want_dirs, want_score = cuda_nw.nw_fwd_plain(
        *(torch.from_numpy(x) for x in (qrp, tp, n, m)), max_len=max_len,
        band=band, steps=steps)
    nm = n + m
    assert (nm > steps).any() and (nm == 0).any()
    assert ((nm > 0) & (nm < band // 2)).any()
    assert band > 1024 or (nm > band // 2).any()
    assert np.array_equal(score, want_score.numpy())
    assert np.array_equal(dirs, want_dirs.numpy())


@pytest.mark.parametrize("band,body", [
    (32, "block"), (64, "block"), (128, "warp"), (384, "warp"),
    (512, "warp"), (768, "block"), (1024, "wide"), (1536, "block"),
    (2048, "block"), (3072, "block"), (4096, "wide"), (8192, "wide"),
    (9216, "block"), (16384, "block")])
def test_fwd_i32_body(band, body):
    assert cuda_nw.fwd_i32_body(band) == body
