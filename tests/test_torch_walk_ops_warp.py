"""The traceback walk's warp body (``walk_ops_kernel`` in
``racon_tpu_torch/ops/kernels/walk_ops.cu``), mirrored in numpy and checked
on the CPU.

The kernel walks one pair per warp, ``WARPS`` warps a block; all 32 lanes
carry the same ``(i, j, t)``:

- window ``w`` covers the direction rows ``R_w - WIN + 1 .. R_w``, ``R_w =
  n + m - 1 - WIN * w``; lane ``k`` stages row ``R_w - k`` (and ``R_w - 32
  - k`` at ``WIN = 64``) when ``0 <= row < S``: the sectors ``staged_span``
  names for the lane predicted from the diagonal ``j - i`` at the time the
  window is issued, 16 B copies into slot ``k`` of the window's buffer
  (``SLOT`` bytes, the first sector then its neighbour);
- the warp keeps a ring of ``NBUF`` buffers: windows ``0 .. NBUF - 1`` are
  issued before the walk, and the first read below ``R_w - WIN + 1`` moves
  it to window ``w + 1`` and issues window ``w + NBUF`` into the buffer of
  window ``w``, predicted on the diagonal of that step;
- the walk goes in chunks: at a chunk's first step the warp moves to the
  next window when that step's row has left the current one, and the
  chunk ends at the next multiple of 512 steps, at S, or (when the step
  reads) after ``(row - (R_w - WIN + 1)) / 2 + 1`` steps, the most a walk
  that lowers the row by 2 a step takes inside the window;
- a step reads its byte from the current buffer when its row is below S
  and its sector was staged, and from device memory otherwise (clipped as
  ``walk_decode`` clips);
- lane ``(t >> 4) & 31`` ORs op ``t`` into its word at ``2 * (t & 15)``;
  when a chunk ends at a multiple ``t`` of 512 the 32 words go out as the
  line at word ``(t - 512) / 16`` (byte by byte when ``S % 16 != 0``);
  when the walk ends at step ``t`` the owner of ``t`` tops its word up with
  code 3, later lanes take 0xFFFFFFFF, the line goes out clipped to the
  row, and the lanes fill the rest of the row with 0xFF words, lane ``l`` at
  words ``line0 / 16 + 32 + l``, ``+ 64``, ...

The constants are read from the kernel's source. The mirror follows the
kernel step for step and is held against ``cuda_nw.walk_ops``'s plain path
(``walk_plain`` + ``pack_ops``) on the grids of ``test_torch_kernels.py``
and on random direction bytes; a staged byte it reads is the byte device
memory holds, so a stale buffer would show. The card holds the kernel
itself against the same plain path (``tests/test_torch_cuda.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from racon_tpu_torch import native
from racon_tpu_torch.ops import cuda_nw
from racon_tpu_torch.utils.simulate import BASES, _mutate
from test_torch_kernels import GRIDS as KERNEL_GRIDS, _grid, _pack

SOURCE = (pathlib.Path(cuda_nw.__file__).parent / "kernels"
          / "walk_ops.cu").read_text()
CONST = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                             SOURCE).group(1))
         for name in ("WARPS", "WIN", "NBUF", "EDGE", "SECTOR", "LINE")}
# shared bytes a staged row: its two sectors
CONST["SLOT"] = CONST["SECTOR"] * int(re.search(
    r"constexpr int SLOT = (\d+) \* SECTOR;", SOURCE).group(1))
WARP = 32
WIN, NBUF, SECTOR, SLOT, LINE = (CONST[k] for k in
                                 ("WIN", "NBUF", "SECTOR", "SLOT", "LINE"))
FULL = 0xFFFFFFFF
POISON = -1


def cdiv2(x: int) -> int:
    """C's ``x / 2`` (truncation toward zero)."""
    return -((-x) // 2) if x < 0 else x // 2


def staged_span(p, d, c, U, RB, stage, edge):
    """``staged_span``: the staged sectors ``(s0, s1)`` of a row with
    parity term ``p`` for a walk predicted on diagonal ``d`` (-1: none)."""
    if not stage:
        return -1, -1
    u = min(max(cdiv2(d + c - p), 0), U - 1)
    bu = u % RB
    nsec = (RB + SECTOR - 1) // SECTOR
    s = bu // SECTOR
    off = bu - s * SECTOR
    length = min(SECTOR, RB - s * SECTOR)
    s1 = -1
    if off < edge:
        s1 = nsec - 1 if s == 0 else s - 1
    elif off >= length - edge:
        s1 = 0 if s + 1 == nsec else s + 1
    return s, (-1 if s1 == s else s1)


def locate(i, j, c, U, RB):
    """``walk_locate``: (op or -1, row, byte, plane)."""
    if i == 0:
        return (3 if j == 0 else 2), 0, 0, 0
    if j == 0:
        return 1, 0, 0, 0
    a = i + j
    p = (a + c) & 1
    u = (j - i + c - p) // 2          # even numerator
    if u < 0 or u >= U:
        return 3, 0, 0, 0
    return -1, a - 1, u % RB, u // RB


class Warp:
    """One warp of the kernel on one pair: its window ring, its 32 words,
    and a record of what it copied, read and stored. ``parity`` and ``edge``
    let a copy of the mirror predict from the wrong parity or stage without
    neighbours."""

    def __init__(self, flat, out, writes, S, band, *, parity=1,
                 edge=CONST["EDGE"]):
        self.flat, self.out, self.writes = flat, out, writes
        self.S, self.c, self.U, self.RB = S, band // 2, band // 2, band // 8
        self.cells = S * self.RB
        self.stage = self.RB % 16 == 0
        self.parity, self.edge = parity, edge
        self.ring = np.full((NBUF, WIN, SLOT), POISON, np.int64)
        self.copies = []        # (row, byte offset in the row) of each 16 B
        self.reads = self.hits = self.exact = self.clipped = 0
        self.line_stores = []   # first word of each in-loop line store

    def span(self, row, d):
        p = (row + self.parity + self.c) & 1
        return staged_span(p, d, self.c, self.U, self.RB, self.stage,
                           self.edge)

    def stage_window(self, buf, R, d):
        self.ring[buf] = POISON        # what a stale buffer would hold
        for k in range(WIN):           # lane k % 32, its row k // 32
            row = R - k
            if not 0 <= row < self.S:
                continue
            for slot, s in enumerate(self.span(row, d)):
                if s < 0:
                    continue
                for piece in range(0, min(SECTOR, self.RB - s * SECTOR), 16):
                    x = s * SECTOR + piece
                    self.copies.append((row, x))
                    lo = row * self.RB + x
                    self.ring[buf, k, slot * SECTOR + piece:
                              slot * SECTOR + piece + 16] = \
                        self.flat[lo:lo + 16]

    def store_word(self, k, word):
        S = self.S
        for q in range(4):
            x = 4 * k + q
            if x < S // 4:
                self.out[x] = (word >> (8 * q)) & 0xFF
                self.writes[x] += 1

    def advance(self, i, j):
        """Into the next window: issue window cur + NBUF into the buffer
        of the window just left, predicted on the current diagonal."""
        self.top -= WIN
        fill = self.cur
        self.cur = (self.cur + 1) % NBUF
        self.dq = self.dq[1:] + [j - i]
        self.stage_window(fill, self.top - (NBUF - 1) * WIN, j - i)

    def read(self, row, byte, plane):
        """The byte a step reads: from the window when staged, else from
        device memory (clipped to the pair's last cell)."""
        S, c, U, RB = self.S, self.c, self.U, self.RB
        top = self.top
        assert 0 <= top - row < WIN, "the walk left its window in a chunk"
        s0, s1 = self.span(row, self.dq[0])
        sec = byte // SECTOR
        self.reads += 1
        if row < S and sec in (s0, s1) and sec >= 0:
            v = int(self.ring[self.cur, top - row,
                              (0 if sec == s0 else SECTOR) + byte % SECTOR])
            assert v != POISON, "read a byte no copy wrote"
            self.hits += 1
        else:
            self.clipped += row >= S
            v = int(self.flat[min(row * RB + byte, self.cells - 1)])
        p = (row + self.parity + c) & 1
        self.exact += byte + RB * plane == min(
            max(cdiv2(self.dq[0] + c - p), 0), U - 1)
        return v

    def walk(self, n, m):
        S, c, U, RB = self.S, self.c, self.U, self.RB
        i, j = n, m
        self.top = i + j - 1
        self.dq = [j - i] * NBUF
        for k in range(NBUF):
            self.stage_window(k, self.top - k * WIN, j - i)
        self.cur = 0
        words = [0] * WARP
        t = op = 0
        # chunks that stay inside one window and one line
        while t < S:
            op0, row0, _, _ = locate(i, j, c, U, RB)
            if op0 < 0 and row0 < self.top - (WIN - 1):
                self.advance(i, j)
            end = min((t | (LINE - 1)) + 1, S)
            if op0 < 0:
                end = min(end, t + (row0 - (self.top - WIN + 1)) // 2 + 1)
            assert end > t, "a chunk without a step"
            while t < end:
                op, row, byte, plane = locate(i, j, c, U, RB)
                if op < 0:
                    op = (self.read(row, byte, plane) >> (2 * plane)) & 3
                if op == 3:
                    break
                words[(t >> 4) & 31] |= op << (2 * (t & 15))
                i -= op != 2
                j -= op != 1
                t += 1
            if op == 3:
                break
            if t % LINE == 0:           # steps t - 512 .. t - 1 are known
                k0 = (t - LINE) // 16
                self.line_stores.append(k0)
                for lane in range(WARP):
                    self.store_word(k0 + lane, words[lane])
                words = [0] * WARP
        self.steps = t
        line0 = t - t % LINE
        if t < S:
            owner = (t >> 4) & 31
            words[owner] |= (FULL << (2 * (t & 15))) & FULL
            for lane in range(owner + 1, WARP):
                words[lane] = FULL
        for lane in range(WARP):
            self.store_word(line0 // 16 + lane, words[lane])
            k = line0 // 16 + 32 + lane
            while 16 * k < S:
                self.store_word(k, FULL)
                k += 32
        return i, j


def mirror_walk_ops(dirs, n, m, *, band, **mutation):
    """The kernel on numpy arrays, one warp (pair) at a time. Returns
    ``(ops [B, S/4], fi, fj, writes [B, S/4], warps)``: ``writes`` counts
    the stores to each output byte, ``warps`` the per-pair records."""
    B, S, RB = dirs.shape
    flat_all = dirs.reshape(B, S * RB).astype(np.int64)
    out = np.full((B, S // 4), POISON, np.int64)
    writes = np.zeros((B, S // 4), np.int64)
    fi = np.zeros(B, np.int64)
    fj = np.zeros(B, np.int64)
    warps = []
    for b in range(B):
        w = Warp(flat_all[b], out[b], writes[b], S, band, **mutation)
        fi[b], fj[b] = w.walk(int(n[b]), int(m[b]))
        warps.append(w)
    return out, fi, fj, writes, warps


def _check(dirs, n, m, band, **mutation):
    """The mirror == the plain path bit for bit, every output byte stored
    once, every copy a whole 16 B piece inside its row; returns the
    warps."""
    B, S, RB = dirs.shape
    out, fi, fj, writes, warps = mirror_walk_ops(dirs, n, m, band=band,
                                                 **mutation)
    want = cuda_nw.walk_ops(torch.from_numpy(dirs), torch.from_numpy(n),
                            torch.from_numpy(m), band=band)
    for got, ref in zip((out, fi, fj), want):
        assert np.array_equal(got, ref.numpy().astype(np.int64))
    assert (writes == 1).all()
    for w in warps:
        assert all(0 <= row < S and x % 16 == 0 and x + 16 <= RB
                   for row, x in w.copies)
        # in-loop stores are whole lines: 32 words from a multiple of 32
        assert all(k0 % 32 == 0 for k0 in w.line_stores)
    return warps


# ------------------------------------------------------------ inputs

def _fwd_dirs(pairs, max_len, band, steps):
    qrp, tp, n, m = _pack(pairs, max_len, band)
    dirs, _ = cuda_nw.nw_fwd(*(torch.from_numpy(a) for a in (qrp, tp, n, m)),
                             max_len=max_len, band=band, steps=steps)
    return dirs.numpy(), n, m


RANDOM = {
    # name: seed, B, band, S, length range, codes. Direction bytes at
    # random: "any" bytes stop a walk on code 3 within a few steps, or let
    # it escape; "wander" codes (0-2 only) make it drift off its diagonal
    # for the whole row, so its reads leave the predicted sectors
    "band_200_S_not_16": (21, 9, 200, 300, (0, 150), "wander"),  # RB 25
    "band_128_S_not_16": (22, 9, 128, 1100, (0, 700), "wander"),  # RB 16
    "band_384_partial_line": (23, 7, 384, 1040, (200, 700), "wander"),
    "band_512_truncated": (24, 6, 512, 1536, (600, 1200), "wander"),
    "band_512_any_bytes": (25, 40, 512, 1024, (0, 600), "any"),
}


def _random_inputs(name):
    seed, B, band, S, (lo, hi), codes = RANDOM[name]
    rng = np.random.default_rng(seed)
    if codes == "any":
        dirs = rng.integers(0, 256, (B, S, band // 8)).astype(np.uint8)
    else:
        c4 = rng.integers(0, 3, (B, S, band // 8, 4)).astype(np.uint8)
        dirs = (c4[..., 0] | c4[..., 1] << 2 | c4[..., 2] << 4
                | c4[..., 3] << 6).astype(np.uint8)
    n = rng.integers(lo, hi, B).astype(np.int32)
    if codes == "any":
        m = rng.integers(lo, hi, B).astype(np.int32)
    else:                               # start inside the band
        m = np.maximum(n + rng.integers(-band // 8, band // 8, B),
                       0).astype(np.int32)
    n[0] = m[0] = 0                     # an empty pair
    return dirs, n, m, band


def _path_dirs(n, m, path, S, band):
    """A direction matrix holding ``path`` (ops of the walk from (n, m), in
    walk order) and zeros elsewhere: the walk over it is the path."""
    c = U = band // 2
    RB = U // 4
    dirs = np.zeros((S, RB), np.uint8)
    i, j = n, m
    for op in path:
        if i > 0 and j > 0:
            a = i + j
            u = (j - i + c - ((a + c) & 1)) // 2
            assert 0 <= u < U
            dirs[a - 1, u % RB] |= op << (2 * (u // RB))
        i -= op != 2
        j -= op != 1
    return dirs


def _cigar_ops(cigar):
    ops = []
    for count, kind in re.findall(r"(\d+)([MID])", cigar):
        ops += [{"M": 0, "I": 1, "D": 2}[kind]] * int(count)
    return ops[::-1]                    # the walk runs from (n, m) back


def _realistic(seed=31, B=3, band=4096, S=16384):
    """``B`` read/draft pairs of 3-8 kbp at the simulator's error rates
    (read 3/3/6%, draft 2/2/6% deletions/insertions/substitutions, as
    ``utils.simulate``), their paths from the host aligner's CIGARs, laid
    into direction matrices at the aligner's (16384, 4096) bucket."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(B):
        truth = BASES[rng.integers(0, 4, int(rng.integers(3000, 8000)))]
        q = _mutate(truth, rng, 0.03, 0.03, 0.06)[0]
        t = _mutate(truth, rng, 0.02, 0.02, 0.06)[0]
        pairs.append((q.tobytes(), t.tobytes()))
    n = np.array([len(q) for q, _ in pairs], np.int32)
    m = np.array([len(t) for _, t in pairs], np.int32)
    dirs = np.stack([_path_dirs(int(n[k]), int(m[k]), _cigar_ops(cg), S,
                                band)
                     for k, cg in enumerate(native.nw_cigar_batch(pairs))])
    return dirs, n, m, band


def _diagonal(band=512, S=1536):
    """Walks that keep to their diagonal: 600 M steps on diagonal 0, and a
    D step then 600 M steps on diagonal 1 (both row parities)."""
    n = np.array([600, 600], np.int32)
    m = np.array([600, 601], np.int32)
    dirs = np.stack([_path_dirs(600, 600, [0] * 600, S, band),
                     _path_dirs(600, 601, [2] + [0] * 600, S, band)])
    return dirs, n, m, band


def hit_share_ok(**mutation):
    """The staging check: at least 99% of the reads of realistic walks hit
    a staged byte, and on a walk that keeps to its diagonal every read is
    of the predicted lane itself."""
    dirs, n, m, band = _realistic()
    warps = mirror_walk_ops(dirs, n, m, band=band, **mutation)[4]
    hit = sum(w.hits for w in warps) / sum(w.reads for w in warps)
    dirs, n, m, band = _diagonal()
    warps = mirror_walk_ops(dirs, n, m, band=band, **mutation)[4]
    exact = all(w.exact == w.reads > 0 for w in warps)
    return hit >= 0.99 and exact


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("grid", KERNEL_GRIDS)
def test_mirror_matches_plain_on_kernel_grids(grid):
    pairs, max_len, band, steps = _grid(grid)
    dirs, n, m = _fwd_dirs(pairs, max_len, band, steps)
    warps = _check(dirs, n, m, band)
    assert sum(w.reads for w in warps) > 0


@pytest.mark.parametrize("name", list(RANDOM))
def test_mirror_matches_plain_on_random_bytes(name):
    dirs, n, m, band = _random_inputs(name)
    B, S, RB = dirs.shape
    warps = _check(dirs, n, m, band)
    reads = sum(w.reads for w in warps)
    hits = sum(w.hits for w in warps)
    assert reads > 0
    if RB % 16:
        assert hits == 0 and not any(w.copies for w in warps)
    elif RB > SECTOR:
        assert 0 < hits < reads
    else:                               # the whole row is staged
        assert hits == sum(w.reads - w.clipped for w in warps)
    if name.endswith("truncated"):
        assert (n.astype(int) + m > S).any()


def test_mirror_matches_plain_on_realistic_paths():
    """Walks of the host aligner's paths: the mirror walks each path to
    (0, 0) and stores one whole line for every 512 steps in the loop."""
    dirs, n, m, band = _realistic()
    warps = _check(dirs, n, m, band)
    assert all(len(w.line_stores) == w.steps // LINE > 0 for w in warps)


@pytest.mark.parametrize("mutation,ok", [
    ({}, True),
    ({"parity": 0}, False),   # the window predicted from the wrong parity
    ({"edge": 0}, False),     # no neighbouring sector
])
def test_hit_share(mutation, ok):
    assert hit_share_ok(**mutation) == ok


def test_block_fits_static_shared_memory():
    assert CONST["WARPS"] * NBUF * WIN * SLOT <= 48 * 1024
    assert SLOT == 2 * SECTOR and WIN % WARP == 0 and LINE == 16 * WARP


def test_body_by_pairs_and_band_range():
    """Launches of up to WALK_WARP_MAX_PAIRS pairs take the warp body, larger
    ones the thread body (at band 128, above WALK_WARP_MAX_PAIRS_BAND128):
    of the aligner's power-of-two chunks, up to 4096 pairs (2048 at band
    128) walk by warp, the sides of the crossings chip_smoke.py measures;
    bands outside the lane decode's range raise."""
    for band, top in ((128, cuda_nw.WALK_WARP_MAX_PAIRS_BAND128),
                      (384, cuda_nw.WALK_WARP_MAX_PAIRS),
                      (512, cuda_nw.WALK_WARP_MAX_PAIRS),
                      (1024, cuda_nw.WALK_WARP_MAX_PAIRS),
                      (4096, cuda_nw.WALK_WARP_MAX_PAIRS)):
        assert [cuda_nw.walk_ops_body(B, band) for B in (1, top, top + 1)
                ] == ["warp", "warp", "thread"]
    assert [cuda_nw.walk_ops_body(B, 128) for B in (2048, 4096)] == [
        "warp", "thread"]
    for band in (384, 512, 1024):
        assert [cuda_nw.walk_ops_body(B, band) for B in (4096, 8192)] == [
            "warp", "thread"]
    n = m = torch.zeros(1, dtype=torch.int32)
    for band in (4, cuda_nw.WALK_MAX_BAND):
        dirs = torch.zeros((1, 8, band // 8), dtype=torch.uint8)
        with pytest.raises(ValueError):
            cuda_nw.walk_ops(dirs, n, m, band=band)
