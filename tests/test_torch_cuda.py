"""The port's CUDA kernels and engines against their plain PyTorch
versions, on the card (``cuda`` marker; every test skips on a host without
a CUDA device). This file imports no JAX, so it runs where only PyTorch is
installed: ``RACON_TPU_TEST_REAL=1 python -m pytest tests/test_torch_cuda.py
-m cuda`` (the variable keeps ``tests/conftest.py`` from importing JAX).

Every comparison is exact: the kernels compute integer DP and integer
votes, so the kernel and its plain version agree bit for bit (direction
rows below each pair's ``n + m``, which are the rows a walk reads).
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.core import backends
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.ops import chain, cuda_nw, overlap_seed, poa
from racon_tpu_torch.ops.nw import CudaAligner
from racon_tpu_torch.ops.poa import CudaPoaConsensus

pytestmark = pytest.mark.cuda

BASES = np.frombuffer(b"ACGT", np.uint8)
K, CH, DEL = 4, 8, 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _mutate(rng, t, err):
    q = t.copy()
    flips = rng.random(len(q)) < err / 3
    q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
    q = q[rng.random(len(q)) >= err / 3]
    ins = rng.random(len(q)) < err / 3
    return np.insert(q, np.flatnonzero(ins),
                     BASES[rng.integers(0, 4, int(ins.sum()))])


GRIDS = {
    # name: (seed, B, lo, hi, err, max_len, band, steps)
    "small_band": (1, 40, 0, 250, 0.2, 256, 128, 0),
    "escapes": (2, 24, 100, 250, 0.6, 256, 128, 0),
    "truncated": (3, 24, 80, 250, 0.15, 256, 128, 256),
    "consensus": (4, 64, 400, 600, 0.15, 1024, 512, 1280),
    "aligner": (5, 8, 3000, 4000, 0.15, 4096, 1024, 0),
    # the main path's widest buckets: 512 and 1024 threads per block
    "aligner_4096": (6, 4, 5000, 8000, 0.15, 16384, 4096, 0),
    "aligner_8192": (7, 2, 5000, 8000, 0.15, 16384, 8192, 0),
    # K1's warp body (bands 128..512): the aligner's (1024, 384) bucket; a
    # band-512 group of 37 pairs (not a multiple of the pairs a block
    # takes) with every third pair empty, as converged consensus windows
    # are; a band-512 group cut at steps < n + m for some pairs
    "aligner_384": (8, 16, 500, 1000, 0.15, 1024, 384, 0),
    "consensus_ragged": (9, 37, 400, 600, 0.15, 1024, 512, 1280),
    "consensus_truncated": (10, 24, 200, 600, 0.15, 1024, 512, 768),
    # the aligner's band-2048 bucket (K1's block body: the wide one measured
    # slower there); K1's wide body (bands 1024, 4096, 8192) on a band-4096
    # group cut at steps < n + m for some pairs and a band-8192 group of 7
    # pairs with every third pair empty; the block body at band 768
    "aligner_2048": (11, 4, 3000, 8000, 0.15, 8192, 2048, 0),
    "aligner_4096_truncated": (12, 6, 5000, 8000, 0.15, 16384, 4096, 12000),
    "aligner_8192_ragged": (13, 7, 5000, 8000, 0.15, 16384, 8192, 0),
    "block_768": (14, 8, 300, 1000, 0.15, 1024, 768, 0),
    # band-ladder rungs: K4's wide body at NW = 3 (1536 at BPT 2, 3072 at
    # BPT 4), K1's warp body at 192 and 256, the block bodies at 64 and 96
    # (each grid runs both kernels)
    "rung_1536": (15, 6, 2500, 3500, 0.15, 8192, 1536, 0),
    "rung_3072": (16, 5, 4000, 6000, 0.15, 16384, 3072, 0),
    "rung_192": (17, 12, 200, 600, 0.1, 1024, 192, 0),
    "rung_256": (18, 12, 300, 800, 0.1, 1024, 256, 0),
    "rung_96": (19, 20, 30, 200, 0.1, 256, 96, 0),
    "rung_64": (20, 20, 20, 150, 0.08, 256, 64, 0),
}
# grid -> every how many pairs one is empty (n = m = 0)
EMPTY_EVERY = {"consensus_ragged": 3, "aligner_8192_ragged": 3}


def _inputs(grid):
    seed, B, lo, hi, err, max_len, band, steps = GRIDS[grid]
    rng = np.random.default_rng(seed)
    c = band // 2
    width = c + max_len + band
    qrp = np.full((B, width), 6, np.uint8)
    tp = np.full((B, width), 7, np.uint8)
    n = np.zeros(B, np.int32)
    m = np.zeros(B, np.int32)
    every = EMPTY_EVERY.get(grid, 0)
    for k in range(B):
        if every and k % every == 0:
            continue
        t = BASES[rng.integers(0, 4, int(rng.integers(lo, hi)))]
        q = _mutate(rng, t, err)[:max_len]
        qrp[k, c + max_len - len(q): c + max_len] = q[::-1]
        tp[k, c: c + len(t)] = t
        n[k], m[k] = len(q), len(t)
    qpw = ((rng.integers(0, 94, (B, max_len)).astype(np.uint16) << 3)
           | rng.integers(0, 5, (B, max_len)).astype(np.uint16))
    bg = rng.integers(0, 8, B).astype(np.int32)
    host = [torch.from_numpy(a) for a in (qrp, tp, n, m, bg,
                                          qpw.view(np.int16))]
    return host, max_len, band, steps


def _rows_equal(got, want, n, m):
    S = want.shape[1]
    for k in range(len(n)):
        r = min(int(n[k]) + int(m[k]), S)
        assert torch.equal(got[k, :r], want[k, :r]), k


@pytest.mark.parametrize("packed16", [False, True])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernels_match_plain(cuda_device, grid, packed16):
    """nw_fwd (K1/K4), walk_ops (K2) and walk_vote (K3) on the card ==
    their plain versions on the same inputs."""
    host, max_len, band, steps = _inputs(grid)
    dev = [x.to(cuda_device) for x in host]
    before = dict(cuda_nw.LAUNCHES)
    kw = dict(max_len=max_len, band=band, steps=steps, packed16=packed16)
    dk, sk = cuda_nw.nw_fwd(*dev[:4], **kw)
    dp, sp = cuda_nw.nw_fwd(*host[:4], **kw)
    torch.cuda.synchronize()
    assert torch.equal(sk.cpu(), sp)
    _rows_equal(dk.cpu(), dp, host[2], host[3])
    ok_, fik, fjk = cuda_nw.walk_ops(dk, dev[2], dev[3], band=band)
    op_, fip, fjp = cuda_nw.walk_ops(dp, host[2], host[3], band=band)
    for a, b in ((ok_, op_), (fik, fip), (fjk, fjp)):
        assert torch.equal(a.cpu(), b)
    vkw = dict(band=band, L=max_len, K=K, CH=CH, DEL=DEL)
    vk = cuda_nw.walk_vote(dk, dev[2], dev[3], dev[4], dev[5], **vkw)
    vp = cuda_nw.walk_vote(dp, host[2], host[3], host[4], host[5], **vkw)
    for a, b in zip(vk, vp):
        assert torch.equal(a.cpu(), b)
    name = "nw_fwd_i16x2" if packed16 else "nw_fwd_i32"
    assert cuda_nw.LAUNCHES[name] == before[name] + 1
    if grid.endswith("truncated"):
        assert (host[2] + host[3] > steps).any(), "grid cuts no pair"
    if grid in EMPTY_EVERY:
        assert (sk.cpu()[host[2] + host[3] == 0] == 0).all()
    assert cuda_nw.LAUNCHES["walk_ops"] == before["walk_ops"] + 1
    assert cuda_nw.LAUNCHES["walk_vote"] == before["walk_vote"] + 1


def _edge_inputs(band, seed, max_len=0):
    """Seven pairs (not a multiple of the pairs a block of K4's NW = 1
    body takes) at ``band``: an empty pair, a target alone (n = 0), a
    query alone (m = 0), a pair whose lengths differ by c - 40 (near the
    band's edge), pairs at 15% and 50% error (the latter leaves the band)
    and a pair longer than the sweep (n + m > steps). ``max_len`` defaults
    to max(1024, 2 * band)."""
    rng = np.random.default_rng(seed)
    c = band // 2
    max_len = max_len or max(1024, 2 * band)
    width = c + max_len + band
    base = min(max_len - c, 3 * c)
    lens = [(0, 0), (0, 100), (100, 0), (base - c + 40, base),
            (base, base), (base // 2, base // 2), (max_len - 8, max_len - 8)]
    qrp = np.full((7, width), 6, np.uint8)
    tp = np.full((7, width), 7, np.uint8)
    n = np.zeros(7, np.int32)
    m = np.zeros(7, np.int32)
    for k, (nq, nt) in enumerate(lens):
        t = BASES[rng.integers(0, 4, nt)]
        q = _mutate(rng, t, 0.5 if k == 5 else 0.15)
        q = np.resize(q, nq) if len(q) else BASES[rng.integers(0, 4, nq)]
        qrp[k, c + max_len - nq: c + max_len] = q[::-1]
        tp[k, c: c + nt] = t
        n[k], m[k] = nq, nt
    steps = (2 * max_len - 512) // 512 * 512
    return [torch.from_numpy(a) for a in (qrp, tp, n, m)], max_len, steps


@pytest.mark.parametrize("band,bpt,max_len", [
    (band, bpt, 0) for band, bpts in cuda_nw.I16X2_WIDE_BPTS.items()
    for bpt in bpts] + [(512, 2, 1000), (2048, 4, 2500)])
def test_i16x2_wide_bodies_match_plain(cuda_device, band, bpt, max_len):
    """K4's wide body at every (band, BPT) it instantiates == the plain
    packed version on the same edge cases, launch counted under K4; twice
    more on rows whose width is not a multiple of 16 bytes (staged a byte
    at a time)."""
    host, max_len, steps = _edge_inputs(band, seed=band + bpt,
                                        max_len=max_len)
    dev = [x.to(cuda_device) for x in host]
    before = cuda_nw.LAUNCHES["nw_fwd_i16x2"]
    kw = dict(max_len=max_len, band=band, steps=steps)
    dk, sk = cuda_nw._launch_fwd(cuda_nw.FWD_I16X2_ENTRIES["wide"], *dev,
                                 bpt=bpt, **kw)
    dp, sp = cuda_nw.nw_fwd_plain(*dev, packed16=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sk.cpu(), sp.cpu())
    _rows_equal(dk.cpu(), dp.cpu(), host[2], host[3])
    assert cuda_nw.LAUNCHES["nw_fwd_i16x2"] == before + 1
    nm = host[2] + host[3]
    assert (nm > steps).any() and (nm == 0).any()
    assert (host[2] == 0).any() and (host[3] == 0).any()


WALK_CASES = {
    # name: (seed, B, band, S, (lo, hi) lengths, codes) for K2 on direction
    # bytes drawn at random, so that a byte served from a stale or wrong
    # window buffer changes the output. "wander" codes (0-2) keep a walk
    # going for its whole row while its diagonal drifts off the one its
    # windows were predicted on; "any" bytes stop it on code 3 or let it
    # escape within a few steps
    "wander_512_partial_block": (31, 45, 512, 1536, (400, 1200), "wander"),
    "any_bytes_512": (32, 64, 512, 1024, (0, 600), "any"),
    "wander_128_S_not_16": (33, 9, 128, 1100, (0, 700), "wander"),
    "wander_384_partial_line": (34, 7, 384, 1040, (200, 700), "wander"),
    "wander_200_no_staging": (35, 9, 200, 300, (0, 150), "wander"),
    "wander_4096_lines": (36, 6, 4096, 16384, (5000, 8000), "wander"),
    # the ladder's narrowest rungs: rows of 8 and 12 bytes
    "wander_64_rung": (37, 11, 64, 512, (0, 250), "wander"),
    "any_bytes_96_rung": (38, 13, 96, 512, (0, 250), "any"),
}


def _walk_inputs(name):
    seed, B, band, S, (lo, hi), codes = WALK_CASES[name]
    rng = np.random.default_rng(seed)
    n = rng.integers(lo, hi, B).astype(np.int32)
    if codes == "any":
        dirs = rng.integers(0, 256, (B, S, band // 8)).astype(np.uint8)
        m = rng.integers(lo, hi, B).astype(np.int32)
    else:
        c4 = rng.integers(0, 3, (B, S, band // 8, 4)).astype(np.uint8)
        dirs = (c4[..., 0] | c4[..., 1] << 2 | c4[..., 2] << 4
                | c4[..., 3] << 6).astype(np.uint8)
        m = np.maximum(n + rng.integers(-band // 8, band // 8, B),
                       0).astype(np.int32)
    n[0] = m[0] = 0                     # an empty pair
    return [torch.from_numpy(a) for a in (dirs, n, m)], band


@pytest.mark.parametrize("body", list(cuda_nw.WALK_OPS_ENTRIES))
@pytest.mark.parametrize("name", list(WALK_CASES))
def test_walk_ops_matches_plain_on_random_bytes(cuda_device, name, body):
    """Each body of walk_ops (K2) on the card == its plain version: B not a
    multiple of the warps a block walks, S not a multiple of 16 or of 512,
    a band whose rows are not whole 16 B pieces (no staging), pairs cut by
    S, empty pairs."""
    host, band = _walk_inputs(name)
    B, S, _ = host[0].shape
    before = cuda_nw.LAUNCHES["walk_ops"]
    got = cuda_nw._launch_walk(cuda_nw.WALK_OPS_ENTRIES[body],
                               *(x.to(cuda_device) for x in host), band=band)
    want = cuda_nw.walk_ops(*host, band=band)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert cuda_nw.LAUNCHES["walk_ops"] == before + 1
    ops = cuda_nw.unpack_ops(want[0])
    assert (ops[1:, 0] < 3).any() and (ops[0] == 3).all()
    if name == "wander_512_partial_block":
        assert B % 4 and (host[1] + host[2] > S).any()


def test_walk_ops_rejects_unaligned_dirs(cuda_device):
    """K2 stages direction rows with 16 B copies: a matrix that does not
    start on a 16 B boundary (a view at an odd offset) raises."""
    B, S, band = 2, 64, 128
    flat = torch.zeros(1 + B * S * band // 8, dtype=torch.uint8,
                       device=cuda_device)
    dirs = flat[1:].view(B, S, band // 8)
    n = m = torch.ones(B, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="16 B boundary"):
        cuda_nw.walk_ops(dirs, n, m, band=band)


def test_aligner_card_matches_cpu(cuda_device):
    """CudaAligner on the card == CudaAligner(device="cpu"): same CIGARs,
    band escalation and host fallback included."""
    rng = np.random.default_rng(9)
    pairs = []
    for k in range(48):
        t = BASES[rng.integers(0, 4, int(rng.integers(20, 240)))]
        err = 0.6 if k % 8 == 0 else 0.1
        pairs.append((_mutate(rng, t, err).tobytes(), t.tobytes()))
    pairs.append((BASES[rng.integers(0, 4, 300)].tobytes(), b"ACGT" * 70))
    buckets = ((64, 32), (128, 64), (256, 128))
    card = CudaAligner(fallback=backends.NativeAligner(1), buckets=buckets,
                       device=cuda_device)
    host = CudaAligner(fallback=backends.NativeAligner(1), buckets=buckets,
                       device="cpu")
    assert card.align_batch(pairs) == host.align_batch(pairs)
    assert card.stats["device"] > 30


def test_breaking_points_card_matches_cpu(cuda_device):
    """breaking_points on the card == on the CPU from one chunk's op stream
    (the aligner grid's forward pass and walk on the card), at window
    lengths 100 and 500."""
    from racon_tpu_torch.ops.nw import breaking_points, window_geometry
    host, max_len, band, steps = _inputs("aligner")
    dev = [x.to(cuda_device) for x in host]
    dirs, _ = cuda_nw.nw_fwd(*dev[:4], max_len=max_len, band=band,
                             steps=steps, packed16=True)
    ops = cuda_nw.walk_ops(dirs, dev[2], dev[3], band=band)[0]
    rng = np.random.default_rng(3)
    for w in (100, 500):
        tb = rng.integers(0, 100000, len(host[2]))
        first_rel, nb = window_geometry(tb, host[3].numpy(), w)
        args = [host[2], host[3], torch.from_numpy(first_rel),
                torch.from_numpy(nb)]
        NW = max_len // w + 2
        card = breaking_points(ops, *(a.to(cuda_device) for a in args),
                               w=w, NW=NW)
        cpu = breaking_points(ops.cpu(), *args, w=w, NW=NW)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
        assert (cpu[0] < 1 << 30).any()


def test_aligner_breaking_points_card_matches_cpu(cuda_device):
    """CudaAligner.breaking_points_batch on the card == on the CPU, on its
    default ragged stream and band ladder (rungs 64 and 96 included)."""
    rng = np.random.default_rng(19)
    pairs = []
    for k in range(60):
        t = BASES[rng.integers(0, 4, int(rng.integers(20, 240)))]
        err = 0.6 if k % 8 == 0 else 0.06
        pairs.append((_mutate(rng, t, err).tobytes(), t.tobytes()))
    metas = [(int(rng.integers(0, 5000)), int(rng.integers(0, 300)))
             for _ in pairs]
    buckets = ((64, 32), (128, 64), (256, 128))
    out = []
    for where in (cuda_device, "cpu"):
        al = CudaAligner(fallback=backends.NativeAligner(1),
                         buckets=buckets, device=where)
        out.append((al.breaking_points_batch(pairs, metas, 50), al.stats))
    (card, st), (cpu, _) = out
    assert all(np.array_equal(a, b) for a, b in zip(card, cpu))
    assert st["ladder_narrow"] > 0
    assert {s[1] for s in st["chunk_shapes"]} & {64, 96}


def _windows(seed, n_w=6, wl=300, depth=10):
    rng = np.random.default_rng(seed)
    out = []
    for wi in range(n_w):
        truth = BASES[rng.integers(0, 4, wl)]
        bb = _mutate(rng, truth, 0.1)
        win = Window(0, wi, WindowType.TGS, bb.tobytes(), b"!" * len(bb))
        for _ in range(depth):
            layer = _mutate(rng, truth, 0.12)
            qual = bytes(33 + int(x) for x in rng.integers(3, 45, len(layer)))
            win.add_layer(layer.tobytes(), qual, 0, len(bb) - 1)
        out.append(win)
    return out


def test_consensus_card_matches_cpu(cuda_device):
    """CudaPoaConsensus on the card == on the CPU: same flags and bytes."""
    fb = backends.NativePoaConsensus(3, -5, -4)
    wc, wh = _windows(21), _windows(21)
    card = CudaPoaConsensus(3, -5, -4, fallback=fb, device=cuda_device)
    host = CudaPoaConsensus(3, -5, -4, fallback=fb, device="cpu")
    assert card.run(wc, trim=True) == host.run(wh, trim=True)
    assert [w.consensus for w in wc] == [w.consensus for w in wh]
    assert card.stats["device_windows"] == len(wc)


def _mixed_windows(seed, n_w=18):
    """Windows of 60, 150 and 300 bp (the ragged buckets L = 256 and 512
    at band 128), 6-10 layers of 8% error each, half with qualities."""
    rng = np.random.default_rng(seed)
    out = []
    for wi in range(n_w):
        wl = (60, 150, 300)[wi % 3]
        truth = BASES[rng.integers(0, 4, wl)]
        bb = _mutate(rng, truth, 0.1)
        win = Window(0, wi, WindowType.TGS, bb.tobytes(), b"!" * len(bb))
        for _ in range(int(rng.integers(6, 11))):
            layer = _mutate(rng, truth, 0.08)
            qual = (bytes(33 + int(x) for x in rng.integers(5, 45, len(layer)))
                    if wi % 2 else None)
            win.add_layer(layer.tobytes(), qual, 0, len(bb) - 1)
        out.append(win)
    return out


@pytest.mark.parametrize("frac,stage", [(0.0, "in_place"), (1.0, "B")])
def test_consensus_stream_matches_padded_on_card(cuda_device, monkeypatch,
                                                 frac, stage):
    """The stream on the card (two buckets, four windows a group, so each
    bucket runs stage A, then continues in place or repacks stage B) ==
    the padded path on the card: same flags and bytes."""
    monkeypatch.setattr(poa, "MAX_GROUP_WINDOWS", 4)
    monkeypatch.setattr(poa, "STAGE_B_MAX_SURVIVOR_FRAC", frac)
    fb = backends.NativePoaConsensus(3, -5, -4)
    ws, wp = _mixed_windows(31), _mixed_windows(31)
    kw = dict(fallback=fb, band=128, rounds=4, device=cuda_device)
    stream = CudaPoaConsensus(3, -5, -4, **kw)
    padded = CudaPoaConsensus(3, -5, -4, use_ragged=False, **kw)
    assert stream.run(ws, trim=True) == padded.run(wp, trim=True)
    assert [w.consensus for w in ws] == [w.consensus for w in wp]
    shapes = stream.stats["group_shapes"]
    assert {g[0] for g in shapes} == {256 + 128, 512 + 128}
    assert "A" in {g[6] for g in shapes} and stage in {g[6] for g in shapes}
    assert stream.stats["device_windows"] > len(ws) // 2


def test_consensus_stream_feed_does_not_wait(cuda_device, monkeypatch):
    """feed() packs, uploads and enqueues full groups with no
    synchronising call (CUDA sync debug mode raises on one), and the
    session's bytes equal the padded path's."""
    monkeypatch.setattr(poa, "MAX_GROUP_PAIRS", 16)
    monkeypatch.setattr(poa, "MAX_GROUP_WINDOWS", 4)
    fb = backends.NativePoaConsensus(3, -5, -4)
    ws, wp = _mixed_windows(32), _mixed_windows(32)
    kw = dict(fallback=fb, band=128, rounds=4, device=cuda_device)
    sess = CudaPoaConsensus(3, -5, -4, **kw).stream(trim=True,
                                                    band_hint=300)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.feed(ws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sess.inflight and sess.fetched == 0
    flags = sess.finish()
    padded = CudaPoaConsensus(3, -5, -4, use_ragged=False, **kw)
    assert flags == padded.run(wp, trim=True)
    assert [w.consensus for w in ws] == [w.consensus for w in wp]


def _chain_arena(rng, S, B):
    """Seed lanes for the chain DP: dead lanes, full lanes, random counts;
    coordinates near one diagonal with noise, gaps past MAX_GAP on some
    lanes."""
    ts = np.zeros((B, S), np.int32)
    qs = np.zeros((B, S), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 3:
            continue
        n = S if b % 5 == 0 else int(rng.integers(1, S + 1))
        step = 12_000 if b % 11 == 4 else 150
        t = np.sort(rng.integers(0, step * n, n))
        ts[b, :n] = t
        qs[b, :n] = np.clip(t + rng.integers(-800, 800, n), 0, None)
        ns[b] = n
    return ts, qs, ns


@pytest.mark.parametrize("S,B", [(16, 64), (64, 37), (256, 130),
                                 (1024, 40)])
def test_chain_dp_matches_plain(cuda_device, S, B):
    ts, qs, ns = (torch.from_numpy(x).to(cuda_device)
                  for x in _chain_arena(np.random.default_rng(S), S, B))
    before = cuda_nw.LAUNCHES["chain_dp"]
    got = chain.chain_dp(ts, qs, ns, k=15)
    torch.cuda.synchronize()
    assert cuda_nw.LAUNCHES["chain_dp"] == before + 1
    assert torch.equal(got, chain.chain_dp_plain(ts, qs, ns, k=15))
    assert torch.equal(got.cpu(), chain.chain_dp(ts.cpu(), qs.cpu(),
                                                 ns.cpu(), k=15))


def test_overlapper_card_matches_cpu(cuda_device):
    """find_overlaps with its tensors on the card (the seeding and the
    join in plain PyTorch, the chain DP's kernel) gives the CPU's rows."""
    rng = np.random.default_rng(3)
    genome = BASES[rng.integers(0, 4, 20_000)]
    reads = [_mutate(rng, genome[s:s + 3000], 0.12).tobytes()
             for s in rng.integers(0, 17_000, 150)]
    self_t = np.full(len(reads), -1, np.int64)
    rows = {}
    for where in (cuda_device, torch.device("cpu")):
        overlap_seed.clear_table_cache()
        rows[where.type] = chain.find_overlaps(reads, [genome.tobytes()],
                                               self_t, device=where)
    assert rows["cuda"]["q_ord"].size > 100
    for key in rows["cpu"]:
        assert np.array_equal(rows["cuda"][key], rows["cpu"][key]), key
