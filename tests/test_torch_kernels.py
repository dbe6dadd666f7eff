"""Port kernels vs the JAX package's XLA twins, on the CPU.

On a CPU tensor every wrapper of ``racon_tpu_torch.ops.cuda_nw`` runs its
plain PyTorch version; these tests feed it and the JAX function the same
numpy inputs (made from seeds) and require **exact** equality: the DP and
the walks are integer code, the vote sums are integer sums, and the
consensus rule's float32 sums use a fixed left-to-right order. Direction
rows are compared below each pair's ``n + m`` (the rows any walk reads;
the kernels leave later rows undefined).

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from racon_tpu.ops.nw import (_nw_wavefront_kernel, _traceback_kernel,
                              _walk_ops_kernel)
from racon_tpu.ops.poa import (_accumulate_votes, _consensus_kernel,
                               _vote_from_ops)
from racon_tpu_torch.ops import cuda_nw
from racon_tpu_torch.ops import poa as tpoa

BASES = np.frombuffer(b"ACGT", np.uint8)
BIG = 1 << 28
K, CH, DEL = 4, 8, 5


def _mutated_pair(rng, ln, err, ndel=4, nins=4):
    t = BASES[rng.integers(0, 4, ln)]
    q = t.copy()
    flips = rng.random(ln) < err
    q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
    if ln > ndel:
        q = np.delete(q, rng.integers(0, len(q), ndel))
    q = np.insert(q, rng.integers(0, len(q) + 1, nins),
                  BASES[rng.integers(0, 4, nins)])
    return q, t


def _grid(name):
    """(pairs, max_len, band, steps) of one input grid."""
    rng = np.random.default_rng({"random": 41, "band_edge": 42,
                                 "boundaries": 43, "truncated": 44,
                                 "wide": 45}[name])
    if name == "random":
        pairs = [_mutated_pair(rng, int(rng.integers(16, 240)),
                               float(rng.uniform(0.0, 0.35)))
                 for _ in range(48)]
        return pairs, 256, 128, 0
    if name == "band_edge":
        # off-diagonal rearrangements escape the band: scores saturate
        pairs = []
        for _ in range(12):
            ln = int(rng.integers(150, 250))
            t = BASES[rng.integers(0, 4, ln)]
            pairs.append((np.concatenate([t[ln // 2:], t[:ln // 2]]), t))
        pairs.append(_mutated_pair(rng, 200, 0.1))
        return pairs, 256, 128, 0
    if name == "boundaries":
        full = BASES[rng.integers(0, 4, 256)]
        fullq = full.copy()
        flips = rng.random(256) < 0.1
        fullq[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        pairs = [(fullq, full), (full[:0], full[:7]), (full[:7], full[:0]),
                 (full[:0], full[:0]), (full[:1], full[:1]),
                 (fullq[:255], full), (full, full), (fullq[:129], full[:128]),
                 (full[:60], full[:2])]
        return pairs, 256, 128, 0
    if name == "truncated":
        # steps below some pairs' n + m: those keep score BIG
        pairs = [_mutated_pair(rng, int(rng.integers(80, 250)), 0.15)
                 for _ in range(16)]
        return pairs, 256, 128, 256
    pairs = [_mutated_pair(rng, int(rng.integers(300, 1000)), 0.12,
                           ndel=20, nins=20) for _ in range(6)]
    return pairs, 1024, 384, 0


GRIDS = ["random", "band_edge", "boundaries", "truncated", "wide"]


def _pack(pairs, max_len, band):
    c = band // 2
    width = c + max_len + band
    B = len(pairs)
    qrp = np.full((B, width), 6, np.uint8)
    tp = np.full((B, width), 7, np.uint8)
    n = np.zeros(B, np.int32)
    m = np.zeros(B, np.int32)
    for k, (q, t) in enumerate(pairs):
        q = q[:max_len]
        qrp[k, c + max_len - len(q): c + max_len] = q[::-1]
        tp[k, c: c + len(t)] = t
        n[k], m[k] = len(q), len(t)
    return qrp, tp, n, m


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _xla_fwd(qrp, tp, n, m, max_len, band, steps, swar):
    d, s = _nw_wavefront_kernel(jnp.asarray(qrp), jnp.asarray(tp),
                                jnp.asarray(n), jnp.asarray(m),
                                max_len=max_len, band=band, steps=steps,
                                swar=swar)
    return np.asarray(d), np.asarray(s)


def _assert_rows_equal(got, want, n, m):
    """Direction rows below each pair's n + m are bit-equal."""
    S = want.shape[1]
    for k in range(len(n)):
        r = min(int(n[k]) + int(m[k]), S)
        assert np.array_equal(got[k, :r], want[k, :r]), k


@pytest.mark.parametrize("packed16", [False, True])
@pytest.mark.parametrize("grid", GRIDS)
def test_nw_fwd_matches_xla(grid, packed16):
    """nw_fwd (K1 int32 / K4 int16x2 plain versions) == the XLA
    wavefront kernel (swar=False / True): scores equal, rows equal."""
    pairs, max_len, band, steps = _grid(grid)
    qrp, tp, n, m = _pack(pairs, max_len, band)
    dx, sx = _xla_fwd(qrp, tp, n, m, max_len, band, steps, packed16)
    dp, sp = cuda_nw.nw_fwd(*_t(qrp, tp, n, m), max_len=max_len,
                            band=band, steps=steps, packed16=packed16)
    assert dp.shape == dx.shape
    assert np.array_equal(sp.numpy(), sx)
    _assert_rows_equal(dp.numpy(), dx, n, m)
    if grid == "truncated":
        assert (sx == BIG).any() and (n + m > 256).any()
    if grid == "band_edge":
        assert sx.max() >= band // 2


@pytest.mark.parametrize("grid", GRIDS)
def test_walk_ops_matches_traceback_kernel(grid):
    """walk_ops == _traceback_kernel: packed ops, fi, fj bit-equal, over
    the XLA direction matrix and over the port's own."""
    pairs, max_len, band, steps = _grid(grid)
    qrp, tp, n, m = _pack(pairs, max_len, band)
    dx, sx = _xla_fwd(qrp, tp, n, m, max_len, band, steps, False)
    ox, _, fix, fjx = map(np.asarray, _traceback_kernel(
        jnp.asarray(dx), jnp.asarray(sx), jnp.asarray(n), jnp.asarray(m),
        max_len=max_len, band=band))
    dp, _ = cuda_nw.nw_fwd(*_t(qrp, tp, n, m), max_len=max_len, band=band,
                           steps=steps)
    for dirs in (torch.from_numpy(dx.copy()), dp):
        op, fi, fj = cuda_nw.walk_ops(dirs, *_t(n, m), band=band)
        assert np.array_equal(op.numpy(), ox)
        assert np.array_equal(fi.numpy(), fix)
        assert np.array_equal(fj.numpy(), fjx)


def _qpw(rng, B, Lq):
    codes = rng.integers(0, 5, (B, Lq)).astype(np.uint16)
    weights = rng.integers(0, 94, (B, Lq)).astype(np.uint16)
    return (weights << 3) | codes


def _vote_inputs(grid):
    pairs, max_len, band, steps = _grid(grid)
    qrp, tp, n, m = _pack(pairs, max_len, band)
    rng = np.random.default_rng(7)
    qpw = _qpw(rng, len(pairs), max_len)
    bg = rng.integers(0, 8, len(pairs)).astype(np.int32)
    dx, sx = _xla_fwd(qrp, tp, n, m, max_len, band, steps, False)
    return pairs, max_len, band, n, m, qpw, bg, dx, sx


@pytest.mark.parametrize("grid", GRIDS)
def test_walk_vote_matches_vote_from_ops(grid):
    """walk_vote == _walk_ops_kernel + _vote_from_ops step for step: vote
    addresses, weights, fi, fj bit-equal (L = max_len backbone columns,
    so the col < L bound and the K-slot insertion cap both bite)."""
    pairs, max_len, band, n, m, qpw, bg, dx, sx = _vote_inputs(grid)
    L = max_len
    ops, fix, fjx = _walk_ops_kernel(jnp.asarray(dx), jnp.asarray(n),
                                     jnp.asarray(m), band=band)
    idx_x, w_x, _ = _vote_from_ops(
        ops, fix, fjx, jnp.asarray(sx), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(qpw), jnp.asarray(bg), max_len=max_len, band=band, L=L,
        K=K)
    idx, w, fi, fj = cuda_nw.walk_vote(
        *_t(dx, n, m, bg, qpw.view(np.int16)), band=band, L=L, K=K, CH=CH,
        DEL=DEL)
    assert np.array_equal(idx.numpy(), np.asarray(idx_x))
    assert np.array_equal(w.numpy().astype(np.int32), np.asarray(w_x))
    assert np.array_equal(fi.numpy(), np.asarray(fix))
    assert np.array_equal(fj.numpy(), np.asarray(fjx))
    assert (idx.numpy() < L * (1 + K) * CH).any()


@pytest.mark.parametrize("scores", [(3, -5, -4), (5, -4, -8)])
@pytest.mark.parametrize("matmul_votes", [False, True])
def test_accumulate_votes_matches_xla(matmul_votes, scores):
    """Integer index_add_ accumulation == _accumulate_votes (both
    RACON_TPU_MATMUL_VOTES legs, default and custom scores): weighted
    float32 and count matrices bit-equal. 64 pairs, so the scatter leg's
    32-pair fold runs."""
    rng = np.random.default_rng(11)
    pairs = [_mutated_pair(rng, int(rng.integers(40, 240)),
                           float(rng.uniform(0.02, 0.3)))
             for _ in range(64)]
    max_len, band = 256, 128
    qrp, tp, n, m = _pack(pairs, max_len, band)
    qpw = _qpw(rng, 64, max_len)
    bg = rng.integers(0, 8, 64).astype(np.int32)
    win_of = (np.arange(64) % 5).astype(np.int32)
    dx, sx = _xla_fwd(qrp, tp, n, m, max_len, band, 0, False)
    L, nW = max_len, 6
    ops, fix, fjx = _walk_ops_kernel(jnp.asarray(dx), jnp.asarray(n),
                                     jnp.asarray(m), band=band)
    idx, w, ok = _vote_from_ops(
        ops, fix, fjx, jnp.asarray(sx), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(qpw), jnp.asarray(bg), max_len=max_len, band=band, L=L,
        K=K)
    wx, ux, _, _ = _accumulate_votes(
        idx, w, ok, jnp.asarray(win_of), jnp.asarray(m), jnp.asarray(bg),
        jnp.asarray(n), jnp.asarray(sx), n_windows=nW, L=L, K=K, band=band,
        scores=scores, matmul_votes=matmul_votes)
    wp, up = tpoa.accumulate_votes(
        *_t(np.asarray(idx), np.asarray(w).astype(np.uint8), np.asarray(ok),
            win_of.astype(np.int64), m, bg, n, sx), n_windows=nW, L=L, K=K,
        scores=scores)
    assert wp.dtype == torch.float32 and up.dtype == torch.int32
    assert np.array_equal(wp.numpy(), np.asarray(wx))
    assert np.array_equal(up.numpy(), np.asarray(ux))
    assert np.asarray(ok).sum() > 32 and np.asarray(ux).sum() > 0


def _consensus_inputs(seed, nW=6, L=64):
    """Vote matrices like a refinement round's: integer weights (x64 at
    default scores), backbone weights that are either phred-scaled or 0
    (refined backbones, where the 0.01 floor makes the sums
    non-integer), and deletion weights pinned near the del_beta
    boundary."""
    rng = np.random.default_rng(seed)
    E = L * (1 + K) * CH
    cnt = rng.integers(0, 12, (nW, E)).astype(np.int32)
    cnt[:, L * CH:] = np.where(rng.random((nW, E - L * CH)) < 0.15,
                               cnt[:, L * CH:], 0)
    wgt = (cnt * rng.integers(0, 60, (nW, E)) * 64).astype(np.float32)
    col = wgt[:, :L * CH].reshape(nW, L, CH)
    col[:, :, 6:] = 0
    base_total = col[:, :, :5].sum(-1)
    pin = rng.random((nW, L)) < 0.3
    col[:, :, DEL] = np.where(pin, np.floor(base_total * 0.65 / 64) * 64,
                              col[:, :, DEL])
    wgt[:, :L * CH] = col.reshape(nW, L * CH)
    bcodes = rng.integers(0, 5, (nW, L)).astype(np.uint8)
    bweights = np.where(rng.random((nW, 1)) < 0.5,
                        64.0 * rng.integers(0, 40, (nW, L)),
                        0.0).astype(np.float32)
    blen = rng.integers(L // 2, L + 1, nW).astype(np.int32)
    return wgt, cnt, bcodes, bweights, blen


@pytest.mark.parametrize("thresholds", [(0.25, 0.65), (0.5, 1.3),
                                        (0.95, 2.5)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_consensus_kernel_matches_xla(seed, thresholds):
    """consensus_kernel == _consensus_kernel: winners, coverage,
    insertion winners/emission/coverage all bit-equal (the float32 sums
    are a fixed left-to-right fold)."""
    theta, beta = thresholds
    L = 64
    wgt, cnt, bcodes, bweights, blen = _consensus_inputs(seed, L=L)
    want = _consensus_kernel(jnp.asarray(wgt), jnp.asarray(cnt),
                             jnp.asarray(bcodes), jnp.asarray(bweights),
                             jnp.asarray(blen), jnp.float32(theta),
                             jnp.float32(beta), L=L, K=K)
    got = tpoa.consensus_kernel(*_t(wgt, cnt, bcodes, bweights, blen),
                                theta, beta, L=L, K=K)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))
