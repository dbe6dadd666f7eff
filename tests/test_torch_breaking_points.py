"""The port's device breaking points against the JAX package's, on the CPU.

- ``racon_tpu_torch.ops.nw.breaking_points`` on CPU tensors (its plain
  version) == ``racon_tpu.ops.nw._breaking_points_kernel`` (NW masked
  reduces) on seeded random packed op streams: walks with code 3 both
  interleaved (as the Pallas walk leaves it) and trailing, walks cut short,
  a walk with no match, arbitrary codes, spans inside one window (``nb =
  1``, ``first_rel = m - 1``), at window lengths 100, 500 and 1000. The
  tables must be exactly equal.
- ``breaking_points_plain`` == the JAX function on adversarial streams
  (pad codes inside and at the tail, intervals with no match, ``nb = 1``,
  steps with ``tpos < 0``, spans whose ``nb`` reaches ``NW``, B not a
  multiple of 32) at w 100, 200 and 500, and a NumPy mirror of the CUDA
  kernel ``kernels/breaking_points.cu`` (its 2048-step tiles, lane counts
  and warp scan, lazy interval index and run flushes) == the plain
  version on the same streams, so the kernel's arithmetic is held here
  as well as on the card.
- ``CudaAligner.breaking_points_batch`` rows == ``TpuAligner.
  breaking_points_batch`` rows on the same pairs (both on their default
  ragged stream and band ladder; the JAX engine without a mesh).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from racon_tpu.core.backends import NativeAligner as JaxNativeAligner
from racon_tpu.ops.nw import TpuAligner, _breaking_points_kernel
from racon_tpu_torch.core.backends import NativeAligner
from racon_tpu_torch.ops import cuda_nw
from racon_tpu_torch.ops.nw import (BP_BIG, CudaAligner, breaking_points,
                                    breaking_points_plain)

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The plain kernels run thousands of small ops; two intra-op threads
    are as fast as eight alone and keep parallel test workers from
    oversubscribing the cores (eight threads each slowed one polisher run
    about twenty-fold)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _walk(rng, n, m, kind):
    """A backward walk's op codes from (n, m): ``clean`` ends at (0, 0),
    ``gaps`` interleaves code 3 after some steps, ``cut`` stops early (an
    escape), ``nomatch`` has no M step, ``any`` is arbitrary codes."""
    if kind == "any":
        return list(rng.integers(0, 4, int(rng.integers(0, n + m + 1))))
    ops, i, j = [], n, m
    while i > 0 or j > 0:
        if kind == "nomatch":
            op = 1 if i > 0 else 2
        elif i == 0:
            op = 2
        elif j == 0:
            op = 1
        else:
            op = int(rng.choice(3, p=(0.8, 0.1, 0.1)))
        ops.append(op)
        i -= op in (0, 1)
        j -= op in (0, 2)
        if kind == "gaps" and rng.random() < 0.1:
            ops.append(3)
    if kind == "cut":
        ops = ops[:int(rng.integers(0, len(ops) + 1))]
    return ops


KINDS = ("clean", "gaps", "cut", "nomatch", "any", "clean", "clean")


def _streams(seed, B, max_len, w):
    """Packed op streams ``[B, S/4]`` with ``S = 2 * max_len``, their (n,
    m) and the per-pair boundary geometry (first_rel, nb) as the aligner
    derives it from a target start; every fourth pair's span lies inside
    one window (nb = 1, first_rel = m - 1)."""
    rng = np.random.default_rng(seed)
    S = 2 * max_len
    ops = np.full((B, S), 3, np.uint8)
    n = rng.integers(1, max_len + 1, B).astype(np.int32)
    m = rng.integers(1, max_len + 1, B).astype(np.int32)
    tb = rng.integers(0, 5 * w, B)
    for b in range(B):
        if b % 4 == 3:
            m[b] = int(rng.integers(1, w // 2))
            tb[b] = int(rng.integers(0, w - m[b])) + 3 * w
        path = _walk(rng, int(n[b]), int(m[b]), KINDS[b % len(KINDS)])
        ops[b, :min(len(path), S)] = path[:S]
    te = tb + m
    n_reg = (te - 1) // w - tb // w
    nb = (n_reg + 1).astype(np.int32)
    first_rel = np.where(n_reg != 0, (tb // w + 1) * w - 1 - tb,
                         m - 1).astype(np.int32)
    packed = cuda_nw.pack_ops(torch.from_numpy(ops)).numpy()
    return packed, n, m, first_rel, nb


@pytest.mark.parametrize("w", [100, 500, 1000])
def test_breaking_points_matches_jax(w):
    max_len = 2048
    NW = max_len // w + 2
    packed, n, m, first_rel, nb = _streams(w, 28, max_len, w)
    assert (nb == 1).any() and (nb > 1).any()
    want = _breaking_points_kernel(
        jnp.asarray(packed), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(first_rel), jnp.asarray(nb), w=w, NW=NW)
    got = breaking_points(*(torch.from_numpy(a) for a in
                            (packed, n, m, first_rel, nb)), w=w, NW=NW)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (28, NW)
        assert np.array_equal(g.numpy(), np.asarray(x))
    first = got[0].numpy()
    # the no-match walk has no first match in any interval
    assert (first[KINDS.index("nomatch")] == 1 << 30).all()
    assert (first < 1 << 30).any()


def _adversarial(seed, B, max_len, w):
    """Packed op streams that probe every branch of the reduction, with
    ``S = 2 * max_len`` (a multiple of 2048 only when ``max_len`` is):
    pad codes inside the walk and at its tail, a deletion run of 2w + 1
    (an interval with no match), ``nb = 1`` spans, a walk that goes
    past (0, 0) (steps at ``tpos < 0`` and ``qpos < 0``), and spans whose
    boundaries fill all ``NW`` intervals (``nb = NW``)."""
    rng = np.random.default_rng(seed)
    S = 2 * max_len
    NW = max_len // w + 2
    ops = np.full((B, S), 3, np.uint8)
    n = rng.integers(1, max_len + 1, B).astype(np.int32)
    m = rng.integers(1, max_len + 1, B).astype(np.int32)
    tb = rng.integers(0, 5 * w, B)
    for b in range(B):
        kind = b % 6
        if kind == 0:      # nb = NW: the longest span, first boundary at 0
            m[b] = max_len
            n[b] = max_len
            tb[b] = w - 1
        elif kind == 1:    # nb = 1
            m[b] = int(rng.integers(1, w // 2))
            tb[b] = int(rng.integers(0, w - m[b])) + 2 * w
        path = []
        i, j = int(n[b]), int(m[b])
        if kind == 2:
            m[b] = max(int(m[b]), 2 * w + 2)
            j = int(m[b])
        gap_at = int(rng.integers(0, j - 2 * w - 1)) if kind == 2 else -1
        while i > 0 or j > 0:
            if j == m[b] - gap_at:
                # a deletion run of 2w + 1 target bases covers one whole
                # interval: no match there
                path += [2] * (2 * w + 1)
                j -= 2 * w + 1
                continue
            if i == 0:
                op = 2
            elif j == 0:
                op = 1
            else:
                op = int(rng.choice(3, p=(0.85, 0.08, 0.07)))
            path.append(op)
            i -= op in (0, 1)
            j -= op in (0, 2)
            if kind == 3 and rng.random() < 0.05:
                path += [3] * int(rng.integers(1, 9))   # pads inside
        if kind == 4:
            # past (0, 0): matches at tpos < 0 and qpos < 0
            path += list(rng.choice(3, int(rng.integers(1, 40))))
        if kind == 5:
            path = list(rng.integers(0, 4, int(rng.integers(0, S + 1))))
        ops[b, :min(len(path), S)] = path[:S]
    te = tb + m
    n_reg = (te - 1) // w - tb // w
    nb = (n_reg + 1).astype(np.int32)
    first_rel = np.where(n_reg != 0, (tb // w + 1) * w - 1 - tb,
                         m - 1).astype(np.int32)
    assert nb.max() == NW and nb.min() == 1
    packed = cuda_nw.pack_ops(torch.from_numpy(ops)).numpy()
    return packed, n, m, first_rel, nb


def _mirror_kernel(packed, n, m, first_rel, nb, *, w, NW):
    """NumPy mirror of ``breaking_points_kernel`` (one warp a pair): per
    tile of 2048 steps, lane l's 16 bytes (0xFF past the row), its M/I and
    M/D counts as 64 less the popcounts of its codes' high and low bit
    planes, packed 16:16 and scanned across the 32 lanes; each lane walks
    its 64 steps with the interval index divided once and again only when
    tpos falls to the current interval's lower boundary, keeping a run's
    min and max and flushing them (as atomicMin/atomicMax) when the
    interval changes and at its end; then bp_last's running max in chunks
    of 32 with a carry."""
    B, S4 = packed.shape
    first = np.full((B, NW), BP_BIG, np.int64)
    last = np.full((B, NW), -1, np.int64)
    tiles = -(-S4 // 512)
    lo_mask = np.uint32(0x55555555)

    def interval_of(tpos, fr):
        return -((fr - tpos) // w)     # floor division, as floor_div

    for b in range(B):
        row = np.full(tiles * 512, 0xFF, np.uint8)
        row[:S4] = packed[b]
        words = row.view("<u4").reshape(tiles, 32, 4)
        q_before = t_before = 0
        for tile in range(tiles):
            wd = words[tile]
            hi = np.array([sum(bin(int((x >> 1) & lo_mask)).count("1")
                               for x in wd[lane]) for lane in range(32)])
            lo = np.array([sum(bin(int(x & lo_mask)).count("1")
                               for x in wd[lane]) for lane in range(32)])
            mine = ((64 - hi) << 16) | (64 - lo)
            incl = np.cumsum(mine)
            excl = incl - mine
            total = int(incl[31])
            for lane in range(32):
                qpos = int(n[b]) - 1 - (q_before + (int(excl[lane]) >> 16))
                tpos = int(m[b]) - 1 - (t_before
                                        + (int(excl[lane]) & 0xFFFF))
                kraw = interval_of(tpos, int(first_rel[b]))
                lower = int(first_rel[b]) + (kraw - 1) * w
                run_k, run_min, run_max = -1, BP_BIG, -1
                for word in wd[lane]:
                    for j in range(16):
                        code = (int(word) >> (2 * j)) & 3
                        if code == 0 and tpos >= 0:
                            if tpos <= lower:
                                kraw = interval_of(tpos, int(first_rel[b]))
                                lower = int(first_rel[b]) + (kraw - 1) * w
                            k = min(max(kraw, 0), int(nb[b]) - 1)
                            if 0 <= k < NW:
                                pk = (tpos << 14) | max(qpos, 0)
                                if k != run_k:
                                    if run_k >= 0:
                                        first[b, run_k] = min(
                                            first[b, run_k], run_min)
                                        last[b, run_k] = max(
                                            last[b, run_k], run_max)
                                    run_k, run_min, run_max = k, pk, pk
                                else:
                                    run_min = min(run_min, pk)
                                    run_max = max(run_max, pk)
                        qpos -= code <= 1
                        tpos -= (code & 1) == 0
                if run_k >= 0:
                    first[b, run_k] = min(first[b, run_k], run_min)
                    last[b, run_k] = max(last[b, run_k], run_max)
            q_before += total >> 16
            t_before += total & 0xFFFF
    carry = np.full(B, -1, np.int64)
    for k0 in range(0, NW, 32):
        chunk = np.maximum.accumulate(last[:, k0:k0 + 32], axis=1)
        last[:, k0:k0 + 32] = np.maximum(chunk, carry[:, None])
        carry = last[:, min(k0 + 31, NW - 1)]
    return first.astype(np.int32), last.astype(np.int32)


@pytest.mark.parametrize("w", [100, 200, 500])
def test_breaking_points_plain_matches_jax_adversarial(w):
    max_len = 2048
    NW = max_len // w + 2
    B = 45                    # not a multiple of 32
    arrs = _adversarial(7 * w, B, max_len, w)
    want = _breaking_points_kernel(*(jnp.asarray(a) for a in arrs), w=w,
                                   NW=NW)
    got = breaking_points_plain(*(torch.from_numpy(a) for a in arrs), w=w,
                                NW=NW)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (B, NW)
        assert np.array_equal(g.numpy(), np.asarray(x))
    first = got[0].numpy()
    # the deletion run leaves an interval without a match inside the span
    gapped = first[2::6]
    assert any((r[:k] == BP_BIG).any() and (r[:k] < BP_BIG).any()
               for r, k in zip(gapped, arrs[4][2::6]))
    # the widest spans have matches in every interval past the first
    # (interval 0 holds target position 0 alone there)
    assert (first[0::6, 1:] < BP_BIG).all()


@pytest.mark.parametrize("w,max_len,B", [(100, 1024, 13), (200, 2048, 9),
                                         (500, 1002, 7)])
def test_breaking_points_kernel_mirror_equals_plain(w, max_len, B):
    """The kernel's algorithm, mirrored in NumPy, on one tile and on
    several, with a row whose bytes end inside a lane's 16 (max_len 1002:
    S/4 = 501)."""
    NW = max_len // w + 2
    arrs = _adversarial(w + B, max(B, 6), max_len, w)
    want = breaking_points_plain(*(torch.from_numpy(a) for a in arrs), w=w,
                                 NW=NW)
    got = _mirror_kernel(*arrs, w=w, NW=NW)
    for g, x in zip(got, want):
        assert np.array_equal(g, x.numpy())


def test_breaking_points_mirror_carries_across_chunks():
    """NW of 34 and 43 (w 60 at 1950 and 2500 bp): the running max of
    bp_last crosses the 32-entry chunks of the kernel's epilogue."""
    for max_len in (1950, 2500):
        w = 60
        NW = max_len // w + 2
        assert NW > 32
        arrs = _adversarial(max_len, 6, max_len, w)
        want = breaking_points_plain(*(torch.from_numpy(a) for a in arrs),
                                     w=w, NW=NW)
        got = _mirror_kernel(*arrs, w=w, NW=NW)
        for g, x in zip(got, want):
            assert np.array_equal(g, x.numpy())


def _pairs(seed, count=40):
    """Pairs of 100-1100 bp at 3-15% error (every seventh at 45%, which
    escapes its seeded band), one pair longer than any test bucket (host
    fallback), one empty pair; overlap-filter error estimates; metas."""
    rng = np.random.default_rng(seed)
    pairs, errors = [], []
    for k in range(count):
        t = BASES[rng.integers(0, 4, int(rng.integers(100, 1100)))]
        q = t.copy()
        flips = rng.random(len(q)) < (0.45 if k % 7 == 0 else 0.03 + k % 4
                                      * 0.04)
        q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        q = np.delete(q, rng.integers(0, len(q), max(1, len(q) // 80)))
        pairs.append((q.tobytes(), t.tobytes()))
        errors.append(1.0 - min(len(q), len(t)) / max(len(q), len(t)))
    pairs.append((BASES[rng.integers(0, 4, 1500)].tobytes(),
                  BASES[rng.integers(0, 4, 1500)].tobytes()))
    errors.append(0.0)
    pairs.append((b"", b"ACGT"))
    errors.append(0.0)
    metas = [(int(rng.integers(0, 2000)), int(rng.integers(0, 500)))
             for _ in pairs]
    return pairs, metas, errors


@pytest.mark.parametrize("w", [100, 500])
def test_breaking_points_batch_matches_tpu_aligner(w):
    buckets = ((256, 128), (1024, 384))
    pairs, metas, errors = _pairs(11 + w)
    ref = TpuAligner(fallback=JaxNativeAligner(2), buckets=buckets,
                     mesh=None)
    want = ref.breaking_points_batch(pairs, metas, w, errors=errors)
    port = CudaAligner(fallback=NativeAligner(2), buckets=buckets,
                       device="cpu")
    got = port.breaking_points_batch(pairs, metas, w, errors=errors)
    assert len(got) == len(want) == len(pairs)
    for g, x in zip(got, want):
        assert g.dtype == np.int32 and g.shape[1:] == (4,)
        assert np.array_equal(g, x)
    for key in ("device", "fallback_length", "fallback_band",
                "band_escalated", "ladder_narrow", "chunks"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["ladder_narrow"] > 0
    assert port.stats["fallback_length"] >= 1
    assert sum(len(g) > 0 for g in got) >= len(pairs) - 5
