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
  kernel ``kernels/breaking_points.cu`` (its block of 256 threads a pair,
  passes of 4096 steps, thread counts, warp and block scans and the pass
  carry, lazy interval index, first and last runs of each interval) ==
  the plain version == the JAX function on the same streams: rows that
  end inside a pass, intervals across threads, warps and passes, pairs of
  length 1, walks without a match, ``nb = 1``; so the kernel's arithmetic
  is held here as well as on the card.
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


# the CUDA kernel's geometry: a block of 256 threads (8 warps) a pair, one
# 4-byte word (16 steps) a thread a pass of 1024 bytes (4096 steps)
THREADS, WARPS, PASS_BYTES = 256, 8, 1024
NO_RUN = 1 << 30
LO_PLANE = 0x55555555


def _popcount(x):
    return np.array([bin(int(v)).count("1") for v in x])


def _step_counts(words):
    """``step_counts``: each thread's M/I and M/D steps, packed 16:16."""
    hi = _popcount((words >> 1) & LO_PLANE)
    lo = _popcount(words & LO_PLANE)
    return ((16 - hi) << 16) | (16 - lo)


def _warp_scan(v, op, ident, down=False):
    """Each warp's inclusive shuffle scan of ``v`` [256]: ``__shfl_up_sync``
    by 1, 2, 4, 8, 16 with lanes below the distance kept (or
    ``__shfl_down_sync`` with lanes past 31 - d kept), as an ``[8, 32]``
    array."""
    v = np.asarray(v, np.int64).reshape(WARPS, 32).copy()
    d = 1
    while d < 32:
        pad = np.full((WARPS, d), ident, np.int64)
        u = (np.concatenate([v[:, d:], pad], 1) if down
             else np.concatenate([pad, v[:, :-d]], 1))
        v = op(v, u)
        d <<= 1
    return v


def _below(b):
    return (1 << b) - 1


class _Shared:
    """One block's ``s_first`` and ``s_last`` tables and the accesses since
    the last ``__syncthreads``: the stores and loads of different threads
    between two barriers are unordered, so a word that one thread writes
    there and another writes or reads is a race (AssertionError)."""

    def __init__(self, first, last):
        self.words = {"first": first, "last": last}
        self.seen = {}

    def _touch(self, table, k, t, store):
        prior = self.seen.get((table, k))
        if prior is not None and prior[0] != t and (store or prior[1]):
            raise AssertionError(f"race on s_{table}[{k}]: threads "
                                 f"{prior[0]} and {t} between barriers")
        if prior is None or store:
            self.seen[(table, k)] = (t, store)

    def store(self, table, k, value, t):
        self._touch(table, k, t, True)
        self.words[table][k] = value

    def load(self, table, k, t):
        self._touch(table, k, t, False)
        return int(self.words[table][k])

    def barrier(self):
        self.seen.clear()


def _walk_steps(word, qpos, tpos, kraw, lower, fr, w, top_k, NW, store,
                interval_of, paths):
    """``walk_steps``: the runs of one thread's 16 steps step by step; an
    interval opened and closed inside them is stored at once through
    ``store(table, k, value)`` (counted under ``paths["interior"]``).
    Returns ``[f_k, f_first, f_last, r_k, r_first, r_last]``."""
    r = [-1, 0, 0, -1, 0, 0]
    for j in range(16):
        code = (word >> (2 * j)) & 3
        if code == 0 and tpos >= 0:
            if tpos <= lower:
                kraw = interval_of(tpos, fr)
                lower = fr + (kraw - 1) * w
            k = min(max(kraw, 0), top_k)
            if 0 <= k < NW:
                pk = (tpos << 14) | max(qpos, 0)
                if k != r[3]:
                    if r[3] >= 0:
                        if r[0] < 0:
                            r[0:3] = r[3:6]
                        else:
                            store("first", r[3], r[5])
                            store("last", r[3], r[4])
                            paths["interior"] = paths.get("interior", 0) + 1
                    r[3], r[4] = k, pk
                r[5] = pk
        qpos -= code <= 1
        tpos -= (code & 1) == 0
    return r


def _runs_from_masks(word, qpos, tpos, kraw, lower, top_k, NW):
    """``runs_from_masks``: the same runs from the word's bit planes, with
    the interval boundary found by a binary search over the target-step
    popcounts; None where tpos falls below 0 inside a segment."""
    pc = _popcount
    tmask = ~word & LO_PLANE
    qmask = ~(word >> 1) & LO_PLANE
    mmask = tmask & qmask
    d = tpos - lower
    assert d >= 1
    seg_a = mmask
    if pc([tmask])[0] >= d:
        lo, hi = 1, 16
        for _ in range(4):
            mid = (lo + hi) >> 1
            if pc([tmask & _below(2 * mid) if mid < 16 else tmask])[0] >= d:
                hi = mid
            else:
                lo = mid + 1
        seg_a = mmask & _below(2 * hi) if hi < 16 else mmask
    r = [-1, 0, 0, -1, 0, 0]
    for i, seg in enumerate((seg_a, mmask & ~seg_a)):
        k = min(max(kraw - i, 0), top_k)
        if seg == 0 or k < 0 or k >= NW:
            continue
        b0 = (seg & -seg).bit_length() - 1
        b1 = seg.bit_length() - 1
        t0 = tpos - pc([tmask & _below(b0)])[0]
        t1 = tpos - pc([tmask & _below(b1)])[0]
        if t0 < 0:
            continue
        if t1 < 0:
            return None
        v0 = (t0 << 14) | max(qpos - pc([qmask & _below(b0)])[0], 0)
        v1 = (t1 << 14) | max(qpos - pc([qmask & _below(b1)])[0], 0)
        if k == r[3]:
            r[5] = v1
        else:
            if r[3] >= 0:
                r[0:3] = r[3:6]
            r[3:6] = [k, v0, v1]
    return r


def _mirror_kernel(packed, n, m, first_rel, nb, *, w, NW, paths=None):
    """NumPy mirror of ``breaking_points_kernel`` (a block of 256 threads
    a pair): per pass of 4096 steps, thread t's 4 bytes at 4 t (0xFF past
    the row), its M/I and M/D counts as 16 less the popcounts of its
    codes' high and low bit planes, packed 16:16, scanned across its warp,
    offset by the warp totals before it and carried from pass to pass;
    each thread divides once for its first step's interval, then takes its
    runs from its bit planes (``runs_from_masks``, w >= 16) or, where that
    cannot tell, walks its 16 steps (``walk_steps``); where it holds two
    runs or more the last run's bp_last is stored before the pass's
    barrier and the first run's bp_first after it; a warp prefix min of
    the last-run intervals and suffix max of the first-run ones, with the
    warps' totals, pick the first and the last run of each interval in
    the pass, which write bp_last (a max with earlier passes) and bp_first
    (over earlier passes) after the barrier; then bp_last's running max
    in chunks of 32 with a carry. Every table access goes through
    :class:`_Shared`, which fails on two threads' conflicting accesses
    between two barriers. ``paths`` counts the threads with a match that
    took each way."""
    B, S4 = packed.shape
    first = np.full((B, NW), BP_BIG, np.int64)
    last = np.full((B, NW), -1, np.int64)
    passes = -(-S4 // PASS_BYTES)
    warp_of = np.arange(THREADS) // 32
    paths = {} if paths is None else paths

    def interval_of(tpos, fr):
        return -((fr - tpos) // w)     # floor division, as floor_div

    for b in range(B):
        sh = _Shared(first[b], last[b])
        sh.barrier()           # after the tables' fill and the first scan
        row = np.full(max(passes, 1) * PASS_BYTES, 0xFF, np.uint8)
        row[:S4] = packed[b]
        words = row.view("<u4").astype(np.int64).reshape(-1, THREADS)
        fr, top_k = int(first_rel[b]), int(nb[b]) - 1
        mine = _step_counts(words[0])
        incl = _warp_scan(mine, np.add, 0).ravel()
        s_count = incl.reshape(WARPS, 32)[:, 31]
        q_before = t_before = 0
        for p in range(passes):
            before = np.array([int(s_count[:wp].sum())
                               for wp in range(WARPS)])[warp_of]
            total = int(s_count.sum())
            excl = before + incl - mine
            qpos0 = int(n[b]) - 1 - (q_before + (excl >> 16))
            tpos0 = int(m[b]) - 1 - (t_before + (excl & 0xFFFF))
            q_before += total >> 16
            t_before += total & 0xFFFF
            f_k = np.full(THREADS, -1)
            r_k = np.full(THREADS, -1)
            f_first = np.zeros(THREADS, np.int64)
            f_last = np.zeros(THREADS, np.int64)
            r_last = np.zeros(THREADS, np.int64)
            two = np.zeros(THREADS, bool)
            for t in range(THREADS):
                qpos, tpos = int(qpos0[t]), int(tpos0[t])
                kraw = interval_of(tpos, fr)
                lower = fr + (kraw - 1) * w
                word = int(words[p, t])
                r = [-1, 0, 0, -1, 0, 0]
                if ~(word | (word >> 1)) & LO_PLANE:
                    got = (_runs_from_masks(word, qpos, tpos, kraw, lower,
                                            top_k, NW) if w >= 16 else None)
                    kind = "masks" if got is not None else "steps"
                    paths[kind] = paths.get(kind, 0) + 1
                    r = got if got is not None else _walk_steps(
                        word, qpos, tpos, kraw, lower, fr, w, top_k, NW,
                        lambda tb, k, v, t=t: sh.store(tb, k, v, t),
                        interval_of, paths)
                two[t] = r[0] >= 0
                if two[t]:
                    # two runs or more: the last run's interval starts here
                    sh.store("last", r[3], r[4], t)
                    f_last[t] = r[2]
                else:
                    r[0], r[1] = r[3], r[4]
                f_k[t], f_first[t], r_k[t], r_last[t] = r[0], r[1], r[3], r[5]
            if p + 1 < passes:
                mine = _step_counts(words[p + 1])
                incl = _warp_scan(mine, np.add, 0).ravel()
                next_count = incl.reshape(WARPS, 32)[:, 31]
            pmin = _warp_scan(np.where(r_k >= 0, r_k, NO_RUN), np.minimum,
                              NO_RUN)
            smax = _warp_scan(f_k, np.maximum, -1, down=True)
            prev_k = np.concatenate([np.full((WARPS, 1), NO_RUN),
                                     pmin[:, :-1]], 1).ravel()
            next_k = np.concatenate([smax[:, 1:],
                                     np.full((WARPS, 1), -1)], 1).ravel()
            sh.barrier()
            for t in range(THREADS):
                wp = warp_of[t]
                for i in range(WARPS):
                    if i < wp:
                        prev_k[t] = min(prev_k[t], pmin[i, 31])
                    if i > wp:
                        next_k[t] = max(next_k[t], smax[i, 0])
                if two[t]:
                    # the first run's interval may have begun in an
                    # earlier pass
                    sh.store("first", f_k[t], f_last[t], t)
                if r_k[t] >= 0:
                    if next_k[t] != r_k[t]:
                        sh.store("first", r_k[t], r_last[t], t)
                    if prev_k[t] != f_k[t]:
                        sh.store("last", f_k[t],
                                 max(sh.load("last", f_k[t], t),
                                     f_first[t]), t)
            if p + 1 < passes:
                s_count = next_count
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


def _match_spans(packed, n, m, first_rel, nb, *, w, NW):
    """The (first, last) step of each interval's valid matches, over every
    row of the streams."""
    ops = cuda_nw.unpack_ops(torch.from_numpy(packed)).numpy().astype(
        np.int64)
    dj = ((ops & 1) == 0).astype(np.int64)
    tpos = m[:, None] - np.cumsum(dj, 1) + dj - 1
    widx = -((first_rel[:, None] - tpos) // w)
    widx = np.minimum(np.maximum(widx, 0), nb[:, None] - 1)
    valid = (ops == 0) & (tpos >= 0) & (widx >= 0) & (widx < NW)
    spans = []
    for b in range(len(ops)):
        for k in np.unique(widx[b][valid[b]]):
            steps = np.nonzero(valid[b] & (widx[b] == k))[0]
            spans.append((int(steps[0]), int(steps[-1])))
    return spans


def _three_ways(arrs, w, NW):
    """The kernel's mirror, the plain version and the JAX function on the
    same streams: all three bit for bit equal. Returns the plain tables and
    the mirror's path counts."""
    want = _breaking_points_kernel(*(jnp.asarray(a) for a in arrs), w=w,
                                   NW=NW)
    plain = breaking_points_plain(*(torch.from_numpy(a) for a in arrs),
                                  w=w, NW=NW)
    paths = {}
    got = _mirror_kernel(*arrs, w=w, NW=NW, paths=paths)
    for g, p, x in zip(got, plain, want):
        assert np.array_equal(p.numpy(), np.asarray(x))
        assert np.array_equal(g, p.numpy())
    return plain + (paths,)


@pytest.mark.parametrize("w,max_len", [(300, 2500), (500, 2050),
                                       (100, 1002)])
def test_breaking_points_mirror_pass_ends_inside_row(w, max_len):
    """Rows whose bytes end inside a pass of 1024 (S/4 = 1250: the second
    pass half full; 1025: one byte in it; 501: inside the first), so the
    last pass loads the pad code past the row."""
    NW = max_len // w + 2
    arrs = _adversarial(max_len + w, 6, max_len, w)
    S4 = arrs[0].shape[1]
    assert S4 % 1024
    _three_ways(arrs, w, NW)


@pytest.mark.parametrize("w", [300, 1000])
def test_breaking_points_mirror_runs_span_threads_warps_passes(w):
    """4096 bp pairs (two passes of 4096 steps): intervals whose matches
    span two threads' 16 steps, two warps' 512 and the two passes, so the
    first and last run of an interval fall in different threads, warps and
    passes."""
    max_len = 4096
    NW = max_len // w + 2
    arrs = _adversarial(w + 1, 6, max_len, w)
    spans = _match_spans(*arrs, w=w, NW=NW)
    for unit in (16, 512, 4096):
        assert any(a // unit != b // unit for a, b in spans), unit
    paths = _three_ways(arrs, w, NW)[2]
    # most threads take their runs from the bit planes (a thread where
    # tpos falls below 0 among its matches walks its steps)
    assert paths["masks"] > 10 * paths.get("steps", 0)


@pytest.mark.parametrize("w", [12, 500, 1000])
def test_breaking_points_mirror_intervals_end_at_pass_starts(w):
    """Intervals that begin in one pass and end within a thread's 16 steps
    of the next pass's start, in thread 0 or (after 16 insertions) thread
    1 of pass 1, in thread 0 of pass 2, and in the last thread of pass 0
    (the card test's streams): the mirror's accesses between barriers
    hold no race, and its tables equal the plain version's and JAX's."""
    from test_torch_cuda import _pass_start_streams
    host, at = _pass_start_streams(w)
    arrs = tuple(x.numpy() for x in host)
    NW = 8192 // w + 2
    spans = _match_spans(*arrs, w=w, NW=NW)
    for start in (4096, 8192):
        assert any(a < start <= b < start + 16 for a, b in spans), start
    assert any(a < 4096 and 4112 <= b < 4128 for a, b in spans)
    assert any(a < 4093 <= b + 1 for a, b in spans)
    assert at[-1] == 4093
    first = _three_ways(arrs, w, NW)[0].numpy()
    assert (first < BP_BIG).any(1).all()


@pytest.mark.parametrize("w", [5, 12])
def test_breaking_points_mirror_narrow_windows(w):
    """Windows narrower than 16 target bases: every thread walks its steps
    (the bit planes hold one boundary at most), and a thread's 16 steps
    hold whole intervals between its first and last run."""
    max_len = 602          # max_len % w >= 2: the widest span has NW
    NW = max_len // w + 2
    arrs = _adversarial(w + 3, 6, max_len, w)
    paths = _three_ways(arrs, w, NW)[2]
    assert "masks" not in paths and paths["steps"] and paths["interior"]


def test_breaking_points_mirror_edge_pairs():
    """Pairs of length 1 (a match; an insertion and a deletion), a walk
    with no match, an empty stream, spans inside one window (nb = 1), a
    match as the very last step of a thread's word and of a row, and
    matches on both sides of (0, 0) in one thread's 16 steps."""
    w, max_len = 100, 512
    NW = max_len // w + 2
    S = 2 * max_len
    rng = np.random.default_rng(26)
    ops = np.full((9, S), 3, np.uint8)
    n = np.ones(9, np.int32)
    m = np.ones(9, np.int32)
    tb = rng.integers(0, 5 * w, 9)
    ops[0, 0] = 0                                   # (1, 1): one match
    ops[1, :2] = (1, 2)                             # (1, 1): no match
    n[2], m[2] = 300, 280
    path = _walk(rng, 300, 280, "nomatch")
    ops[2, :len(path)] = path                       # no match, 580 steps
    # ops[3]: the empty stream
    n[4], m[4] = 40, 30                             # inside one window
    tb[4] = 3 * w + 10
    path = _walk(rng, 40, 30, "clean")
    ops[4, :len(path)] = path
    n[5], m[5] = 16, 16                             # a thread's word
    ops[5, :16] = 0
    n[6], m[6] = max_len, max_len // 2              # matches to the end
    ops[6, :max_len // 2] = 1
    ops[6, max_len // 2:max_len] = 0
    ops[6, max_len:] = 2
    n[7], m[7] = 200, 200
    path = _walk(rng, 200, 200, "clean")
    ops[7, S - len(path):] = path                   # ends on the last step
    n[8], m[8] = 3, 3                               # matches past (0, 0)
    ops[8, 10:18] = 0                               # in one thread's word
    te = tb + m
    n_reg = (te - 1) // w - tb // w
    nb = (n_reg + 1).astype(np.int32)
    first_rel = np.where(n_reg != 0, (tb // w + 1) * w - 1 - tb,
                         m - 1).astype(np.int32)
    assert nb[4] == 1 and (nb == 1).sum() >= 3
    packed = cuda_nw.pack_ops(torch.from_numpy(ops)).numpy()
    first, last, paths = _three_ways((packed, n, m, first_rel, nb), w, NW)
    # the pair past (0, 0) walks its steps; the others take the bit planes
    assert paths["steps"] >= 1 and paths["masks"] >= 1
    first = first.numpy()
    assert first[0, 0] == 0 and (first[0, 1:] == BP_BIG).all()
    assert (first[[1, 2, 3]] == BP_BIG).all()
    assert (last.numpy()[[1, 2, 3]] == -1).all()
    assert (first[7] < BP_BIG).any()


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
