"""The port's align stream and band ladder against the JAX package's, on
the CPU (a mirror of ``tests/test_align_stream.py``'s ``_mixed_pairs``
cases).

- The port's {bucketed, ragged} x {fixed band, ladder} CIGARs and
  breaking-point rows == JAX ``TpuAligner``'s default output (ragged
  stream, ladder, no mesh).
- With ``max_dirs_bytes`` equal on both sides (small, so classes split
  into several chunks and the stream's in-flight bound forces fetches),
  the port's session counters equal the JAX engine's in the same mode:
  both make the same seeding, chunking and escalation decisions, cold and
  (past ``ADAPT_MIN_PAIRS`` observed pairs) warm.
- The ladder's wavefront work is below the fixed band's; sliced feeds give
  the bytes of one feed; empty pairs and F-mode short reads.
"""

import numpy as np
import pytest
import torch

from racon_tpu.core.backends import NativeAligner as JaxNativeAligner
from racon_tpu.ops.nw import TpuAligner
from racon_tpu_torch.core.backends import NativeAligner
from racon_tpu_torch.ops import nw as port_nw
from racon_tpu_torch.ops.nw import CudaAligner

BASES = np.frombuffer(b"ACGT", np.uint8)
# the counters the two engines share
COUNTERS = ("device", "fallback_length", "fallback_band", "band_escalated",
            "chunks", "ladder_narrow", "lanes_occupied", "lanes_total",
            "steps_wasted", "wavefront_work")
MODES = [(ragged, ladder) for ragged in (False, True)
         for ladder in (False, True)]
# 2 MiB of direction matrix in flight: a few to a few dozen pairs a chunk
SMALL_DIRS = 2 << 20


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


def _mixed_pairs(rng, n=48, lo=60, hi=1200, hot_every=9):
    """``tests/test_align_stream.py``'s workload: pairs spanning the
    (256, 128), (1024, 384) and (4096, 1024) buckets, low- and
    high-divergence (the
    50%-flip slice escapes even the TYPICAL-seeded rung), indels for span
    asymmetry, two empty pairs, overlap-filter-style error estimates."""
    pairs, errors = [], []
    for k in range(n):
        ln = int(rng.integers(lo, hi))
        t = BASES[rng.integers(0, 4, ln)]
        q = np.delete(t.copy(), rng.integers(0, ln, max(2, ln // 60)))
        div = 0.5 if k % hot_every == 0 else 0.03
        flips = rng.random(len(q)) < div
        q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        pairs.append((q.tobytes(), t.tobytes()))
        errors.append(1.0 - min(len(q), len(t)) / max(len(q), len(t)))
    pairs.append((b"", t.tobytes()))
    errors.append(0.0)
    pairs.append((b"ACGT", b""))
    errors.append(0.0)
    metas = [(k * 13 % 300, k * 7 % 200) for k in range(len(pairs))]
    return pairs, metas, errors


def _jax(ragged=True, ladder=True, **kw):
    return TpuAligner(fallback=JaxNativeAligner(2), mesh=None,
                      use_ragged=ragged, use_ladder=ladder, **kw)


def _port(ragged=True, ladder=True, **kw):
    return CudaAligner(fallback=NativeAligner(2), device="cpu",
                       use_ragged=ragged, use_ladder=ladder, **kw)


def _bp_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def jax_default():
    """JAX TpuAligner's default output (ragged stream, ladder) per seed:
    (pairs, metas, errors, CIGARs, breaking points)."""
    out = {}
    for seed in range(2):
        rng = np.random.default_rng(400 + seed)
        pairs, metas, errors = _mixed_pairs(rng)
        eng = _jax()
        out[seed] = (pairs, metas, errors,
                     eng.align_batch(pairs, errors=errors),
                     eng.breaking_points_batch(pairs, metas, 100,
                                               errors=errors))
    return out


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("ragged,ladder", MODES)
def test_grid_matches_jax_default(jax_default, seed, ragged, ladder):
    """Every port mode gives the JAX default's CIGARs and rows; the
    ladder modes seed narrow rungs and re-batch escapes."""
    pairs, metas, errors, cig, bps = jax_default[seed]
    eng = _port(ragged, ladder)
    assert eng.align_batch(pairs, errors=errors) == cig
    assert _bp_equal(eng.breaking_points_batch(pairs, metas, 100,
                                               errors=errors), bps)
    assert any(len(b) for b in bps)
    if ladder:
        assert eng.stats["ladder_narrow"] > 0
        assert eng.stats["band_escalated"] > 0
    assert 0 < eng.stats["lanes_occupied"] <= eng.stats["lanes_total"]


def _warm_pairs():
    """1400 short pairs (past ALIGN_PROBE_PAIRS and ADAPT_MIN_PAIRS, so
    the later seeds use observed divergence), every fifth at 40% error."""
    rng = np.random.default_rng(23)
    pairs, errors = [], []
    for k in range(1400):
        t = BASES[rng.integers(0, 4, int(rng.integers(30, 120)))]
        q = t.copy()
        flips = rng.random(len(q)) < (0.4 if k % 5 == 0 else 0.04)
        q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        pairs.append((q.tobytes(), t.tobytes()))
        errors.append(0.0)
    metas = [(k * 31 % 500, k % 90) for k in range(len(pairs))]
    return pairs, metas, errors


@pytest.mark.parametrize("ragged,ladder", MODES)
def test_session_counters_match_jax(ragged, ladder):
    """Same max_dirs_bytes on both sides: equal rows and equal counters,
    on the mixed workload (several chunks a class) and, with the ladder,
    on the warm one (the adaptive estimate seeds most pairs)."""
    workloads = [_mixed_pairs(np.random.default_rng(77), n=40)]
    if ladder:
        workloads.append(_warm_pairs())
    for pairs, metas, errors in workloads:
        ref = _jax(ragged, ladder, max_dirs_bytes=SMALL_DIRS)
        eng = _port(ragged, ladder, max_dirs_bytes=SMALL_DIRS)
        want = ref.breaking_points_batch(pairs, metas, 50, errors=errors)
        got = eng.breaking_points_batch(pairs, metas, 50, errors=errors)
        assert _bp_equal(got, want)
        for key in COUNTERS:
            assert eng.stats[key] == ref.stats[key], key
        assert eng.stats["chunks"] > 4
        assert eng._div_obs == ref._div_obs
    if ladder:
        assert eng._adaptive_divergence() is not None
        assert eng.stats["ladder_narrow"] > 0


def test_ladder_cuts_wavefront_work():
    rng = np.random.default_rng(401)
    pairs, metas, errors = _mixed_pairs(rng)
    work = {}
    for ladder in (False, True):
        eng = _port(True, ladder)
        eng.breaking_points_batch(pairs, metas, 100, errors=errors)
        work[ladder] = eng.stats["wavefront_work"]
    assert work[True] < work[False]


def test_stream_feed_slices_match_single_feed():
    """The polisher feeds the session in slices; slice boundaries change
    no byte, and every span copy and meta is released at the end."""
    rng = np.random.default_rng(77)
    pairs, metas, errors = _mixed_pairs(rng, n=30)
    ref = _port(False, False).breaking_points_batch(pairs, metas, 100,
                                                    errors=errors)
    eng = _port()
    sess = eng.bp_stream(100, total=len(pairs))
    for a in range(0, len(pairs), 7):
        sess.feed(pairs[a:a + 7], metas[a:a + 7], errors[a:a + 7])
    assert _bp_equal(sess.finish(), ref)
    assert not sess.pairs and not sess.metas
    assert _port(ragged=False).bp_stream(100) is None


def test_stream_empty_edges():
    eng = _port()
    sess = eng.bp_stream(100)
    sess.feed([], [], [])
    assert sess.finish() == []
    sess2 = eng.bp_stream(100)
    sess2.feed([(b"", b"ACGT"), (b"AC", b"")], [(0, 0), (0, 0)],
               [0.0, 0.0])
    out = sess2.finish()
    assert len(out) == 2 and all(len(o) == 0 for o in out)
    with pytest.raises(RuntimeError):
        sess2.finish()
    for ragged in (False, True):
        cig = _port(ragged).align_batch([(b"", b"ACGT"), (b"AC", b""),
                                         (b"", b"")])
        assert cig == ["4D", "2I", ""]


def test_f_mode_short_reads_match_jax():
    """F-mode shapes: short pairs, all in the smallest bucket and the
    narrowest rungs (64, 96: the rows of K2's narrowest bands)."""
    rng = np.random.default_rng(31)
    pairs, metas, errors = _mixed_pairs(rng, n=40, lo=30, hi=90)
    ref = _jax()
    want = ref.breaking_points_batch(pairs, metas, 50, errors=errors)
    eng = _port()
    got = eng.breaking_points_batch(pairs, metas, 50, errors=errors)
    assert _bp_equal(got, want)
    assert {s[1] for s in eng.stats["chunk_shapes"]} & {64, 96}
    for key in COUNTERS:
        assert eng.stats[key] == ref.stats[key], key


def test_device_path_fetches_tables_not_ops(monkeypatch):
    """In breaking-points mode the op stream stays on the device: every
    fetch is one chunk's [C, 2 NW + 3] int32 tables and gate scalars, and
    no CIGAR is built."""
    rng = np.random.default_rng(5)
    pairs, metas, errors = _mixed_pairs(rng, n=24)
    fetched = []
    real_fetch = CudaAligner._fetch

    def spy(self, t):
        fetched.append((tuple(t.shape), t.dtype))
        return real_fetch(self, t)

    def no_cigar(path):
        raise AssertionError("a CIGAR was built on the device path")

    monkeypatch.setattr(CudaAligner, "_fetch", spy)
    monkeypatch.setattr(port_nw, "ops_to_cigar", no_cigar)
    eng = _port()
    eng.breaking_points_batch(pairs, metas, 100, errors=errors)
    assert len(fetched) == eng.stats["chunks"]
    for (shape, dtype), launch in zip(fetched, eng.stats["chunk_shapes"]):
        max_len, _, pairs_, _, _ = launch
        assert str(dtype) == "torch.int32"
        assert shape == (pairs_, 2 * (max_len // 100 + 2) + 3)
    assert eng.stats["fetched_bytes"] == sum(
        4 * s[0] * s[1] for s, _ in fetched)
