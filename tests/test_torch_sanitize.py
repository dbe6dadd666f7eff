"""The port's runtime sanitizer (``racon_tpu_torch/sanitize.py``) on the
CPU, where K4 and K1 are their plain PyTorch versions:

- the shadow sampler's cadence and ``shadow_compare``;
- the aligner's K1 shadow of a K4 chunk and the consensus engine's K1
  shadow of a K4 group: each catches a seeded one-byte corruption of the
  packed pass's direction rows, is silent with the sanitizer off, and is
  clean on honest input;
- both canaries;
- the queue watchdog dumps every stack on a stall and stays quiet while
  beaten;
- a polish on the device engines gives the same bytes with the sanitizer
  on, every chunk and group shadowed.
"""

import io
import time

import numpy as np
import pytest
import torch

from racon_tpu_torch import sanitize
from racon_tpu_torch.core import backends as port_backends
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.ops import cuda_nw
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.ops.nw import CudaAligner
from racon_tpu_torch.utils.simulate import simulate
from tests.test_ragged import BASES
from tests.test_torch_consensus_stream import _converging_windows
from tests.test_torch_engines import _mutate


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("RACON_TPU_SANITIZE", "RACON_TPU_SANITIZE_SAMPLE",
                 "RACON_TPU_SANITIZE_WATCHDOG_S"):
        monkeypatch.delenv(name, raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    metrics.clear_run()
    yield
    torch.set_num_threads(saved)


def _sanitize(monkeypatch, sample="1"):
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    monkeypatch.setenv("RACON_TPU_SANITIZE_SAMPLE", sample)


# -------------------------------------------------------------- sampler

@pytest.mark.parametrize("sample,want", [
    ("3", [1, 0, 0, 1, 0, 0, 1]),
    ("1", [1] * 7),
    (None, [1, 0, 0, 0, 0, 0, 0]),           # the default, 8
])
def test_sampler_cadence(monkeypatch, sample, want):
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    if sample is not None:
        monkeypatch.setenv("RACON_TPU_SANITIZE_SAMPLE", sample)
    s = sanitize.ShadowSampler()
    assert [int(s.should_shadow()) for _ in want] == want


def test_sampler_is_off_without_the_flag():
    s = sanitize.ShadowSampler()
    assert not any(s.should_shadow() for _ in range(4))


def test_shadow_compare():
    a = (np.arange(6, dtype=np.int32),
         torch.tensor([1, 2], dtype=torch.uint8))
    sanitize.shadow_compare(a, (a[0].copy(), a[1].clone()), ("x", "y"),
                            "ctx")
    bad = a[1].clone()
    bad[1] = 7
    with pytest.raises(sanitize.SwarShadowMismatch, match=r"ctx: y .* 1/2"):
        sanitize.shadow_compare(a, (a[0], bad), ("x", "y"), "ctx")
    with pytest.raises(sanitize.SwarShadowMismatch, match="shape"):
        sanitize.shadow_compare(a, (a[0][:5], a[1]), ("x", "y"), "ctx")


# --------------------------------------------------------------- shadows

def _corrupt_packed_pass(monkeypatch, seed=3):
    """K4's direction rows lose one byte: the one the walk of a seeded
    live pair reads first (its last anti-diagonal, at its end cell), so
    the walk must change."""
    real = cuda_nw.nw_fwd
    rng = np.random.default_rng(seed)

    def fwd(qrp, tp, n, m, *, max_len, band, steps=0, packed16=False):
        dirs, score = real(qrp, tp, n, m, max_len=max_len, band=band,
                           steps=steps, packed16=packed16)
        live = torch.nonzero((n > 0) & (m > 0)).flatten()
        if packed16 and live.numel():
            b = int(live[int(rng.integers(0, live.numel()))])
            nb, mb = int(n[b]), int(m[b])
            c = band // 2
            a = nb + mb
            u = (mb - nb + c - ((a + c) & 1)) // 2
            dirs[b, a - 1, u % dirs.shape[2]] ^= 0xFF
        return dirs, score

    monkeypatch.setattr(cuda_nw, "nw_fwd", fwd)


def _aligner_pairs():
    rng = np.random.default_rng(4)
    pairs = []
    for _ in range(12):
        t = BASES[rng.integers(0, 4, int(rng.integers(120, 240)))]
        pairs.append((_mutate(rng, t, 0.08).tobytes(), t.tobytes()))
    return pairs


def _align():
    """CIGARs of a chunk at (256, 512), a band the aligner runs on K4."""
    eng = CudaAligner(fallback=port_backends.NativeAligner(1),
                      buckets=((256, 512),), device="cpu", use_ladder=False)
    return eng.align_batch(_aligner_pairs()), eng


def _consensus():
    eng = tpoa.CudaPoaConsensus(
        3, -5, -4, fallback=port_backends.NativePoaConsensus(3, -5, -4),
        device="cpu")
    windows = _converging_windows(8, n_w=4)
    flags = eng.run(windows, trim=True)
    return (flags, [w.consensus for w in windows]), eng


@pytest.mark.parametrize("engine,counter", [
    (_align, "align.shadow_chunks"),
    (_consensus, "consensus.shadow_groups"),
])
def test_shadow_clean_on_honest_input(monkeypatch, engine, counter):
    want, _ = engine()
    assert metrics.counter(counter) == 0          # off: no shadow
    _sanitize(monkeypatch)
    got, _ = engine()
    assert got == want
    assert metrics.counter(counter) >= 1


@pytest.mark.parametrize("engine", [_align, _consensus])
def test_shadow_catches_a_corrupt_packed_byte(monkeypatch, engine):
    _corrupt_packed_pass(monkeypatch)
    _sanitize(monkeypatch)
    with pytest.raises(sanitize.SwarShadowMismatch, match="K4"):
        engine()


@pytest.mark.parametrize("engine", [_align, _consensus])
def test_shadow_silent_with_the_sanitizer_off(monkeypatch, engine):
    _corrupt_packed_pass(monkeypatch)
    engine()                                       # no shadow, no raise
    assert metrics.counter("align.shadow_chunks") == 0
    assert metrics.counter("consensus.shadow_groups") == 0


def test_the_shadow_runs_k1(monkeypatch):
    """The aligner's shadow pass is the int32 kernel (K1) on the same
    rows, after the K4 pass."""
    seen = []
    real = cuda_nw.nw_fwd

    def spy(*args, **kw):
        seen.append(kw["packed16"])
        return real(*args, **kw)

    monkeypatch.setattr(cuda_nw, "nw_fwd", spy)
    _sanitize(monkeypatch)
    _align()
    assert seen == [True, False]


# -------------------------------------------------------------- canaries

def test_aligner_canaries():
    ok = np.array([0, 5, 1 << 28], np.int32)
    zero = np.zeros(3, np.int32)
    sanitize.check_aligner_canaries(ok, zero, zero, big=1 << 28, context="c")
    for score, fi in ((np.array([-1], np.int32), zero[:1]),
                      (np.array([(1 << 28) + 1], np.int32), zero[:1]),
                      (zero[:1], np.array([-2], np.int32))):
        with pytest.raises(sanitize.CanaryError, match="c:"):
            sanitize.check_aligner_canaries(score, fi, zero[:1],
                                            big=1 << 28, context="c")


def test_consensus_canaries():
    codes = np.array([[0, 1, 5]], np.uint8)
    blen = np.array([3])
    covs = np.array([[1, 0, 2]])
    sanitize.check_consensus_canaries(codes, blen, covs, Lb=3, context="g")
    with pytest.raises(sanitize.CanaryError, match="alphabet"):
        sanitize.check_consensus_canaries(codes + 1, blen, covs, Lb=3,
                                          context="g")
    with pytest.raises(sanitize.CanaryError, match="length"):
        sanitize.check_consensus_canaries(codes, blen + 1, covs, Lb=3,
                                          context="g")
    with pytest.raises(sanitize.CanaryError, match="coverage"):
        sanitize.check_consensus_canaries(codes, blen, -covs, Lb=3,
                                          context="g")


# -------------------------------------------------------------- watchdog

def test_watchdog_quiet_while_beaten_then_dumps_on_a_stall():
    out = io.StringIO()
    wd = sanitize.QueueWatchdog(0.8, "test queue", stream=out).start()
    try:
        t_end = time.monotonic() + 1.2
        while time.monotonic() < t_end:          # beaten: quiet
            wd.beat()
            time.sleep(0.01)
        assert wd.fired == 0 and out.getvalue() == ""
        assert wd.stalled.wait(10.0)             # the beats stop: a stall
        assert wd.fired == 1
        text = out.getvalue()
        assert "test queue made no progress" in text
        assert "--- thread MainThread" in text
    finally:
        wd.stop()


def test_queue_watchdog_follows_the_flag(monkeypatch):
    assert sanitize.queue_watchdog("q") is None
    _sanitize(monkeypatch)
    monkeypatch.setenv("RACON_TPU_SANITIZE_WATCHDOG_S", "0.5")
    wd = sanitize.queue_watchdog("q")
    try:
        assert wd.timeout == 0.5
    finally:
        wd.stop()


# ------------------------------------------------- a polish, sanitized

def test_polish_bytes_equal_with_the_sanitizer_on(tmp_path, monkeypatch):
    reads, paf, draft, _ = simulate(0.005, seed=5, coverage=30,
                                    mean_read=1000, max_read=1300,
                                    min_read=700)
    for name, blob in (("r.fastq", reads), ("o.paf", paf),
                       ("d.fasta", draft)):
        (tmp_path / name).write_bytes(blob)
    args = [str(tmp_path / n) for n in ("r.fastq", "o.paf", "d.fasta")]

    def polish():
        return [(s.name, s.data) for s in create_polisher(
            *args, num_threads=2, aligner="cuda", consensus="cuda",
            device="cpu").run()]

    want = polish()
    _sanitize(monkeypatch)
    assert polish() == want
    assert metrics.counter("align.shadow_chunks") >= 1
    assert metrics.counter("consensus.shadow_groups") >= 1
