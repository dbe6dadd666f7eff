"""The port's consensus engine on its default path, the ragged streaming
session, against the JAX package's, on the CPU.

Mirrors ``tests/test_ragged.py`` and reuses its window generator: band
128, windows of 60, 150 and 300 bp (ragged buckets L = 256 and 512),
depths 0-12, real and dummy qualities. The reference is
``TpuPoaConsensus(mesh=None)`` on its default ragged path (the tests'
eight virtual CPU devices would otherwise give it a mesh and its padded
path); the port runs ``device="cpu"``, where every kernel is its plain
PyTorch version. Flags and consensus bytes must equal JAX's stream and the
port's padded path; the stream's counters (groups, lanes, stage-B
windows, wavefront steps, drops, device and host windows, the band) must
equal JAX's. Stage B is forced by patching ``MAX_GROUP_WINDOWS`` in both
packages' modules so that a bucket holds several groups, with
``STAGE_B_MAX_SURVIVOR_FRAC`` at 0 (every group with a survivor continues
in place) and at 1 (the survivors are repacked).
"""

import numpy as np
import pytest
import torch

from racon_tpu.core.backends import CpuPoaConsensus
from racon_tpu.core.window import Window as JaxWindow
from racon_tpu.core.window import WindowType as JaxWindowType
from racon_tpu.ops import poa as jax_poa
from racon_tpu_torch.core.backends import NativePoaConsensus
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.params import STATE_NAMES, refine_state_to_torch
from tests.test_ragged import BASES, _mixed_windows
from tests.test_torch_engines import _windows

TEST_BAND = 128
ROUNDS = 4
COUNTERS = ("groups", "group_windows", "lanes_occupied", "lanes_total",
            "stage_b_windows", "wavefront_steps", "dropped_layers",
            "sweep_truncated", "device_windows", "fallback_windows",
            "passthrough", "band")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads: as fast as eight alone, and parallel test
    workers do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _jax_engine():
    return jax_poa.TpuPoaConsensus(
        3, -5, -4, fallback=CpuPoaConsensus(3, -5, -4), band=TEST_BAND,
        rounds=ROUNDS, mesh=None)


def _port_engine(**kw):
    return tpoa.CudaPoaConsensus(
        3, -5, -4, fallback=NativePoaConsensus(3, -5, -4), band=TEST_BAND,
        rounds=ROUNDS, device="cpu", **kw)


def _port_copy(windows):
    """The port's windows with the same backbones and layers."""
    out = []
    for jw in windows:
        w = Window(jw.id, jw.rank, WindowType[jw.type.name], jw.backbone,
                   jw.backbone_quality)
        for s, q, (b, e) in zip(jw.sequences[1:], jw.qualities[1:],
                                jw.positions[1:]):
            w.add_layer(s, q, b, e)
        out.append(w)
    return out


def _run(engine, windows, batch=0):
    """Flags and consensus bytes of one stream session fed ``batch``
    windows at a time (all at once for 0), or of ``run``."""
    if batch:
        sess = engine.stream(trim=True)
        for a in range(0, len(windows), batch):
            sess.feed(windows[a:a + batch])
        flags = sess.finish()
    else:
        flags = engine.run(windows, trim=True)
    return flags, [w.consensus for w in windows]


def _check(jax_windows, batch=0):
    """JAX's stream == the port's stream == the port's padded path, bytes
    and flags; the streams' counters equal. Returns the port's engine."""
    ref = _jax_engine()
    want = _run(ref, jax_windows, batch)
    port = _port_engine()
    got = _run(port, _port_copy(jax_windows), batch)
    padded = _run(_port_engine(use_ragged=False), _port_copy(jax_windows))
    assert any(want[0])
    assert got == want
    assert padded == want
    for key in COUNTERS:
        assert port.stats[key] == ref.stats[key], key
    return port


@pytest.mark.parametrize("seed", range(2))
def test_stream_matches_jax_randomized(seed):
    rng = np.random.default_rng(100 + seed)
    port = _check(_mixed_windows(rng, with_quality=bool(seed % 2)))
    # both buckets launched, each with its own lane width
    assert {g[0] for g in port.stats["group_shapes"]} == {
        256 + TEST_BAND, 512 + TEST_BAND}


def test_stream_matches_jax_f_mode_short_reads():
    rng = np.random.default_rng(321)
    _check(_mixed_windows(rng, n_w=24, type_=JaxWindowType.NGS))


def test_stream_matches_jax_oversized_layer_rejects():
    """A window whose layers exceed the padded path's pair buffer takes
    the host fallback on every path (the reject set is part of the
    byte-identity contract)."""
    rng = np.random.default_rng(55)
    windows = _mixed_windows(rng, n_w=8)
    wl = 150
    truth = BASES[rng.integers(0, 4, wl)]
    win = JaxWindow(0, len(windows), JaxWindowType.TGS, truth.tobytes(),
                    b"!" * wl)
    for _ in range(4):
        layer = np.insert(truth.copy(), rng.integers(0, wl, 800),
                          BASES[rng.integers(0, 4, 800)])
        win.add_layer(layer.tobytes(), None, 0, wl - 1)
    windows.append(win)
    port = _check(windows)
    assert port.stats["fallback_windows"] >= 1


def test_stream_feed_batches_match_jax_and_one_feed():
    """Ranges fed one after another (as Polisher.run() feeds them) give
    JAX's bytes and counters, and the bytes of one feed of everything."""
    rng = np.random.default_rng(7)
    windows = _mixed_windows(rng, n_w=21)
    _check(windows, batch=7)
    assert _run(_port_engine(), _port_copy(windows), batch=7) == \
        _run(_port_engine(), _port_copy(windows))


def test_stream_dispatches_while_fed(monkeypatch):
    """With groups of at most 16 pairs and 4 windows and no in-flight
    budget, the session freezes the band at the first feed (from its
    ``band_hint``), dispatches groups while it is fed and fetches the
    oldest when more than one is in flight; the bytes are still JAX's."""
    monkeypatch.setattr(tpoa, "MAX_GROUP_PAIRS", 16)
    monkeypatch.setattr(tpoa, "MAX_GROUP_WINDOWS", 4)
    monkeypatch.setattr(tpoa, "MAX_INFLIGHT_BYTES", 0)
    rng = np.random.default_rng(7)
    windows = _mixed_windows(rng, n_w=21)
    want = _run(_jax_engine(), windows)
    port = _port_engine()
    pw = _port_copy(windows)
    sess = port.stream(trim=True, band_hint=max(
        len(w.backbone) for w in windows if w.layer_count >= 2))
    sess.feed(pw[:7])
    assert sess.band == TEST_BAND
    for a in range(7, len(pw), 7):
        sess.feed(pw[a:a + 7])
    assert sess.fetched > 0                # the budget forced a fetch
    assert (sess.finish(), [w.consensus for w in pw]) == want


@pytest.mark.parametrize("frac,stage", [(0.0, "in_place"), (1.0, "B")])
def test_stage_b_matches_jax(monkeypatch, frac, stage):
    """Four windows a group, so each bucket holds several groups and they
    run STAGE_A_ROUNDS first. At a survivor fraction of 0 every group with
    an unconverged window continues in place; at 1 the unconverged windows
    of a bucket are repacked into stage-B groups. Either way the bytes,
    flags and counters equal JAX's."""
    for mod in (jax_poa, tpoa):
        monkeypatch.setattr(mod, "MAX_GROUP_WINDOWS", 4)
        monkeypatch.setattr(mod, "STAGE_B_MAX_SURVIVOR_FRAC", frac)
    rng = np.random.default_rng(100)
    port = _check(_mixed_windows(rng, with_quality=False))
    stages = [g[6] for g in port.stats["group_shapes"]]
    assert "A" in stages and stage in stages
    assert (port.stats["stage_b_windows"] > 0) == (stage == "B")


def _converging_windows(seed, n_w=5, wl=100, depth=8):
    """Windows that reach their fixed point in a few rounds: a backbone
    with 5% substitutions under layers with 2%, and in the first window a
    random layer twice as long that every round rejects (so ``dropped``
    counts until the window converges)."""
    rng = np.random.default_rng(seed)
    out = []
    for wi in range(n_w):
        truth = BASES[rng.integers(0, 4, wl)]
        bb = truth.copy()
        flips = rng.random(wl) < 0.05
        bb[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        win = Window(0, wi, WindowType.TGS, bb.tobytes(), b"!" * wl)
        for _ in range(depth):
            layer = truth.copy()
            flips = rng.random(wl) < 0.02
            layer[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
            win.add_layer(layer.tobytes(), bytes(
                33 + int(x) for x in rng.integers(10, 40, wl)), 0, wl - 1)
        if wi == 0:
            win.add_layer(BASES[rng.integers(0, 4, 2 * wl)].tobytes(), None,
                          0, wl - 1)
        out.append(win)
    return out


def test_refine_loop_early_exit_is_invisible():
    """refine_loop without its exit test (the card's stream: no host read)
    leaves every state tensor, the telemetry in ``dropped`` included,
    equal to the loop that stops once every window is converged or
    frozen, and counts the rounds it ran past that point."""
    stats = {"dropped_layers": 0}
    items = [(i, tpoa._Work(w, 200, stats))
             for i, w in enumerate(_converging_windows(3))]
    band, L, Lq, Lb = tpoa.bucket_geometry(TEST_BAND, 100)
    max_nm = max(int(np.max(w.lens + np.minimum(w.ends - w.begins + 65,
                                                Lb))) for _, w in items)
    steps, Lq2 = tpoa.sweep_geometry(Lq, max_nm,
                                     max(w.max_layer_len for _, w in items))
    state, B, nWp = tpoa.pack_group(items, Lq, Lb)
    st = refine_state_to_torch(state, "cpu")
    kw = dict(rounds=6, n_windows=nWp, max_len=Lq, band=band, Lb=Lb, K=4,
              steps=steps, Lq2=Lq2, packed16=True)
    idle = {}
    out = {}
    for early in (True, False):
        idle[early] = torch.zeros((), dtype=torch.int64)
        out[early] = tpoa.refine_loop(*[st[k] for k in STATE_NAMES], 0.25,
                                      0.65, early_exit=early,
                                      idle=idle[early], **kw)
    for name, a, b in zip(STATE_NAMES[4:], out[True], out[False]):
        assert torch.equal(a, b), name
    assert int(idle[True]) == 0 and int(idle[False]) > 0
    conv, dropped = out[False][8], out[False][9]
    assert bool(conv[:len(items)].all())
    assert int(dropped[0, 0]) > 0       # the rejected layer's rounds
