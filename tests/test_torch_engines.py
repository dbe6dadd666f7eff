"""Port engines vs the JAX package's engines, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port
counterpart (``device="cpu"``, where every kernel runs its plain PyTorch
version); every comparison is **exact**: refine-loop state arrays,
CIGAR strings and consensus bytes. The JAX engines run without a mesh
(``mesh=None``; the test conftest gives JAX 8 virtual CPU devices) and on
their bucketed/padded paths, which the JAX package holds byte-identical to
its ragged ones.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from racon_tpu.core import backends as jax_backends
from racon_tpu.core.window import Window as JaxWindow
from racon_tpu.ops.nw import TpuAligner
from racon_tpu.ops.poa import TpuPoaConsensus, refine_loop as jax_refine_loop
from racon_tpu_torch.core import backends as port_backends
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.ops.nw import CudaAligner
from racon_tpu_torch.params import STATE_NAMES, refine_state_to_torch

BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, seq, err):
    q = seq.copy()
    flips = rng.random(len(q)) < err
    q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
    nd = max(1, int(len(q) * err / 3))
    q = np.delete(q, rng.integers(0, len(q), nd))
    return np.insert(q, rng.integers(0, len(q) + 1, nd),
                     BASES[rng.integers(0, 4, nd)])


def _windows(seed, n_w=5, wl=120, depth=8, cls=Window):
    """Windows with a noisy backbone and noisy layers (some partial-span,
    some without quality), plus a 1-layer passthrough window and one with
    a layer longer than the device's query lanes (it takes the host
    fallback)."""
    rng = np.random.default_rng(seed)
    out = []
    for wi in range(n_w):
        truth = BASES[rng.integers(0, 4, wl)]
        bb = _mutate(rng, truth, 0.1)
        win = cls(0, wi, WindowType.TGS if cls is Window else
                  _jax_type(), bb.tobytes(),
                  bytes(33 + int(x) for x in rng.integers(0, 40, len(bb))))
        for li in range(depth if wi != n_w - 2 else 1):
            if wi == n_w - 1 and li == 0:
                layer = _mutate(rng, np.tile(truth, 9), 0.1)
                b, e = 0, len(bb) - 1
            elif li % 3 == 2:
                lo = int(rng.integers(0, wl // 3))
                layer = _mutate(rng, truth[lo:], 0.12)
                b, e = min(lo, len(bb) - 2), len(bb) - 1
            else:
                layer = _mutate(rng, truth, 0.12)
                b, e = 0, len(bb) - 1
            qual = (None if li % 4 == 3 else
                    bytes(33 + int(x) for x in
                          rng.integers(3, 45, len(layer))))
            win.add_layer(layer.tobytes(), qual, b, e)
        out.append(win)
    return out


def _jax_type():
    from racon_tpu.core.window import WindowType as JaxWindowType
    return JaxWindowType.TGS


# ------------------------------------------------------------ refine loop

JAX_DTYPES = {"win_of": np.int32, "dropped": np.int32}


@pytest.mark.parametrize("swar,matmul_votes,scores", [
    (True, True, (3, -5, -4)),
    (False, False, (3, -5, -4)),
    (True, True, (5, -4, -8)),
])
def test_refine_loop_matches_jax(swar, matmul_votes, scores):
    """The port's refine_loop == JAX refine_loop(use_pallas=False) on one
    packed group carried across by params.refine_state_to_torch: every
    state array bit-equal after all rounds. The scatter leg's fold
    telemetry (dropped[:, 2] and [:, 4:]) has no port counterpart: the
    port's scatter is uncapped, so those columns are compared only on the
    matmul leg, where the JAX package reports them as 0 too."""
    windows = _windows(5)
    stats = {"dropped_layers": 0}
    items = [(i, tpoa._Work(w, 200, stats)) for i, w in enumerate(windows)
             if w.layer_count >= 2]
    max_bb = max(len(w.backbone) for _, w in items)
    band, L, Lq, Lb = tpoa.bucket_geometry(128, max_bb)
    items = [(i, w) for i, w in items
             if w.max_layer_len <= Lq and len(w.backbone) <= Lb]
    max_nm = max(int(np.max(w.lens + np.minimum(w.ends - w.begins + 65,
                                                Lb))) for _, w in items)
    steps, Lq2 = tpoa.sweep_geometry(Lq, max_nm,
                                     max(w.max_layer_len for _, w in items))
    state, B, nWp = tpoa.pack_group(items, Lq, Lb)
    theta, beta = 0.25, 0.65
    kw = dict(rounds=6, n_windows=nWp, max_len=Lq, band=band, Lb=Lb, K=4,
              steps=steps, Lq2=Lq2, scores=scores)
    jargs = [jnp.asarray(state[k].astype(JAX_DTYPES.get(k,
                                                        state[k].dtype)))
             for k in STATE_NAMES]
    # graftlint: disable=swar-guard (Lq <= 1024 fits the int16 lanes)
    want = jax_refine_loop(*jargs, jnp.float32(theta), jnp.float32(beta),
                           use_pallas=False, use_swar=swar,
                           matmul_votes=matmul_votes, **kw)
    st = refine_state_to_torch(state, "cpu")
    got = tpoa.refine_loop(*[st[k] for k in STATE_NAMES], theta, beta,
                           packed16=swar, **kw)
    names = STATE_NAMES[4:]
    for name, g, x in zip(names, got, want):
        g, x = g.numpy(), np.asarray(x)
        if name == "dropped" and not matmul_votes:
            g, x = g[:, [0, 1, 3]], x[:, [0, 1, 3]]
        assert np.array_equal(g, x.astype(g.dtype)), name
    ever = np.asarray(want[6])
    assert ever[:len(items)].sum() >= len(items) - 1


# --------------------------------------------------------------- aligner

def _aligner_pairs(seed=9):
    """Pairs across the small test buckets: plain ones, ones that escape
    the first band and escalate, and ones too long for any bucket (host
    fallback)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(40):
        ln = int(rng.integers(20, 230))
        t = BASES[rng.integers(0, 4, ln)]
        err = 0.35 if k % 6 == 0 else 0.08
        pairs.append((_mutate(rng, t, err).tobytes(), t.tobytes()))
    for _ in range(6):   # short and divergent: escape (128, 64)
        t = BASES[rng.integers(0, 4, int(rng.integers(50, 64)))]
        pairs.append((_mutate(rng, t, 0.6).tobytes(), t.tobytes()))
    t = BASES[rng.integers(0, 4, 300)]
    pairs.append((_mutate(rng, t, 0.05).tobytes(), t.tobytes()))
    pairs.append((b"", b"ACGT"))
    pairs.append((b"ACG", b""))
    return pairs


def test_cuda_aligner_matches_tpu_aligner(monkeypatch):
    """CudaAligner(device="cpu") CIGARs == TpuAligner(mesh=None) CIGARs on
    the JAX bucketed path (ragged stream and band ladder off), including
    band escalation and the host fallback."""
    monkeypatch.setenv("RACON_TPU_ALIGN_RAGGED", "0")
    monkeypatch.setenv("RACON_TPU_BAND_LADDER", "0")
    buckets = ((64, 32), (128, 64), (256, 128))
    pairs = _aligner_pairs()
    ref = TpuAligner(fallback=jax_backends.NativeAligner(1), mesh=None,
                     buckets=buckets)
    port = CudaAligner(fallback=port_backends.NativeAligner(1),
                       buckets=buckets, device="cpu")
    assert port.align_batch(pairs) == ref.align_batch(pairs)
    assert port.stats["band_escalated"] > 0
    assert port.stats["fallback_length"] + port.stats["fallback_band"] > 0
    assert port.stats["device"] > 30


# ------------------------------------------------------------- consensus

def test_cuda_consensus_matches_tpu_consensus():
    """CudaPoaConsensus(device="cpu") == TpuPoaConsensus(use_ragged=False,
    mesh=None): same polished flags and consensus bytes per window,
    passthrough and host-fallback windows included."""
    port_w = _windows(21, n_w=6, wl=300, depth=10)
    jax_w = _windows(21, n_w=6, wl=300, depth=10, cls=JaxWindow)
    ref = TpuPoaConsensus(3, -5, -4,
                          fallback=jax_backends.CpuPoaConsensus(3, -5, -4),
                          use_ragged=False, mesh=None)
    port = tpoa.CudaPoaConsensus(
        3, -5, -4, fallback=port_backends.NativePoaConsensus(3, -5, -4),
        device="cpu")
    want = ref.run(jax_w, trim=True)
    got = port.run(port_w, trim=True)
    assert got == want
    assert [w.consensus for w in port_w] == [w.consensus for w in jax_w]
    assert port.stats["device_windows"] == ref.stats["device_windows"] >= 3
    assert port.stats["passthrough"] == 1
    assert port.stats["fallback_windows"] == \
        ref.stats["fallback_windows"] >= 1
