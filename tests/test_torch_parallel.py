"""The port's mesh path against the JAX package's, on the CPU.

The JAX side shards over the 8 virtual CPU devices ``tests/conftest.py``
forces (``jax.shard_map``); the port's mesh names the CPU ``k`` times
(``Mesh((cpu,) * k)``), so every split, pad, per-shard launch and merge
runs with the kernels' plain versions. Every comparison is exact:

- ``partition_balanced`` bins equal JAX's on random costs, ties included;
- ``sharded_align`` from the aligner's upload blocks (2-bit, nibble and
  raw) equals JAX's ``sharded_align`` from its rows element by element at
  mesh sizes 1, 2, 4 and 8, with the int32 and the packed forward pass;
- ``sharded_refine_loop`` equals JAX's at mesh sizes 1, 2 and 4, every
  state array;
- ``CudaAligner(mesh=...)`` gives JAX's ``TpuAligner(mesh=...)`` CIGARs and
  ``stats["device"]`` and the single-device engine's (breaking points
  too); ``CudaPoaConsensus(mesh=...)`` gives JAX's consensus, with fewer
  windows than devices among the cases
  (``tests/test_parallel.py``'s inputs);
- ``Mesh`` and ``get_mesh`` keep JAX's rules and errors, and the engines'
  automatic mesh never engages on the CPU;
- each CUDA launch wrapper enters its tensors' device (a mocked
  ``torch.cuda.device``), and inputs on two devices raise.
"""

import os
import sys
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from racon_tpu import parallel as jax_parallel
from racon_tpu.core.window import Window as JaxWindow
from racon_tpu.core.window import WindowType as JaxWindowType
from racon_tpu.ops import nw as jax_nw
from racon_tpu.ops.nw import TpuAligner
from racon_tpu.ops.poa import TpuPoaConsensus
from racon_tpu_torch import parallel
from racon_tpu_torch.core import backends
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.ops import _build, chain, cuda_nw
from racon_tpu_torch.ops import nw as tnw
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.ops.nw import CudaAligner
from racon_tpu_torch.ops.poa import CudaPoaConsensus
from racon_tpu_torch.params import STATE_NAMES, refine_state_to_torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_parallel import _random_pairs  # noqa: E402

CPU = torch.device("cpu")
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _mesh(k):
    return parallel.get_mesh(devices=[CPU] * k)


def _random_windows(count, depth=5, blen=64, seed=9, cls=Window,
                    wtype=WindowType.TGS):
    """``tests/test_parallel.py``'s windows, for either package."""
    rng = np.random.default_rng(seed)
    bases = b"ACGT"
    windows = []
    for k in range(count):
        backbone = bytes(bases[i] for i in rng.integers(0, 4, blen))
        win = cls(0, k, wtype, backbone, b"5" * blen)
        for _ in range(depth):
            layer = bytearray(backbone)
            for p in rng.integers(1, blen - 1, 4):
                layer[p] = bases[int(rng.integers(0, 4))]
            win.add_layer(bytes(layer), b"9" * len(layer), 0, blen - 1)
        windows.append(win)
    return windows


# ------------------------------------------------------------------ mesh

def test_mesh_and_get_mesh_rules():
    m = _mesh(3)
    assert parallel.mesh_size(m) == 3 and parallel.mesh_size(None) == 1
    assert m.shape == {"d": 3} and m.axis_names == ("d",)
    assert m.devices == (CPU,) * 3 and hash(m) == hash(_mesh(3))
    assert parallel.get_mesh(2, devices=[CPU] * 5).devices == (CPU, CPU)
    with pytest.raises(ValueError) as mine:
        parallel.get_mesh(9, devices=[CPU] * 8)
    with pytest.raises(ValueError) as theirs:
        jax_parallel.get_mesh(9)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="different types"):
        parallel.Mesh((CPU, torch.device("cuda", 0)))
    with pytest.raises(ValueError):
        parallel.Mesh(())
    # this host's own devices: one, so no mesh engages on its own
    assert parallel.mesh_size(parallel.get_mesh()) == \
        max(1, torch.cuda.device_count())
    assert backends._auto_mesh(None, "cpu") is None
    assert backends._auto_mesh(m, "cpu") is m
    if not torch.cuda.is_available():
        assert backends._auto_mesh(None, "cuda") is None


def test_auto_mesh_engages_only_unpinned_on_several_cards(monkeypatch):
    """On a host with several cards an unindexed ``cuda`` engages a mesh
    of all of them; an indexed device (a pin) and the CPU never do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = backends._auto_mesh(None, "cuda")
    assert m.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert backends._auto_mesh(None, "cuda:1") is None
    assert backends._auto_mesh(None, "cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backends._auto_mesh(None, "cuda") is None


def test_engines_take_a_mesh_or_a_pin_not_both():
    with pytest.raises(ValueError, match="not both"):
        CudaAligner(device="cpu", mesh=_mesh(2))
    with pytest.raises(ValueError, match="not both"):
        CudaPoaConsensus(3, -5, -4, device="cpu", mesh=_mesh(2))
    eng = backends.make_consensus("cuda", 3, -5, -4, device="cpu",
                                  mesh=_mesh(2))
    assert eng.mesh == _mesh(2) and eng.device == CPU and not eng.pinned
    # a chip worker's pin is an indexed card, where no mesh engages
    # (test_auto_mesh_engages_only_unpinned_on_several_cards); an
    # explicit mesh is the caller's and wins
    meshed = backends.make_aligner("cuda", 1, device="cpu", mesh=_mesh(2))
    assert meshed.mesh == _mesh(2) and meshed.device == CPU


@pytest.mark.parametrize("seed", range(6))
def test_partition_balanced_equals_jax(seed):
    rng = np.random.default_rng(seed)
    # few distinct values: many ties
    costs = rng.integers(1, 6 if seed % 2 else 1000, 40).tolist()
    for n in (1, 2, 3, 8, 50):
        assert parallel.partition_balanced(costs, n) == \
            jax_parallel.partition_balanced(costs, n)
    assert tpoa.partition_balanced is parallel.partition_balanced


# ---------------------------------------------------------- sharded_align

def _rows(seed, B=8, max_len=256, band=128):
    rng = np.random.default_rng(seed)
    n = np.zeros(B, np.int32)
    m = np.zeros(B, np.int32)
    qcat = np.zeros(B * max_len, np.uint8)
    tcat = np.zeros(B * max_len, np.uint8)
    for k in range(B):
        t = BASES[rng.integers(0, 4, int(rng.integers(40, 200)))]
        q = t.copy()
        flips = rng.random(len(q)) < 0.1
        q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        q = np.delete(q, rng.integers(0, len(q), 3))
        n[k], m[k] = len(q), len(t)
        qcat[k * max_len:k * max_len + len(q)] = q
        tcat[k * max_len:k * max_len + len(t)] = t
    steps = tnw.sweep_bound(int((n + m).max()), max_len)
    return qcat, tcat, n, m, steps


def _blocks(qcat, tcat, n, m, max_len, bits):
    """The chunk's upload blocks in form ``bits`` (the aligner's packer)."""
    seqs = [[cat[k * max_len:k * max_len + ln].tobytes()
             for k, ln in enumerate(lens)]
            for cat, lens in ((qcat, n), (tcat, m))]
    q, t, _ = tnw.pack_chunk(*seqs, n, m, len(n), max_len, swar=True,
                             bits=bits)
    return q, t


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("swar", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_align_equals_jax(k, swar, bits):
    """The port from the chunk's upload blocks in each form (each shard
    builds its rows from its slice), JAX from its rows."""
    max_len, band = 256, 128
    qcat, tcat, n, m, steps = _rows(k + 10 * swar)
    jq, jt = jax_nw._build_rows(jnp.asarray(qcat), jnp.asarray(tcat),
                                jnp.asarray(n), jnp.asarray(m),
                                max_len=max_len, band=band)
    want = jax_parallel.sharded_align(
        jax_parallel.get_mesh(k), jq, jt, jnp.asarray(n), jnp.asarray(m),
        max_len=max_len, band=band, steps=steps, use_swar=swar)
    nt, mt = torch.from_numpy(n), torch.from_numpy(m)
    qblk, tblk = _blocks(qcat, tcat, n, m, max_len, bits)
    parts = parallel.sharded_align(_mesh(k), qblk, tblk, nt, mt,
                                   max_len=max_len, band=band, bits=bits,
                                   steps=steps, packed16=swar)
    assert len(parts) == k and all(p[0].shape[0] == 8 // k for p in parts)
    got = parallel.gather_shards(parts)
    for name, g, w in zip(("ops_packed", "score", "fi", "fj"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), (name, k, swar)
    qrp, tp = tnw.build_rows(qblk, tblk, nt, mt, max_len=max_len, band=band,
                             bits=bits)
    single = tnw.align_chain(qrp, tp, nt, mt, max_len=max_len, band=band,
                             steps=steps, packed16=swar)
    assert all(torch.equal(a, b) for a, b in zip(got, single))


def test_sharded_align_needs_a_multiple_of_the_mesh():
    qcat, tcat, n, m, steps = _rows(3, B=6)
    nt, mt = torch.from_numpy(n), torch.from_numpy(m)
    qblk, tblk = _blocks(qcat, tcat, n, m, 256, 2)
    with pytest.raises(ValueError, match="multiple of the mesh size 4"):
        parallel.sharded_align(_mesh(4), qblk, tblk, nt, mt, max_len=256,
                               band=128, bits=2, steps=steps)
    # rows are not blocks: the one input form is the flat upload
    qrp, tp = tnw.build_rows(qblk, tblk, nt, mt, max_len=256, band=128,
                             bits=2)
    with pytest.raises(ValueError, match="must be flat"):
        parallel.sharded_align(_mesh(2), qrp, tp, nt, mt, max_len=256,
                               band=128, bits=2, steps=steps)


# ---------------------------------------------------- sharded_refine_loop

JAX_DTYPES = {"win_of": np.int32, "dropped": np.int32}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_refine_loop_equals_jax(k):
    from test_torch_engines import _windows
    windows = _windows(5, n_w=6)
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
    bins = parallel.partition_balanced([w.n_layers for _, w in items], k)
    shards = [[items[i] for i in b] for b in bins]
    B = tpoa._pow2_at_least(max(sum(w.n_layers for _, w in sh)
                                for sh in shards))
    nWp = tpoa._pow2_at_least(max(len(sh) for sh in shards) + 1)
    packs = [tpoa.pack_group(sh, Lq, Lb, B=B, nWp=nWp)[0] for sh in shards]
    state = {key: np.concatenate([p[key] for p in packs])
             for key in packs[0]}
    assert state["dropped"].shape == (k, 4 + nWp)
    theta, beta = 0.25, 0.65
    kw = dict(rounds=3, n_windows_local=nWp, max_len=Lq, band=band, Lb=Lb,
              K=4, steps=steps, Lq2=Lq2, scores=(3, -5, -4))
    jargs = [jnp.asarray(state[key].astype(JAX_DTYPES.get(
        key, state[key].dtype))) for key in STATE_NAMES]
    # graftlint: disable=swar-guard (Lq <= 1024 fits the int16 lanes)
    want = jax_parallel.sharded_refine_loop(
        jax_parallel.get_mesh(k), jargs[:4], jargs[4:], jnp.float32(theta),
        jnp.float32(beta), use_swar=True, matmul_votes=True, **kw)
    st = refine_state_to_torch(state, "cpu")
    idle = torch.zeros((), dtype=torch.int64)
    got = parallel.sharded_refine_loop(
        _mesh(k), [st[key] for key in STATE_NAMES[:4]],
        [st[key] for key in STATE_NAMES[4:]], theta, beta, packed16=True,
        idle=idle, **kw)
    for name, g, w in zip(STATE_NAMES[4:], got, want):
        g = g.numpy()
        assert np.array_equal(g, np.asarray(w).astype(g.dtype)), (name, k)
    assert int(idle) == 0  # the CPU loop stops at convergence
    assert np.asarray(want[6]).sum() >= len(items) - 1


# ----------------------------------------------------------------- engines

@pytest.mark.parametrize("k,count,seed", [(8, 37, 5), (4, 10, 6)])
def test_mesh_aligner_equals_jax_and_single(k, count, seed):
    pairs = _random_pairs(count, seed=seed)
    jax_eng = TpuAligner(buckets=((256, 128),),
                         mesh=jax_parallel.get_mesh(k))
    mine = CudaAligner(buckets=((256, 128),), mesh=_mesh(k))
    single = CudaAligner(buckets=((256, 128),), device="cpu")
    got = mine.align_batch(pairs)
    assert got == jax_eng.align_batch(pairs) == single.align_batch(pairs)
    assert mine.stats["device"] == jax_eng.stats["device"] == count
    assert mine.bp_stream(500) is None       # the bucketed wave driver
    assert all(B % k == 0 for _, _, _, B, _ in mine.stats["chunk_shapes"])
    if k == 4:  # breaking points: one shard table a shard device
        metas = [(37 * i, 3 * i) for i in range(count)]
        for a, b in zip(mine.breaking_points_batch(pairs, metas, 50),
                        single.breaking_points_batch(pairs, metas, 50)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("count,rounds,trim,seed", [
    (13, 2, True, 9), (3, 1, False, 21)])
def test_mesh_consensus_equals_jax(count, rounds, trim, seed):
    jax_w = _random_windows(count, seed=seed, cls=JaxWindow,
                            wtype=JaxWindowType.TGS)
    mine_w = _random_windows(count, seed=seed)
    single_w = _random_windows(count, seed=seed)
    jax_eng = TpuPoaConsensus(3, -5, -4, band=64, rounds=rounds,
                              mesh=jax.sharding.Mesh(
                                  np.asarray(jax.devices()), ("d",)))
    mine = CudaPoaConsensus(3, -5, -4, band=64, rounds=rounds,
                            mesh=_mesh(8))
    single = CudaPoaConsensus(3, -5, -4, band=64, rounds=rounds,
                              device="cpu")
    flags = mine.run(mine_w, trim=trim)
    assert flags == jax_eng.run(jax_w, trim=trim) == \
        single.run(single_w, trim=trim)
    assert [w.consensus for w in mine_w] == [w.consensus for w in jax_w] \
        == [w.consensus for w in single_w]
    assert mine.stats["device_windows"] == jax_eng.stats["device_windows"]
    assert mine.stream(trim) is None         # the padded path
    assert mine.stats["groups"] >= 1
    assert all(B >= 1 for _, _, _, B, *_ in mine.stats["group_shapes"])


def test_mesh_consensus_stage_b_and_shards_of_several_groups(monkeypatch):
    """Several groups a run, each over the mesh (the bins of the padded
    path and of each group's shards are partition_balanced's), and a group
    continuing in place: the bytes equal the single-device padded run."""
    monkeypatch.setattr(tpoa, "MAX_GROUP_PAIRS", 16)
    a = _random_windows(11, seed=4)
    b = _random_windows(11, seed=4)
    mine = CudaPoaConsensus(3, -5, -4, band=64, rounds=3, mesh=_mesh(3),
                            num_batches=2)
    single = CudaPoaConsensus(3, -5, -4, band=64, rounds=3, device="cpu",
                              use_ragged=False, num_batches=2)
    assert mine.run(a, trim=True) == single.run(b, trim=True)
    assert [w.consensus for w in a] == [w.consensus for w in b]
    assert mine.stats["groups"] == single.stats["groups"] > 1


# ------------------------------------------------------ launches and devices

class _FakeCuda:
    """A stand-in for a CUDA tensor: what the launch wrappers read."""

    def __init__(self, shape, dtype, index=1):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", index)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096

    def __getitem__(self, i):
        return _FakeCuda(self.shape[1:], self.dtype, self.device.index)


@contextmanager
def _fake_card(monkeypatch):
    """Launches without a card: ``torch.cuda.device`` records the device
    it enters, ``torch.cuda.current_device`` reports it (0 outside any),
    allocations make fakes on the requested device, and every C entry
    records the current device when it is called."""
    current, calls = [None], []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            self.prev = current[0]
            current[0] = self.dev

        def __exit__(self, *exc):
            current[0] = self.prev
            return False

    def empty(shape, dtype=None, device=None):
        return _FakeCuda(shape, dtype, torch.device(device).index)

    def function(entry):
        def fn(*args):
            calls.append((entry, current[0]))
            return 0
        return fn

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: 0 if current[0] is None else current[0].index)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(cuda_nw, "_stream", lambda t: 0)
    yield calls
    cuda_nw.reset_launches()


def test_every_wrapper_launches_on_its_tensors_device(monkeypatch):
    B, L, band = 4, 256, 128
    width = band // 2 + L + band
    u8, i32, i16 = torch.uint8, torch.int32, torch.int16
    with _fake_card(monkeypatch) as calls:
        row = _FakeCuda((B, width), u8)
        lens = _FakeCuda((B,), i32)
        for packed16 in (False, True):
            cuda_nw.nw_fwd(row, row, lens, lens, max_len=L, band=band,
                           steps=512, packed16=packed16)
        dirs = _FakeCuda((B, 512, band // 8), u8)
        cuda_nw.walk_ops(dirs, lens, lens, band=band)
        cuda_nw.walk_vote(dirs, lens, lens, lens,
                          _FakeCuda((B, L), i16), band=band, L=L, K=4,
                          CH=6, DEL=5)
        tnw.breaking_points(_FakeCuda((B, 128), u8), lens, lens, lens,
                            lens, w=100, NW=4)
        chain.chain_dp(_FakeCuda((B, 64), i32), _FakeCuda((B, 64), i32),
                       lens, k=15)
    launched = {entry for entry, _ in calls}
    assert {"rt_walk_ops", "rt_walk_vote", "rt_breaking_points",
            "rt_chain_dp"} <= launched and len(calls) == 6
    # every C entry ran with the tensors' card (cuda:1) current
    assert {dev for _, dev in calls} == {torch.device("cuda", 1)}


def test_launches_on_the_current_card_enter_no_device(monkeypatch):
    """Tensors on the current card (cuda:0 here) launch with no device
    switch: no ``torch.cuda.device`` is entered, and every C entry still
    runs with that card current."""
    B, L, band = 4, 256, 128
    width = band // 2 + L + band
    u8, i32 = torch.uint8, torch.int32
    entered = []
    with _fake_card(monkeypatch) as calls:
        fake_device = torch.cuda.device

        def device(dev):
            entered.append(dev)
            return fake_device(dev)
        monkeypatch.setattr(torch.cuda, "device", device)
        row = _FakeCuda((B, width), u8, index=0)
        lens = _FakeCuda((B,), i32, index=0)
        cuda_nw.nw_fwd(row, row, lens, lens, max_len=L, band=band,
                       steps=512, packed16=True)
        tnw.breaking_points(_FakeCuda((B, 128), u8, index=0), lens, lens,
                            lens, lens, w=100, NW=4)
        tnw.build_rows(_FakeCuda((B * L // 4,), u8, index=0),
                       _FakeCuda((B * L // 4,), u8, index=0), lens, lens,
                       max_len=L, band=band, bits=2)
    assert entered == []
    assert [entry for entry, _ in calls] == [
        cuda_nw.FWD_I16X2_ENTRIES[cuda_nw.fwd_i16x2_body(band, B)[0]],
        "rt_breaking_points", "rt_build_rows"]
    assert {dev for _, dev in calls} == {None}


def test_stream_handle_by_raw_lookup_or_public_call(monkeypatch):
    """``cuda_nw._stream`` resolves PyTorch's raw stream lookup once, as
    ``torch._C`` has it (absent from a CPU-only build), and asks it for the
    tensor's card; without it, ``torch.cuda.current_stream`` of the
    tensor's device gives the handle."""
    assert cuda_nw._RAW_STREAM is getattr(
        torch._C, "_cuda_getCurrentRawStream", None)
    t = _FakeCuda((4,), torch.uint8, index=1)
    asked = []
    monkeypatch.setattr(cuda_nw, "_RAW_STREAM",
                        lambda index: asked.append(index) or 7000 + index)
    assert cuda_nw._stream(t) == 7001 and asked == [1]

    class Stream:
        cuda_stream = 9001
    monkeypatch.setattr(cuda_nw, "_RAW_STREAM", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: asked.append(device) or Stream)
    assert cuda_nw._stream(t) == 9001
    assert asked == [1, torch.device("cuda", 1)]


def test_inputs_on_two_devices_raise(monkeypatch):
    B, L, band = 4, 256, 128
    width = band // 2 + L + band
    with _fake_card(monkeypatch) as calls:
        row = _FakeCuda((B, width), torch.uint8, index=0)
        other = _FakeCuda((B,), torch.int32, index=1)
        mine = _FakeCuda((B,), torch.int32, index=0)
        with pytest.raises(ValueError, match="different devices"):
            cuda_nw.nw_fwd(row, row, mine, other, max_len=L, band=band)
        dirs = _FakeCuda((B, 512, band // 8), torch.uint8, index=0)
        with pytest.raises(ValueError, match="different devices"):
            cuda_nw.walk_ops(dirs, mine, other, band=band)
        with pytest.raises(ValueError, match="different devices"):
            chain.chain_dp(_FakeCuda((B, 64), torch.int32, index=0),
                           _FakeCuda((B, 64), torch.int32, index=1),
                           mine, k=15)
    assert calls == []
