"""The resident dataflow's consensus side (``RACON_TPU_RESIDENT``): the
lane ingest from the device-resident pool against the JAX package's and
against the host gather, on the CPU.

- ``gather_qpw_rows`` == JAX ``_gather_qpw_rows`` == ``LayerStore.
  gather_qpw`` on seeded pools, with zero-length lanes, lanes of exactly
  ``Lq`` and longer, and dead padding lanes;
- ``pack_group(allow_dev=...)`` plus the device gather gives the host
  pack's refine state, at stage A and for a stage-B repack with
  overrides;
- an engine group with device lanes ends in the same ten state arrays as
  with host lanes, with the K1 shadow of the sanitizer on it; whole
  engine runs (the ragged stream through stage B, and the padded path)
  give the same bytes, every group counted in ``lanes_device_groups``;
- the gate: a pool on another device, a hand-built window in the group or
  layers from two stores take the host gather and count nothing;
- a failing ``gather_qpw_rows`` makes the resident polish raise;
- under the shard runner (one engine pair for every shard) no finished
  shard's pool stays referenced when the next shard uploads its own, and
  the sharded bytes equal the single shot's.

Windows come from ``tests/test_ragged._mixed_windows`` (seeded numpy),
their layers moved into one ``LayerStore``; the polish uses
``tests/test_columnar_init.write_synthetic_assembly``.
"""

import gc
import io
import weakref

import numpy as np
import pytest
import torch

from racon_tpu.ops import poa as jax_poa
from racon_tpu_torch import sanitize
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.core.backends import NativePoaConsensus
from racon_tpu_torch.core.layers import LayerStore
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.exec.runner import ShardRunner
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.ops import nw as port_nw
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.params import STATE_NAMES, refine_state_to_torch
from tests.test_ragged import _mixed_windows
from tests.test_torch_consensus_stream import _port_copy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _columnar(windows, pool_device=CPU):
    """Port copies of ``windows`` whose layers live in one ``LayerStore``
    (in window order); with ``pool_device`` the store's pool is uploaded
    there as the resident dataflow uploads it (``dev_qpw``)."""
    data, qual, wid, begin, end = [], [], [], [], []
    for wi, w in enumerate(windows):
        for s, q, (b, e) in zip(w.sequences[1:], w.qualities[1:],
                                w.positions[1:]):
            data.append(s)
            qual.append(q)
            wid += [wi]
            begin += [b]
            end += [e]
    n = len(data)
    lens = np.fromiter((len(s) for s in data), np.int64, n)
    store = LayerStore.build(data, qual, np.arange(n), np.zeros(n, np.int64),
                             lens, np.array(wid, np.int64),
                             np.array(begin, np.int64),
                             np.array(end, np.int64), len(windows))
    if pool_device is not None:
        store.dev_qpw = port_nw.upload_qpw_pool(store.qpw_pool,
                                                pool_device)
    out = []
    bounds = store.row_bounds
    for wi, w in enumerate(windows):
        pw = Window(w.id, w.rank, WindowType[w.type.name], w.backbone,
                    w.backbone_quality)
        if bounds[wi + 1] > bounds[wi]:
            pw.attach_layers(store, int(bounds[wi]), int(bounds[wi + 1]))
        out.append(pw)
    return out, store


def _items(windows):
    stats = {"dropped_layers": 0}
    return [(i, tpoa._Work(w, 200, stats)) for i, w in enumerate(windows)
            if w.layer_count >= 2]


def _geometry(items, band=128):
    band, _, Lq, Lb = tpoa.bucket_geometry(
        band, max(len(w.backbone) for _, w in items))
    max_nm = max(int(np.max(w.lens + np.minimum(w.ends - w.begins + 65,
                                                Lb))) for _, w in items)
    steps, Lq2 = tpoa.sweep_geometry(Lq, max_nm,
                                     max(w.max_layer_len for _, w in items))
    return band, (Lq, Lb, steps, Lq2)


@pytest.mark.parametrize("Lq", [64, 300, 1024])
def test_gather_qpw_rows_matches_jax_and_host_gather(Lq):
    rng = np.random.default_rng(Lq)
    # weight << 3 | code values, as the pool holds them (below 2^11)
    pool = rng.integers(0, 1 << 11, 6 * Lq + 7).astype(np.uint16)
    B = 40
    lens = rng.integers(1, Lq, B)
    lens[:4] = (0, Lq, Lq + 5, 1)          # empty, exact, longer, one base
    src0 = rng.integers(0, pool.size - 2 * Lq, B)
    src0[0] = pool.size - 1
    lens[-6:] = 0                          # dead padding lanes
    src0[-6:] = 0
    got = tpoa.gather_qpw_rows(torch.from_numpy(pool.view(np.int16)),
                               torch.from_numpy(src0),
                               torch.from_numpy(lens), Lq)
    assert got.dtype == torch.int16 and got.shape == (B, Lq)
    got = got.numpy().view(np.uint16)
    want = np.asarray(jax_poa._gather_qpw_rows(
        pool, src0.astype(np.int32), lens.astype(np.int32), Lq=Lq))
    assert np.array_equal(got, want)
    store = LayerStore(None, None, pool, src0, lens, None, None, None, None,
                       None)
    assert np.array_equal(got, store.gather_qpw(np.arange(B), Lq))
    assert not got[-6:].any() and not got[0].any()
    assert np.array_equal(got[2], pool[src0[2]:src0[2] + Lq])


@pytest.mark.parametrize("stage", ["A", "B"])
def test_pack_group_device_rows_give_the_host_state(stage):
    rng = np.random.default_rng(7)
    windows, _ = _columnar(_mixed_windows(rng))
    items = _items(windows)
    _, (Lq, Lb, _, _) = _geometry(items)
    overrides = None
    if stage == "B":
        # fetched stage-A state for every other window: the repack keeps
        # its backbone, coverage and remapped spans
        overrides = {}
        for i, w in items[::2]:
            kw = w.n_layers
            overrides[i] = (rng.integers(0, 5, Lb).astype(np.uint8),
                            int(rng.integers(40, Lb)),
                            rng.integers(0, 9, Lb).astype(np.int32),
                            bool(i % 4), rng.integers(0, 50, kw),
                            rng.integers(50, 100, kw))
    host, B, nWp = tpoa.pack_group(items, Lq, Lb, overrides)
    dev, B2, nWp2 = tpoa.pack_group(items, Lq, Lb, overrides, allow_dev=CPU)
    assert (B, nWp) == (B2, nWp2)
    assert "qpw_rows" not in host and dev["qpw"] is None
    pool, src0, lens = dev.pop("qpw_rows")
    assert src0.dtype == lens.dtype == np.int64 and src0.shape == (B,)
    dev["qpw"] = tpoa.gather_qpw_rows(pool, torch.from_numpy(src0),
                                      torch.from_numpy(lens), Lq)
    want = refine_state_to_torch(host)
    got = refine_state_to_torch(dev)
    assert got["qpw"] is dev["qpw"]       # taken as it is, not copied
    for name in STATE_NAMES:
        assert torch.equal(got[name], want[name]), name


def test_engine_group_device_lanes_equal_host_lanes(monkeypatch):
    """One group dispatched from a store with its pool on the engine's
    device and from the same store without it: the same four static and
    ten state arrays after the rounds, the K1 shadow of the K4 group
    agreeing, and the counters of the device group only."""
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    monkeypatch.setenv("RACON_TPU_SANITIZE_SAMPLE", "1")
    rng = np.random.default_rng(11)
    src = _mixed_windows(rng, n_w=10)
    out = {}
    for leg, where in (("host", None), ("device", CPU)):
        metrics.clear("dataflow.")
        metrics.clear("consensus.")
        eng = tpoa.CudaPoaConsensus(3, -5, -4, rounds=3, device="cpu")
        items = _items(_columnar(src, where)[0])
        band, geom = _geometry(items, band=512)
        la = eng._dispatch_group(items, geom, band, 3, "full")
        out[leg] = (la, eng.stats, metrics.dataflow_summary(),
                    metrics.snapshot()["counters"])
    (la_h, st_h, df_h, c_h), (la_d, st_d, df_d, c_d) = out["host"], out[
        "device"]
    for a, b in zip(la_h["static"] + la_h["state"],
                    la_d["static"] + la_d["state"]):
        assert torch.equal(a, b)
    assert sanitize.enabled() and c_d["consensus.shadow_groups"] == 1
    assert st_h["lane_upload_saved_bytes"] == 0
    assert df_h["lanes_device_groups"] == df_h["bytes_avoided"] == 0
    saved = 2 * la_d["B"] * geom[0]
    assert st_d["lane_upload_saved_bytes"] == saved
    assert df_d["lanes_device_groups"] == 1
    assert df_d["bytes_avoided"] == saved


@pytest.mark.parametrize("ragged", [True, False])
def test_engine_runs_with_device_lanes_polish_the_same_bytes(monkeypatch,
                                                            ragged):
    """Whole engine runs, the ragged stream forced through stage-B
    repacks (as in tests/test_torch_consensus_stream.py) or the padded
    path: device lanes and host lanes give the same flags and bytes, and
    every device-lane group is counted."""
    monkeypatch.setattr(tpoa, "MAX_GROUP_WINDOWS", 4)
    monkeypatch.setattr(tpoa, "STAGE_B_MAX_SURVIVOR_FRAC", 1.0)
    src = _mixed_windows(np.random.default_rng(100), with_quality=False)
    res = {}
    for leg, where in (("host", None), ("device", CPU)):
        metrics.clear("dataflow.")
        windows, _ = _columnar(src, where)
        eng = tpoa.CudaPoaConsensus(
            3, -5, -4, fallback=NativePoaConsensus(3, -5, -4), band=128,
            rounds=4, use_ragged=ragged, device="cpu")
        flags = eng.run(windows, trim=True)
        res[leg] = (flags, [w.consensus for w in windows], eng.stats,
                    metrics.dataflow_summary())
    assert res["device"][:2] == res["host"][:2]
    stats, df = res["device"][2:]
    assert df["lanes_device_groups"] == stats["groups"] > 0
    assert stats["lane_upload_saved_bytes"] == df["bytes_avoided"] == sum(
        2 * g[3] * g[0] for g in stats["group_shapes"])
    if ragged:
        assert stats["stage_b_windows"] > 0
        assert "B" in {g[6] for g in stats["group_shapes"]}
    assert res["host"][3]["lanes_device_groups"] == 0


@pytest.mark.parametrize("case", ["other_device", "hand_built",
                                  "two_stores"])
def test_gate_sends_the_group_through_the_host_gather(case):
    rng = np.random.default_rng(5)
    src = [w for w in _mixed_windows(rng) if w.layer_count >= 2]
    if case == "other_device":
        windows, _ = _columnar(src, torch.device("meta"))
    elif case == "hand_built":
        windows = _columnar(src)[0][:-1] + _port_copy(src[-1:])
    else:
        half = len(src) // 2
        windows = _columnar(src[:half])[0] + _columnar(src[half:])[0]
    items = _items(windows)
    _, (Lq, Lb, _, _) = _geometry(items)
    state, _, _ = tpoa.pack_group(items, Lq, Lb, allow_dev=CPU)
    assert "qpw_rows" not in state
    want, _, _ = tpoa.pack_group(_items(_port_copy(src)), Lq, Lb)
    assert np.array_equal(state["qpw"], want["qpw"])
    metrics.clear("dataflow.")
    eng = tpoa.CudaPoaConsensus(3, -5, -4, device="cpu")
    eng._launch_group(items, Lq, Lb)
    assert eng.stats["lane_upload_saved_bytes"] == 0
    assert metrics.dataflow_summary()["lanes_device_groups"] == 0


def test_failing_lane_gather_makes_the_polish_raise(tmp_path, monkeypatch):
    from tests.test_columnar_init import write_synthetic_assembly
    reads, paf, draft = write_synthetic_assembly(tmp_path, seed=29)

    def broken(*args, **kwargs):
        raise RuntimeError("lane gather failed")

    monkeypatch.setattr(tpoa, "gather_qpw_rows", broken)
    monkeypatch.setenv("RACON_TPU_RESIDENT", "1")
    p = port_polisher.create_polisher(
        str(reads), str(paf), str(draft), num_threads=2, aligner="cuda",
        consensus="cuda", device="cpu")
    with pytest.raises(RuntimeError, match="lane gather failed"):
        p.run()


def test_shard_runner_releases_each_shards_pool(tmp_path, monkeypatch):
    from tests.test_columnar_init import write_synthetic_assembly
    reads, paf, draft = write_synthetic_assembly(tmp_path, seed=31,
                                                 n_contigs=3)
    monkeypatch.setenv("RACON_TPU_RESIDENT", "1")
    pools, alive = [], []
    upload0 = port_nw.upload_qpw_pool

    def upload(qpw_pool, device):
        gc.collect()
        alive.append(sum(ref() is not None for ref in pools))
        pool = upload0(qpw_pool, device)
        pools.append(weakref.ref(pool))
        return pool

    monkeypatch.setattr(port_nw, "upload_qpw_pool", upload)
    kw = dict(num_threads=2, aligner="cuda", consensus="cuda",
              device="cpu")
    runner = ShardRunner(str(reads), str(paf), str(draft), n_shards=3,
                         work_dir=str(tmp_path / "work"), **kw)
    buf = io.BytesIO()
    runner.run(buf)
    assert len(pools) == 3 and alive == [0, 0, 0]
    assert runner.get_engines(False)[1].stats["lane_upload_saved_bytes"] > 0
    single = port_polisher.create_polisher(str(reads), str(paf),
                                           str(draft), **kw)
    assert buf.getvalue() == b"".join(
        b">" + s.name + b"\n" + s.data + b"\n" for s in single.run())
