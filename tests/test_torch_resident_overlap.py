"""The resident dataflow's overlapper side (``RACON_TPU_RESIDENT``) and the
overlapper's flags, against the JAX package's, on the CPU.

- with the flag off, a port ``--overlaps auto`` polish reports the JAX
  auto polish's ``dataflow`` section: the device join's 8-byte count
  fetch, and on the second polish the target-table cache hit's avoided
  bytes;
- ``compact_selected`` == JAX ``_compact_kernel`` on all-false, all-true
  and seeded masks;
- ``build_seed_table(resident=True)`` == ``resident=False``, with the JAX
  resident build's ``dataflow`` counters;
- ``join_seeds(resident=True)``: ``q``/``t``/``rel`` are the host join's,
  ``tp_dev``/``qc_dev`` its ``tp``/``qc``, the counters JAX's;
- ``gather_pairs`` == JAX ``_gather_pairs_kernel`` == ``_pack_lanes``, and
  a device-source chain stream gives the host stream's rows;
- each ``RACON_TPU_OVERLAP_*`` flag the port reads changes
  ``find_overlaps``' rows and counters as it changes JAX's;
- a failing ``compact_selected`` or ``gather_pairs`` makes the resident
  auto polish raise.

Inputs: seeded numpy tables and masks, ``simulate(0.01, seed=5)`` with
0.7-1.3 kbp reads, ``tests/test_columnar_init.write_synthetic_assembly``.
"""

import pathlib

import numpy as np
import pytest
import torch

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.obs import metrics as jax_metrics
from racon_tpu.ops import chain as jax_chain
from racon_tpu.ops import overlap_seed as jax_seed
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.io import parsers
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.ops import chain as port_chain
from racon_tpu_torch.ops import overlap_seed as port_seed
from racon_tpu_torch.utils.simulate import simulate
from tests.test_columnar_init import write_synthetic_assembly
from tests.test_torch_chain import _rand_table

K = 15


@pytest.fixture(autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _fasta(seqs):
    return b"".join(b">" + s.name + b"\n" + s.data + b"\n" for s in seqs)


def test_auto_dataflow_counters_with_the_flag_off_equal_jax(tmp_path,
                                                           monkeypatch):
    """Two auto polishes a side on the host engines, the table cache
    cleared before the first: the dataflow sections after each equal."""
    monkeypatch.delenv("RACON_TPU_RESIDENT", raising=False)
    monkeypatch.setenv("RACON_TPU_WARMUP", "0")
    reads, _, draft = write_synthetic_assembly(tmp_path, seed=23)
    args = (str(reads), "auto", str(draft))
    seen = {}
    for side, make, mod in (
            ("jax", lambda: jax_polisher.create_polisher(
                *args, num_threads=2), jax_metrics),
            ("port", lambda: port_polisher.create_polisher(
                *args, num_threads=2, aligner="native",
                consensus="native", device="cpu"), metrics)):
        jax_seed.clear_table_cache()
        port_seed.clear_table_cache()
        mod.clear_run()
        first = _fasta(make().run())
        df1 = mod.dataflow_summary()
        mod.clear_run()
        second = _fasta(make().run())
        seen[side] = (first, second, df1, mod.dataflow_summary())
    assert seen["port"] == seen["jax"]
    first, second, df1, df2 = seen["port"]
    assert first == second and first.startswith(b">")
    assert df1["bytes_fetched"] == df2["bytes_fetched"] == 8
    assert df1["bytes_avoided"] == 0 < df2["bytes_avoided"]
    assert df2["resident"] == 0


def _masks(rng, B, P):
    return {"all_false": np.zeros((B, P), bool),
            "all_true": np.ones((B, P), bool),
            "seeded": rng.random((B, P)) < 0.3}


@pytest.mark.parametrize("mask", ["all_false", "all_true", "seeded"])
def test_compact_selected_matches_jax(mask):
    rng = np.random.default_rng(41)
    B, P = 6, 50
    h = rng.integers(0, 1 << 32, (B, P), dtype=np.uint64).astype(np.uint32)
    strand = rng.random((B, P)) < 0.5
    sel = _masks(rng, B, P)[mask]
    want = jax_seed._compact_kernel(h, strand, sel)
    got = port_seed.compact_selected(
        torch.from_numpy(h.view(np.int32)), torch.from_numpy(strand),
        torch.from_numpy(sel))
    n = int(want[4])
    assert int(got[4]) == n == int(sel.sum())
    assert got[0].dtype == torch.int32 and got[3].dtype == torch.bool
    assert got[1].dtype == got[2].dtype == torch.int32
    outs = [got[0].numpy().view(np.uint32)] + [g.numpy() for g in got[1:4]]
    for g, w in zip(outs, want[:4]):
        assert g.shape == (B * P,)
        assert np.array_equal(g, np.asarray(w)[:B * P])
    rows, cols = np.nonzero(sel)
    assert np.array_equal(outs[1][:n], rows)
    assert np.array_equal(outs[2][:n], cols)
    assert np.array_equal(outs[0][:n], h[rows, cols])


def _seqs(rng):
    """Sequences of several length buckets: short, window-sized, a few
    kbp, one with ambiguous bases, one too short for a window."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = [bases[rng.integers(0, 4, n)].tobytes()
           for n in (30, 90, 700, 1300, 2600, 5000)]
    amb = bytearray(bases[rng.integers(0, 4, 900)].tobytes())
    amb[100:140] = b"N" * 40
    return out + [bytes(amb), b"ACGTA"]


@pytest.mark.parametrize("k,w", [(15, 5), (11, 9)])
def test_resident_seed_table_equals_the_host_table(k, w):
    seqs = _seqs(np.random.default_rng(k))
    metrics.clear("dataflow.")
    host = port_seed.build_seed_table(seqs, k=k, w=w, device="cpu")
    assert set(metrics.dataflow_summary().values()) == {0}
    res = port_seed.build_seed_table(seqs, k=k, w=w, resident=True,
                                     device="cpu")
    got = metrics.dataflow_summary()
    jax_metrics.clear("dataflow.")
    want = jax_seed.build_seed_table(seqs, k=k, w=w, resident=True)
    for a, b, c in zip(res, host, want):
        assert a.dtype == b.dtype == np.asarray(c).dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert host[0].size > 100
    assert got == jax_metrics.dataflow_summary()
    assert got["bytes_fetched"] > 0 and got["bytes_avoided"] > 0


def test_resident_join_keeps_the_seed_coordinates_on_the_device():
    rng = np.random.default_rng(43)
    for trial in range(4):
        n_reads = int(rng.integers(2, 10))
        n_targets = int(rng.integers(1, 6))
        space = int(rng.integers(20, 300))
        base = (1 << 31) - space // 2 if trial % 2 else 0
        rt = _rand_table(rng, n_reads, 400, space, base)
        tt = _rand_table(rng, n_targets, 400, space, base)
        self_t = np.where(rng.random(n_reads) < 0.3,
                          rng.integers(0, n_targets, n_reads),
                          -1).astype(np.int64)
        qlens = rng.integers(4100, 6000, n_reads).astype(np.int64)
        kw = dict(k=K, max_occ=int(rng.integers(4, 40)))
        host, capped_h = port_chain.join_seeds(rt, tt, self_t, qlens,
                                               device="cpu", **kw)
        metrics.clear("dataflow.")
        res, capped_r = port_chain.join_seeds(rt, tt, self_t, qlens,
                                              resident=True, device="cpu",
                                              **kw)
        got = metrics.dataflow_summary()
        jax_metrics.clear("dataflow.")
        jax_chain.join_seeds(rt, tt, self_t, qlens, resident=True, **kw)
        assert capped_r == capped_h
        assert set(res) == {"q", "t", "rel", "tp_dev", "qc_dev"}
        for key in ("q", "t", "rel"):
            assert np.array_equal(res[key], host[key]), (trial, key)
        for key in ("tp", "qc"):
            dev = res[key + "_dev"]
            assert dev.dtype == torch.int32
            assert np.array_equal(dev.numpy(), host[key]), (trial, key)
        n = host["q"].size
        assert n > 0
        assert got == jax_metrics.dataflow_summary()
        assert got["bytes_fetched"] == 8 + 12 * n + 4
        assert got["bytes_avoided"] == 8 * n


@pytest.mark.parametrize("S", [16, 64])
def test_gather_pairs_matches_jax_and_the_host_pack(S):
    rng = np.random.default_rng(S)
    n_hits = 500
    tp = rng.integers(0, 1 << 20, n_hits).astype(np.int32)
    qc = rng.integers(0, 1 << 20, n_hits).astype(np.int32)
    B = 16
    counts = rng.integers(1, S + 1, B)
    counts[:2] = (S, 1)
    starts = rng.integers(0, n_hits - S, B)
    starts[2] = n_hits - 3                 # a lane at the end of the hits
    counts[2] = 3
    counts[-4:] = 0                        # dead lanes past the live ones
    starts[-4:] = 0
    ts, qs = port_chain.gather_pairs(
        torch.from_numpy(tp), torch.from_numpy(qc), torch.from_numpy(starts),
        torch.from_numpy(counts.astype(np.int32)), S)
    assert ts.dtype == qs.dtype == torch.int32 and ts.shape == (B, S)
    want = jax_chain._gather_pairs_kernel(
        tp, qc, starts.astype(np.int32), counts.astype(np.int32), S=S)
    host = port_chain._pack_lanes(tp.astype(np.int64), qc.astype(np.int64),
                                  starts, counts, S, B)
    for got, w, h in zip((ts, qs), want, host):
        assert np.array_equal(got.numpy(), np.asarray(w))
        assert np.array_equal(got.numpy(), h)


def test_device_source_chain_stream_gives_the_host_rows(monkeypatch):
    rng = np.random.default_rng(34)
    target = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000).tobytes()
    reads = [target[i * 400:i * 400 + 1500] for i in range(8)]
    rt = port_seed.build_seed_table(reads, device="cpu")
    tt = port_seed.build_seed_table([target], device="cpu")
    self_t = np.full(len(reads), -1, np.int64)
    qlens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
    hits, _ = port_chain.join_seeds(rt, tt, self_t, qlens, k=K, max_occ=64,
                                    resident=True, device="cpu")
    starts, _, counts = port_chain._pair_runs(hits)
    host_tp = hits["tp_dev"].numpy().astype(np.int64)
    host_qc = hits["qc_dev"].numpy().astype(np.int64)
    # arenas small enough that chunks are fetched while others fly
    monkeypatch.setattr(port_chain, "CHAIN_ARENA_CELLS", 256)
    rows = {}
    for src in ("host", "device"):
        dev = src == "device"
        st = port_chain._ChainStream(
            k=K, tp=hits["tp_dev"] if dev else host_tp,
            qc=hits["qc_dev"] if dev else host_qc, device_src=dev,
            device="cpu")
        for p in range(starts.size):
            st.add(p, int(starts[p]), int(counts[p]))
            st.pump()
        rows[src] = st.finish()
    assert len(rows["host"]) == starts.size >= 8
    for pid, row in rows["host"].items():
        assert rows["device"][pid].tolist() == row.tolist()


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    reads, _, draft, _ = simulate(0.01, seed=5, coverage=30,
                                  mean_read=1000, max_read=1300,
                                  min_read=700)
    d = pathlib.Path(tmp_path_factory.mktemp("flags"))
    (d / "r.fastq").write_bytes(reads)
    (d / "d.fasta").write_bytes(draft)
    return ([r.data for r in parsers.parse_fastq(str(d / "r.fastq"))],
            [r.data for r in parsers.parse_fasta(str(d / "d.fasta"))])


def _counters(mod):
    over = {k: v for k, v in mod.overlap_summary().items()
            if not k.endswith("_s")}
    return over, mod.dataflow_summary()


FLAGS = {"RACON_TPU_OVERLAP_K": "13", "RACON_TPU_OVERLAP_W": "8",
         "RACON_TPU_OVERLAP_MAX_OCC": "6",
         "RACON_TPU_OVERLAP_MIN_SEEDS": "12",
         "RACON_TPU_OVERLAP_DEVICE_JOIN": "0",
         "RACON_TPU_OVERLAP_CACHE": "0"}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_overlap_flag_has_the_jax_effect(genome, monkeypatch, name):
    """The flag at a value off its default: the port's rows and counters
    equal JAX's, and differ from the port's at the default (rows, or for
    the join and cache switches the counters). Two calls a side, so the
    second can take the target table from the cache."""
    reads, draft = genome
    self_t = np.full(len(reads), -1, np.int64)
    monkeypatch.delenv("RACON_TPU_RESIDENT", raising=False)

    def run(mod, find, clear_cache):
        clear_cache()
        mod.clear_run()
        rows = [find(reads, draft, self_t) for _ in range(2)]
        assert all(np.array_equal(rows[0][k], rows[1][k]) for k in rows[0])
        return rows[0], _counters(mod)

    port = lambda *a: port_chain.find_overlaps(*a, device="cpu")
    default = run(metrics, port, port_seed.clear_table_cache)
    monkeypatch.setenv(name, FLAGS[name])
    got = run(metrics, port, port_seed.clear_table_cache)
    want = run(jax_metrics, jax_chain.find_overlaps,
               jax_seed.clear_table_cache)
    for key in want[0]:
        assert np.array_equal(got[0][key], want[0][key]), key
    assert got[1] == want[1]
    same_rows = all(np.array_equal(got[0][k], default[0][k])
                    for k in got[0])
    if name in ("RACON_TPU_OVERLAP_DEVICE_JOIN", "RACON_TPU_OVERLAP_CACHE"):
        assert same_rows and got[1] != default[1]
    else:
        assert not same_rows
    assert got[0]["q_ord"].size > 0


@pytest.mark.parametrize("broken", ["compact_selected", "gather_pairs"])
def test_failing_device_step_makes_the_auto_polish_raise(tmp_path,
                                                         monkeypatch,
                                                         broken):
    reads, _, draft = write_synthetic_assembly(tmp_path, seed=29)
    module = port_seed if broken == "compact_selected" else port_chain

    def fail(*args, **kwargs):
        raise RuntimeError(f"{broken} failed")

    monkeypatch.setattr(module, broken, fail)
    monkeypatch.setenv("RACON_TPU_RESIDENT", "1")
    port_seed.clear_table_cache()
    p = port_polisher.create_polisher(
        str(reads), "auto", str(draft), num_threads=2, aligner="cuda",
        consensus="cuda", device="cpu")
    with pytest.raises(RuntimeError, match=f"{broken} failed"):
        p.run()
