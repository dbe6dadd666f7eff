"""The port's seed join and chain DP (``racon_tpu_torch/ops/chain.py``)
against the JAX package's (``racon_tpu/ops/chain.py``), on the CPU.

- ``chain_dp`` on CPU tensors (its plain version, ``chain_dp_plain``)
  against the JAX ``_chain_kernel`` and ``chain_np`` on arenas with dead
  lanes, full lanes (``ns = S``), a tie between two predecessors, gaps
  over ``MAX_GAP`` and drift over ``BAND_DIAG``, at S of 16 and 64;
- ``join_seeds`` on its device path (CPU tensors) against JAX
  ``join_seeds`` and ``match_seeds``: hits and the capped count, with hot
  buckets, self hits and hashes on both sides of 2^31, and no bail-out;
  the empty-side bail-out, counted;
- ``_ChainStream``: the same rows however it is fed, with arenas small
  enough that chunks are fetched while others are in flight, equal to the
  JAX stream's rows;
- ``find_overlaps`` and the concatenated ``iter_overlap_groups`` give the
  JAX ``find_overlaps`` rows on ``simulate(0.02, seed=11)``, with and
  without self hits, the second call's target table from the cache;
- the overlapper's defaults are the JAX flags' defaults, and the paths it
  takes with no switch are the ones those flags choose by default.
"""

import pathlib

import numpy as np
import pytest
import torch

from racon_tpu import flags
from racon_tpu.ops import chain as jax_chain
from racon_tpu_torch.io import parsers
from racon_tpu_torch.ops import chain as port_chain
from racon_tpu_torch.ops import overlap_seed as port_seed
from racon_tpu_torch.utils.simulate import simulate

K = 15


def _arena(rng, S, B):
    ts = np.zeros((B, S), np.int32)
    qs = np.zeros((B, S), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 6
        if kind == 0:
            continue                       # a dead lane
        n = S if kind == 1 else int(rng.integers(2, S + 1))
        step = {2: 12_000, 3: 300}.get(kind, 150)   # gaps over MAX_GAP
        t = np.sort(rng.integers(0, step * n, n))
        q = t + rng.integers(-60, 60, n)
        if kind == 3:
            q = q + (np.arange(n) % 3) * 700     # drift over BAND_DIAG
        ts[b, :n] = t
        qs[b, :n] = np.clip(q, 0, None)
        ns[b] = n
    # two equal candidates: A (0, 10) and B (10, 0) both start chains, and
    # C (100, 100) scores 240 + 240 - 10 from either; the nearer (B) wins
    ts[B - 1, :3], qs[B - 1, :3], ns[B - 1] = (0, 10, 100), (10, 0, 100), 3
    return ts, qs, ns


@pytest.mark.parametrize("S", [16, 64])
def test_chain_dp_plain_matches_jax_kernel_and_oracle(S):
    rng = np.random.default_rng(S)
    B = 24
    ts, qs, ns = _arena(rng, S, B)
    want = np.asarray(jax_chain._chain_kernel(ts, qs, ns, S=S, k=K))
    got = port_chain.chain_dp(torch.from_numpy(ts), torch.from_numpy(qs),
                              torch.from_numpy(ns), k=K)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    assert np.array_equal(got.numpy(), want)
    for b in range(B):
        n = int(ns[b])
        if n:
            assert tuple(got[b].tolist()) == jax_chain.chain_np(
                ts[b, :n], qs[b, :n], K)
        else:
            assert got[b].tolist() == [port_chain._NEG, 0, 0, qs[b, 0], 0,
                                       ts[b, 0]]
    # the tie went to the nearer predecessor
    assert got[B - 1].tolist() == [470, 2, 0, 100, 10, 100]
    # the lanes cover chains of one seed and long ones
    assert got[:, 1].min() == 0 and got[:, 1].max() > 8


def _rand_table(rng, n_seqs, n_entries, hash_space, base=0):
    """A minimizer table over a tiny hash space (dense collisions),
    deduplicated on (seq, pos) as build_seed_table's is."""
    sid = rng.integers(0, n_seqs, n_entries).astype(np.int32)
    pos = rng.integers(0, 4000, n_entries).astype(np.int32)
    order = np.lexsort((pos, sid))
    sid, pos = sid[order], pos[order]
    keep = np.ones(sid.size, bool)
    keep[1:] = (sid[1:] != sid[:-1]) | (pos[1:] != pos[:-1])
    sid, pos = sid[keep], pos[keep]
    h = (base + rng.integers(0, hash_space, sid.size)).astype(np.uint32)
    strand = rng.integers(0, 2, sid.size).astype(bool)
    return h, sid, pos, strand


def test_join_seeds_matches_jax_join_and_oracle():
    rng = np.random.default_rng(31)
    port_chain.reset_stats()
    for trial in range(8):
        n_reads = int(rng.integers(2, 10))
        n_targets = int(rng.integers(1, 6))
        space = int(rng.integers(20, 300))
        max_occ = int(rng.integers(2, 40))
        # odd trials straddle 2^31, where int32 hashes would sort first
        base = (1 << 31) - space // 2 if trial % 2 else 0
        rt = _rand_table(rng, n_reads, int(rng.integers(50, 600)), space,
                         base)
        tt = _rand_table(rng, n_targets, int(rng.integers(50, 600)),
                         space, base)
        self_t = np.where(rng.random(n_reads) < 0.3,
                          rng.integers(0, n_targets, n_reads),
                          -1).astype(np.int64)
        qlens = rng.integers(4100, 6000, n_reads).astype(np.int64)
        want, capped_w = jax_chain.match_seeds(rt, tt, self_t, qlens, k=K,
                                               max_occ=max_occ)
        jax_hits, capped_j = jax_chain.join_seeds(
            rt, tt, self_t, qlens, k=K, max_occ=max_occ, device_join=True)
        got, capped_g = port_chain.join_seeds(
            rt, tt, self_t, qlens, k=K, max_occ=max_occ, device="cpu")
        assert capped_g == capped_w == capped_j, trial
        for key in ("q", "t", "rel", "tp", "qc"):
            assert got[key].dtype == np.int64
            assert np.array_equal(got[key], want[key]), (trial, key)
            assert np.array_equal(got[key], np.asarray(jax_hits[key],
                                                       np.int64))
        oracle, capped_o = port_chain.match_seeds(
            rt, tt, self_t, qlens, k=K, max_occ=max_occ)
        assert capped_o == capped_w
        for key in want:
            assert np.array_equal(oracle[key], want[key])
    assert port_chain.STATS["join_bailouts"] == 0
    assert port_chain.STATS["freq_capped_buckets"] == 0  # join alone


def test_join_seeds_empty_side_bails_out_counted():
    rng = np.random.default_rng(33)
    rt = _rand_table(rng, 4, 200, 100)
    empty = (np.zeros(0, np.uint32), np.zeros(0, np.int32),
             np.zeros(0, np.int32), np.zeros(0, bool))
    port_chain.reset_stats()
    for a, b in ((rt, empty), (empty, rt)):
        hits, capped = port_chain.join_seeds(
            a, b, np.full(4, -1, np.int64), np.full(4, 5000, np.int64),
            k=K, max_occ=64, device="cpu")
        assert hits["q"].size == 0 and capped == 0
    assert port_chain.STATS["join_bailouts"] == 2


def _revcomp(s):
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def test_chain_stream_rows_do_not_depend_on_feeding(monkeypatch):
    rng = np.random.default_rng(34)
    target = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000).tobytes()
    reads = [target[i * 400:i * 400 + 1500] for i in range(8)]
    reads += [_revcomp(target[2000:3500]), target[100:400]]
    rt = port_seed.build_seed_table(reads, device="cpu")
    tt = port_seed.build_seed_table([target], device="cpu")
    self_t = np.full(len(reads), -1, np.int64)
    qlens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
    hits, _ = port_chain.match_seeds(rt, tt, self_t, qlens, k=K,
                                     max_occ=64)
    starts, _, counts = port_chain._pair_runs(hits)
    jobs = [(p, int(starts[p]), int(counts[p])) for p in range(starts.size)]
    assert len(jobs) >= 9 and len({port_chain._seed_bucket(c)
                                   for _, _, c in jobs}) >= 2

    ref = jax_chain._ChainStream(k=K, tp=hits["tp"], qc=hits["qc"])
    for pid, s0, c in jobs:
        ref.add(pid, s0, c)
    want = ref.finish()
    # arenas of one lane at S = 512 and two at S = 128: a chunk is fetched
    # while the next is in flight
    monkeypatch.setattr(port_chain, "CHAIN_ARENA_CELLS", 256)
    for split in (len(jobs), 1, 3):
        seen = []
        st = port_chain._ChainStream(
            k=K, tp=hits["tp"], qc=hits["qc"], device="cpu",
            on_row=lambda pid, row: seen.append(pid))
        for i, (pid, s0, c) in enumerate(jobs):
            st.add(pid, s0, c)
            if (i + 1) % split == 0:
                st.pump()
        got = st.finish()
        assert sorted(seen) == sorted(got) == sorted(want)
        for pid in want:
            assert got[pid].tolist() == np.asarray(want[pid]).tolist()


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    reads, _, draft, _ = simulate(0.02, seed=11)
    d = pathlib.Path(tmp_path_factory.mktemp("ovl"))
    (d / "r.fastq").write_bytes(reads)
    (d / "d.fasta").write_bytes(draft)
    return ([r.data for r in parsers.parse_fastq(str(d / "r.fastq"))],
            [r.data for r in parsers.parse_fasta(str(d / "d.fasta"))])


@pytest.mark.parametrize("self_hits", [False, True])
def test_find_overlaps_matches_jax(genome, self_hits):
    reads, draft = genome
    targets = draft
    self_t = np.full(len(reads), -1, np.int64)
    if self_hits:
        # the first 20 reads are targets too: their hits on themselves drop
        targets = draft + reads[:20]
        self_t[:20] = np.arange(len(draft), len(draft) + 20)
    want = jax_chain.find_overlaps(reads, targets, self_t)
    assert want["q_ord"].size > 80
    port_seed.clear_table_cache()
    port_chain.reset_stats()
    groups = list(port_chain.iter_overlap_groups(reads, targets, self_t,
                                                 device="cpu"))
    stats = dict(port_chain.STATS)
    legs = {"groups": {key: np.concatenate([g[key] for g in groups])
                       for key in want},
            "find": port_chain.find_overlaps(reads, targets, self_t,
                                             device="cpu")}
    for leg, rows in legs.items():
        for key in want:
            assert np.array_equal(rows[key], want[key]), (leg, key)
    assert len(groups) == np.unique(want["q_ord"]).size
    assert stats["chains_kept"] == want["q_ord"].size
    assert stats["stream_groups"] >= len(groups)
    assert stats["join_bailouts"] == 0 and stats["chunks"] > 0
    assert stats["lanes_occupied"] <= stats["lanes_total"]
    # the second call took the target table from the cache
    assert port_chain.STATS["cache_hits"] == 1
    if self_hits:
        q = want["q_ord"]
        assert not (want["t_idx"][q < 20] == self_t[q[q < 20]]).any()


def test_defaults_are_the_jax_flag_defaults():
    def default(name):
        return int(flags.REGISTRY[name].default)

    assert port_seed.DEFAULT_K == default("RACON_TPU_OVERLAP_K")
    assert port_seed.DEFAULT_W == default("RACON_TPU_OVERLAP_W")
    assert port_chain.DEFAULT_MAX_OCC == default("RACON_TPU_OVERLAP_MAX_OCC")
    assert port_chain.DEFAULT_MIN_SEEDS == default(
        "RACON_TPU_OVERLAP_MIN_SEEDS")
    kw = port_chain.find_overlaps.__kwdefaults__
    assert kw == port_chain.iter_overlap_groups.__kwdefaults__
    assert kw == {"k": 15, "w": 5, "max_occ": 64, "min_seeds": 4,
                  "device": "cuda"}
    # the port has no switch for these: it always takes the device join,
    # the ragged chain stream and the target-table cache
    for name in ("RACON_TPU_OVERLAP_DEVICE_JOIN", "RACON_TPU_OVERLAP_RAGGED",
                 "RACON_TPU_OVERLAP_CACHE"):
        assert default(name) == 1, name
    for name in ("CHAIN_LOOKBACK", "MAX_GAP", "BAND_DIAG", "GAP_UNIT",
                 "_NEG", "CHAIN_ARENA_CELLS", "JOIN_TABLE_CELLS",
                 "JOIN_MAX_HITS", "CHAIN_INFLIGHT"):
        assert getattr(port_chain, name) == getattr(jax_chain, name), name
    for name in ("SEED_ARENA_CELLS", "SEED_SLICE", "_HASH_MAX"):
        assert getattr(port_seed, name) == getattr(
            jax_chain.overlap_seed, name), name
