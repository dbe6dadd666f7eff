"""The port's streaming shard runner (``racon_tpu_torch.exec``) against the
JAX package's (``racon_tpu.exec``) on the CPU, and against the port's own
single-shot polish.

Held equal to the JAX package, exactly, with the same files passed to
both: the span scans and byte-range copies, the ``RunIndex`` arrays on
PAF, MHAP, SAM, gzipped and fragment-mode inputs (and a hand-made file
that exercises the filter replay's group rules), the shard plans in the
``shards``, ``max-ram`` and ``split`` modes, ``paf_bytes`` on rows of the
port's overlapper, and the merged FASTA of ``ShardRunner`` (host engines
on both sides) at 1 and 3 shards and in ``-f`` mode, with the key sets of
a manifest entry and of a report row.

Held within the port: with the device engines on ``device="cpu"`` a
2-shard run gives the single shot's bytes, and so does one whose first
attempt takes an injected device OOM (``reduce-capacity``: both engines
at half capacity); with ``-u`` a shard that keeps no overlap gives the
single shot's raw record; ``evict_reads`` releases the read payloads and
keeps the output.

Inputs: ``simulate(0.012, seed=5)`` cut into 5 contigs of 2.4 kbp with
reads of 0.7-1.3 kbp; the device-engine cases use ``simulate(0.005)`` in
2 contigs, since the kernels' plain versions take seconds a shard here.
"""

import gzip
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from racon_tpu.core.polisher import PolisherType as JaxPolisherType
from racon_tpu.exec import ShardRunner as JaxShardRunner
from racon_tpu.exec import build_index as jax_build_index
from racon_tpu.exec import plan_shards as jax_plan_shards
from racon_tpu.io import parsers as jax_parsers
from racon_tpu.ops import chain as jax_chain
from racon_tpu_torch import faults
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.exec import ShardRunner, build_index, plan_shards
from racon_tpu_torch.exec import manifest as mf
from racon_tpu_torch.io import parsers
from racon_tpu_torch.obs import report
from racon_tpu_torch.ops import chain
from racon_tpu_torch.utils.simulate import simulate
from tests.test_torch_parsers import paf_to_mhap, paf_to_sam
from tests.test_torch_polisher_bp import _fragment_paf


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # module scope: set before the module's fixtures polish anything (a
    # polish on every core slows ~20x under parallel test workers)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _write(d: pathlib.Path, blobs: dict) -> dict:
    out = {}
    for name, blob in blobs.items():
        out[name] = str(d / name)
        (d / name).write_bytes(blob)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.012, seed=5, mean_read=1000,
                                    max_read=1300, min_read=700,
                                    n_contigs=5)
    d = pathlib.Path(tmp_path_factory.mktemp("exec"))
    out = _write(d, {"reads.fastq": reads, "ovl.paf": paf,
                     "draft.fasta": draft})
    rd = {r.name: r.data for r in parsers.parse_fastq(out["reads.fastq"])}
    tg = {t.name: t.data for t in parsers.parse_fasta(out["draft.fasta"])}
    out.update(_write(d, {
        "reads.fastq.gz": gzip.compress(reads, 1),
        "ovl.paf.gz": gzip.compress(paf, 1),
        "draft.fasta.gz": gzip.compress(draft, 1),
        "ovl.mhap": paf_to_mhap(paf, list(rd), list(tg)),
        "ovl.sam": paf_to_sam(paf, rd, tg),
        "frag.paf": _fragment_paf(paf)}))
    return out


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.005, seed=5, mean_read=1000,
                                    max_read=1300, min_read=700,
                                    n_contigs=2)
    d = pathlib.Path(tmp_path_factory.mktemp("exec_small"))
    return _write(d, {"reads.fastq": reads, "ovl.paf": paf,
                      "draft.fasta": draft})


def fasta(polished) -> bytes:
    return b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                    for s in polished)


def port_sharded(triple, work_dir, **kw):
    kw.setdefault("num_threads", 2)
    runner = ShardRunner(*triple, work_dir=str(work_dir), **kw)
    buf = io.BytesIO()
    summary = runner.run(buf)
    return buf.getvalue(), summary, runner


def jax_sharded(triple, work_dir, **kw):
    kw.setdefault("num_threads", 2)
    runner = JaxShardRunner(*triple, work_dir=str(work_dir), **kw)
    buf = io.BytesIO()
    summary = runner.run(buf)
    return buf.getvalue(), summary


# ------------------------------------------------------------ span scans

@pytest.mark.parametrize("name", ["reads.fastq", "draft.fasta",
                                  "reads.fastq.gz", "draft.fasta.gz"])
def test_scan_spans_and_ranges_match_jax(files, name):
    path = files[name]
    spans = list(parsers.scan_sequence_spans(path))
    want = list(jax_parsers.scan_sequence_spans(path))
    assert [(s.name, s.start, s.end, s.bases, s.has_quality)
            for s in spans] == \
        [(s.name, s.start, s.end, s.bases, s.has_quality) for s in want]
    assert spans[0].start == 0
    assert all(a.end == b.start for a, b in zip(spans, spans[1:]))
    ranges = [(s.start, s.end) for s in spans[1::3]]
    got = io.BytesIO()
    assert parsers.copy_byte_ranges(path, ranges, got) == \
        sum(e - s for s, e in ranges)
    assert got.getvalue() == b"".join(
        jax_parsers.iter_byte_ranges(path, ranges))
    lines = list(parsers.scan_line_spans(path))
    assert lines == list(jax_parsers.scan_line_spans(path))


def test_scan_errors_name_the_byte_offset(tmp_path):
    bad = tmp_path / "bad.fasta"
    bad.write_bytes(b">a\nACGT\nGG\n>\nACGT\n")
    with pytest.raises(parsers.ParseError, match=r"\(byte 11\)"):
        list(parsers.scan_sequence_spans(str(bad)))
    with pytest.raises(ValueError, match="past EOF"):
        list(parsers.iter_byte_ranges(str(bad), [(0, 1000)]))


# ----------------------------------------------------------------- index

INDEX_CASES = {
    "paf": ("reads.fastq", "ovl.paf", "draft.fasta", "C"),
    "mhap": ("reads.fastq", "ovl.mhap", "draft.fasta", "C"),
    "sam": ("reads.fastq", "ovl.sam", "draft.fasta", "C"),
    "gzip": ("reads.fastq.gz", "ovl.paf.gz", "draft.fasta.gz", "C"),
    "fragment": ("reads.fastq", "frag.paf", "reads.fastq", "F"),
}


def _index_arrays(idx):
    return {"ov_start": idx.ov_start, "ov_end": idx.ov_end,
            "ov_target": idx.ov_target, "ov_read": idx.ov_read,
            "read_spans": idx.read_spans}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_index_matches_jax(files, case):
    *keys, mode = INDEX_CASES[case]
    triple = [files[k] for k in keys]
    idx = build_index(*triple, PolisherType[mode])
    ref = jax_build_index(*triple, JaxPolisherType[mode])
    for key, arr in _index_arrays(idx).items():
        np.testing.assert_array_equal(arr, _index_arrays(ref)[key],
                                      err_msg=key)
    assert idx.window_type.name == ref.window_type.name
    assert idx.overlap_fmt == ref.overlap_fmt
    assert idx.read_names == ref.read_names
    assert [(t.name, t.start, t.end, t.bases) for t in idx.targets] == \
        [(t.name, t.start, t.end, t.bases) for t in ref.targets]
    np.testing.assert_array_equal(idx.contig_read_bytes(),
                                  ref.contig_read_bytes())
    np.testing.assert_array_equal(idx.contig_overlap_bytes(),
                                  ref.contig_overlap_bytes())
    assert idx.ov_start.size > 0


def _paf(q, ql, qb, qe, t, tl, tb, te):
    return b"\t".join([q, b"%d" % ql, b"%d" % qb, b"%d" % qe, b"+", t,
                       b"%d" % tl, b"%d" % tb, b"%d" % te, b"50", b"100",
                       b"255"]) + b"\n"


def test_index_replays_the_group_filter_like_jax(tmp_path):
    """A query's groups split by another query's line stay two groups;
    the longer line of a group wins (the later one on a tie); an error
    above the threshold drops; an unresolvable line does not split a
    group; a read named like a target collapses onto it (its overlap to
    itself is a self overlap and drops)."""
    lp = tmp_path / "t.fasta"
    lp.write_bytes(b">A\n" + b"ACGT" * 300 + b"\n>B\n" + b"TGCA" * 300
                   + b"\n")
    rp = tmp_path / "r.fasta"
    rp.write_bytes(b">r1\n" + b"ACGT" * 250 + b"\n>r2\n" + b"ACGT" * 250
                   + b"\n>A\n" + b"ACGT" * 300 + b"\n")
    pp = tmp_path / "o.paf"
    pp.write_bytes(
        _paf(b"r1", 1000, 0, 100, b"A", 1200, 0, 100)
        + _paf(b"nosuch", 1000, 0, 900, b"A", 1200, 0, 900)
        + _paf(b"r1", 1000, 0, 400, b"A", 1200, 0, 400)
        + _paf(b"r1", 1000, 0, 400, b"A", 1200, 10, 410)
        + _paf(b"r2", 1000, 0, 300, b"A", 1200, 100, 400)
        + _paf(b"r1", 1000, 0, 200, b"B", 1200, 0, 200)
        + _paf(b"r2", 1000, 0, 50, b"B", 1200, 0, 500)
        + _paf(b"A", 1200, 0, 600, b"A", 1200, 0, 600)
        + _paf(b"A", 1200, 0, 600, b"B", 1200, 0, 600))
    for mode in ("C", "F"):
        idx = build_index(str(rp), str(pp), str(lp), PolisherType[mode])
        ref = jax_build_index(str(rp), str(pp), str(lp),
                              JaxPolisherType[mode])
        for key, arr in _index_arrays(idx).items():
            np.testing.assert_array_equal(arr, _index_arrays(ref)[key])
    idx = build_index(str(rp), str(pp), str(lp))
    kept = list(zip(idx.ov_read.tolist(), idx.ov_target.tolist()))
    assert kept == [(0, 0), (1, 0), (0, 1), (2, 1)]
    # r1's first group keeps its later 400-span line (the tie)
    assert idx.ov_start[0] == sum(
        len(ln) for ln in pp.read_bytes().splitlines(True)[:3])


def test_index_rejects_like_jax(tmp_path):
    lp = tmp_path / "t.fasta"
    lp.write_bytes(b">A\nACGT\n")
    rp = tmp_path / "r.fasta"
    rp.write_bytes(b">r1\nACGT\n")
    pp = tmp_path / "o.paf"
    pp.write_bytes(b"")
    for build in (build_index, jax_build_index):
        with pytest.raises(ValueError, match="empty overlap set"):
            build(str(rp), str(pp), str(lp))
    bad = tmp_path / "o.txt"
    bad.write_bytes(b"x\n")
    with pytest.raises(ValueError, match="unsupported format extension"):
        build_index(str(rp), str(bad), str(lp))


# ---------------------------------------------------------------- planner

@pytest.mark.parametrize("mode", ["shards", "max-ram", "split"])
def test_plan_matches_jax(files, mode, monkeypatch):
    # the budget floor (64 MiB) would fold these kilobytes into one shard
    from racon_tpu.exec import planner as jax_planner
    from racon_tpu_torch.exec import planner
    for mod in (planner, jax_planner):
        monkeypatch.setattr(mod, "_MIN_AVAIL", 1)
    triple = [files[k] for k in ("reads.fastq", "ovl.paf", "draft.fasta")]
    idx = build_index(*triple)
    ref_idx = jax_build_index(*triple)
    total = int((2 * np.fromiter((t.bases for t in idx.targets), np.int64)
                 + 3 * idx.contig_read_bytes()
                 + 2 * idx.contig_overlap_bytes()).sum())
    kw = {"shards": {"n_shards": 3},
          "max-ram": {"max_ram_bytes": (64 << 20) + total // 3,
                      "base_rss": 64 << 20},
          "split": {"max_target_bytes": 5000}}[mode]
    plan = plan_shards(idx, **kw)
    ref = jax_plan_shards(ref_idx, **kw)
    assert plan.mode == ref.mode == mode
    assert plan.shards == ref.shards and plan.n_shards > 1
    assert plan.costs == ref.costs
    assert (plan.budget_bytes, plan.avail_bytes) == \
        (ref.budget_bytes, ref.avail_bytes)
    assert plan.devices == ref.devices == []
    assert sorted(ci for s in plan.shards for ci in s) == list(range(5))


# --------------------------------------------------------------- paf_bytes

def test_paf_bytes_match_jax(files):
    reads = parsers.parse_fastq(files["reads.fastq"])
    targets = parsers.parse_fasta(files["draft.fasta"])
    rows = chain.find_overlaps([r.data for r in reads],
                               [t.data for t in targets],
                               np.full(len(reads), -1, np.int64),
                               device="cpu")
    args = ([r.name for r in reads],
            np.array([len(r.data) for r in reads], np.int64),
            [t.name for t in targets],
            np.array([len(t.data) for t in targets], np.int64))
    got = chain.paf_bytes(rows, *args, k=15)
    assert len(got) == rows["q_ord"].size > 0
    assert got == chain.paf_bytes_rowwise(rows, *args, k=15)
    assert got == jax_chain.paf_bytes(rows, *args, k=15)
    assert got == jax_chain.paf_bytes_rowwise(rows, *args, k=15)
    empty = {k: v[:0] for k, v in rows.items()}
    assert chain.paf_bytes(empty, *args, k=15) == []


# ------------------------------------------------------ the merged FASTA

RUN_CASES = {
    "one_shard": ({"n_shards": 1}, ("reads.fastq", "ovl.paf",
                                    "draft.fasta")),
    "three_shards": ({"n_shards": 3}, ("reads.fastq", "ovl.paf",
                                       "draft.fasta")),
    "fragment": ({"n_shards": 4, "include_unpolished": True},
                 ("reads.fastq", "frag.paf", "reads.fastq")),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_sharded_fasta_matches_jax_runner(files, tmp_path, case):
    kw, keys = RUN_CASES[case]
    triple = [files[k] for k in keys]
    port_kw = dict(kw, type_=PolisherType.F) if case == "fragment" else kw
    jax_kw = dict(kw, type_=JaxPolisherType.F) if case == "fragment" \
        else kw
    got, summary, _ = port_sharded(triple, tmp_path / "port",
                                   keep_work_dir=True, **port_kw)
    want, ref = jax_sharded(triple, tmp_path / "jax", keep_work_dir=True,
                            **jax_kw)
    assert got == want and got.startswith(b">")
    assert summary["n_shards"] == ref["n_shards"] == kw["n_shards"]
    assert not summary["quarantined"]
    # a manifest entry and a report row carry the JAX runner's keys
    for side in ("port", "jax"):
        assert mf.load_manifest(str(tmp_path / side)) is not None
    entries = [json.loads((tmp_path / s / "manifest.json").read_text())
               ["shards"][0] for s in ("port", "jax")]
    assert set(entries[0]) == set(entries[1])
    assert entries[0]["engine"] == "primary"
    reps = [json.loads((tmp_path / s / "run_report.json").read_text())
            for s in ("port", "jax")]
    assert report.validate_report(reps[0]) == []
    assert report.validate_report(reps[1]) == []
    assert reps[0]["kind"] == reps[1]["kind"] == "exec"
    assert [set(r) for r in reps[0]["shards"]] == \
        [set(r) for r in reps[1]["shards"]]
    assert reps[0]["devices"] == {}


def test_no_overlap_shard_with_u_matches_single_shot(files, tmp_path):
    """``-u``: a contig that keeps no overlap lands in a shard alone, and
    the runner writes the single shot's raw record for it."""
    targets = parsers.parse_fasta(files["draft.fasta"])
    victim = targets[1].name
    cut = tmp_path / "cut.paf"
    cut.write_bytes(b"".join(
        ln + b"\n" for _, _, ln in parsers.scan_line_spans(files["ovl.paf"])
        if ln.split(b"\t")[5] != victim))
    triple = (files["reads.fastq"], str(cut), files["draft.fasta"])
    want = fasta(create_polisher(*triple, num_threads=2).run(False))
    got, summary, _ = port_sharded(triple, tmp_path / "w", n_shards=5,
                                   include_unpolished=True)
    assert got == want
    assert b">" + victim + b" LN:i:%d RC:i:0" % len(targets[1].data) in got
    assert [e["timings"] for e in summary["shards"]
            if e["contigs"] == [1]] == [{}]


# ------------------------------------------- device engines on the CPU

@pytest.fixture(scope="module")
def small_single_shot(small):
    triple = (small["reads.fastq"], small["ovl.paf"], small["draft.fasta"])
    return triple, fasta(create_polisher(
        *triple, num_threads=2, aligner="cuda", consensus="cuda",
        device="cpu").run())


def test_device_engines_sharded_equals_single_shot(small_single_shot,
                                                   tmp_path):
    triple, want = small_single_shot
    got, summary, runner = port_sharded(
        triple, tmp_path / "w", n_shards=2, aligner="cuda",
        consensus="cuda", device="cpu")
    assert got == want
    assert [e["engine"] for e in summary["shards"]] == ["primary"] * 2
    # one engine pair served both shards
    aligner, consensus = runner.engines
    assert aligner.stats["chunks"] > 0 and consensus.stats["groups"] >= 2


def test_oom_backpressure_halves_both_engines_same_bytes(
        small_single_shot, tmp_path, monkeypatch):
    triple, want = small_single_shot
    monkeypatch.setenv("RACON_TPU_FAULTS", "exec.polish:oom@1")
    faults.reset()
    got, summary, runner = port_sharded(
        triple, tmp_path / "w", n_shards=2, aligner="cuda",
        consensus="cuda", device="cpu")
    assert got == want
    faulted = [e for e in summary["shards"] if e.get("attempts")]
    assert len(faulted) == 1
    (att,) = faulted[0]["attempts"]
    assert (att["class"], att["action"]) == ("device-oom",
                                             "reduce-capacity")
    assert all(e["engine"] == "primary" for e in summary["shards"])
    aligner, consensus = runner.engines
    assert aligner.capacity_scale == consensus.capacity_scale == 2
    assert aligner.dirs_budget_cap == aligner.max_dirs_bytes // 2
    assert consensus.group_pairs_cap == 32768 // 2
    assert summary["faults"]["backpressure_halvings"] == 2


def test_reduce_capacity_stops_at_the_floor(monkeypatch):
    from racon_tpu_torch.ops import poa
    from racon_tpu_torch.ops.nw import CudaAligner
    from racon_tpu_torch.ops.poa import (ARENA_LANES, MAX_GROUP_PAIRS,
                                         CudaPoaConsensus)
    aligner = CudaAligner(device="cpu")
    consensus = CudaPoaConsensus(3, -5, -4, device="cpu")
    chunk0 = aligner.chunk_dirs_budget()
    halvings = 0
    while aligner.reduce_capacity():
        assert consensus.reduce_capacity()
        halvings += 1
        assert aligner.chunk_dirs_budget() == chunk0 >> halvings
    assert halvings == 4 and not consensus.reduce_capacity()
    assert aligner.capacity_scale == consensus.capacity_scale == 16
    assert consensus.group_pairs_cap == max(2048, MAX_GROUP_PAIRS // 16)
    assert consensus.arena_lanes_cap == max(2048 * 1024,
                                            ARENA_LANES // 16)
    assert consensus.cap_pairs_for(256, 512) < 4 * MAX_GROUP_PAIRS
    # the floor never lifts a cap above the configured one (tests shrink
    # the groups to force dispatches)
    monkeypatch.setattr(poa, "MAX_GROUP_PAIRS", 16)
    assert CudaPoaConsensus(3, -5, -4, device="cpu").group_pairs_cap == 16
    assert consensus.group_pairs_cap == 16


# --------------------------------------------------------------- eviction

@pytest.mark.parametrize("threads", [1, 2])
def test_evict_reads_releases_payloads_and_keeps_output(files, threads):
    """``initialize()`` (one thread) and the pipelined ``run()`` (two):
    every read's payload is released once the layers are built, and the
    polished bytes do not change (the layer store holds its own copy)."""
    triple = (files["reads.fastq"], files["ovl.paf"], files["draft.fasta"])
    want = fasta(create_polisher(*triple, num_threads=threads).run())
    p = create_polisher(*triple, num_threads=threads, evict_reads=True)
    seen = []
    assemble = p._assemble_layers

    def spy(*a, **kw):
        assemble(*a, **kw)
        seen.append([(len(s.data), s.quality, s._reverse_complement)
                     for s in p.sequences[p.targets_size:]])
    p._assemble_layers = spy
    got = fasta(p.run())
    assert got == want
    assert seen and len(seen[0]) > 0
    assert all(r == (0, None, None) for r in seen[0])
