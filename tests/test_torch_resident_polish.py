"""The port's ``Polisher`` with the resident dataflow
(``RACON_TPU_RESIDENT=1``) against its host path and against the JAX
resident polish, on the CPU, with both device engines (``aligner="cuda",
consensus="cuda", device="cpu"``: the plain kernel versions).

- resident == host FASTA bytes at the default settings, in fragment mode
  (``-f``), with FASTA reads (no qualities) and at a high ``-q`` that drops
  rows on the mean-PHRED filter, with the ``dataflow.resident`` gauge at 1
  and no bail-out, and every consensus group's lanes gathered on the
  device (``lanes_device_groups`` = the engine's groups; the host path
  counts none);
- the default case also equals the JAX package's resident polish (its
  device engines without a mesh), with the full ``dataflow`` counters
  equal to JAX's, ``lanes_device_groups`` and the consensus share of
  ``bytes_avoided`` included, and ``lane_upload_saved_s`` in the timings;
- so do resident ``--overlaps auto`` polishes, in contig and ``-f`` mode:
  bytes and full counters, the overlapper's device compaction and chain
  arena gather included;
- the two precondition bail-outs (a fractional ``-q``, quality bytes below
  33) polish the host path's bytes with one bail-out counted;
- with the flag off the run report's ``dataflow`` section is all zeros,
  with the JAX report's keys;
- no fallback hides the device: a failing table finalize raises.

Inputs: ``tests/test_columnar_init.write_synthetic_assembly`` (two 3 kbp
contigs, 900 bp reads on both strands), with seeded per-read quality
levels of 10-30 in place of its constant ones.
"""

import pathlib

import numpy as np
import pytest
import torch

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.core.backends import NativeAligner as JaxNativeAligner
from racon_tpu.core.backends import NativePoaConsensus as JaxNativePoa
from racon_tpu.obs import metrics as jax_metrics
from racon_tpu.obs import report as jax_report
from racon_tpu.ops import overlap_seed as jax_seed
from racon_tpu.ops.nw import TpuAligner
from racon_tpu.ops.poa import TpuPoaConsensus
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.obs import metrics, report
from racon_tpu_torch.ops import nw as port_nw
from racon_tpu_torch.ops import overlap_seed as port_seed
from tests.test_columnar_init import write_synthetic_assembly


@pytest.fixture(autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _requalify(fastq: bytes, rng, sub33: bool = False) -> bytes:
    """The FASTQ with each read's qualities drawn around its own level
    (10-30); with ``sub33`` one read also carries bytes below '!'."""
    lines = fastq.split(b"\n")
    for k in range(3, len(lines), 4):
        n = len(lines[k])
        q = np.clip(rng.normal(rng.integers(10, 31), 3, n), 0, 60)
        qual = (q.astype(np.uint8) + 33)
        if sub33 and k == 3:
            qual[::7] = 30
        lines[k] = qual.tobytes()
    return b"\n".join(lines)


def _fasta_reads(fastq: bytes) -> bytes:
    lines = fastq.split(b"\n")
    return b"".join(b">" + lines[i][1:] + b"\n" + lines[i + 1] + b"\n"
                    for i in range(0, len(lines) - 3, 4))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("resident")
    reads, paf, draft = write_synthetic_assembly(d, seed=23, n_contigs=2)
    raw = pathlib.Path(reads).read_bytes()
    paths = {"paf": str(paf), "draft": str(draft)}
    for key, blob in (
            ("fastq", _requalify(raw, np.random.default_rng(1))),
            ("sub33", _requalify(raw, np.random.default_rng(1), True)),
            ("fasta", _fasta_reads(raw))):
        path = d / f"{key}.{'fasta' if key == 'fasta' else 'fastq'}"
        path.write_bytes(blob)
        paths[key] = str(path)
    return paths


def _fasta(seqs):
    return b"".join(b">" + s.name + b"\n" + s.data + b"\n" for s in seqs)


def _port(monkeypatch, inputs, resident, reads="fastq", mode="C", q=10.0,
          overlaps="paf"):
    """One port polish with both device engines on the CPU: (bytes,
    timings, dataflow summary, the run report, the consensus engine's
    groups)."""
    if resident:
        monkeypatch.setenv("RACON_TPU_RESIDENT", "1")
    else:
        monkeypatch.delenv("RACON_TPU_RESIDENT", raising=False)
    metrics.clear_run()
    port_seed.clear_table_cache()
    # -f on the overlapper: the reads are their own targets
    auto_f = overlaps == "auto" and mode == "F"
    target = inputs[reads] if auto_f else inputs["draft"]
    p = port_polisher.create_polisher(
        inputs[reads], inputs[overlaps] if overlaps == "paf" else overlaps,
        target, type_=port_polisher.PolisherType[mode],
        quality_threshold=q, num_threads=2, aligner="cuda",
        consensus="cuda", device="cpu")
    out = _fasta(p.run())
    assert out.startswith(b">")
    return (out, dict(p.timings), metrics.dataflow_summary(),
            report.build_report("cli"), p.consensus.stats["groups"])


CASES = {"default": {}, "fragment": {"mode": "F"},
         "fasta_reads": {"reads": "fasta"}, "high_q": {"q": 20.0}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resident_polish_equals_host(inputs, monkeypatch, case):
    want, host_tm, host_df, host_rep, _ = _port(monkeypatch, inputs,
                                                False, **CASES[case])
    assert set(host_df.values()) == {0}
    assert "window_derive_s" not in host_tm
    got, tm, df, rep, groups = _port(monkeypatch, inputs, True,
                                     **CASES[case])
    assert got == want
    assert df["resident"] == 1 and df["resident_bailouts"] == 0
    assert df["bytes_fetched"] > 0 and df["bytes_avoided"] > 0
    assert rep["dataflow"] == df
    assert "window_derive_s" in tm and "layer_store_s" in tm
    # every group's lanes came from the pool on the device
    assert df["lanes_device_groups"] == groups > 0
    assert tm["lane_upload_saved_s"] > 0 and "lane_upload_saved_s" \
        not in host_tm
    if case == "default":
        # the flag off: all zeros, under the JAX report's keys
        assert set(host_rep["dataflow"].values()) == {0}
        assert set(host_rep["dataflow"]) == set(
            jax_report.build_report("cli")["dataflow"])
    if case == "high_q":
        # the threshold drops layers: the bytes differ from -q 10's
        assert got != _port(monkeypatch, inputs, True)[0]


def _jax_resident(monkeypatch, inputs, overlaps="paf", mode="C"):
    """The JAX resident polish on its device engines without a mesh:
    (bytes, dataflow summary, its consensus engine's stats)."""
    monkeypatch.setenv("RACON_TPU_RESIDENT", "1")
    monkeypatch.setenv("RACON_TPU_WARMUP", "0")
    jax_metrics.clear_run()
    jax_seed.clear_table_cache()
    consensus = TpuPoaConsensus(
        3, -5, -4, fallback=JaxNativePoa(3, -5, -4, 2), mesh=None)
    auto_f = overlaps == "auto" and mode == "F"
    ref = jax_polisher.create_polisher(
        inputs["fastq"], inputs["paf"] if overlaps == "paf" else overlaps,
        inputs["fastq"] if auto_f else inputs["draft"],
        type_=jax_polisher.PolisherType[mode], num_threads=2,
        aligner=TpuAligner(fallback=JaxNativeAligner(2), mesh=None),
        consensus=consensus)
    return _fasta(ref.run()), jax_metrics.dataflow_summary(), \
        consensus.stats


def test_resident_polish_equals_jax_resident(inputs, monkeypatch):
    want, want_df, jax_stats = _jax_resident(monkeypatch, inputs)
    got, tm, df, _, groups = _port(monkeypatch, inputs, True)
    assert got == want
    assert want_df["resident"] == 1
    # the full counters: the consensus groups' lanes and bytes too
    assert df == want_df
    assert df["lanes_device_groups"] == groups == jax_stats["groups"] > 0
    assert jax_stats["lane_upload_saved_bytes"] > 0
    assert "lane_upload_saved_s" in tm


@pytest.mark.parametrize("mode", ["C", "F"])
def test_resident_auto_polish_equals_jax_resident(inputs, monkeypatch,
                                                  mode):
    """``--overlaps auto`` under the flag: the overlapper compacts its
    tables on the device and chains from the resident join; the bytes and
    the full counters equal the JAX resident auto polish's."""
    want, want_df, jax_stats = _jax_resident(monkeypatch, inputs, "auto",
                                             mode)
    got, tm, df, _, groups = _port(monkeypatch, inputs, True, mode=mode,
                                   overlaps="auto")
    assert got == want and got.count(b">") >= 2
    assert df == want_df
    assert df["resident"] == 1 and df["resident_bailouts"] == 0
    assert df["lanes_device_groups"] == groups == jax_stats["groups"] > 0
    assert "lane_upload_saved_s" in tm


@pytest.mark.parametrize("case,reads,q", [("fractional_q", "fastq", 10.5),
                                         ("sub33_quality", "sub33", 10.0)])
def test_resident_bails_to_host_bytes(inputs, monkeypatch, case, reads, q):
    want = _port(monkeypatch, inputs, False, reads=reads, q=q)[0]
    got, tm, df, _, _ = _port(monkeypatch, inputs, True, reads=reads, q=q)
    assert got == want
    assert df["resident"] == 0 and df["resident_bailouts"] == 1
    assert "window_derive_s" not in tm
    # the host path's store holds no pool on the device
    assert df["lanes_device_groups"] == 0


def test_resident_device_failure_raises(inputs, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("finalize failed")

    monkeypatch.setattr(port_nw, "finalize_layer_table", broken)
    with pytest.raises(RuntimeError, match="finalize failed"):
        _port(monkeypatch, inputs, True)
    assert metrics.dataflow_summary()["resident"] == 0
