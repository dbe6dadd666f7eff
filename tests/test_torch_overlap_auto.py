"""``--overlaps auto`` through the port's ``Polisher`` against the JAX
``Polisher``, on the CPU.

The port runs ``create_polisher(reads, "auto", target, aligner="cuda",
device="cpu")``: its overlapper on CPU tensors (the plain versions), the
streaming overlap->align handoff into the device aligner's session on the
plain kernels. The JAX package runs the same with a ``TpuAligner`` without
a mesh (the tests' eight virtual CPU devices would otherwise give it a
mesh and its bucketed driver) and its warm-up threads off. Both run the
native consensus. Every overlap's ids, strand, coordinates and breaking
points must be equal, and so must the polished bytes.

Contig mode on ``simulate(0.01, seed=5)`` with 0.7-1.3 kbp reads (the
plain kernels' cost grows with the reads' length); fragment mode (the
reads are their own targets, so every read's hits on itself drop) on
0.004 Mbp at 10x, because all-against-all overlaps multiply the
alignments.
"""

import pathlib

import numpy as np
import pytest
import torch

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.core.backends import NativeAligner as JaxNativeAligner
from racon_tpu.ops.nw import TpuAligner
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.io import parsers
from racon_tpu_torch.ops import chain
from racon_tpu_torch.utils.simulate import simulate


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads: eight per test worker oversubscribe the
    cores (tests/test_torch_polisher_bp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("auto"))
    paths = {}
    for key, mbp, cov in (("C", 0.01, 30), ("F", 0.004, 10)):
        reads, _, draft, _ = simulate(mbp, seed=5, coverage=cov,
                                      mean_read=1000, max_read=1300,
                                      min_read=700)
        (d / f"reads_{key}.fastq").write_bytes(reads)
        (d / f"draft_{key}.fasta").write_bytes(draft)
        paths[key] = (str(d / f"reads_{key}.fastq"),
                      str(d / (f"draft_{key}.fasta" if key == "C"
                               else f"reads_{key}.fastq")))
    return paths


def _capture(polisher):
    """Keep each overlap's identity, coordinates and breaking points as
    the breaking-point phase returns (the window build releases them)."""
    rows = []
    inner = polisher.find_overlap_breaking_points

    def wrapped(overlaps, *args, **kwargs):
        inner(overlaps, *args, **kwargs)
        rows.extend(((o.q_id, o.t_id, bool(o.strand), o.q_begin, o.q_end,
                      o.t_begin, o.t_end), np.array(o.breaking_points))
                    for o in overlaps)

    polisher.find_overlap_breaking_points = wrapped
    return rows


def _fasta(seqs):
    return b"".join(b">" + s.name + b"\n" + s.data + b"\n" for s in seqs)


@pytest.mark.parametrize("mode", ["C", "F"])
def test_auto_polisher_matches_jax(inputs, monkeypatch, mode):
    reads, target = inputs[mode]
    monkeypatch.setenv("RACON_TPU_WARMUP", "0")
    ref = jax_polisher.create_polisher(
        reads, "auto", target, type_=jax_polisher.PolisherType[mode],
        num_threads=2, consensus_backend="native",
        aligner=TpuAligner(fallback=JaxNativeAligner(2), mesh=None))
    want_rows = _capture(ref)
    want = _fasta(ref.run())

    chain.reset_stats()
    port = port_polisher.create_polisher(
        reads, parsers.AUTO_OVERLAPS, target,
        type_=port_polisher.PolisherType[mode], num_threads=2,
        aligner="cuda", consensus="native", device="cpu")
    got_rows = _capture(port)
    got = _fasta(port.run())
    assert len(got_rows) == len(want_rows) > 30
    for (gid, gbp), (wid, wbp) in zip(got_rows, want_rows):
        assert gid == wid
        assert np.array_equal(gbp, wbp)
    assert got == want and got.startswith(b">")
    if mode == "F":
        # reads are targets: no overlap of a read with itself
        assert all(i[0] != i[1] for i, _ in got_rows)
        assert got.count(b">") > 10
    assert port.aligner.stats["device"] > len(got_rows) // 2
    assert port.timings["overlap_feed_s"] > 0
    assert chain.STATS["chains_kept"] >= len(got_rows)
    assert chain.STATS["join_bailouts"] == 0


def test_auto_polisher_on_the_host_aligner_drains_the_feed(inputs):
    """A host aligner has no session: the feed is drained first and the
    overlaps take the barrier path, with the same bytes."""
    reads, target = inputs["C"]
    args = (reads, "auto", target)
    device = port_polisher.create_polisher(
        *args, num_threads=2, aligner="cuda", consensus="native",
        device="cpu").run()
    host = port_polisher.create_polisher(
        *args, num_threads=2, aligner="native", consensus="native",
        device="cpu")
    assert _fasta(host.run()) == _fasta(device)
    assert "overlap_feed_s" not in host.timings


def test_create_polisher_auto_validation(inputs):
    reads, target = inputs["C"]
    with pytest.raises(ValueError, match="'auto'"):
        port_polisher.create_polisher(reads, "overlaps.txt", target)
    assert parsers.overlaps_mode("auto") == "auto"
    assert parsers.overlaps_mode("ovl.paf") == "paf"
    if not torch.cuda.is_available():
        # auto runs the overlapper on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_polisher.create_polisher(reads, "auto", target)
