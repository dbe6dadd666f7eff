"""The port's ``Polisher`` on its device aligner path against the JAX
``Polisher``, on the CPU, at the flags that path reaches: window lengths
200 and 500, and fragment mode.

Both sides run the native consensus (the CLI parity test holds the device
consensus), so this isolates the aligner: the port with
``aligner="cuda", device="cpu"`` (its default ragged stream and band
ladder on the plain kernels), the JAX package with a ``TpuAligner``
without a mesh (its default ragged stream and ladder; under the tests'
eight virtual CPU devices ``aligner_backend="tpu"`` would build a mesh and
take the bucketed driver). Every overlap's breaking points and the
polished bytes must be equal.

Inputs: a simulated 0.01 Mbp genome at 30x with reads of 0.7-1.3 kbp
(seed 5; the plain kernels' cost grows with the reads' length, and the
simulator's 7 kbp reads cost minutes of CPU a run), and
for fragment mode read-to-read overlaps made from the simulator's read
placements: each read against the next two by draft start whose draft
spans share at least 300 bp, coordinates mapped linearly along each read
and flipped on the reverse strand.
"""

import pathlib

import numpy as np
import pytest
import torch

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.core.backends import NativeAligner as JaxNativeAligner
from racon_tpu.ops.nw import TpuAligner
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.ops import nw as port_nw
from racon_tpu_torch.utils.simulate import simulate


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The plain kernels run thousands of small ops; two intra-op threads
    are as fast as eight alone and keep parallel test workers from
    oversubscribing the cores (eight threads each slowed one polisher run
    about twenty-fold)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _fragment_paf(paf: bytes) -> bytes:
    """Read-to-read PAF lines from the simulator's read-to-draft lines."""
    reads = []
    for line in paf.splitlines():
        f = line.split(b"\t")
        reads.append((f[0], int(f[1]), f[4] == b"-", int(f[7]), int(f[8])))
    reads.sort(key=lambda r: r[3])

    def span(read, a, b):
        _, ln, rev, tb, te = read
        pa = (a - tb) * ln // (te - tb)
        pb = (b - tb) * ln // (te - tb)
        return (ln - pb, ln - pa) if rev else (pa, pb)

    out = []
    for k, qr in enumerate(reads):
        for tr in reads[k + 1:k + 3]:
            a, b = max(qr[3], tr[3]), min(qr[4], tr[4])
            if b - a < 300:
                continue
            qb, qe = span(qr, a, b)
            tb, te = span(tr, a, b)
            out.append(b"\t".join([
                qr[0], b"%d" % qr[1], b"%d" % qb, b"%d" % qe,
                b"-" if qr[2] != tr[2] else b"+", tr[0], b"%d" % tr[1],
                b"%d" % tb, b"%d" % te, b"%d" % min(qe - qb, te - tb),
                b"%d" % max(qe - qb, te - tb), b"255"]) + b"\n")
    return b"".join(out)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.01, seed=5, mean_read=1000,
                                    max_read=1300, min_read=700)
    d = tmp_path_factory.mktemp("bp")
    paths = {}
    for key, name, blob in (("reads", "reads.fastq", reads),
                            ("overlaps", "ovl.paf", paf),
                            ("draft", "draft.fasta", draft),
                            ("fragments", "frag.paf", _fragment_paf(paf))):
        paths[key] = str(pathlib.Path(d) / name)
        pathlib.Path(paths[key]).write_bytes(blob)
    return paths


def _capture(polisher):
    """Wrap the polisher's breaking-point phase to keep a copy of every
    overlap's rows (the window build releases them)."""
    rows = []
    inner = polisher.find_overlap_breaking_points

    def wrapped(overlaps, *args, **kwargs):
        inner(overlaps, *args, **kwargs)
        rows.extend(np.array(o.breaking_points) for o in overlaps)

    polisher.find_overlap_breaking_points = wrapped
    return rows


def _fasta(seqs):
    return b"".join(b">" + s.name + b"\n" + s.data + b"\n" for s in seqs)


@pytest.mark.parametrize("window,mode", [(200, "C"), (500, "C"),
                                         (500, "F")])
def test_polisher_breaking_points_match_jax(inputs, monkeypatch, window,
                                            mode):
    ovl = inputs["overlaps" if mode == "C" else "fragments"]
    target = inputs["draft" if mode == "C" else "reads"]
    args = (inputs["reads"], ovl, target)
    ref = jax_polisher.create_polisher(
        *args, type_=jax_polisher.PolisherType[mode], window_length=window,
        num_threads=2, consensus_backend="native",
        aligner=TpuAligner(fallback=JaxNativeAligner(2), mesh=None))
    want_rows = _capture(ref)
    want = _fasta(ref.run())

    # the device path builds no CIGAR and leaves the polisher's host
    # decode nothing to do
    def forbidden(*a, **k):
        raise AssertionError("host CIGAR work on the device path")

    monkeypatch.setattr(port_nw, "ops_to_cigar", forbidden)
    monkeypatch.setattr(port_polisher, "decode_breaking_points_batch",
                        forbidden)
    port = port_polisher.create_polisher(
        *args, type_=port_polisher.PolisherType[mode], window_length=window,
        num_threads=2, aligner="cuda", consensus="native", device="cpu")
    got_rows = _capture(port)
    got = _fasta(port.run())
    assert len(got_rows) == len(want_rows) > 50
    for g, x in zip(got_rows, want_rows):
        assert np.array_equal(g, x)
    assert got == want and got.startswith(b">")
    st = port.aligner.stats
    assert st["device"] > len(got_rows) // 2 and st["ladder_narrow"] > 0
    assert port.timings["bp_decode_s"] < port.timings["align_s"]
