"""The port's pipelined ``Polisher.run()`` on the CPU: a producer thread
assembles the layers and hands window ranges through a bounded queue to
the consensus engine's streaming session.

Its FASTA must equal the JAX ``Polisher.run()`` with the JAX device
consensus (``TpuPoaConsensus(mesh=None)``, its default ragged stream) and
the port's own ``initialize()`` + ``polish()``. Both sides align with the
native host aligner (``tests/test_torch_polisher_bp.py`` holds the device
aligner), so the consensus engine and the pipeline are what is compared.
The port's ranges are cut to 4 windows (its floor patched, and the
engine's ``group_pairs_hint`` set to 8 pairs) so that several ranges flow
through the queue; the JAX side hands over one range.

Inputs: ``simulate(0.01, seed=5)`` with reads of 0.7-1.3 kbp, as in
``tests/test_torch_polisher_bp.py``; fragment mode corrects the reads with
the first 150 of its read-to-read overlaps (all of them would make the JAX
reference alone take minutes on the CPU).
"""

import pathlib
import sys
import threading

import pytest
import torch

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.core.backends import CpuPoaConsensus
from racon_tpu.ops.poa import TpuPoaConsensus
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.utils.simulate import simulate
from tests.test_torch_polisher_bp import _fasta, _fragment_paf


@pytest.fixture(autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _small_ranges(monkeypatch):
    monkeypatch.setattr(port_polisher, "MIN_CHUNK_WINDOWS", 4)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.01, seed=5, mean_read=1000,
                                    max_read=1300, min_read=700)
    fragments = b"".join(_fragment_paf(paf).splitlines(True)[:150])
    d = tmp_path_factory.mktemp("run")
    paths = {}
    for key, name, blob in (("reads", "reads.fastq", reads),
                            ("overlaps", "ovl.paf", paf),
                            ("draft", "draft.fasta", draft),
                            ("fragments", "frag.paf", fragments)):
        paths[key] = str(pathlib.Path(d) / name)
        pathlib.Path(paths[key]).write_bytes(blob)
    return paths


def _args(inputs, mode):
    return (inputs["reads"], inputs["overlaps" if mode == "C"
                                     else "fragments"],
            inputs["draft" if mode == "C" else "reads"])


def _port(inputs, mode="C", window=500, consensus="cuda"):
    polisher = port_polisher.create_polisher(
        *_args(inputs, mode), type_=port_polisher.PolisherType[mode],
        window_length=window, num_threads=2, aligner="native",
        consensus=consensus, device="cpu")
    polisher.consensus.group_pairs_hint = 8
    return polisher


def _producer_alive():
    return any(t.name == "racon-layers" and t.is_alive()
               for t in threading.enumerate())


@pytest.mark.parametrize("window,mode", [(500, "C"), (200, "F")])
def test_run_matches_jax_run(inputs, window, mode):
    ref = jax_polisher.create_polisher(
        *_args(inputs, mode), type_=jax_polisher.PolisherType[mode],
        window_length=window, num_threads=2, aligner_backend="native",
        consensus=TpuPoaConsensus(3, -5, -4,
                                  fallback=CpuPoaConsensus(3, -5, -4),
                                  mesh=None))
    want = _fasta(ref.run())
    port = _port(inputs, mode, window)
    fed = []
    stream = port.consensus.stream

    def counting_stream(*a, **k):
        sess = stream(*a, **k)
        feed = sess.feed
        sess.feed = lambda windows: (fed.append(len(windows)),
                                     feed(windows))
        return sess

    port.consensus.stream = counting_stream
    got = _fasta(port.run())
    assert got == want and got.startswith(b">")
    assert len(fed) > 1                       # several ranges flowed
    for key in ("device_windows", "fallback_windows", "stage_b_windows",
                "groups", "lanes_total", "band"):
        assert port.consensus.stats[key] == ref.consensus.stats[key], key
    t = port.timings
    for key in ("parse_s", "align_s", "build_windows_s", "consensus_s",
                "consensus_feed_s", "consensus_finish_s", "queue_wait_s",
                "pipeline_overlap_saved_s", "stitch_s"):
        assert t[key] >= 0, key
    assert t["consensus_feed_s"] + t["consensus_finish_s"] <= \
        t["consensus_s"]
    assert not _producer_alive()


def test_run_matches_initialize_polish(inputs):
    split = _port(inputs)
    split.initialize()
    want = _fasta(split.polish())
    got = _fasta(_port(inputs).run())
    assert got == want and got.startswith(b">")


def test_layer_fault_propagates_and_joins_producer(inputs, monkeypatch):
    """A fault in the layer assembly (the producer thread), after it has
    handed a range over, comes out of run() once the thread has ended."""
    assemble = port_polisher.Polisher._assemble_layers

    def faulty(self, overlaps, emit=None, chunk_windows=0):
        def emit_then_fail(a, b):
            emit(a, b)
            raise ValueError("layer fault")
        assemble(self, overlaps, emit=emit_then_fail,
                 chunk_windows=chunk_windows)

    monkeypatch.setattr(port_polisher.Polisher, "_assemble_layers", faulty)
    with pytest.raises(ValueError, match="layer fault"):
        _port(inputs).run()
    assert not _producer_alive()


def test_consensus_fault_drains_queue_and_joins_producer(inputs):
    """A fault in the consensus engine (this thread) while the producer
    still has ranges to hand over: the queue is drained, the producer
    ends, and the fault comes out of run()."""

    class FaultyConsensus:
        def run(self, windows, trim, progress=None):
            raise RuntimeError("consensus fault")

    polisher = _port(inputs, consensus=FaultyConsensus())
    with pytest.raises(RuntimeError, match="consensus fault"):
        polisher.run()
    assert not _producer_alive()


def test_ranges_arrive_once_in_order_under_thread_switching(inputs,
                                                            monkeypatch):
    """One-window ranges with the interpreter switching threads every
    microsecond: the consumer feeds every window exactly once, in order,
    each with its layers attached, and maps the session's flags back."""
    monkeypatch.setattr(port_polisher, "MIN_CHUNK_WINDOWS", 1)
    fed = []

    class RecordingSession:
        def feed(self, windows):
            for w in windows:
                assert w.layer_view[0] is not None or w.layer_count == 0
                fed.append(w)

        def finish(self):
            for w in fed:
                w.consensus = w.backbone
            return [w.rank % 2 == 0 for w in fed]

    class RecordingConsensus:
        group_pairs_hint = 1

        def stream(self, trim, band_hint=0):
            return RecordingSession()

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        polisher = _port(inputs, consensus=RecordingConsensus())
        polisher.initialize = None        # run() must not take this path
        windows = []
        assemble = polisher._assemble_layers

        def keep_windows(overlaps, emit=None, chunk_windows=0):
            windows.extend(polisher.windows)
            assemble(overlaps, emit=emit, chunk_windows=chunk_windows)

        polisher._assemble_layers = keep_windows
        out = polisher.run(drop_unpolished_sequences=False)
    finally:
        sys.setswitchinterval(saved)
    assert len(windows) > 10 and fed == windows
    assert b"".join(s.data for s in out) == b"".join(
        w.backbone for w in windows)
    ratio = sum(w.rank % 2 == 0 for w in windows) / len(windows)
    assert out[0].name.endswith(b"XC:f:%.6f" % ratio)
    assert polisher.timings["pipeline_overlap_saved_s"] >= 0
    assert not _producer_alive()
