"""The port's transmute (``Polisher._transmute_all``) on the CPU.

The port transmutes serially where the JAX package runs a thread pool of
64-sequence chunks. On the reads and draft of ``write_inputs(0.05,
seed=13)`` (over 128 sequences, so the JAX pool runs), with per-sequence
flags drawn from a seed, every ``Sequence`` must end with the same
``name``, ``data``, ``quality``, reverse complement and reversed quality
at 1, 4 and 16 threads, and equal to the JAX package's
``Polisher._transmute_all`` at 4 threads on the same parsed inputs.
``Polisher._load`` at 1 and 4 threads gives the same sequences and
overlaps.
"""

import numpy as np
import pytest

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.core.sequence import Sequence as JaxSequence
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.core.sequence import Sequence
from racon_tpu_torch.io import parsers
from racon_tpu_torch.utils.simulate import write_inputs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(0.05, str(tmp_path_factory.mktemp("tm")), seed=13)


@pytest.fixture(scope="module")
def records(inputs):
    recs = parsers.parse_fasta(inputs["draft"]) + \
        parsers.parse_fastq(inputs["reads"])
    assert len(recs) > 128
    rng = np.random.default_rng(3)
    flags = [rng.random(len(recs)) < p for p in (0.3, 0.6, 0.5)]
    return recs, [[bool(x) for x in f] for f in flags]


def _state(seqs):
    # the reverse complement is read from the private fields: the public
    # properties would build it for a sequence the transmute left alone
    return [(s.name, s.data, s.quality, s._reverse_complement,
             s._reverse_quality) for s in seqs]


def _port_transmute(records, threads):
    recs, (has_name, has_data, has_reverse) = records
    p = port_polisher.Polisher.__new__(port_polisher.Polisher)
    p.sequences = [Sequence(r.name, r.data, r.quality) for r in recs]
    p.num_threads = threads
    p._transmute_all(has_name, has_data, has_reverse)
    return _state(p.sequences)


@pytest.fixture(scope="module")
def jax_state(records):
    recs, (has_name, has_data, has_reverse) = records
    ref = jax_polisher.Polisher.__new__(jax_polisher.Polisher)
    ref.sequences = [JaxSequence(r.name, r.data, r.quality) for r in recs]
    ref.num_threads = 4
    ref._transmute_all(has_name, has_data, has_reverse)
    return _state(ref.sequences)


@pytest.mark.parametrize("threads", [1, 4, 16])
def test_transmute_matches_jax_pool(records, jax_state, threads):
    got = _port_transmute(records, threads)
    assert got == jax_state
    assert any(s[3] for s in got) and any(not s[1] for s in got)


def test_load_is_the_same_at_1_and_4_threads(inputs):
    def load(threads):
        p = port_polisher.create_polisher(
            inputs["reads"], inputs["overlaps"], inputs["draft"],
            num_threads=threads)
        overlaps = p._load()
        rows = [(o.q_id, o.t_id, o.q_begin, o.q_end, o.t_begin, o.t_end,
                 o.strand) for o in overlaps]
        return _state(p.sequences), rows, p.timings

    seqs1, rows1, _ = load(1)
    seqs4, rows4, timings = load(4)
    assert len(seqs1) > 128
    assert seqs4 == seqs1 and rows4 == rows1
    for key in ("load_targets_s", "load_reads_s", "load_overlaps_s",
                "filter_s", "transmute_s"):
        assert timings[key] >= 0, key
