"""The port's deterministic ``align.*``, ``aligner.*``, ``consensus.*`` and
``overlap.*`` metrics against the JAX engines' on the same inputs, on the
CPU. Seconds are not compared.

- the aligner: ``CudaAligner(device="cpu")`` and ``TpuAligner(mesh=None)``
  on their default ragged streams with the band ladder off and one
  bucket, (256, 512), whose band both packages run on the packed kernel
  (K4 in the port), so ``aligner.swar_chunks`` counts the same chunks;
- the consensus stream: ``tests/test_ragged.py``'s windows through both
  engines at band 128 (as ``test_torch_consensus_stream.py``);
- the overlapper: ``find_overlaps`` of both packages on
  ``simulate(0.01, seed=5)``, called twice so the second call takes the
  target table from the cache.
"""

import numpy as np
import pytest
import torch

from racon_tpu.core.backends import CpuPoaConsensus, NativeAligner
from racon_tpu.obs import metrics as jax_metrics
from racon_tpu.ops import chain as jax_chain
from racon_tpu.ops import overlap_seed as jax_seed
from racon_tpu.ops import poa as jax_poa
from racon_tpu.ops.nw import TpuAligner
from racon_tpu_torch.core import backends as port_backends
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.ops import chain as port_chain
from racon_tpu_torch.ops import overlap_seed as port_seed
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.ops.nw import CudaAligner
from racon_tpu_torch.io.parsers import _parse_fasta_py, _parse_fastq_py
from racon_tpu_torch.utils.simulate import simulate
from tests.test_ragged import BASES, _mixed_windows
from tests.test_torch_consensus_stream import _port_copy
from tests.test_torch_engines import _mutate


@pytest.fixture(autouse=True)
def _clean():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    metrics.clear_run()
    jax_metrics.clear_run()
    yield
    torch.set_num_threads(saved)


def _counters(store, prefixes):
    return {k: v for k, v in store.snapshot()["counters"].items()
            if k.startswith(prefixes)}


def test_aligner_counters_equal_jax(monkeypatch):
    monkeypatch.setenv("RACON_TPU_BAND_LADDER", "0")
    rng = np.random.default_rng(9)
    pairs = []
    for k in range(48):
        t = BASES[rng.integers(0, 4, int(rng.integers(90, 250)))]
        err = 0.6 if k % 16 == 0 else 0.1    # a few escape to the host
        pairs.append((_mutate(rng, t, err).tobytes(), t.tobytes()))
    buckets = ((256, 512),)
    ref = TpuAligner(fallback=NativeAligner(1), mesh=None, buckets=buckets)
    port = CudaAligner(fallback=port_backends.NativeAligner(1),
                       buckets=buckets, device="cpu", use_ladder=False)
    assert port.align_batch(pairs) == ref.align_batch(pairs)
    prefixes = ("align.", "aligner.swar_chunks")
    got = _counters(metrics, prefixes)
    want = _counters(jax_metrics, prefixes)
    assert got == want
    assert got["aligner.swar_chunks"] == got["align.chunks"] > 0
    assert got["align.steps_wasted"] == (got["align.lanes_total"]
                                         - got["align.lanes_occupied"])


def test_consensus_counters_equal_jax():
    windows = _mixed_windows(np.random.default_rng(100))
    ref = jax_poa.TpuPoaConsensus(3, -5, -4,
                                  fallback=CpuPoaConsensus(3, -5, -4),
                                  band=128, rounds=4, mesh=None)
    port = tpoa.CudaPoaConsensus(
        3, -5, -4, fallback=port_backends.NativePoaConsensus(3, -5, -4),
        band=128, rounds=4, device="cpu")
    port_w = _port_copy(windows)
    assert port.run(port_w, trim=True) == ref.run(windows, trim=True)
    assert [w.consensus for w in port_w] == [w.consensus for w in windows]
    got = _counters(metrics, ("consensus.",))
    want = _counters(jax_metrics, ("consensus.",))
    assert got == want
    assert got["consensus.groups"] == port.stats["groups"] > 0


def test_overlap_counters_equal_jax(tmp_path):
    reads, _, draft, _ = simulate(0.01, seed=5, coverage=30,
                                  mean_read=1000, max_read=1300,
                                  min_read=700)
    (tmp_path / "r.fastq").write_bytes(reads)
    (tmp_path / "d.fasta").write_bytes(draft)
    read_seqs = [r.data for r in _parse_fastq_py(str(tmp_path / "r.fastq"))]
    targets = [r.data for r in _parse_fasta_py(str(tmp_path / "d.fasta"))]
    self_t = np.full(len(read_seqs), -1, np.int64)
    jax_seed.clear_table_cache()
    port_seed.clear_table_cache()
    for _ in range(2):
        want_rows = jax_chain.find_overlaps(read_seqs, targets, self_t)
        got_rows = port_chain.find_overlaps(read_seqs, targets, self_t,
                                            device="cpu")
        for key in want_rows:
            assert np.array_equal(got_rows[key], want_rows[key]), key
    got = _counters(metrics, ("overlap.",))
    want = {k: v for k, v in _counters(jax_metrics, ("overlap.",)).items()
            if not k.startswith("overlap.chain_lanes_")}
    assert got == want
    assert got["overlap.cache_hits"] == got["overlap.cache_misses"] == 1
    assert got["overlap.chains_kept"] == 2 * want_rows["q_ord"].size > 0
