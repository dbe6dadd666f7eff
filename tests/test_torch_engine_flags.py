"""The engines' A/B flags against the JAX package's, on the CPU.

``RACON_TPU_SWAR``, ``RACON_TPU_ALIGN_RAGGED``, ``RACON_TPU_BAND_LADDER``,
``RACON_TPU_RAGGED`` and ``RACON_TPU_OVERLAP`` are read where the JAX
package reads them (the engines' constructors, the forward-kernel choice,
``parsers.overlaps_mode``). Each keeps JAX's default and type, and flipping
it moves the engines' counters as it moves JAX's, while the bytes stay.
The JAX engines run without a mesh (``mesh=None``). The README's port
flag table is the registry's generated one.
"""

import os
import subprocess
import sys

import pytest
import torch

from racon_tpu import flags as jax_flags
from racon_tpu.core.window import Window as JaxWindow
from racon_tpu.core.window import WindowType as JaxWindowType
from racon_tpu.io import parsers as jax_parsers
from racon_tpu.ops.nw import TpuAligner
from racon_tpu.ops.poa import TpuPoaConsensus
from racon_tpu_torch import flags
from racon_tpu_torch.io import parsers
from racon_tpu_torch.ops import swar
from racon_tpu_torch.ops.nw import CudaAligner
from racon_tpu_torch.ops.poa import CudaPoaConsensus

from test_torch_parallel import _random_pairs, _random_windows

FLAGS = ("RACON_TPU_SWAR", "RACON_TPU_ALIGN_RAGGED", "RACON_TPU_BAND_LADDER",
         "RACON_TPU_RAGGED", "RACON_TPU_OVERLAP", "RACON_TPU_CHIPS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", FLAGS)
def test_flag_default_and_type_are_jax(name):
    mine, theirs = flags.REGISTRY[name], jax_flags.REGISTRY[name]
    assert (mine.default, mine.kind) == (theirs.default, theirs.kind)
    getter = {"bool": "get_bool", "int": "get_int", "str": "get_str"}
    assert getattr(flags, getter[mine.kind])(name) == \
        getattr(jax_flags, getter[theirs.kind])(name)


def _aligners(**kw):
    return (CudaAligner(device="cpu", **kw), TpuAligner(mesh=None, **kw))


@pytest.mark.parametrize("value", ["1", "0"])
def test_swar_flag_moves_the_packed_chunks_as_jax(monkeypatch, value):
    """At band 512 (where the port launches K4) every chunk is packed
    with the flag on and none with it off, in both packages."""
    monkeypatch.setenv("RACON_TPU_SWAR", value)
    pairs = _random_pairs(12, seed=3)
    mine, theirs = _aligners(buckets=((256, 512),), use_ladder=False)
    assert mine.align_batch(pairs) == theirs.align_batch(pairs)
    assert mine.stats["swar_chunks"] == theirs.stats["swar_chunks"] == \
        (mine.stats["chunks"] if value == "1" else 0)
    assert swar.use_packed16(256, 512) is (value == "1")


@pytest.mark.parametrize("value", ["1", "0"])
def test_align_ragged_flag_picks_the_driver_as_jax(monkeypatch, value):
    monkeypatch.setenv("RACON_TPU_ALIGN_RAGGED", value)
    pairs = _random_pairs(20, seed=4)
    mine, theirs = _aligners(buckets=((256, 128),))
    assert mine.use_ragged is theirs.use_ragged is (value == "1")
    assert (mine.bp_stream(100) is None) is (theirs.bp_stream(100) is None) \
        is (value == "0")
    assert mine.align_batch(pairs) == theirs.align_batch(pairs)
    assert mine.stats["chunks"] == theirs.stats["chunks"]


@pytest.mark.parametrize("value", ["1", "0"])
def test_band_ladder_flag_seeds_bands_as_jax(monkeypatch, value):
    monkeypatch.setenv("RACON_TPU_BAND_LADDER", value)
    pairs = _random_pairs(20, lo=60, hi=120, err=0.02, seed=8)
    mine, theirs = _aligners(buckets=((256, 256),),
                             use_ragged=False)
    assert mine.use_ladder is theirs.use_ladder is (value == "1")
    assert mine.align_batch(pairs) == theirs.align_batch(pairs)
    for key in ("ladder_narrow", "band_escalated", "device"):
        assert mine.stats[key] == theirs.stats[key], key
    assert (mine.stats["ladder_narrow"] > 0) is (value == "1")


@pytest.mark.parametrize("value", ["1", "0"])
def test_ragged_flag_picks_the_consensus_path_as_jax(monkeypatch, value):
    monkeypatch.setenv("RACON_TPU_RAGGED", value)
    mine = CudaPoaConsensus(3, -5, -4, band=64, rounds=2, device="cpu")
    theirs = TpuPoaConsensus(3, -5, -4, band=64, rounds=2, mesh=None)
    assert mine.use_ragged is theirs.use_ragged is (value == "1")
    assert (mine.stream(True) is None) is (theirs.stream(True) is None) \
        is (value == "0")
    mw = _random_windows(7, seed=12)
    jw = _random_windows(7, seed=12, cls=JaxWindow,
                         wtype=JaxWindowType.TGS)
    assert mine.run(mw, trim=True) == theirs.run(jw, trim=True)
    assert [w.consensus for w in mw] == [w.consensus for w in jw]
    for key in ("groups", "group_windows", "device_windows"):
        assert mine.stats[key] == theirs.stats[key], key


@pytest.mark.parametrize("value,want", [(None, "paf"), ("auto", "auto"),
                                        ("AUTO ", "auto"), ("paf", "paf")])
def test_overlap_flag_overrides_the_overlaps_argument_as_jax(monkeypatch,
                                                             value, want):
    if value is not None:
        monkeypatch.setenv("RACON_TPU_OVERLAP", value)
    for path in ("reads.paf", "ovl.mhap.gz"):
        assert parsers.overlaps_mode(path) == \
            jax_parsers.overlaps_mode(path) == want
    assert parsers.overlaps_mode("auto") == "auto"


def test_overlap_flag_routes_the_runner_to_the_overlapper(monkeypatch,
                                                         tmp_path):
    from racon_tpu_torch.exec import ShardRunner
    monkeypatch.setenv("RACON_TPU_OVERLAP", "auto")
    runner = ShardRunner(str(tmp_path / "r.fasta"), str(tmp_path / "o.paf"),
                         str(tmp_path / "t.fasta"), work_dir=str(tmp_path))
    assert parsers.is_auto_overlaps(runner.overlaps)


README = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "README.md")


def test_readme_port_flag_table_is_current():
    """The README's port table is ``flags.readme_table()`` verbatim, under
    its own header, and the JAX package's generated block stays beside
    it."""
    assert flags.check_readme(README)
    table = flags.readme_table()
    assert table.startswith("### Environment flags (port)\n")
    assert all(f"| `{name}` |" in table for name in flags.REGISTRY)
    assert jax_flags.check_readme(README)
    with open(README, encoding="utf-8") as fh:
        assert fh.read().count("## Environment flags\n") == 1


def test_flags_module_checks_the_readme(tmp_path):
    """``python -m racon_tpu_torch.flags`` prints the table, and
    ``--check-readme`` exits 0 on the README and 1 on a stale copy."""
    run = [sys.executable, "-m", "racon_tpu_torch.flags"]
    out = subprocess.run(run, capture_output=True, text=True, check=True)
    assert out.stdout == flags.readme_table()
    assert subprocess.run(run + ["--check-readme", README]).returncode == 0
    stale = tmp_path / "README.md"
    stale.write_text(flags.readme_table().replace("| `RACON_TPU_SWAR` |",
                                                  "| `RACON_TPU_SWAR2` |"))
    done = subprocess.run(run + ["--check-readme", str(stale)],
                          capture_output=True, text=True)
    assert done.returncode == 1 and "stale" in done.stderr
    assert not flags.check_readme(str(tmp_path / "missing.md"))
