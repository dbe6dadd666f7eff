"""The port's ``rampler`` and ``racon_wrapper`` against the JAX package's,
on the CPU with the host engines (the port's counterpart of
``tests/test_wrapper.py``, whose λ-phage inputs are absent here).

- ``rampler split`` and ``subsample`` write the same files, byte for byte,
  as ``racon_tpu.rampler``; ``rampler plan`` prints JAX's JSON in the
  ``--shards``, ``--split``, ``--max-ram`` and ``auto`` modes (under
  ``--max-ram`` but for ``avail_bytes``, which is the budget less this
  process's peak RSS);
- ``wrapper --split`` writes JAX's wrapper bytes and the port's
  single-shot bytes; ``wrapper --legacy-split`` writes JAX's
  legacy-split bytes in contig mode and with ``-f`` (a chunk run keeps
  only the overlaps of its own targets, so in contig mode its bytes may
  differ from the single shot's); ``--subsample`` writes JAX's bytes.

Inputs: ``simulate(0.008, seed=7)`` in 4 contigs of 2 kbp with reads of
0.7-1.3 kbp; for ``-f`` the reads are their own targets, with all-vs-all
overlaps from the port's overlapper (``exec.index.write_auto_paf``).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from racon_tpu import rampler as jax_rampler
from racon_tpu_torch import rampler
from racon_tpu_torch.exec.index import write_auto_paf
from racon_tpu_torch.io import parsers
from racon_tpu_torch.utils.simulate import simulate

REPO = pathlib.Path(__file__).resolve().parent.parent
# the wrapper's scores (the reference wrapper's defaults)
SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.008, seed=7, mean_read=1000,
                                    max_read=1300, min_read=700,
                                    n_contigs=4)
    d = pathlib.Path(tmp_path_factory.mktemp("wrapper"))
    out = {}
    for key, name, blob in (("reads", "reads.fastq", reads),
                            ("overlaps", "ovl.paf", paf),
                            ("draft", "draft.fasta", draft)):
        (d / name).write_bytes(blob)
        out[key] = str(d / name)
    out["ava"] = str(d / "ava.paf")
    write_auto_paf(out["reads"], out["reads"], out["ava"], device="cpu")
    out["contig_bytes"] = [len(r.data) for r in
                           parsers.parse_fasta(out["draft"])]
    out["read_bases"] = sum(len(r.data) for r in
                            parsers.parse_fastq(out["reads"]))
    return out


def _start(module, args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [
                       os.environ.get("PYTHONPATH", "")] if p]))
    os.makedirs(cwd, exist_ok=True)
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _run_all(procs):
    """Wait for every process; each must exit 0. Their stdouts."""
    outs = {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (key, err.decode()[-2000:])
        outs[key] = out
    return outs


# ------------------------------------------------------------------ rampler

def _tree(d: pathlib.Path):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("key,chunk", [("draft", 4500), ("reads", 3000),
                                       ("reads", 10 ** 9)])
def test_rampler_split_writes_jax_files(files, tmp_path, key, chunk):
    for mod, name in ((rampler, "port"), (jax_rampler, "jax")):
        assert mod.main(["-o", str(tmp_path / name), "split", files[key],
                         str(chunk)]) == 0
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port == jax
    ext = ".fasta" if key == "draft" else ".fastq"
    assert set(port) == {f"{key}_{i}{ext}" for i in range(len(port))}
    parse = parsers.sequence_parser_for(files[key])
    joined = [(r.name, r.data, r.quality)
              for i in range(len(port))
              for r in parse(str(tmp_path / "port" / f"{key}_{i}{ext}"))]
    assert joined == [(r.name, r.data, r.quality)
                      for r in parse(files[key])]
    assert (len(port) > 1) == (chunk < 10 ** 9)


@pytest.mark.parametrize("seed", [0, 3])
def test_rampler_subsample_writes_jax_file(files, tmp_path, seed):
    out = {}
    for mod, name in ((rampler, "port"), (jax_rampler, "jax")):
        assert mod.main(["-o", str(tmp_path / name), "--seed", str(seed),
                         "subsample", files["reads"], "8000", "4"]) == 0
        out[name] = _tree(tmp_path / name)
    assert out["port"] == out["jax"]
    assert list(out["port"]) == ["reads_4x.fastq"]
    picked = list(parsers.parse_fastq(str(tmp_path / "port" /
                                          "reads_4x.fastq")))
    total = sum(len(r.data) for r in picked)
    assert 8000 * 4 <= total < files["read_bases"]


@pytest.mark.parametrize("case", [
    dict(n_shards=3), dict(split_bytes=4500), dict(max_ram="64G"),
    dict(n_shards=2, fragment_correction=True, error_threshold=0.2),
    dict(n_shards=2, overlaps="auto"), dict(split_bytes=4500,
                                            overlaps="auto")])
def test_rampler_plan_is_jax(files, case):
    case = dict(case)
    ovl = case.pop("overlaps", files["overlaps"])
    args = (files["reads"], ovl, files["draft"])
    if case.get("fragment_correction"):
        args = (files["reads"], files["ava"], files["reads"])
    port = rampler.plan(*args, **case)
    jax = jax_rampler.plan(*args, **case)
    if "max_ram" in case:
        # the budget less each process's own peak RSS
        assert port.pop("avail_bytes") > 0 and jax.pop("avail_bytes") > 0
    assert json.dumps(port, indent=1) == json.dumps(jax, indent=1)
    assert port["n_overlaps"] == (0 if ovl == "auto" else
                                  port["n_overlaps"])


def test_rampler_plan_cli_prints_the_plan(files, capsys):
    assert rampler.main(["plan", files["reads"], files["overlaps"],
                         files["draft"], "--split", "4500"]) == 0
    plan = json.loads(capsys.readouterr().out)
    assert plan == rampler.plan(files["reads"], files["overlaps"],
                                files["draft"], split_bytes=4500)
    assert plan["mode"] == "split" and len(plan["shards"]) == 2


# ------------------------------------------------------------------ wrapper

def test_wrapper_matches_jax_wrapper(files, tmp_path):
    """Every wrapper path of both packages, side by side: ``--split`` at
    the largest contig's size (one contig a shard), ``--legacy-split`` in
    contig mode and with ``-f``, ``--subsample``; and the port's single
    shot with the wrapper's scores."""
    split = str(max(files["contig_bytes"]))
    contig = [files["reads"], files["overlaps"], files["draft"]]
    frag = ["-f", files["reads"], files["ava"], files["reads"]]
    cases = {
        "split": ["--split", split, *contig],
        "legacy": ["--legacy-split", "--split", "4500", *contig],
        "legacy_f": ["--legacy-split", "--split",
                     str(files["read_bases"] // 2 + 1), *frag],
        "subsample": ["--subsample", "8000", "4", *contig],
    }
    procs = {}
    for name, args in cases.items():
        for module, side in (("racon_tpu_torch.wrapper", "port"),
                             ("racon_tpu.wrapper", "jax")):
            procs[(name, side)] = _start(module, ["-t", "2", *args],
                                         tmp_path / f"{name}_{side}")
    procs[("single", "port")] = _start(
        "racon_tpu_torch", ["-t", "2", *SCORES, *contig],
        tmp_path / "single")
    outs = _run_all(procs)
    for name in cases:
        assert outs[(name, "port")] == outs[(name, "jax")], name
    single = outs[("single", "port")]
    assert single.startswith(b">contig_0 LN:i:")
    assert outs[("split", "port")] == single
    assert outs[("legacy", "port")].count(b">") == 4
    assert outs[("legacy_f", "port")].startswith(b">read_")
    assert outs[("subsample", "port")].count(b">contig_") >= 1
    # the wrapper's scratch directories are gone, and so is the runner's
    # derived work dir after the --split run
    for name in cases:
        assert not list((tmp_path / f"{name}_port").iterdir()), name


def test_wrapper_plan_has_one_contig_a_shard(files):
    plan = rampler.plan(files["reads"], files["overlaps"], files["draft"],
                        split_bytes=max(files["contig_bytes"]))
    assert sorted(len(s["contigs"]) for s in plan["shards"]) == [1] * 4
