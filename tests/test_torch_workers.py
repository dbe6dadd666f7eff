"""Several workers on one work dir, across real processes, on the CPU with
the host engines (``python -m racon_tpu_torch --workers/--exec-secondary``).

- ``--workers 2 --shards 4`` writes the bytes of the port's plain CLI and
  of the JAX CLI's ``--workers 2``, and the report left at
  ``--run-report`` is the primary's (written after the secondary exits);
- a secondary launched by hand before its primary adopts the primary's
  plan and polishes shards of it; a secondary that finds no manifest gives
  up with ``RuntimeError`` (``runner._SECONDARY_MANIFEST_WAIT_S`` patched
  down in-process);
- worker A SIGKILLs itself at its second shard (``worker.kill:kill@2``),
  leaving that shard ``running``; worker B reclaims it through A's dead
  pid, survives its own transient fault and merges the plain bytes;
- two workers launched at once on an empty directory both merge the
  plain bytes (one publishes the plan, the other adopts it);
- ``_secondary_argv`` is JAX's.

Inputs: ``simulate(0.008, seed=7)`` in 4 contigs of 2 kbp with reads of
0.7-1.3 kbp.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from racon_tpu_torch import cli
from racon_tpu_torch.exec import ShardRunner, load_manifest
from racon_tpu_torch.exec import manifest as mf
from racon_tpu_torch.exec import runner as runner_mod
from racon_tpu_torch.obs import report
from racon_tpu_torch.utils.simulate import simulate

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.008, seed=7, mean_read=1000,
                                    max_read=1300, min_read=700,
                                    n_contigs=4)
    d = pathlib.Path(tmp_path_factory.mktemp("workers"))
    out = []
    for name, blob in (("reads.fastq", reads), ("ovl.paf", paf),
                       ("draft.fasta", draft)):
        (d / name).write_bytes(blob)
        out.append(str(d / name))
    return out


def _cli(module, args, cwd=REPO, **env):
    path = os.pathsep.join([str(REPO)] + [p for p in [
        os.environ.get("PYTHONPATH", "")] if p])
    return subprocess.Popen(
        [sys.executable, "-m", module, "-t", "2", *args], cwd=cwd,
        env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=path,
                 RACON_TPU_EXEC_LEASE_TTL_S="60", **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _done(proc, rc=0):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == rc, err.decode()[-2000:]
    return out, err


@pytest.fixture(scope="module")
def plain(assembly):
    return _done(_cli("racon_tpu_torch", assembly))[0]


def test_workers_flag_matches_plain_cli_and_jax_cli(assembly, plain,
                                                   tmp_path):
    procs = {
        "jax": _cli("racon_tpu", ["--workers", "2", "--shards", "4",
                                  "--shard-dir", str(tmp_path / "jax"),
                                  *assembly], JAX_PLATFORMS="cpu"),
        "port": _cli("racon_tpu_torch", [
            "--workers", "2", "--shards", "4", "--shard-dir",
            str(tmp_path / "port"), "--run-report",
            str(tmp_path / "rep.json"), *assembly]),
        # no --shard-dir: the derived work dir goes after the reap
        "derived": _cli("racon_tpu_torch", ["--workers=2", "--shards", "4",
                                            *assembly], cwd=tmp_path),
    }
    outs = {k: _done(p)[0] for k, p in procs.items()}
    assert plain.startswith(b">contig_0 LN:i:")
    assert outs == {"jax": plain, "port": plain, "derived": plain}
    m = load_manifest(str(tmp_path / "port"))
    assert [e["status"] for e in m["shards"]] == ["done"] * 4
    rep = json.loads((tmp_path / "rep.json").read_text())
    assert report.validate_report(rep) == []
    # the primary's report: written after the secondary's, at the path
    # both were given
    assert rep["kind"] == "exec" and "--exec-secondary" not in rep["argv"]
    assert "--workers" in rep["argv"] and len(rep["shards"]) == 4
    assert not list(tmp_path.glob("racon_exec_*"))


def test_secondary_launched_first_joins_the_primary_plan(assembly, plain,
                                                        tmp_path):
    wd = str(tmp_path / "w")
    args = ["--shards", "4", "--shard-dir", wd, *assembly]
    # the secondary indexes, then polls for the manifest; the primary
    # sleeps before each shard after its first, so the secondary's claims
    # land while the primary polishes
    second = _cli("racon_tpu_torch", [*args, "--exec-secondary"],
                  RACON_TPU_WORKER="second", RACON_TPU_EXEC_SLEEP_S="2")
    first = _cli("racon_tpu_torch", args, RACON_TPU_WORKER="first",
                 RACON_TPU_EXEC_SLEEP_S="2")
    out, err = _done(first)
    s_out, s_err = _done(second)
    assert out == plain and s_out == b""
    m = load_manifest(wd)
    by = {e["worker"] for e in m["shards"]}
    assert [e["status"] for e in m["shards"]] == ["done"] * 4
    assert by == {"first", "second"}, s_err.decode()[-2000:]
    # each announces the shards the other finished
    assert b"by worker second" in err and b"by worker first" in s_err


def test_secondary_without_a_manifest_gives_up(assembly, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(runner_mod, "_SECONDARY_MANIFEST_WAIT_S", 0.3)
    runner = ShardRunner(*assembly, n_shards=2, secondary=True,
                         work_dir=str(tmp_path / "w"))
    assert runner.keep_work_dir
    with open(os.devnull, "wb") as sink, \
            pytest.raises(RuntimeError, match="no manifest"):
        runner.run(sink)


def test_chaos_kill_then_reclaim_gives_the_plain_bytes(assembly, plain,
                                                       tmp_path):
    wd = tmp_path / "w"
    args = ["--shards", "4", "--shard-dir", str(wd), "--resume", *assembly]
    # worker A dies at its second shard, after recording it running
    proc_a = _cli("racon_tpu_torch", args,
                  RACON_TPU_FAULTS="worker.kill:kill@2",
                  RACON_TPU_WORKER="chaos-a")
    _done(proc_a, rc=-9)
    m = load_manifest(str(wd))
    running = [e for e in m["shards"] if e["status"] == "running"]
    assert len(running) == 1 and running[0]["worker"] == "chaos-a"
    assert sum(e["status"] == "done" for e in m["shards"]) == 1
    # worker B joins, breaks the dead pid's lease at once (no TTL wait),
    # reclaims the shard, survives a transient fault and merges
    out, err = _done(_cli("racon_tpu_torch", args,
                          RACON_TPU_FAULTS="exec.polish:io@1",
                          RACON_TPU_WORKER="chaos-b",
                          RACON_TPU_EXEC_BACKOFF_S="0.05"))
    assert out == plain
    assert b"reclaiming shard" in err
    m = load_manifest(str(wd))
    assert [e["status"] for e in m["shards"]] == ["done"] * 4
    assert {e["worker"] for e in m["shards"]} == {"chaos-a", "chaos-b"}
    reclaimed = [e for e in m["shards"] if e.get("reclaimed")]
    assert len(reclaimed) == 1 and reclaimed[0]["worker"] == "chaos-b"
    rep = json.loads((wd / mf.REPORT_NAME).read_text())
    assert report.validate_report(rep) == []
    assert rep["faults"]["lease.reclaimed"] >= 1
    assert rep["faults"]["injected.exec.polish"] == 1
    assert rep["faults"]["transient-io"] == 1
    assert any(r.get("attempts") for r in rep["shards"])


def test_two_workers_racing_one_manifest(assembly, plain, tmp_path):
    wd = tmp_path / "w"
    procs = [_cli("racon_tpu_torch",
                  ["--shards", "4", "--shard-dir", str(wd), "--resume",
                   *assembly], RACON_TPU_WORKER=f"race-{k}",
                  RACON_TPU_EXEC_SLEEP_S="0.5") for k in range(2)]
    outs = [_done(p)[0] for p in procs]
    assert outs == [plain, plain]
    m = load_manifest(str(wd))
    assert [e["status"] for e in m["shards"]] == ["done"] * 4


@pytest.mark.parametrize("argv", [
    ["--workers", "3", "--shards", "4", "r.fq", "o.paf", "d.fa"],
    ["-t", "8", "--workers=2", "--resume", "--shard-dir", "W", "r", "o",
     "d"],
    ["-c", "1", "--cudaaligner-batches", "1", "--workers", "2", "r", "o",
     "d", "--run-report", "x.json"],
    ["r", "o", "d"],
])
def test_secondary_argv_is_jax(argv):
    from racon_tpu import cli as jax_cli
    for n in (1, 2):
        assert cli._secondary_argv(argv, n) == \
            jax_cli._secondary_argv(argv, n)
    child = cli._secondary_argv(argv, 1)[0]
    assert child[-1] == "--exec-secondary"
    assert not any(t.startswith("--workers") for t in child)


def test_workers_keep_the_device_and_never_fall_back(assembly, tmp_path):
    """The secondaries get the primary's ``--device``; with ``--device
    cuda`` and no card the run raises, as a single worker does, rather
    than polish on the CPU, and its secondary is stopped."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = ["-c", "1", "--cudaaligner-batches", "1", "--device", "cuda",
            "--workers", "2", "--shards", "2", "--shard-dir",
            str(tmp_path / "w"), *assembly]
    child = cli._secondary_argv(args, 1)[0]
    assert child[child.index("--device") + 1] == "cuda"
    out, err = _done(_cli("racon_tpu_torch", args), rc=1)
    assert out == b"" and b"torch.cuda.is_available() is False" in err
