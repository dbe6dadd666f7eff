"""The shard runner through the port's CLI (``python -m racon_tpu_torch
--shards/--max-ram/--resume/--shard-dir``), on the CPU with the host
engines.

- ``--shards 3`` and ``--max-ram 64G`` write the bytes of the port's plain
  CLI and of the JAX CLI's ``--shards 3``; the ``--run-report`` of a
  sharded run is of kind ``exec`` with a row a shard;
- a run with a quarantined shard exits 1 without that shard's contig,
  and ``--resume`` then completes it to the plain bytes;
- a run SIGKILLed after its first part is resumed with ``--resume`` to
  the same bytes, skipping the shards that finished
  (``RACON_TPU_EXEC_SLEEP_S`` widens the kill's window).

Inputs: ``simulate(0.008, seed=7)`` in 4 contigs of 2 kbp with reads of
0.7-1.3 kbp.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from racon_tpu_torch.exec import load_manifest
from racon_tpu_torch.obs import report
from racon_tpu_torch.utils.simulate import simulate

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.008, seed=7, mean_read=1000,
                                    max_read=1300, min_read=700,
                                    n_contigs=4)
    d = pathlib.Path(tmp_path_factory.mktemp("exec_cli"))
    out = []
    for name, blob in (("reads.fastq", reads), ("ovl.paf", paf),
                       ("draft.fasta", draft)):
        (d / name).write_bytes(blob)
        out.append(str(d / name))
    return out


def _cli(module, args, cwd=REPO, log=None, **env):
    """The CLI in a subprocess; its stderr goes to ``log`` when given (a
    run nobody reads until it ends must not fill a pipe)."""
    path = os.pathsep.join([str(REPO)] + [p for p in [
        os.environ.get("PYTHONPATH", "")] if p])
    return subprocess.Popen(
        [sys.executable, "-m", module, "-t", "2", *args], cwd=cwd,
        env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=path, **env),
        stdout=subprocess.PIPE if log is None else subprocess.DEVNULL,
        stderr=subprocess.PIPE if log is None else log)


def _out(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err.decode()[-2000:]
    return out


@pytest.fixture(scope="module")
def plain(assembly):
    return _out(_cli("racon_tpu_torch", assembly))


def test_cli_shards_match_plain_cli_and_jax_cli(assembly, plain, tmp_path):
    procs = {
        "jax": _cli("racon_tpu", ["--shards", "3", "--shard-dir",
                                  str(tmp_path / "jax"), *assembly],
                    JAX_PLATFORMS="cpu"),
        "shards": _cli("racon_tpu_torch", [
            "--shards", "3", "--shard-dir", str(tmp_path / "port"),
            "--run-report", str(tmp_path / "rep.json"), *assembly]),
        # no --shard-dir: the work dir is derived in the working directory
        "max_ram": _cli("racon_tpu_torch", ["--max-ram", "64G",
                                            *assembly], cwd=tmp_path),
    }
    outs = {k: _out(p) for k, p in procs.items()}
    assert plain.startswith(b">contig_0 LN:i:")
    assert outs["shards"] == plain
    assert outs["jax"] == plain
    assert outs["max_ram"] == plain
    rep = json.loads((tmp_path / "rep.json").read_text())
    assert report.validate_report(rep) == []
    assert rep["kind"] == "exec" and len(rep["shards"]) == 3
    assert {r["engine"] for r in rep["shards"]} == {"primary"}
    # an explicit --shard-dir is kept; the derived one of --max-ram is not
    assert load_manifest(str(tmp_path / "port")) is not None
    assert not list(tmp_path.glob("racon_exec_*"))


def test_quarantined_shard_fails_the_run_until_resumed(assembly, plain,
                                                     tmp_path):
    args = ["--shards", "2", "--shard-dir", str(tmp_path / "w"), *assembly]
    failed = _cli("racon_tpu_torch", args, RACON_TPU_EXEC_FAULT_SHARD="1*")
    out, err = failed.communicate(timeout=300)
    assert failed.returncode == 1
    assert "quarantined" in err.decode() and "--resume" in err.decode()
    assert 0 < out.count(b">") < plain.count(b">")
    m = load_manifest(str(tmp_path / "w"))
    assert [e["status"] for e in m["shards"]] == ["done", "quarantined"]
    resumed = _cli("racon_tpu_torch", [*args, "--resume"])
    assert _out(resumed) == plain


def test_sigkill_then_resume_gives_the_same_bytes(assembly, plain,
                                                  tmp_path):
    wd = tmp_path / "w"
    args = ["--shards", "4", "--shard-dir", str(wd), *assembly]
    log = open(tmp_path / "killed.log", "wb")
    proc = _cli("racon_tpu_torch", args, log=log,
                RACON_TPU_EXEC_SLEEP_S="8")

    def done_count():
        m = load_manifest(str(wd)) if (wd / "manifest.json").exists() \
            else None
        return sum(e["status"] == "done" for e in m["shards"]) if m else 0

    try:
        deadline = time.time() + 120
        while done_count() < 1:
            if proc.poll() is not None:
                pytest.fail("the run ended before the kill: " + (
                    tmp_path / "killed.log").read_text()[-2000:])
            if time.time() > deadline:
                pytest.fail("no shard finished before the deadline")
            time.sleep(0.1)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()
    assert proc.returncode == -signal.SIGKILL
    m = load_manifest(str(wd))
    done = [e["id"] for e in m["shards"] if e["status"] == "done"]
    assert 0 < len(done) < 4
    resumed = _cli("racon_tpu_torch", [*args, "--resume"])
    out, err = resumed.communicate(timeout=300)
    assert resumed.returncode == 0, err.decode()[-2000:]
    assert out == plain
    assert err.decode().count("resume: skipping completed shard") == \
        len(done)
