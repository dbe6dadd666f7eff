"""The port's shard runner under faults, leases and resumes, on the CPU.

- **The ladder**: ``RACON_TPU_EXEC_FAULT_SHARD=1`` retries shard 1 on the
  CPU engines with the same bytes, ``2*`` quarantines shard 2 and a resume
  completes it; a ``transient-io`` fault retries on the same engines
  after a backoff, and a persistent one walks the whole ladder to
  quarantine; an ENOSPC at ``part.write`` and an EIO at
  ``manifest.write`` retry; a ``stall`` goes to the CPU rung, and so does
  a device OOM once both device engines (on ``device="cpu"``) are at
  their floor; with the engines on the card there is no CPU rung, and
  such faults quarantine the shard; a corrupt or truncated part is
  re-queued before the merge; the sanitizer's queue watchdog escalation
  fails an attempt as ``stall`` (in a bare polisher and through the
  runner).
- **Leases**: exclusion, release, expiry and reclaim, a heartbeat that
  keeps a lease alive, the immediate break of a dead pid's lease, and a
  fresh run that refuses a directory with a live lease.
- **Resume**: completed shards are skipped (their parts untouched), with
  or without the sizing knobs; a parameter change re-runs everything; a
  torn manifest is recovered.
- The run report of a faulted run passes both packages' validators and
  counts the fault.

The runs use the host engines (the engine does not matter to the ladder)
on ``simulate(0.008, seed=7)`` in 4 contigs of 2 kbp with reads of
0.7-1.3 kbp; the device-OOM floor case uses the device engines with
``device="cpu"``, faulted before they run.
"""

import io
import json
import os
import pathlib
import time

import pytest
import torch

from racon_tpu.obs import report as jax_report
from racon_tpu_torch import faults
from racon_tpu_torch.core import polisher as port_polisher
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.exec import ShardRunner, lease, load_manifest
from racon_tpu_torch.exec import manifest as mf
from racon_tpu_torch.exec import runner as runner_mod
from racon_tpu_torch.obs import metrics, report
from racon_tpu_torch.utils.simulate import simulate


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # module scope: set before the module's fixtures polish anything (a
    # polish on every core slows ~20x under parallel test workers)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _fresh_fault_counts():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.008, seed=7, mean_read=1000,
                                    max_read=1300, min_read=700,
                                    n_contigs=4)
    d = pathlib.Path(tmp_path_factory.mktemp("exec_faults"))
    out = []
    for name, blob in (("reads.fastq", reads), ("ovl.paf", paf),
                       ("draft.fasta", draft)):
        (d / name).write_bytes(blob)
        out.append(str(d / name))
    return tuple(out)


@pytest.fixture(scope="module")
def want(assembly):
    return b"".join(b">" + s.name + b"\n" + s.data + b"\n" for s in
                    create_polisher(*assembly, num_threads=2).run())


def sharded(assembly, work_dir, **kw):
    kw.setdefault("num_threads", 2)
    runner = ShardRunner(*assembly, work_dir=str(work_dir), **kw)
    buf = io.BytesIO()
    summary = runner.run(buf)
    return buf.getvalue(), summary, runner


def _faulted(summary):
    return [e for e in summary["shards"] if e.get("attempts")]


# ------------------------------------------------------------- the ladder

def test_legacy_fault_shard_retries_on_cpu(assembly, want, tmp_path,
                                           monkeypatch):
    monkeypatch.setenv("RACON_TPU_EXEC_FAULT_SHARD", "1")
    got, summary, _ = sharded(assembly, tmp_path / "w", n_shards=4)
    assert got == want
    entry = summary["shards"][1]
    assert (entry["status"], entry["engine"]) == ("done", "cpu-retry")
    assert faults.LEGACY_MESSAGE in entry["reason"]
    assert [a["action"] for a in entry["attempts"]] == ["cpu-retry"]
    assert summary["faults"]["injected.exec.polish"] == 1
    assert summary["faults"]["deterministic-compute"] == 1
    assert not summary["quarantined"]


def test_persistent_fault_quarantines_then_resumes(assembly, want,
                                                   tmp_path, monkeypatch):
    monkeypatch.setenv("RACON_TPU_EXEC_FAULT_SHARD", "2*")
    got, summary, _ = sharded(assembly, tmp_path / "w", n_shards=4,
                              keep_work_dir=True)
    assert summary["quarantined"] == [2]
    entry = summary["shards"][2]
    assert entry["status"] == "quarantined"
    assert "cpu retry: " in entry["reason"]
    assert got.count(b">") == 3
    assert load_manifest(str(tmp_path / "w"))["shards"][2]["status"] == \
        "quarantined"
    monkeypatch.delenv("RACON_TPU_EXEC_FAULT_SHARD")
    got2, summary2, _ = sharded(assembly, tmp_path / "w", n_shards=4,
                                resume=True, keep_work_dir=True)
    assert got2 == want
    assert all(e["status"] == "done" for e in summary2["shards"])


def test_transient_fault_backs_off_on_the_same_engines(assembly, want,
                                                       tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("RACON_TPU_FAULTS", "exec.polish:io@1")
    monkeypatch.setenv("RACON_TPU_EXEC_BACKOFF_S", "0.02")
    got, summary, _ = sharded(assembly, tmp_path / "w", n_shards=2)
    assert got == want
    (entry,) = _faulted(summary)
    (att,) = entry["attempts"]
    assert (att["class"], att["action"]) == ("transient-io",
                                             "retry-backoff")
    assert att["backoff_s"] > 0
    assert entry["engine"] == "primary"
    assert summary["faults"]["transient-io"] == 1
    assert metrics.timer_s("exec.backoff_s") > 0


def test_transient_budget_walks_the_whole_ladder(assembly, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("RACON_TPU_FAULTS", "exec.polish:io@1*")
    monkeypatch.setenv("RACON_TPU_EXEC_RETRIES", "2")
    monkeypatch.setenv("RACON_TPU_EXEC_BACKOFF_S", "0.01")
    _, summary, _ = sharded(assembly, tmp_path / "w", n_shards=1,
                            keep_work_dir=True)
    assert summary["quarantined"] == [0]
    actions = [a["action"] for a in summary["shards"][0]["attempts"]]
    assert actions == ["retry-backoff", "retry-backoff", "cpu-retry",
                       "quarantine"]
    m = load_manifest(str(tmp_path / "w"))
    assert [a["action"] for a in m["shards"][0]["attempts"]] == actions


@pytest.mark.parametrize("spec,cls", [("part.write:enospc@1",
                                       "transient-io"),
                                      ("exec.polish:stall@1", "stall")])
def test_part_write_and_stall_faults(assembly, want, tmp_path, monkeypatch,
                                     spec, cls):
    monkeypatch.setenv("RACON_TPU_FAULTS", spec)
    monkeypatch.setenv("RACON_TPU_EXEC_BACKOFF_S", "0.02")
    got, summary, _ = sharded(assembly, tmp_path / "w", n_shards=2)
    assert got == want
    (entry,) = _faulted(summary)
    (att,) = entry["attempts"]
    assert att["class"] == cls
    assert entry["engine"] == ("cpu-retry" if cls == "stall"
                               else "primary")


def test_manifest_write_fault_retries(assembly, want, tmp_path,
                                      monkeypatch, capfd):
    monkeypatch.setenv("RACON_TPU_FAULTS", "manifest.write:io@2")
    got, summary, _ = sharded(assembly, tmp_path / "w", n_shards=2)
    assert got == want and not summary["quarantined"]
    assert "retrying" in capfd.readouterr().err


def test_oom_at_the_floor_falls_to_the_cpu_rung(assembly, want, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("RACON_TPU_FAULTS", "exec.polish:oom@1")
    runner = ShardRunner(*assembly, work_dir=str(tmp_path / "w"),
                         num_threads=2, n_shards=1, aligner="cuda",
                         consensus="cuda", device="cpu")
    for eng in runner.get_engines(cpu=False):
        eng.capacity_scale = eng._MAX_CAPACITY_SCALE
        assert not eng.reduce_capacity()
    buf = io.BytesIO()
    summary = runner.run(buf)
    assert buf.getvalue() == want  # the native engines' bytes
    entry = summary["shards"][0]
    assert entry["engine"] == "cpu-retry"
    assert [(a["class"], a["action"]) for a in entry["attempts"]] == \
        [("device-oom", "cpu-retry")]


def _as_if_on_the_card(monkeypatch):
    """``cuda`` devices resolve without a card: only the ladder's choice
    reads the device in the runs below (their faults fire before any
    engine launches)."""
    monkeypatch.setattr(runner_mod, "resolve", torch.device)


@pytest.mark.parametrize("device,aligner,consensus,on_card", [
    ("cuda", "cuda", "cuda", True), ("cuda:0", "cuda", "native", True),
    ("cuda", "native", "cuda", True), ("cuda", "native", "native", False),
    ("cpu", "cuda", "cuda", False)])
def test_primary_on_card(assembly, tmp_path, monkeypatch, device, aligner,
                         consensus, on_card):
    _as_if_on_the_card(monkeypatch)
    runner = ShardRunner(*assembly, work_dir=str(tmp_path), device=device,
                         aligner=aligner, consensus=consensus)
    assert runner.primary_on_card() is on_card


@pytest.mark.parametrize("spec,cls", [("exec.polish:err@1",
                                       "deterministic-compute"),
                                      ("exec.polish:oom@1", "device-oom")])
def test_card_engines_have_no_cpu_rung(assembly, tmp_path, monkeypatch,
                                       spec, cls):
    monkeypatch.setenv("RACON_TPU_FAULTS", spec)
    runner = ShardRunner(*assembly, work_dir=str(tmp_path / "w"),
                         num_threads=2, n_shards=1, aligner="cuda",
                         consensus="cuda", device="cpu")
    for eng in runner.get_engines(cpu=False):  # no OOM rung left
        eng.capacity_scale = eng._MAX_CAPACITY_SCALE
    runner.device = "cuda"
    _as_if_on_the_card(monkeypatch)
    buf = io.BytesIO()
    summary = runner.run(buf)
    assert buf.getvalue() == b""
    assert summary["quarantined"] == [0]
    entry = summary["shards"][0]
    assert entry["status"] == "quarantined" and "engine" not in entry
    assert [(a["engine"], a["class"], a["action"])
            for a in entry["attempts"]] == [("primary", cls, "quarantine")]
    assert runner.cpu_engines is None  # the host engines were never built
    assert load_manifest(str(tmp_path / "w"))["shards"][0]["status"] == \
        "quarantined"


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_bad_part_requeued_before_merge(assembly, want, tmp_path, capfd,
                                        damage):
    _, summary, _ = sharded(assembly, tmp_path / "w", n_shards=3,
                            keep_work_dir=True)
    part = tmp_path / "w" / summary["shards"][1]["part"]
    blob = bytearray(part.read_bytes())
    if damage == "flip":
        blob[len(blob) // 2] ^= 0xFF  # same size: only the CRC sees it
    else:
        del blob[-40:]
    part.write_bytes(bytes(blob))
    got, _, _ = sharded(assembly, tmp_path / "w", n_shards=3, resume=True,
                        keep_work_dir=True)
    assert got == want
    err = capfd.readouterr().err
    assert "failed verification" in err and "re-queueing" in err
    assert metrics.counter("faults.part_corrupt") == 1


# ------------------------------------------------------ stall escalation

def _wedge_first_build(monkeypatch, seconds):
    """The first layer build of the process sleeps ``seconds`` (a wedged
    producer); later ones run."""
    real = port_polisher.Polisher._assemble_layers
    calls = []

    def wedged(self, *a, **kw):
        calls.append(1)
        if len(calls) == 1:
            time.sleep(seconds)
            return
        return real(self, *a, **kw)
    monkeypatch.setattr(port_polisher.Polisher, "_assemble_layers", wedged)


def test_watchdog_escalation_fails_the_polish_with_stall(assembly,
                                                         monkeypatch):
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    monkeypatch.setenv("RACON_TPU_SANITIZE_WATCHDOG_S", "0.2")
    metrics.clear("faults.")
    _wedge_first_build(monkeypatch, 3)
    p = create_polisher(*assembly, num_threads=2, stall_escalation=True)
    t0 = time.monotonic()
    with pytest.raises(faults.StallError) as info:
        p.run()
    assert time.monotonic() - t0 < 2.5  # escalated, not waited out
    assert faults.classify(info.value) == faults.CLASS_STALL
    assert metrics.counter("faults.stall_escalations") == 1


def test_watchdog_escalation_in_a_shard_goes_down_the_ladder(
        assembly, want, tmp_path, monkeypatch):
    # a timeout no healthy polish of these shards comes near, even on a
    # loaded host
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    monkeypatch.setenv("RACON_TPU_SANITIZE_WATCHDOG_S", "1")
    _wedge_first_build(monkeypatch, 5)
    got, summary, _ = sharded(assembly, tmp_path / "w", n_shards=2)
    assert got == want
    (entry,) = _faulted(summary)
    assert entry["engine"] == "cpu-retry"
    assert [(a["class"], a["action"]) for a in entry["attempts"]] == \
        [("stall", "cpu-retry")]
    assert summary["faults"]["stall_escalations"] == 1


# ----------------------------------------------------------------- leases

def test_lease_exclusion_and_release(tmp_path):
    wd = str(tmp_path)
    a = lease.try_claim(wd, 0, "worker-a")
    assert a is not None
    assert lease.try_claim(wd, 0, "worker-b") is None
    assert lease.read_lease(wd, 0)["worker"] == "worker-a"
    b = lease.try_claim(wd, 1, "worker-b")
    assert b is not None
    a.release()
    b.release()
    c = lease.try_claim(wd, 0, "worker-b")
    assert c is not None
    c.release()
    assert not os.path.exists(lease.lease_path(wd, 0))


def test_lease_expiry_and_reclaim(tmp_path):
    wd = str(tmp_path)
    metrics.clear("lease.")
    a = lease.try_claim(wd, 0, "worker-a", ttl_s=0.2)
    a._keeper.stop()          # a dead worker: no more heartbeats
    a._keeper = None
    time.sleep(0.35)
    b = lease.try_claim(wd, 0, "worker-b", ttl_s=0.2)
    assert b is not None
    assert lease.read_lease(wd, 0)["worker"] == "worker-b"
    assert metrics.counter("lease.expired") == 1
    a.release()               # not a's any more: b's lease stays
    assert a.lost.is_set()
    assert lease.read_lease(wd, 0)["worker"] == "worker-b"
    os.unlink(b.path)         # broken under b: its next beat finds out
    assert not b.heartbeat() and b.lost.is_set()
    assert metrics.counter("lease.lost") == 1
    b.release()


def test_lease_heartbeat_blocks_expiry(tmp_path, monkeypatch):
    wd = str(tmp_path)
    monkeypatch.setenv("RACON_TPU_EXEC_LEASE_TTL_S", "1.2")
    a = lease.try_claim(wd, 0, "worker-a")
    time.sleep(2.0)           # past the TTL, but the keeper beat (0.3 s)
    assert lease.try_claim(wd, 0, "worker-b") is None
    a.release()


def test_lease_of_a_dead_pid_breaks_at_once(tmp_path):
    wd = str(tmp_path)
    a = lease.try_claim(wd, 0, "worker-a", ttl_s=3600.0)
    a._keeper.stop()
    a._keeper = None
    blob = json.loads(pathlib.Path(a.path).read_bytes())
    blob["pid"] = 2 ** 22 + 1  # past the default pid_max
    pathlib.Path(a.path).write_text(json.dumps(blob))
    b = lease.try_claim(wd, 0, "worker-b", ttl_s=3600.0)
    assert b is not None
    b.release()


def test_fresh_run_refuses_a_dir_with_a_live_lease(assembly, tmp_path):
    wd = tmp_path / "w"
    wd.mkdir()
    held = lease.try_claim(str(wd), 0, "someone-else")
    try:
        with pytest.raises(RuntimeError, match="live shard lease"):
            sharded(assembly, wd, n_shards=2)
    finally:
        held.release()


# ----------------------------------------------------------------- resume

@pytest.mark.parametrize("sizing", [{"n_shards": 3}, {}])
def test_resume_skips_completed_shards(assembly, want, tmp_path, capfd,
                                       sizing):
    got, _, _ = sharded(assembly, tmp_path / "w", n_shards=3,
                        keep_work_dir=True)
    assert got == want
    parts = sorted((tmp_path / "w").glob("part_*.fasta"))
    assert len(parts) == 3
    mtimes = [p.stat().st_mtime_ns for p in parts]
    capfd.readouterr()
    got2, summary, _ = sharded(assembly, tmp_path / "w", resume=True,
                               keep_work_dir=True, **sizing)
    assert got2 == want
    assert summary["n_shards"] == 3  # the stored plan
    assert capfd.readouterr().err.count(
        "resume: skipping completed shard") == 3
    assert [p.stat().st_mtime_ns for p in parts] == mtimes


def test_resume_with_other_parameters_reruns_everything(assembly, want,
                                                        tmp_path, capfd):
    sharded(assembly, tmp_path / "w", n_shards=3, keep_work_dir=True)
    capfd.readouterr()
    # the simulator's '9' qualities pass either threshold: same bytes, but
    # the runner cannot know that
    got, _, _ = sharded(assembly, tmp_path / "w", n_shards=3, resume=True,
                        keep_work_dir=True, quality_threshold=9.5)
    assert got == want
    err = capfd.readouterr().err
    assert "fingerprint does not match" in err
    assert "resume: skipping" not in err


def test_torn_manifest_is_recovered(assembly, want, tmp_path, capfd):
    sharded(assembly, tmp_path / "w", n_shards=3, keep_work_dir=True)
    path = tmp_path / "w" / mf.MANIFEST_NAME
    blob = path.read_bytes()
    path.write_bytes(blob[:len(blob) // 2])
    capfd.readouterr()
    got, summary, _ = sharded(assembly, tmp_path / "w", n_shards=3,
                              resume=True, keep_work_dir=True)
    assert got == want
    assert all(e["status"] == "done" for e in summary["shards"])
    err = capfd.readouterr().err
    assert "corrupt" in err and "re-running every shard" in err


# ------------------------------------------------------------ run report

def test_run_report_counts_the_fault(assembly, tmp_path, monkeypatch):
    monkeypatch.setenv("RACON_TPU_FAULTS", "exec.polish:io@1")
    monkeypatch.setenv("RACON_TPU_EXEC_BACKOFF_S", "0.02")
    sharded(assembly, tmp_path / "w", n_shards=2, keep_work_dir=True)
    rep = json.loads((tmp_path / "w" / mf.REPORT_NAME).read_text())
    assert report.validate_report(rep) == []
    assert jax_report.validate_report(rep) == []
    assert rep["kind"] == "exec"
    assert rep["faults"]["transient-io"] == 1
    assert rep["faults"]["injected.exec.polish"] == 1
    assert rep["faults"]["lease.claimed"] >= 2
    rows = rep["shards"]
    assert [r["attempts"][0]["class"] for r in rows if "attempts" in r] \
        == ["transient-io"]
    assert all("crc32" in r and "worker" in r for r in rows)
    # a row with a bad key fails the validator
    rows[0]["part"] = "part_0000.fasta"
    assert any("unknown key 'part'" in e
               for e in report.validate_report(rep))
