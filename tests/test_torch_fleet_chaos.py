"""The port's fleet under faults, as ``tests/test_fleet.py``'s chaos cases
run the JAX package's: every job comes back with the JAX one-shot CLI's
bytes, none lost and none duplicated.

- ``gateway.accept:err@1`` kills the first submit's connection before
  anything is journaled, and the keyed retry lands exactly one job;
- ``fleet.place:io@1`` costs one placement tick, never the job;
- a high-priority job drains a low-priority one (held in a retry backoff
  by ``serve.polish:io@1``) back to the queue; both come back, the victim
  under a fresh incarnation key;
- a member process wedged by ``serve.polish:io@1*`` and a 120 s backoff is
  SIGKILLed with a leased job: its lease is broken and the job comes back
  from the survivor, with one ``done`` record;
- every gateway journal walks ``TENANT_MACHINE``'s edges, a cancelled and
  a failed job included.

Helpers and inputs are ``tests/test_torch_fleet.py``'s.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from racon_tpu_torch.obs import metrics
from tests.test_fleet import _spec
# the fixtures (autouse ``_clean`` among them) are the fleet tests'
from tests.test_torch_fleet import (REPO, _clean, _env, _Gate,  # noqa: F401
                                    _Host, _kinds, fast_fleet,
                                    journal_records, short_tmp,
                                    tenant_walk, triple)


def test_gateway_accept_fault_keyed_retry(short_tmp, fast_fleet, triple):
    """An accept fault fires before the journal write and the
    acknowledgment: the connection dies, and the keyed retry lands
    exactly one job."""
    fast_fleet.setenv("RACON_TPU_FAULTS", "gateway.accept:err@1")
    fleet_dir = os.path.join(short_tmp, "fleet")
    with _Host(short_tmp, "h0", fleet_dir), _Gate(fleet_dir) as gate:
        gate.wait_hosts(1)
        c = gate.client()
        try:
            spec = _spec(*triple[0])
            with pytest.raises((ConnectionError, OSError)):
                c.submit(spec, key="ga-1")
            c.reconnect()
            resub = c.submit(spec, key="ga-1")
            assert resub["ok"] and not resub["existing"], resub
            header, payload = c.result(resub["job"], timeout_s=240)
            assert header["ok"] and payload == triple[1]
            recs = journal_records(fleet_dir)
            subs = [r for r in recs if r.get("rec") == "submitted"]
            assert len(subs) == 1 and subs[0]["key"] == "ga-1"
            assert tenant_walk(recs) == []
        finally:
            c.close()
    assert metrics.counter("faults.injected.gateway.accept") >= 1


def test_fleet_place_fault_requeues_and_retries(short_tmp, fast_fleet,
                                                triple):
    """A placement attempt that faults requeues the job and the next tick
    places it; the client never notices."""
    fast_fleet.setenv("RACON_TPU_FAULTS", "fleet.place:io@1")
    fleet_dir = os.path.join(short_tmp, "fleet")
    before = metrics.counter("faults.injected.fleet.place")
    with _Host(short_tmp, "h0", fleet_dir), _Gate(fleet_dir) as gate:
        gate.wait_hosts(1)
        with gate.client() as c:
            sub = c.submit(_spec(*triple[0]))
            assert sub["ok"]
            header, payload = c.result(sub["job"], timeout_s=240)
            assert header["ok"], header
            assert payload == triple[1]
        kinds = _kinds(journal_records(fleet_dir), sub["job"])
        assert kinds == {"submitted": 1, "running": 1, "done": 1,
                         "collected": 1}
    assert metrics.counter("faults.injected.fleet.place") == before + 1


def test_fleet_preemption_chaos(short_tmp, fast_fleet, triple):
    """Preemption drains, never kills: a low-priority job held in a
    transient-retry backoff is drained back to the queue, the
    high-priority job takes the slot, and both come back with the JAX
    CLI's bytes (the victim under a fresh incarnation key)."""
    fast_fleet.setenv("RACON_TPU_FAULTS", "serve.polish:io@1")
    fast_fleet.setenv("RACON_TPU_EXEC_BACKOFF_S", "4.0")
    reads, paf, layout = triple[0]
    fleet_dir = os.path.join(short_tmp, "fleet")
    done_at = {}
    with _Host(short_tmp, "h0", fleet_dir), _Gate(fleet_dir) as gate:
        gate.wait_hosts(1)
        with gate.client() as c:
            victim = c.submit(_spec(reads, paf, layout, priority=0),
                              key="pr-victim")
            assert victim["ok"]
            deadline = time.monotonic() + 60
            while c.status(victim["job"]).get("state") != "placed":
                assert time.monotonic() < deadline, \
                    "victim was never placed"
                time.sleep(0.02)
            time.sleep(0.5)  # the host fails attempt 1 into its backoff
            urgent = c.submit(_spec(reads, paf, layout, priority=5),
                              key="pr-urgent")
            assert urgent["ok"]

        def fetch(jid, label):
            with gate.client() as c2:
                header, payload = c2.result(jid, timeout_s=240)
            assert header.get("ok"), (label, header)
            assert payload == triple[1], \
                f"{label} result diverged from the one-shot CLI"
            done_at[label] = time.monotonic()

        threads = [threading.Thread(target=fetch, args=args)
                   for args in ((urgent["job"], "urgent"),
                                (victim["job"], "victim"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
            assert not t.is_alive(), "a fetch never completed"
        with gate.client() as c:
            st = c.stats()
            assert st["preempted"] >= 1, st
            assert st["fleet"]["jobs_preempted"] >= 1
            assert c.status(victim["job"]).get("state") == "collected"
        recs = journal_records(fleet_dir)
        runs = [r for r in recs if r.get("rec") == "running"
                and r["job"] == victim["job"]]
        assert len(runs) >= 2
        assert runs[0]["hkey"] != runs[-1]["hkey"]
        for job in (victim["job"], urgent["job"]):
            kinds = _kinds(recs, job)
            assert kinds["submitted"] == kinds["done"] == \
                kinds["collected"] == 1
        assert tenant_walk(recs) == []
    assert set(done_at) == {"urgent", "victim"}
    assert done_at["urgent"] < done_at["victim"], (
        "the high-priority job should finish before the drained "
        "victim's re-run")


def test_fleet_migration_chaos_kill_host(short_tmp, fast_fleet, triple):
    """SIGKILL a member process with a leased job: the gateway breaks the
    dead host's lease and places the job on a survivor; the result has
    the JAX CLI's bytes, with one submitted, one done and one collected
    record."""
    fleet_dir = os.path.join(short_tmp, "fleet")
    sick_sock = os.path.join(short_tmp, "sick.sock")
    log_path = os.path.join(short_tmp, "sick.log")
    # a real process, so the SIGKILL is real; every polish attempt faults
    # into a 120 s backoff, so a job placed there stays leased and running
    # until the kill
    env = _env(RACON_TPU_FAULTS="serve.polish:io@1*",
               RACON_TPU_EXEC_BACKOFF_S="120")
    with open(log_path, "wb") as log:
        sick = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch", "--serve", sick_sock,
             "--fleet-dir", fleet_dir, "--device", "cpu", "-t", "2"],
            cwd=REPO, env=env, stderr=log)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(os.path.join(fleet_dir, "hosts",
                                              "sick.json")):
            assert time.monotonic() < deadline, "sick host did not start"
            assert sick.poll() is None, "sick host died at startup"
            time.sleep(0.1)
        with _Gate(fleet_dir) as gate:
            gate.wait_hosts(1)
            with gate.client() as c:
                sub = c.submit(_spec(*triple[0]), key="mg-1")
                assert sub["ok"]
                jid = sub["job"]
                deadline = time.monotonic() + 60
                while True:
                    row = c.status(jid)
                    if row.get("state") == "placed" and \
                            row.get("host") == "sick":
                        break
                    assert time.monotonic() < deadline, row
                    time.sleep(0.05)
            lease = os.path.join(fleet_dir, f"lease_job_{jid}.json")
            assert os.path.exists(lease)
            os.kill(sick.pid, signal.SIGKILL)
            sick.wait(timeout=30)
            with _Host(short_tmp, "h1", fleet_dir):
                gate.wait_hosts(1)
                with gate.client(timeout_s=300) as c:
                    header, payload = c.result(jid, timeout_s=240)
                    assert header["ok"], header
                    assert payload == triple[1], \
                        "migrated result diverged from the one-shot CLI"
                    st = c.stats()
                    assert st["migrated"] >= 1, st
                    assert st["hosts"]["dead"] >= 1, st
                    assert st["fleet"]["jobs_migrated"] >= 1
                    assert st["fleet"]["hosts_dead"] >= 1
                    row = c.status(jid)
                    assert row.get("host") == "h1"
                    assert row.get("migrations", 0) >= 1
                recs = journal_records(fleet_dir)
                kinds = _kinds(recs, jid)
                assert kinds.get("submitted") == 1
                assert kinds.get("running", 0) >= 2
                assert kinds.get("done") == 1
                assert kinds.get("collected") == 1
                hosts = [r["host"] for r in recs
                         if r.get("job") == jid and r["rec"] == "running"]
                assert hosts[0] == "sick" and hosts[-1] == "h1"
                assert tenant_walk(recs) == []
    finally:
        if sick.poll() is None:
            sick.kill()
            sick.wait()
    with open(log_path, "rb") as f:
        assert b"fleet member sick registered" in f.read()


def test_every_gateway_journal_transition_is_a_machine_edge(
        short_tmp, fast_fleet, triple):
    """A job cancelled while queued, one a host rejects for its profile
    (failed), and one done and collected: each job's journal records walk
    ``TENANT_MACHINE``'s edges; and so do the gateway's in-memory stage
    writes (every ``_advance`` is checked against the machine)."""
    fleet_dir = os.path.join(short_tmp, "fleet")
    with _Gate(fleet_dir) as gate:
        with gate.client() as c:
            queued = c.submit(_spec(*triple[0]), key="ed-cancel")
            assert queued["ok"]
            cancel = c.cancel(queued["job"])
            assert cancel["ok"] and cancel["state"] == "cancelled"
            assert not c.cancel(queued["job"])["ok"]
        with _Host(short_tmp, "h0", fleet_dir):
            gate.wait_hosts(1)
            with gate.client() as c:
                bad = c.submit(_spec(*triple[0], match=5), key="ed-bad")
                good = c.submit(_spec(*triple[0]), key="ed-good")
                assert bad["ok"] and good["ok"]
                header, _ = c.result(bad["job"], timeout_s=240)
                assert not header["ok"] and header["state"] == "failed"
                assert "rejected by host h0" in header["error"]
                header, payload = c.result(good["job"], timeout_s=240)
                assert header["ok"] and payload == triple[1]
        recs = journal_records(fleet_dir)
    assert _kinds(recs, queued["job"]) == {"submitted": 1, "cancelled": 1}
    assert _kinds(recs, bad["job"]) == {"submitted": 1, "running": 1,
                                        "failed": 1}
    assert _kinds(recs, good["job"]) == {"submitted": 1, "running": 1,
                                         "done": 1, "collected": 1}
    assert tenant_walk(recs) == []
    # an undeclared edge is refused, not taken
    with pytest.raises(AssertionError, match="undeclared tenant"):
        gate.gateway._advance(gate.gateway._jobs[good["job"]], "queued")
