"""Crash-safe serving in the port (``racon_tpu_torch.serve``): the durable
journal, restart recovery, slot supervision, the drain protocol and the
retrying client, the counterparts of ``tests/test_serve_recovery.py``, on
the CPU with the host engines.

- the kill-restart soak: four jobs on a two-slot server (a subprocess,
  ``python -m racon_tpu_torch --serve ... --device cpu``) killed by
  ``server.kill:kill@3``, restarted on the same ``--serve-dir`` through
  ``python -m racon_tpu_torch.serve``: every job
  gives its one-shot bytes, jobs done before the kill are not re-polished,
  the idempotency key dedupes across the restart, and the report's
  ``recovery`` counts match;
- a restart serves done jobs from the spool and requeues queued ones; a
  corrupt spool requeues its job; tmp litter is swept; compaction bounds
  the journal; a failed append rolls back its partial write; journal fault
  injection keeps the admission contract; replay tolerates a torn tail; a
  double submit under one key is idempotent;
- a dead slot restarts with fresh engines (the dead slot's dropped);
  repeated deaths quarantine it; the drain protocol; the client's connect
  retries, socket-fault retries and deterministic backoff;
- across packages: the same appends give the JAX ``JobJournal``'s journal
  and spool bytes, and each package's journal replays in the other's
  server.
"""

import errno
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from racon_tpu import faults as jax_faults
from racon_tpu.serve import journal as jax_journal
from racon_tpu_torch import faults
from racon_tpu_torch.obs import buildwatch, metrics
from racon_tpu_torch.obs.report import validate_report
from racon_tpu_torch.serve import journal as journal_mod
from racon_tpu_torch.serve import protocol
from racon_tpu_torch.serve.client import ServiceClient
from racon_tpu_torch.serve.journal import JobJournal
from racon_tpu_torch.serve.service import PolishServer
from tests.test_serve import _assembly, _spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("RACON_TPU_SANITIZE", "RACON_TPU_FAULTS",
                 "RACON_TPU_SERVE_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RACON_TPU_SERVE_WARM_SHAPES", "")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    faults.reset()
    yield
    faults.reset()
    torch.set_num_threads(saved)


@pytest.fixture()
def short_tmp():
    with tempfile.TemporaryDirectory(dir="/tmp", prefix="trc") as td:
        yield td


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RACON_TPU_")}
    return dict(env, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                RACON_TPU_SERVE_WARM_SHAPES="", **extra)


def _oneshot(triple):
    proc = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch", "-w", "150", "-t", "2",
         *triple], capture_output=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    return proc.stdout


class _Server:
    def __init__(self, td, **kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("num_threads", 2)
        self.server = PolishServer(os.path.join(td, "racon.sock"), **kw)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        assert self.server.started.wait(60), "server did not start"
        return self.server

    def __exit__(self, exc_type, exc, tb):
        self.server.shutdown()
        self.thread.join(timeout=60)
        buildwatch.reset()
        return False


def _records(serve_dir):
    with open(os.path.join(serve_dir, "journal.jsonl"), "rb") as f:
        return [json.loads(line) for line in f.read().splitlines()
                if line.strip()]


def _running_counts(records):
    counts = {}
    for r in records:
        if r.get("rec") == "running":
            counts[r["job"]] = counts.get(r["job"], 0) + 1
    return counts


def _wait_state(c, jid, states=("done", "failed"), timeout=300):
    deadline = time.monotonic() + timeout
    st = c.status(jid)
    while st["state"] not in states:
        assert time.monotonic() < deadline, st
        time.sleep(0.1)
        st = c.status(jid)
    return st


def _start(cmd, env, log, sock):
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stderr=log,
                            stdout=subprocess.DEVNULL)
    deadline = time.monotonic() + 120
    while not os.path.exists(sock):
        assert time.monotonic() < deadline, "server did not start"
        assert proc.poll() is None, "server died at startup"
        time.sleep(0.1)
    return proc


# ------------------------------------------------------- kill-server soak

def test_chaos_kill_restart_soak(short_tmp):
    n_jobs = 4
    triples = [_assembly(short_tmp, [3000 + 150 * i], seed=11 + i,
                         prefix=f"k{i}") for i in range(n_jobs)]
    with ThreadPoolExecutor(n_jobs) as pool:
        want = list(pool.map(_oneshot, triples))
    sock = os.path.join(short_tmp, "racon.sock")
    serve_dir = os.path.join(short_tmp, "serve_dir")
    cmd = [sys.executable, "-m", "racon_tpu_torch", "--serve", sock,
           "--serve-dir", serve_dir, "-w", "150", "-t", "2", "--workers",
           "2", "--device", "cpu"]
    job_ids = []
    with open(os.path.join(short_tmp, "a.log"), "wb") as log:
        server_a = _start(cmd, _env(RACON_TPU_FAULTS="server.kill:kill@3"),
                          log, sock)
        try:
            # all four submissions in one write, so each is admitted before
            # the third job's start kills the server (the first two polish
            # for tens of milliseconds; an admission takes a few)
            with ServiceClient(sock, timeout_s=60) as c:
                c.sock.sendall(b"".join(
                    protocol.encode({"op": "submit", "spec": _spec(*t),
                                     "key": f"soak{i}"})
                    for i, t in enumerate(triples)))
                for _ in triples:
                    resp = protocol.read_msg(c.rfile)
                    assert resp["ok"], resp
                    job_ids.append(resp["job"])
            server_a.wait(timeout=300)
            assert server_a.returncode == -9
        finally:
            if server_a.poll() is None:
                server_a.kill()
                server_a.wait()
    pre = _records(serve_dir)
    done_jobs = {r["job"] for r in pre if r.get("rec") == "done"}
    assert 1 <= len(done_jobs) < n_jobs
    for j in done_jobs:
        assert _running_counts(pre)[j] == 1
    os.unlink(sock)  # the SIGKILL left it behind
    # the restart through the module entry, python -m racon_tpu_torch.serve
    cmd_b = [sys.executable, "-m", "racon_tpu_torch.serve", sock,
             *cmd[5:]]
    with open(os.path.join(short_tmp, "b.log"), "wb") as log:
        server_b = _start(cmd_b, _env(), log, sock)
        try:
            post = _running_counts(_records(serve_dir))
            for j in done_jobs:
                assert post.get(j, 0) == 1, post
            with ServiceClient(sock, timeout_s=60) as c:
                dup = c.submit(_spec(*triples[0]), key="soak0")
                assert dup["ok"] and dup["existing"]
                assert dup["job"] == job_ids[0]
            report = None
            for i, jid in enumerate(job_ids):
                with ServiceClient(sock, timeout_s=600) as c:
                    header, payload = c.result(jid, timeout_s=550)
                    assert header["ok"], (jid, header)
                    assert payload == want[i], jid
                    report = header.get("report") or report
            assert report is not None and validate_report(report) == []
            rec = report["recovery"]
            assert rec["recovered_jobs"] == n_jobs
            assert rec["served_from_spool"] == len(done_jobs)
            assert rec["requeued_jobs"] == n_jobs - len(done_jobs)
            assert rec["journal_replayed"] > 0
            assert rec["journal_compactions"] >= 1
            with ServiceClient(sock, timeout_s=60) as c:
                c.shutdown(mode="drain")
            assert server_b.wait(timeout=120) == 0
        finally:
            if server_b.poll() is None:
                server_b.kill()
                server_b.wait()
    # every job was collected: the exit compaction left nothing behind
    assert _records(serve_dir) == []
    assert os.listdir(os.path.join(serve_dir, "spool")) == []
    assert not any(".tmp" in n for n in os.listdir(serve_dir))


# --------------------------------------------- in-process restart recovery

def test_restart_serves_done_from_spool(short_tmp):
    triple = _assembly(short_tmp, [2000], seed=7)
    want = _oneshot(triple)
    serve_dir = os.path.join(short_tmp, "sd")
    with _Server(short_tmp, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            jid = c.submit(_spec(*triple), key="spool1")["job"]
            assert _wait_state(c, jid)["state"] == "done"
        assert server._jobs[jid].result is None  # no payload in RAM
        assert os.path.exists(os.path.join(serve_dir, "spool",
                                           f"result_{jid}.fasta"))
    base = metrics.counter("serve.spool_served")
    with _Server(short_tmp, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            header, payload = c.result(jid, timeout_s=60)
            assert header["ok"] and payload == want
            assert server._jobs[jid].journal_runs == 1
            dup = c.submit(_spec(*triple), key="spool1")
            assert dup["ok"] and dup["existing"] and dup["job"] == jid
    assert metrics.counter("serve.spool_served") == base + 1


def test_restart_requeues_queued_jobs(short_tmp):
    triple = _assembly(short_tmp, [1800], seed=19)
    want = _oneshot(triple)
    serve_dir = os.path.join(short_tmp, "sd")
    with _Server(short_tmp, autostart=False, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            j1 = c.submit(_spec(*triple))["job"]
            j2 = c.submit(_spec(*triple))["job"]
    base = metrics.counter("serve.requeued_jobs")
    with _Server(short_tmp, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            for jid in (j1, j2):
                header, payload = c.result(jid, timeout_s=300)
                assert header["ok"] and payload == want
            j3 = c.submit(_spec(*triple))["job"]
    assert metrics.counter("serve.requeued_jobs") == base + 2
    assert (j1, j2, j3) == ("j1", "j2", "j3")  # the ids carry on


def test_corrupt_spool_requeues_job(short_tmp):
    triple = _assembly(short_tmp, [1900], seed=23)
    want = _oneshot(triple)
    serve_dir = os.path.join(short_tmp, "sd")
    with _Server(short_tmp, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            jid = c.submit(_spec(*triple))["job"]
            assert _wait_state(c, jid)["state"] == "done"
    spool = os.path.join(serve_dir, "spool", f"result_{jid}.fasta")
    with open(spool, "r+b") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 0xFF]))
    base = metrics.counter("serve.spool_corrupt")
    with _Server(short_tmp, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            header, payload = c.result(jid, timeout_s=300)
            assert header["ok"] and payload == want
            assert server._jobs[jid].journal_runs >= 2
    assert metrics.counter("serve.spool_corrupt") == base + 1


def test_tmp_litter_swept_on_startup(short_tmp):
    serve_dir = os.path.join(short_tmp, "sd")
    spool = os.path.join(serve_dir, "spool")
    os.makedirs(spool)
    litter = [os.path.join(serve_dir, "journal.jsonl.tmp"),
              os.path.join(spool, "result_j1.fasta.tmp.7.8")]
    for p in litter:
        with open(p, "wb") as f:
            f.write(b"torn")
    assert JobJournal(serve_dir).sweep_tmp() == 0  # the constructor swept
    for p in litter:
        assert not os.path.exists(p), p


def test_journal_compaction_bounds_size(short_tmp, monkeypatch):
    monkeypatch.setattr(JobJournal, "compact_every", 4)
    triple = _assembly(short_tmp, [1600], seed=29)
    serve_dir = os.path.join(short_tmp, "sd")
    base = metrics.counter("serve.journal_compactions")
    with _Server(short_tmp, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path, timeout_s=600) as c:
            for _ in range(5):
                jid = c.submit(_spec(*triple))["job"]
                header, payload = c.result(jid, timeout_s=300)
                assert header["ok"] and payload
                deadline = time.monotonic() + 30
                while not server._jobs[jid].collected:
                    assert time.monotonic() < deadline
                    time.sleep(0.02)
    assert metrics.counter("serve.journal_compactions") > base + 1
    assert _records(serve_dir) == []
    assert os.path.getsize(os.path.join(serve_dir, "journal.jsonl")) == 0
    assert os.listdir(os.path.join(serve_dir, "spool")) == []


def test_append_retry_rolls_back_partial_write(short_tmp, monkeypatch):
    j = JobJournal(os.path.join(short_tmp, "sd"))
    j.append({"rec": "submitted", "job": "j1", "cost": 1, "key": None,
              "unix": 0.0, "spec": {}})
    real = journal_mod.mf.append_durable
    state = {"fired": False}

    def flaky(f, blob):
        if not state["fired"]:
            state["fired"] = True
            f.write(blob[: len(blob) // 2])
            f.flush()
            raise faults.TransientIOError(errno.EIO, "partial append")
        real(f, blob)

    monkeypatch.setattr(journal_mod.mf, "append_durable", flaky)
    j.append({"rec": "running", "job": "j1", "worker": "w", "run": 1})
    monkeypatch.setattr(journal_mod.mf, "append_durable", real)
    assert [r["rec"] for r in j.replay()] == ["submitted", "running"]
    j.close()
    j.append({"rec": "done", "job": "j1"})  # closed: a no-op
    assert len(j.replay()) == 2


def test_journal_fault_injection_admission_contract(short_tmp,
                                                    monkeypatch):
    serve_dir = os.path.join(short_tmp, "sd")
    triple = _assembly(short_tmp, [2200], seed=23)
    with _Server(short_tmp, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            monkeypatch.setenv("RACON_TPU_FAULTS", "serve.journal:io@1")
            sub = c.submit(_spec(*triple), key="k-blip")
            assert sub["ok"], sub
            header, payload = c.result(sub["job"], timeout_s=300)
            assert header["ok"] and payload.startswith(b">ctg0")
            monkeypatch.setenv("RACON_TPU_FAULTS", "serve.journal:err*")
            rej = c.submit(_spec(*triple), key="k-dur")
            assert not rej["ok"] and "journal write failed" in rej["error"]
            monkeypatch.delenv("RACON_TPU_FAULTS")
            assert c.ping()["ok"]
            sub2 = c.submit(_spec(*triple), key="k-dur")
            assert sub2["ok"], sub2
            header2, payload2 = c.result(sub2["job"], timeout_s=300)
            assert header2["ok"] and payload2 == payload
    recs = JobJournal(serve_dir).replay()
    assert {r["job"] for r in recs} <= {sub["job"], sub2["job"]}


def test_journal_replay_tolerates_torn_tail(short_tmp):
    j = JobJournal(os.path.join(short_tmp, "sd"))
    j.append({"rec": "submitted", "job": "j1", "cost": 1, "key": None,
              "unix": 0.0, "spec": {}})
    j.append({"rec": "running", "job": "j1", "worker": "w", "run": 1})
    j.close()
    with open(j.path, "ab") as f:
        f.write(b'{"rec": "done", "job": "j1", "by')
    recs = JobJournal(os.path.join(short_tmp, "sd")).replay()
    assert [r["rec"] for r in recs] == ["submitted", "running"]


def test_idempotent_double_submit(short_tmp):
    triple = _assembly(short_tmp, [1700], seed=37)
    serve_dir = os.path.join(short_tmp, "sd")
    with _Server(short_tmp, autostart=False, serve_dir=serve_dir) as server:
        with ServiceClient(server.socket_path) as c:
            r1 = c.submit(_spec(*triple), key="K")
            assert r1["ok"] and not r1["existing"]
            r2 = c.submit(_spec(*triple), key="K")
            assert r2["ok"] and r2["existing"] and r2["job"] == r1["job"]
            r3 = c.submit(_spec(*triple), key="K2")
            assert r3["ok"] and not r3["existing"]
            assert r3["job"] != r1["job"]
            bad = c._roundtrip({"op": "submit", "spec": _spec(*triple),
                                "key": 5})
            assert not bad["ok"] and "must be a string" in bad["error"]
            with server._lock:
                assert len(server._queue) == 2
            assert server._counts["submitted"] == 2


# --------------------------------------------------------- slot supervision

@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_slot_death_restarts_with_fresh_engines(short_tmp, monkeypatch):
    monkeypatch.setenv("RACON_TPU_FAULTS", "serve.slot:err@1")
    faults.reset()
    triple = _assembly(short_tmp, [1900], seed=41)
    want = _oneshot(triple)
    base = metrics.counter("slot.restarts")
    with _Server(short_tmp) as server:
        dead = server._chip_slots()[0]
        assert dead.engines is not None  # the warm pool built them
        with ServiceClient(server.socket_path) as c:
            header, payload = c.result(c.submit(_spec(*triple))["job"],
                                       timeout_s=300)
        fresh = server._chip_slots()[0]
    assert header["ok"] and payload == want
    assert "crash" in [a["class"] for a in header["attempts"]]
    assert metrics.counter("slot.restarts") == base + 1
    # the dead slot's engines were dropped; the fresh slot built its own
    assert fresh is not dead and fresh.worker == dead.worker
    assert dead.engines is None and dead.cpu_engines is None
    assert fresh.engines is not None


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_repeated_slot_deaths_quarantine(short_tmp, monkeypatch):
    monkeypatch.setenv("RACON_TPU_FAULTS", "serve.slot:err*")
    faults.reset()
    triple = _assembly(short_tmp, [1700], seed=43)
    base = metrics.counter("slot.quarantined")
    with _Server(short_tmp) as server:
        with ServiceClient(server.socket_path) as c:
            header, payload = c.result(c.submit(_spec(*triple))["job"],
                                       timeout_s=120)
            assert not header["ok"] and header["state"] == "failed"
            acts = [a["action"] for a in header["attempts"]]
            assert acts.count("requeue") == 2 and acts[-1] == "fail"
            deadline = time.monotonic() + 30
            while server.healthy_workers() > 0:
                assert time.monotonic() < deadline
                time.sleep(0.2)
            r = c.submit(_spec(*triple))
            assert not r["ok"] and "quarantined" in r["error"]
            assert c.stats()["slots"] == {"healthy": 0, "quarantined": 1}
    assert metrics.counter("slot.quarantined") == base + 1


# ------------------------------------------------------------------ drain

def test_drain_protocol(short_tmp):
    triple = _assembly(short_tmp, [1700], seed=47)
    serve_dir = os.path.join(short_tmp, "sd")
    harness = _Server(short_tmp, autostart=False, serve_dir=serve_dir)
    with harness as server:
        with ServiceClient(server.socket_path) as c:
            jid = c.submit(_spec(*triple))["job"]
        drainer = ServiceClient(server.socket_path)
        resp = drainer.shutdown(mode="drain")
        assert resp["ok"] and resp["state"] == "draining"
        drainer.close()
        with ServiceClient(server.socket_path) as c:
            r = c.submit(_spec(*triple))
            assert not r["ok"] and "drain" in r["error"]
            assert c.ping()["draining"]
            server.start_workers()
            header, payload = c.result(jid, timeout_s=300, keep=True)
            assert header["ok"] and payload
        deadline = time.monotonic() + 60
        while not server._stop.is_set():
            assert time.monotonic() < deadline, "drain never completed"
            time.sleep(0.2)
    harness.thread.join(60)
    recs = _records(serve_dir)
    assert {r["rec"] for r in recs} == {"submitted", "running", "done"}
    assert all(r["job"] == jid for r in recs)


def test_stop_wakes_accept_where_listener_shutdown_fails(short_tmp,
                                                         monkeypatch):
    """Where ``shutdown(SHUT_RDWR)`` refuses a listening socket (ENOTCONN,
    as under gVisor) and ``close`` leaves ``accept`` blocked, the stop's
    wake-up connection still ends the accept loop."""
    real_bind = PolishServer._bind

    class Listener:
        def __init__(self, sock):
            self.sock = sock

        def accept(self):
            return self.sock.accept()

        def shutdown(self, how):
            raise OSError(errno.ENOTCONN, "Transport endpoint is not "
                                          "connected")

        def close(self):
            pass  # the real socket closes at the test's end

    made = []

    def bind(self):
        made.append(real_bind(self))
        return Listener(made[-1])

    monkeypatch.setattr(PolishServer, "_bind", bind)
    harness = _Server(short_tmp, autostart=False)
    with harness as server:
        with ServiceClient(server.socket_path) as c:
            assert c.ping()["ok"]
    assert not harness.thread.is_alive()
    made[0].close()


# --------------------------------------------------------- retrying client

def test_client_connect_retries_until_server_up(short_tmp):
    sock = os.path.join(short_tmp, "racon.sock")
    with pytest.raises(ConnectionError, match="1 attempt"):
        ServiceClient(sock, retries=0)
    harness = _Server(short_tmp, autostart=False)

    def late_start():
        time.sleep(1.0)
        harness.thread.start()

    threading.Thread(target=late_start, daemon=True).start()
    try:
        c = ServiceClient(sock, timeout_s=60, retries=20, backoff_s=0.2)
        assert c.ping()["ok"]
        c.close()
    finally:
        assert harness.server.started.wait(60)
        harness.server.shutdown()
        harness.thread.join(timeout=30)
        buildwatch.reset()


def test_client_socket_fault_injection_retries(short_tmp, monkeypatch):
    with _Server(short_tmp, autostart=False) as server:
        monkeypatch.setenv("RACON_TPU_FAULTS", "serve.socket:io@1")
        faults.reset()
        c = ServiceClient(server.socket_path, retries=3, backoff_s=0.0)
        assert c.ping()["ok"]
        c.close()
        assert metrics.counter("faults.injected.serve.socket") >= 1
        monkeypatch.setenv("RACON_TPU_FAULTS", "serve.socket:io*")
        faults.reset()
        with pytest.raises(ConnectionError, match="3 attempt"):
            ServiceClient(server.socket_path, retries=2, backoff_s=0.0)


def test_backoff_is_deterministic_and_equals_jax():
    a = faults.backoff_s(0.5, 0, "tok")
    assert a == faults.backoff_s(0.5, 0, "tok")
    assert 0.375 <= a <= 0.625
    assert faults.backoff_s(0.5, 3, "tok") == a * 8
    assert faults.backoff_s(0.0, 5, "x") == 0.0
    for k in range(5):
        assert faults.backoff_s(0.25, k, f"key:{k}") == \
            jax_faults.backoff_s(0.25, k, f"key:{k}")


# ------------------------------------------------------ across packages

_APPENDS = [
    {"rec": "submitted", "job": "j1", "key": "k1", "cost": 4096,
     "unix": 1700000000.125,
     "spec": {"sequences": "/d/r.fastq", "overlaps": "/d/o.paf",
              "target_sequences": "/d/t.fasta",
              "fragment_correction": False, "window_length": 150,
              "quality_threshold": 10.0, "error_threshold": 0.3,
              "no_trimming": False, "match": 3, "mismatch": -5, "gap": -4,
              "banded": False, "threads": 2, "include_unpolished": False,
              "tenant": "default", "priority": 0}},
    {"rec": "running", "job": "j1", "worker": "h:1", "run": 1},
    {"rec": "done", "job": "j1", "bytes": 12, "crc32": 0, "spool":
     "result_j1.fasta", "wall_s": 0.5, "engine": "primary"},
    {"rec": "collected", "job": "j1"},
    {"rec": "failed", "job": "j2", "error": "ünï — x"},
]


def test_journal_and_spool_bytes_equal_jax(short_tmp):
    dirs = {}
    for name, mod in (("port", journal_mod), ("jax", jax_journal)):
        d = dirs[name] = os.path.join(short_tmp, name)
        j = mod.JobJournal(d)
        for rec in _APPENDS:
            j.append(rec)
        spooled = j.spool_write("j1", b">ctg0\nACGT\n")
        assert j.spool_read("j1", spooled[1], spooled[2]) == \
            b">ctg0\nACGT\n"
        assert j.spool_read("j1", spooled[1], spooled[2] ^ 1) is None
        j.rewrite(_APPENDS[:2])
        j.append(_APPENDS[4])
        j.close()
        dirs[name + "_spool"] = spooled
    assert dirs["port_spool"] == dirs["jax_spool"]
    for rel in ("journal.jsonl", os.path.join("spool", "result_j1.fasta")):
        with open(os.path.join(dirs["port"], rel), "rb") as f:
            port = f.read()
        with open(os.path.join(dirs["jax"], rel), "rb") as f:
            assert f.read() == port, rel
    for name, mod in (("port", journal_mod), ("jax", jax_journal)):
        assert mod.JobJournal(dirs[name]).replay() == \
            _APPENDS[:2] + [_APPENDS[4]]
    assert journal_mod.JobJournal(dirs["jax"]).replay() == \
        jax_journal.JobJournal(dirs["port"]).replay()


def test_each_journal_replays_in_the_other_package(short_tmp):
    """A port server's serve dir restarts a JAX server's recovery, and a
    JAX-written journal restarts a port server: the same jobs, states and
    crash ladders come back."""
    from racon_tpu.serve.service import PolishServer as JaxServer
    triple = _assembly(short_tmp, [1600], seed=53)
    spec = _spec(*triple)
    port_dir = os.path.join(short_tmp, "port")
    with _Server(short_tmp, autostart=False, serve_dir=port_dir) as server:
        with ServiceClient(server.socket_path) as c:
            c.submit(spec, key="a")
            c.submit(spec, key="b")
    jax_dir = os.path.join(short_tmp, "jax")
    j = jax_journal.JobJournal(jax_dir)
    for rec in _records(port_dir):
        j.append(rec)
    j.append({"rec": "running", "job": "j1", "worker": "w", "run": 1})
    j.close()
    views = []
    for cls, d, extra in ((PolishServer, jax_dir, {"device": "cpu"}),
                          (JaxServer, port_dir, {})):
        srv = cls(os.path.join(short_tmp, "x.sock"), autostart=False,
                  serve_dir=d, **extra)
        srv._recover()
        views.append(sorted((jid, job.state, job.key, job.crash_count)
                            for jid, job in srv._jobs.items()))
        srv._journal.close()
    assert views[0] == [("j1", "queued", "a", 1), ("j2", "queued", "b", 0)]
    assert views[1] == [("j1", "queued", "a", 0), ("j2", "queued", "b", 0)]
