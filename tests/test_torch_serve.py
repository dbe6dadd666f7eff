"""The port's resident polishing service (``racon_tpu_torch.serve``) against
the JAX package's (``racon_tpu.serve``), on the CPU: servers run with
``device="cpu"``, on the host engines unless a case says otherwise.

- the wire protocol's messages and ``normalize_spec`` equal JAX's on a
  table of specs, errors included;
- three concurrent jobs on a two-slot pool give the port one-shot CLI's
  bytes, which equal the JAX one-shot CLI's;
- a device-engine job (the plain kernels on the CPU) gives the port CLI's
  ``-c 1 --cudaaligner-batches 1`` bytes;
- ``--submit`` streams the same bytes and works with the default
  ``--device cuda`` on a host without a card;
- every admission reason is JAX's string; cancel and queue order; a result
  survives a dead client; the footprint bounds concurrency;
- the ``serve.polish`` ladder (``err@1``, ``io@1``, ``err*``), the server
  surviving each, and with ``primary_on_card`` forced the ladder fails with
  the reason instead of taking a CPU rung (in the per-job ladder and at a
  second crash);
- job reports are kind ``job``, pass both validators and hold disjoint
  scopes; the layer-producer thread inherits the scope;
- the warm pool seals the build watch: a build on a job's thread lands in
  that job's scope (and fails it under the sanitizer), the next job
  records 0 builds;
- ``parse_warm_shapes`` equals JAX's; ``PolishServer(device="cuda")``
  raises on a host without a card;
- the shared pieces: the admission cost model equals JAX's, ``JOB_MACHINE``
  and ``JOURNAL_RECORDS`` equal JAX's, every state a job is given is an
  edge of the machine, and the CLI's serve parser errors equal JAX's.

Inputs: ``tests/test_serve.py``'s synthetic assemblies (contigs of 1.8-3
kbp, 0.9 kbp reads, ``-w 150``).
"""

import io
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

from racon_tpu import contracts as jax_contracts
from racon_tpu.exec import planner as jax_planner
from racon_tpu.obs.report import validate_report as jax_validate
from racon_tpu.serve import protocol as jax_protocol
from racon_tpu.serve import service as jax_service
from racon_tpu_torch import cli, contracts, faults
from racon_tpu_torch.exec import planner
from racon_tpu_torch.obs import buildwatch, metrics
from racon_tpu_torch.obs.report import validate_report
from racon_tpu_torch.serve import protocol, service
from racon_tpu_torch.serve.client import ServiceClient
from racon_tpu_torch.serve.service import PolishServer, parse_warm_shapes
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
    """AF_UNIX socket paths are bounded near 107 bytes: sockets live in a
    short /tmp directory."""
    with tempfile.TemporaryDirectory(dir="/tmp", prefix="tsv") as td:
        yield td


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")


def _oneshot(module, triple, *extra):
    """The one-shot CLI's stdout (``module``: the port or the JAX
    package)."""
    proc = subprocess.run(
        [sys.executable, "-m", module, "-w", "150", "-t", "2", *extra,
         *triple], capture_output=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    return proc.stdout


class _Server:
    """An in-process server on a thread, always shut down and joined."""

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
        # the server's explicit seal is process-wide: later runs of this
        # process seal at their first launch again
        buildwatch.reset()
        return False


def _run(c, spec, timeout_s=300, **kw):
    sub = c.submit(spec, **kw)
    assert sub["ok"], sub
    return c.result(sub["job"], timeout_s=timeout_s)


# --------------------------------------------------------------- protocol

_SPECS = [
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa"},
    {"sequences": "r.fq", "overlaps": "auto", "target_sequences": "t.fa",
     "window_length": 200, "quality_threshold": 7, "banded": True,
     "threads": 4, "tenant": "lab", "priority": 3},
    "not a dict",
    {"sequences": "r.fq"},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "frobnicate": 1},
    {"sequences": "", "overlaps": "o.paf", "target_sequences": "t.fa"},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "banded": 1},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "match": True},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "error_threshold": "x"},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "tenant": 5},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "window_length": 0},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "threads": 0},
    {"sequences": "r.fq", "overlaps": "o.paf", "target_sequences": "t.fa",
     "tenant": ""},
]


@pytest.mark.parametrize("k", range(len(_SPECS)))
def test_normalize_spec_equals_jax(k):
    assert protocol.normalize_spec(_SPECS[k]) == \
        jax_protocol.normalize_spec(_SPECS[k])


def test_protocol_messages_equal_jax():
    assert protocol.SPEC_DEFAULTS == jax_protocol.SPEC_DEFAULTS
    assert protocol.SPEC_KEYS == jax_protocol.SPEC_KEYS
    msg = {"op": "result", "job": "j3", "timeout_s": 5.5, "keep": False,
           "spec": {"tenant": "ünï"}}
    assert protocol.encode(msg) == jax_protocol.encode(msg)
    for mod in (protocol, jax_protocol):
        assert mod.read_msg(io.BytesIO(b"")) is None
        with pytest.raises(ValueError, match="not an object"):
            mod.read_msg(io.BytesIO(b"[1, 2]\n"))
        with pytest.raises(ValueError):
            mod.read_msg(io.BytesIO(b"not json\n"))
        assert mod.read_exact(io.BytesIO(b"abcdef"), 4) == b"abcd"
    errs = []
    for mod in (protocol, jax_protocol):
        with pytest.raises(ConnectionError) as e:
            mod.read_exact(io.BytesIO(b"ab"), 5)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "3 bytes short" in errs[0]


def test_protocol_roundtrip_and_error_paths(short_tmp):
    reads, paf, layout = _assembly(short_tmp, [2000], seed=4)
    with _Server(short_tmp) as server:
        with ServiceClient(server.socket_path) as c:
            pong = c.ping()
            assert pong["ok"] and pong["workers"] == 1
            assert pong["profile"] == {"match": 3, "mismatch": -5,
                                       "gap": -4, "banded": False}
            bad = c._roundtrip({"op": "frobnicate"})
            assert not bad["ok"] and "unknown op" in bad["error"]
            assert "unknown job" in c.status("j999")["error"]
            assert "unknown shutdown mode" in \
                c._roundtrip({"op": "shutdown", "mode": "x"})["error"]
            header, payload = _run(c, _spec(reads, paf, layout))
            assert header["ok"] and header["bytes"] == len(payload)
            assert header["state"] == "done" and header["engine"] == \
                "primary"
            again, none = c.result(header["job"], timeout_s=10)
            assert none is None and "already collected" in again["error"]
            stats = c.stats()
            assert stats["done"] == 1 and stats["slots"]["healthy"] == 1
        with ServiceClient(server.socket_path) as c:
            c.sock.sendall(b"this is not json\n")
            resp = protocol.read_msg(c.rfile)
            assert not resp["ok"] and "bad request" in resp["error"]
        with ServiceClient(server.socket_path) as c:
            assert c.ping()["ok"]


# ------------------------------------------------------ bytes vs the CLIs

def test_concurrent_jobs_equal_port_and_jax_cli(short_tmp):
    """Three jobs at once on a two-slot pool: each gives the port one-shot
    CLI's bytes, and those equal the JAX one-shot CLI's."""
    triples = [_assembly(short_tmp, [2200 + 400 * i], seed=11 + i,
                         prefix=f"w{i}") for i in range(3)]
    with ThreadPoolExecutor(6) as pool:
        port = list(pool.map(lambda t: _oneshot("racon_tpu_torch", t),
                             triples))
        jax = list(pool.map(lambda t: _oneshot("racon_tpu", t), triples))
    assert port == jax
    got = [None] * 3
    with _Server(short_tmp, workers=2) as server:
        def one(i):
            with ServiceClient(server.socket_path) as c:
                header, payload = _run(c, _spec(*triples[i]))
                assert header["ok"], header
                got[i] = (header, payload)

        with ThreadPoolExecutor(3) as pool:
            list(pool.map(one, range(3)))
        assert server._counts["done"] == 3
        assert server.healthy_workers() == 2
    assert [p for _, p in got] == port
    reports = [h["report"] for h, _ in got]
    for rep in reports:
        assert rep["kind"] == "job"
        assert validate_report(rep) == [] and jax_validate(rep) == []
    # disjoint scopes: each report counts its own job's windows only
    assert len({rep["argv"][0] for rep in reports}) == 3
    for h, _ in got:
        assert metrics.group(metrics.job_scope(h["job"])) == {}


def test_device_engine_job_equals_port_cli(short_tmp):
    """A server with the device engines (their plain PyTorch versions on
    the CPU) polishes the port CLI's ``-c 1 --cudaaligner-batches 1``
    bytes."""
    triple = _assembly(short_tmp, [1800], seed=5)
    want = _oneshot("racon_tpu_torch", triple, "-c", "1",
                    "--cudaaligner-batches", "1", "--device", "cpu")
    with _Server(short_tmp, aligner_backend="cuda",
                 consensus_backend="cuda") as server:
        assert not server.primary_on_card()
        with ServiceClient(server.socket_path) as c:
            header, payload = _run(c, _spec(*triple))
        slot = server._chip_slots()[0]
        assert type(slot.engines[0]).__name__ == "CudaAligner"
        assert type(slot.engines[1]).__name__ == "CudaPoaConsensus"
    assert header["ok"] and payload == want
    rep = header["report"]
    assert rep["pack"]["align_chunks"] > 0 and rep["pack"]["groups"] > 0
    assert rep["metrics"]["timers"]["align.dispatch"] > 0


def test_submit_cli_streams_the_same_bytes(short_tmp):
    """``python -m racon_tpu_torch --submit`` with the default ``--device
    cuda`` works without a card (the device is the server's) and streams
    the one-shot bytes; ``--run-report`` writes the job's report."""
    triple = _assembly(short_tmp, [2600], seed=5)
    want = _oneshot("racon_tpu_torch", triple)
    report_path = os.path.join(short_tmp, "job.json")
    with _Server(short_tmp) as server:
        proc = subprocess.run(
            [sys.executable, "-m", "racon_tpu_torch", "-w", "150", "-t",
             "2", "--submit", server.socket_path, "--run-report",
             report_path, *triple], capture_output=True, timeout=300,
            cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert proc.stdout == want
    assert b"done in" in proc.stderr and b"submitted" in proc.stderr
    with open(report_path) as f:
        rep = json.load(f)
    assert rep["kind"] == "job" and validate_report(rep) == []


# -------------------------------------------------------------- admission

def _admit_both(td, raw, key=None, **kw):
    """The same admission on a port and a JAX server that never start
    (the JAX reason is the reference)."""
    out = []
    for mod, extra in ((service, {"device": "cpu"}), (jax_service, {})):
        srv = mod.PolishServer(os.path.join(td, "x.sock"),
                               autostart=False, **extra, **kw)
        srv._warm_job_geometry = lambda spec: False
        out.append(srv)
    return out


def test_admission_reasons_equal_jax(short_tmp):
    reads, paf, layout = _assembly(short_tmp, [2000], seed=3)
    txt = os.path.join(short_tmp, "reads.txt")
    with open(txt, "w") as f:
        f.write("x")
    cases = [
        ({}, _spec(reads, paf, layout, match=5), "engine profile"),
        ({}, _spec("/nonexistent.fasta", paf, layout), "input not found"),
        ({}, {"sequences": reads}, "missing input path"),
        ({}, _spec(txt, paf, layout), "unsupported format"),
        ({}, _spec(reads, txt, layout), "unsupported format"),
        ({"budget_bytes": 16 << 10}, _spec(reads, paf, layout),
         "exceeds the service budget"),
    ]
    for kw, spec, fragment in cases:
        port, jax = _admit_both(short_tmp, spec, **kw)
        got = [srv._admit(spec) for srv in (port, jax)]
        assert got[0][0] is None and got[1][0] is None
        assert got[0][1] == got[1][1] and fragment in got[0][1], got
    port, jax = _admit_both(short_tmp, None, max_queue=1)
    reasons = []
    for srv in (port, jax):
        assert srv._admit(_spec(reads, paf, layout))[0] is not None
        reasons.append(srv._admit(_spec(reads, paf, layout))[1])
        srv._draining = True
        reasons.append(srv._admit(_spec(reads, paf, layout))[1])
        srv._draining = False
        srv._slots, srv._quarantined = [], {0}
        reasons.append(srv._admit(_spec(reads, paf, layout))[1])
    assert reasons[:3] == reasons[3:]
    assert "queue full" in reasons[0] and "draining" in reasons[1]
    assert "quarantined" in reasons[2]


def test_cancel_and_queue_order(short_tmp):
    reads, paf, layout = _assembly(short_tmp, [2000], seed=9)
    with _Server(short_tmp, autostart=False) as server:
        with ServiceClient(server.socket_path) as c:
            j1 = c.submit(_spec(reads, paf, layout))["job"]
            j2 = c.submit(_spec(reads, paf, layout))["job"]
            assert c.status(j1)["queue_position"] == 0
            assert c.status(j2)["queue_position"] == 1
            r = c.cancel(j1)
            assert r["ok"] and r["state"] == "cancelled"
            assert c.status(j2)["queue_position"] == 0
            server.start_workers()
            header, payload = c.result(j2, timeout_s=300)
            assert header["ok"] and payload
            h1, p1 = c.result(j1, timeout_s=10)
            assert not h1["ok"] and p1 is None
            assert h1["state"] == "cancelled"
            r = c.cancel(j2)
            assert not r["ok"] and "not queued" in r["error"]
            r = c.preempt(j2)
            assert not r["ok"] and "already terminal" in r["error"]


def test_preempt_releases_a_queued_job(short_tmp):
    reads, paf, layout = _assembly(short_tmp, [1800], seed=2)
    with _Server(short_tmp, autostart=False) as server:
        with ServiceClient(server.socket_path) as c:
            spec = _spec(reads, paf, layout, tenant="lab", priority=2)
            j1 = c.submit(spec)["job"]
            assert c.stats()["tenants"] == {"lab": 1}
            st = c.status(j1)
            assert st["tenant"] == "lab" and st["priority"] == 2
            r = c.preempt(j1)
            assert r["ok"] and r["drained"] and r["state"] == "cancelled"


def test_result_survives_dead_client(short_tmp):
    reads, paf, layout = _assembly(short_tmp, [2200], seed=41)
    with _Server(short_tmp, autostart=False) as server:
        with ServiceClient(server.socket_path) as c:
            job_id = c.submit(_spec(reads, paf, layout))["job"]
            bad = c._roundtrip({"op": "result", "job": job_id,
                                "timeout_s": "soon"})
            assert not bad["ok"] and "bad request field" in bad["error"]
            assert c.ping()["ok"]
        dead = ServiceClient(server.socket_path)
        protocol.send_msg(dead.sock, {"op": "result", "job": job_id,
                                      "timeout_s": 300})
        time.sleep(0.2)
        dead.close()
        server.start_workers()
        with ServiceClient(server.socket_path) as c:
            header, payload = c.result(job_id, timeout_s=300)
        assert header["ok"], header
        assert payload and payload.startswith(b">ctg0")
    assert metrics.group(metrics.job_scope(job_id)) == {}


def test_footprint_bounds_concurrency(short_tmp):
    """Two jobs that fit the budget alone but not together run one after
    the other on a two-slot pool."""
    reads, paf, layout = _assembly(short_tmp, [2400], seed=17)
    cost = planner.estimate_job_cost(reads, paf, layout)
    with _Server(short_tmp, workers=2,
                 budget_bytes=int(1.5 * cost)) as server:
        with ServiceClient(server.socket_path) as c:
            j1 = c.submit(_spec(reads, paf, layout))["job"]
            j2 = c.submit(_spec(reads, paf, layout))["job"]
            h1, p1 = c.result(j1, timeout_s=300)
            h2, p2 = c.result(j2, timeout_s=300)
    assert h1["ok"] and h2["ok"] and p1 == p2
    job1, job2 = server._jobs[j1], server._jobs[j2]
    assert job2.started_at >= job1.started_at + job1.wall_s - 0.05


# ------------------------------------------------------------ fault ladder

def test_fault_ladder_and_server_survival(short_tmp, monkeypatch):
    monkeypatch.setenv("RACON_TPU_EXEC_BACKOFF_S", "0")
    triple = _assembly(short_tmp, [2400], seed=13)
    want = _oneshot("racon_tpu_torch", triple)
    with _Server(short_tmp) as server:
        with ServiceClient(server.socket_path) as c:
            monkeypatch.setenv("RACON_TPU_FAULTS", "serve.polish:err@1")
            header, payload = _run(c, _spec(*triple))
            assert header["ok"] and payload == want
            assert header["engine"] == "cpu-retry"
            assert [a["action"] for a in header["attempts"]] == \
                ["cpu-retry"]

            monkeypatch.setenv("RACON_TPU_FAULTS", "serve.polish:io@1")
            header, payload = _run(c, _spec(*triple))
            assert header["ok"] and payload == want
            assert header["engine"] == "primary"
            assert [a["action"] for a in header["attempts"]] == \
                ["retry-backoff"]

            monkeypatch.setenv("RACON_TPU_FAULTS", "serve.polish:err*")
            header, payload = _run(c, _spec(*triple))
            assert not header["ok"] and header["state"] == "failed"
            assert payload is None and "InjectedFault" in header["error"]
            assert [a["action"] for a in header["attempts"]] == \
                ["cpu-retry", "fail"]
            rep = header["report"]
            assert validate_report(rep) == [] and jax_validate(rep) == []
            assert rep["faults"].get("deterministic-compute", 0) >= 2

            monkeypatch.delenv("RACON_TPU_FAULTS")
            header, payload = _run(c, _spec(*triple))
            assert header["ok"] and payload == want
        assert server._counts["failed"] == 1


def test_on_card_ladder_fails_instead_of_a_cpu_rung(short_tmp,
                                                    monkeypatch):
    """With the slots' primary engines on the card (forced here), a
    deterministic fault fails the job with the reason, the host engines
    are never built, and a job at its second crash fails at once."""
    monkeypatch.setattr(PolishServer, "primary_on_card", lambda self: True)
    monkeypatch.setenv("RACON_TPU_FAULTS", "serve.polish:err@1")
    reads, paf, layout = _assembly(short_tmp, [1800], seed=21)
    with _Server(short_tmp) as server:
        with ServiceClient(server.socket_path) as c:
            header, payload = _run(c, _spec(reads, paf, layout))
        assert server._chip_slots()[0].cpu_engines is None
    assert not header["ok"] and payload is None
    assert [a["action"] for a in header["attempts"]] == ["fail"]
    assert "no CPU rung" in header["error"]
    monkeypatch.delenv("RACON_TPU_FAULTS")
    faults.reset()
    srv = PolishServer(os.path.join(short_tmp, "y.sock"), device="cpu",
                       autostart=False)
    job = service.Job("j9", protocol.normalize_spec(
        _spec(reads, paf, layout))[0], 1)
    job.crash_count = 2
    slot = srv._chip_slots()[0]
    srv._run_job(slot, job)
    assert job.state == "failed" and "no CPU rung" in job.error
    assert job.attempts[-1]["action"] == "fail"
    assert slot.engines is None and slot.cpu_engines is None


# ------------------------------------------------- per-job observability

def test_interleaved_job_scopes_stay_disjoint():
    """A run boundary (``clear_run``) in one job's thread leaves another
    job's scoped numbers alone, and two jobs' scopes never mix."""
    barrier = threading.Barrier(2, timeout=30)
    results = {}

    def job(name, val):
        metrics.set_scope(metrics.job_scope(name))
        try:
            metrics.set_gauge("queue.depth", val)
            metrics.inc("consensus.groups", val)
            metrics.add_time("align.dispatch", val / 10.0)
            barrier.wait()
            if name == "B":
                metrics.clear_run()
            barrier.wait()
            results[name] = metrics.group(metrics.job_scope(name))
        finally:
            metrics.set_scope(None)

    threads = [threading.Thread(target=job, args=a)
               for a in (("A", 3), ("B", 7))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert results["A"]["queue.depth"] == 3
    assert results["A"]["consensus.groups"] == 3
    assert results["B"]["consensus.groups"] == 7
    assert results["B"]["align.dispatch"] == pytest.approx(0.7)
    snap = metrics.snapshot(metrics.job_scope("A"))
    assert snap["counters"] == {"consensus.groups": 3}
    assert metrics.queue_summary(metrics.job_scope("A"))["depth"] == 3
    metrics.clear_job("A")
    metrics.clear_job("B")
    assert metrics.group(metrics.job_scope("A")) == {}
    assert {"queue.depth", "consensus.groups"} <= metrics.seen_names()


def test_producer_thread_inherits_the_job_scope(short_tmp):
    reads, paf, layout = _assembly(short_tmp, [2400], seed=29)
    metrics.clear("queue.")
    with _Server(short_tmp) as server:
        with ServiceClient(server.socket_path) as c:
            header, _ = _run(c, _spec(reads, paf, layout, threads=2))
    assert header["ok"]
    rep = header["report"]
    assert "queue.producer_wait_s" in rep["metrics"]["timers"]
    assert "build.windows" in rep["metrics"]["timers"]
    assert metrics.timer_s("queue.producer_wait_s") == 0.0
    assert "align_dispatch_s" in rep["phases"]


def test_warm_pool_seals_and_job_builds_land_in_its_scope(short_tmp,
                                                          monkeypatch):
    """The warm pool loads the native library and seals the build watch. A
    build on job 1's thread lands in job 1's scope (its ``compile_s``, its
    report's ``compiles``, ``compiles_after_warm``); job 2 records 0
    builds; under the sanitizer the warm-path assert fails such a job and
    the server serves on."""
    reads, paf, layout = _assembly(short_tmp, [1800], seed=33)
    real = PolishServer._polish
    builds = {"j1": 0.25, "j3": 0.125}

    def polish(self, job, worker, cpu):
        if job.id in builds:
            buildwatch.record("walk_vote", builds[job.id], "nvcc")
        return real(self, job, worker, cpu)

    monkeypatch.setattr(PolishServer, "_polish", polish)
    with _Server(short_tmp) as server:
        assert buildwatch.sealed() == "serve warm pool"
        with ServiceClient(server.socket_path) as c:
            h1, p1 = _run(c, _spec(reads, paf, layout))
            h2, p2 = _run(c, _spec(reads, paf, layout))
            monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
            h3, p3 = _run(c, _spec(reads, paf, layout))
            h4, p4 = _run(c, _spec(reads, paf, layout))
    assert h1["ok"] and h2["ok"] and p1 == p2 == p4
    assert h1["compile_s"] == 0.25 and h1["compiles_after_warm"] == 1
    assert h1["report"]["compiles"]["count"] == 1
    assert h1["report"]["compiles"]["post_warm"] == 1
    assert h1["report"]["dispatch_fetch"]["compile_s"] == 0.25
    assert h2["compile_s"] == 0.0 and h2["compiles_after_warm"] == 0
    assert h2["report"]["compiles"] == dict(
        h2["report"]["compiles"], count=0, post_warm=0, sealed=1,
        total_s=0.0)
    assert not h3["ok"] and "warm-path assert" in h3["error"]
    assert h3["compiles_after_warm"] == 1
    assert h4["ok"] and h4["compiles_after_warm"] == 0
    assert buildwatch.post_warm() == []


def test_warm_shapes_parsed_at_start_and_equal_jax(short_tmp,
                                                   monkeypatch, capsys):
    for raw in ("500:131072:8192:8", "500:10:5, 250:4:2:7", "", " , "):
        assert parse_warm_shapes(raw) == jax_service.parse_warm_shapes(raw)
    for raw in ("500:10", "500:0:5", "a:b:c", "1:2:3:4:5"):
        errs = []
        for fn in (parse_warm_shapes, jax_service.parse_warm_shapes):
            with pytest.raises(ValueError) as e:
                fn(raw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    monkeypatch.setenv("RACON_TPU_SERVE_WARM_SHAPES", "500:4096:512:4,1:2:3")
    with _Server(short_tmp, autostart=False):
        pass
    assert "2 warm shape profile(s)" in capsys.readouterr().err
    monkeypatch.setenv("RACON_TPU_SERVE_WARM_SHAPES", "500:4096")
    srv = PolishServer(os.path.join(short_tmp, "b.sock"), device="cpu")
    with pytest.raises(ValueError, match="window_length:pairs:windows"):
        srv.serve_forever()
    assert not os.path.exists(srv.socket_path)


def test_cuda_server_raises_without_a_card(short_tmp):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    sock = os.path.join(short_tmp, "c.sock")
    with pytest.raises(RuntimeError, match="CUDA"):
        PolishServer(sock)
    with pytest.raises(RuntimeError, match="CUDA"):
        PolishServer(sock, aligner_backend="cuda",
                     consensus_backend="cuda", device="cuda")
    assert not os.path.exists(sock)
    assert cli.main(["--serve", sock]) == 1


# --------------------------------------------------------- shared pieces

def test_job_cost_equals_jax(short_tmp):
    import gzip
    reads, paf, layout = _assembly(short_tmp, [2000], seed=8)
    gz = reads + ".gz"
    with open(reads, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    for triple in ((reads, paf, layout), (gz, paf, layout),
                   (reads, "auto", layout)):
        want = jax_planner.estimate_job_cost(*triple)
        assert planner.estimate_job_cost(*triple) == want
        assert planner.cached_job_cost(*triple) == want
        hits = metrics.counter("fleet.cost_cache_hits")
        assert planner.cached_job_cost(*triple) == want
        assert metrics.counter("fleet.cost_cache_hits") == hits + 1
        assert planner._spec_fingerprint(*triple) == \
            jax_planner._spec_fingerprint(*triple)
    assert planner.input_cost_bytes(gz) == \
        jax_planner.input_cost_bytes(gz)
    with pytest.raises(OSError):
        planner.cached_job_cost("/nonexistent.fq", paf, layout)


def test_job_machine_equals_jax():
    port, jax = contracts.JOB_MACHINE, jax_contracts.JOB_MACHINE
    assert (port.name, port.states, port.edges, port.initial) == \
        (jax.name, jax.states, jax.edges, jax.initial)
    assert port.terminal == jax.terminal
    assert contracts.JOURNAL_RECORDS == jax_contracts.JOURNAL_RECORDS
    assert port in contracts.MACHINES
    assert contracts.JOB_SCOPE_ROOT == jax_contracts.JOB_SCOPE_ROOT
    assert contracts.selfcheck() == []
    for site in ("serve.polish", "serve.journal", "serve.socket",
                 "serve.slot", "server.kill"):
        assert site in contracts.FAULT_SITES
    assert service.QUEUED is contracts.JOB_QUEUED
    assert service.DONE is contracts.JOB_DONE


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_every_job_state_write_is_a_machine_edge(short_tmp, monkeypatch):
    """Each state a job is given, across a done job, a cancelled one, a
    failed one, a slot death's re-queue and a corrupt spool's re-queue,
    walks ``JOB_MACHINE``'s edges from ``queued``."""
    walks = {}

    class Recorded(service.Job):
        def __setattr__(self, name, value):
            if name == "state":
                if "state" in self.__dict__:
                    walks[self.id].append(value)
                else:
                    walks[self.id] = [value]
            object.__setattr__(self, name, value)

    monkeypatch.setattr(service, "Job", Recorded)
    monkeypatch.setenv("RACON_TPU_EXEC_BACKOFF_S", "0")
    reads, paf, layout = _assembly(short_tmp, [1700], seed=37)
    sd = os.path.join(short_tmp, "sd")
    with _Server(short_tmp, autostart=False, serve_dir=sd) as server:
        with ServiceClient(server.socket_path) as c:
            j1 = c.submit(_spec(reads, paf, layout))["job"]
            j2 = c.submit(_spec(reads, paf, layout))["job"]
            assert c.cancel(j2)["ok"]
            monkeypatch.setenv("RACON_TPU_FAULTS", "serve.slot:err@1")
            faults.reset()
            server.start_workers()
            h1, p1 = c.result(j1, timeout_s=300)
            assert h1["ok"] and "crash" in [a["class"]
                                           for a in h1["attempts"]]
            monkeypatch.setenv("RACON_TPU_FAULTS", "serve.polish:err*")
            h3, _ = _run(c, _spec(reads, paf, layout))
            assert not h3["ok"]
            monkeypatch.delenv("RACON_TPU_FAULTS")
            j4 = c.submit(_spec(reads, paf, layout))["job"]
            deadline = time.monotonic() + 300
            while c.status(j4)["state"] != "done":
                assert time.monotonic() < deadline
                time.sleep(0.1)
            with open(os.path.join(sd, "spool", f"result_{j4}.fasta"),
                      "r+b") as f:
                f.write(b"X")
            bad, none = c.result(j4, timeout_s=10)
            assert none is None and "re-queued" in bad["error"]
            h4, p4 = c.result(j4, timeout_s=300)
            assert h4["ok"] and p4 == p1
    machine = contracts.JOB_MACHINE
    assert len(walks) == 4
    for jid, walk in walks.items():
        bad = [(a, b) for a, b in zip(walk, walk[1:])
               if not machine.has_edge(a, b)]
        assert bad == [], (jid, walk)
    assert walks[j1][:4] == ["queued", "running", "queued", "running"]
    assert walks[j2] == ["queued", "cancelled"]
    assert walks[j4][-4:] == ["done", "queued", "running", "done"]


@pytest.mark.parametrize("argv", [
    ["--serve-dir", "d", "r.fq", "o.paf", "t.fa"],
    ["--serve", "s.sock", "r.fq", "o.paf", "t.fa"],
    ["--serve", "s.sock", "--submit", "s.sock"],
    ["--submit", "s.sock", "r.fq"],
    [],
])
def test_serve_parser_errors_equal_jax(argv, capsys):
    from racon_tpu import cli as jax_cli
    lines = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(list(argv))
        assert e.value.code == 2
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert lines[0] == lines[1] and lines[0].startswith("racon: error:")
