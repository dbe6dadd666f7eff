"""The port's fleet (``racon_tpu_torch.fleet``: tenants, registry, gateway)
against the JAX package's (``racon_tpu.fleet``), on the CPU. Hosts are
in-process ``PolishServer(..., device="cpu")`` members on the host engines
unless a case says otherwise; the gateway runs on an ephemeral TCP port.

- ``parse_tenants`` and ``parse_gateway_address`` give JAX's values and
  errors on a table of strings; ``TenantScheduler`` gives JAX's pop order,
  depths and admit messages on one seeded sequence of calls over three
  tenants, besides the JAX unit cases (stride fairness, priority and
  requeue order, budgets);
- a beacon has JAX's keys and member name for the same socket, and each
  package's ``read_hosts`` reads the other's beacons; job leases have
  JAX's file names and a lease held by hand ages out and is broken by one
  of several claimants;
- one job through the gateway and two hosts gives the JAX one-shot CLI's
  bytes, and the gateway journal's records equal the JAX gateway's for the
  same sequence (times and ids masked); a fleet dir one package's gateway
  left with a done, uncollected job is served by the other's from its
  spool with no host;
- a host on the device engines (their plain versions) gives the port
  CLI's ``-c 1 --cudaaligner-batches 1`` bytes; the report's ``fleet``
  section has JAX's keys, counts the gateway's admissions and placements,
  and is zeros in a plain polish;
- the JAX cases of ``tests/test_fleet.py`` that are not chaos: stats,
  budgets, restart from the spool, ``shutdown now`` recovery, host-local
  rejections, the worker-count cache, the CLI's ``--gateway`` and
  ``--submit HOST:PORT --tenant --priority``.

The chaos cases are in ``tests/test_torch_fleet_chaos.py``. Inputs:
``tests/test_fleet.py``'s ``_assembly`` (a 2 kbp contig, 0.9 kbp reads,
``-w 150``).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from racon_tpu.exec import lease as jax_lease
from racon_tpu.fleet import gateway as jax_gateway
from racon_tpu.fleet import registry as jax_registry
from racon_tpu.fleet import tenants as jax_tenants
from racon_tpu.obs import metrics as jax_metrics
from racon_tpu.obs.report import validate_report as jax_validate
from racon_tpu.serve import service as jax_service
from racon_tpu_torch import contracts, faults
from racon_tpu_torch.exec import lease as lease_mod
from racon_tpu_torch.exec.planner import cached_job_cost
from racon_tpu_torch.fleet import gateway as gateway_mod
from racon_tpu_torch.fleet import registry, tenants
from racon_tpu_torch.fleet.gateway import Gateway, parse_gateway_address
from racon_tpu_torch.fleet.registry import HostBeacon, host_ttl_s, read_hosts
from racon_tpu_torch.fleet.tenants import TenantScheduler, parse_tenants
from racon_tpu_torch.obs import buildwatch, metrics
from racon_tpu_torch.obs import report as report_mod
from racon_tpu_torch.serve.client import ServiceClient, parse_tcp_address
from racon_tpu_torch.serve.service import PolishServer
from tests.test_fleet import _assembly, _spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLEET_ENV = {"RACON_TPU_SERVE_WARM_SHAPES": "",
             "RACON_TPU_FLEET_HOST_TTL_S": "1.0",
             "RACON_TPU_FLEET_POLL_S": "0.05"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("RACON_TPU_SANITIZE", "RACON_TPU_FAULTS",
                 "RACON_TPU_SERVE_DIR", "RACON_TPU_FLEET_TENANTS"):
        monkeypatch.delenv(name, raising=False)
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
    with tempfile.TemporaryDirectory(dir="/tmp", prefix="tfl") as td:
        yield td


@pytest.fixture()
def fast_fleet(monkeypatch):
    """Test-scale fleet timing: a tight beacon TTL and placement poll, no
    warm-shape profile."""
    for name, value in FLEET_ENV.items():
        monkeypatch.setenv(name, value)
    yield monkeypatch


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                **FLEET_ENV, **extra)


def _oneshot(module, triple, *extra):
    """The one-shot CLI's stdout (``module``: the port or the JAX
    package)."""
    proc = subprocess.run(
        [sys.executable, "-m", module, "-w", "150", "-t", "2", *extra,
         *triple], capture_output=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    return proc.stdout


class _Host:
    """An in-process fleet member: a server with a ``fleet_dir`` beacon,
    ``serve_forever`` on a thread, always shut down and joined."""

    def __init__(self, td, name, fleet_dir, server_cls=PolishServer, **kw):
        if server_cls is PolishServer:
            kw.setdefault("device", "cpu")
        kw.setdefault("num_threads", 2)
        self.server = server_cls(os.path.join(td, f"{name}.sock"),
                                 fleet_dir=fleet_dir, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        assert self.server.started.wait(60), "host did not start"
        return self.server

    def __exit__(self, exc_type, exc, tb):
        self.server.shutdown()
        self.thread.join(timeout=60)
        buildwatch.reset()
        return False


class _Gate:
    """An in-process gateway on an ephemeral TCP port."""

    def __init__(self, fleet_dir, gateway_cls=Gateway, **kw):
        self.gateway = gateway_cls("127.0.0.1:0", fleet_dir, **kw)
        self.thread = threading.Thread(target=self.gateway.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        assert self.gateway.started.wait(60), "gateway did not start"
        self.address = f"127.0.0.1:{self.gateway.port}"
        return self

    def __exit__(self, exc_type, exc, tb):
        self.gateway.shutdown("now")
        self.thread.join(timeout=60)
        return False

    def client(self, timeout_s=300.0):
        return ServiceClient(self.address, timeout_s=timeout_s)

    def wait_hosts(self, n, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self.client(timeout_s=10.0) as c:
                if c.ping().get("hosts", {}).get("alive", 0) >= n:
                    return
            time.sleep(0.05)
        raise AssertionError(f"{n} hosts never registered")


def journal_records(fleet_dir):
    path = os.path.join(fleet_dir, "journal.jsonl")
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        return [json.loads(line) for line in f.read().splitlines()
                if line.strip()]


def _kinds(records, job):
    out = {}
    for r in records:
        if r.get("job") == job:
            out[r["rec"]] = out.get(r["rec"], 0) + 1
    return out


def tenant_walk(records):
    """Each job's journal records as a walk of ``TENANT_MACHINE``: a
    ``submitted`` record is ``accepted`` (the gateway then queues it),
    ``running`` is ``placed``, the terminal records and ``collected`` are
    their states. Returns the (job, from, to) steps that are not edges."""
    machine = contracts.TENANT_MACHINE
    state = {}
    bad = []
    for r in records:
        job, rec = r.get("job"), r.get("rec")
        if rec == "submitted":
            steps = [(None, contracts.TENANT_ACCEPTED),
                     (contracts.TENANT_ACCEPTED, contracts.TENANT_QUEUED)]
        else:
            to = contracts.TENANT_PLACED if rec == "running" else rec
            steps = [(state.get(job), to)]
        for frm, to in steps:
            if frm is not None and not machine.has_edge(frm, to):
                bad.append((job, frm, to))
            state[job] = to
    return bad


# --------------------------------------------------- the JAX-parity units

TENANT_STRINGS = ("alpha:3,beta:1:512M, gamma:2.5:1G", "", " , ",
                  "solo:1:0", "x:2:1500", "alpha", "alpha:x", "alpha:0",
                  "alpha:-1", ":3", "alpha:1:2:3", "a:1,b:inf:1G",
                  "a:1e-3:2K")


@pytest.mark.parametrize("raw", TENANT_STRINGS)
def test_parse_tenants_equals_jax(raw):
    def parse(mod):
        try:
            return mod.parse_tenants(raw)
        except ValueError as e:
            return ("error", str(e))
    assert parse(tenants) == parse(jax_tenants)


def test_parse_tenants_grammar():
    cfg = parse_tenants("alpha:3,beta:1:512M, gamma:2.5:1G")
    assert cfg["alpha"] == (3.0, 0)
    assert cfg["beta"] == (1.0, 512 << 20)
    assert cfg["gamma"] == (2.5, 1 << 30)
    assert parse_tenants("") == {}
    for bad in ("alpha", "alpha:x", "alpha:0", "alpha:-1", ":3",
                "alpha:1:2:3"):
        with pytest.raises(ValueError):
            parse_tenants(bad)


def test_stride_weighted_fairness():
    """alpha:3 against beta:1 drains 3:1 over any window, and an idle
    tenant banks no credit to monopolize later."""
    sched = TenantScheduler(parse_tenants("alpha:3,beta:1"))
    for i in range(12):
        sched.push("alpha", f"a{i}")
    for i in range(4):
        sched.push("beta", f"b{i}")
    first8 = [sched.pop()[0] for _ in range(8)]
    assert first8.count("alpha") == 6 and first8.count("beta") == 2
    while sched.pop() is not None:
        pass
    for i in range(20):
        sched.push("alpha", f"a2{i}")
    for _ in range(10):
        assert sched.pop()[0] == "alpha"
    sched.push("beta", "late")
    order = [sched.pop()[0] for _ in range(4)]
    assert "beta" in order and order.count("alpha") >= 2


def test_priority_and_requeue_ordering():
    sched = TenantScheduler()
    sched.push("t", "low1", priority=0)
    sched.push("t", "hi", priority=5)
    sched.push("t", "low2", priority=0)
    assert sched.peek_priority() == ("t", 5, "hi")
    assert sched.pop() == ("t", "hi")
    assert sched.pop() == ("t", "low1")
    # a drained or migrated job goes back to the front of its class
    sched.push("t", "low3", priority=0)
    sched.requeue("t", "drained", priority=0)
    assert sched.pop() == ("t", "drained")
    assert sched.remove("t", "low3")
    assert not sched.remove("t", "low3")
    assert sched.pop() == ("t", "low2")
    assert len(sched) == 0 and sched.depths() == {}


def test_budget_admit_check_rejects_with_reason():
    sched = TenantScheduler(parse_tenants("cap:1:10M"))
    assert sched.admit_check("cap", 6 << 20) is None
    sched.charge("cap", 6 << 20)
    reason = sched.admit_check("cap", 6 << 20)
    assert reason is not None and "budget exhausted" in reason
    assert "cap" in reason and "RACON_TPU_FLEET_TENANTS" in reason
    sched.uncharge("cap", 6 << 20)
    assert sched.admit_check("cap", 6 << 20) is None
    assert sched.admit_check("stranger", 1 << 40) is None


def _scheduler_ops(seed=2026, n=600):
    """One seeded sequence of scheduler calls over three tenants (items
    are shared objects, so ``remove`` finds the same one in both
    packages)."""
    rng = np.random.default_rng(seed)
    names = ("alpha", "beta", "gamma")
    items = [f"job{i}" for i in range(n)]
    kinds = ("push", "push", "push", "requeue", "pop", "pop", "remove",
             "charge", "uncharge", "admit", "peek")
    ops = []
    for i in range(n):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        tenant = names[int(rng.integers(0, 3))]
        item = items[int(rng.integers(0, i + 1))]
        ops.append((kind, tenant, item, int(rng.integers(-1, 4)),
                    int(rng.integers(0, 3 << 20))))
    return ops


def _drive(mod, ops):
    sched = mod.TenantScheduler(mod.parse_tenants(
        "alpha:3:4M,beta:1:2M,gamma:2"))
    log = []
    for kind, tenant, item, prio, cost in ops:
        if kind == "push":
            out = sched.push(tenant, item, prio)
        elif kind == "requeue":
            out = sched.requeue(tenant, item, prio)
        elif kind == "pop":
            out = sched.pop()
        elif kind == "remove":
            out = sched.remove(tenant, item)
        elif kind == "charge":
            out = sched.charge(tenant, cost)
        elif kind == "uncharge":
            out = sched.uncharge(tenant, cost)
        elif kind == "admit":
            out = sched.admit_check(tenant, cost)
        else:
            out = sched.peek_priority()
        log.append((kind, out, sched.depths(), len(sched),
                    {t: sched.charged_bytes(t) for t in
                     ("alpha", "beta", "gamma")}))
    return log


def test_scheduler_matches_jax_on_a_seeded_sequence():
    ops = _scheduler_ops()
    port, jax = _drive(tenants, ops), _drive(jax_tenants, ops)
    assert port == jax
    pops = [out for kind, out, *_ in port if kind == "pop" and out]
    assert {t for t, _ in pops} == {"alpha", "beta", "gamma"}
    assert any(kind == "admit" and out for kind, out, *_ in port)
    assert any(kind == "remove" and out for kind, out, *_ in port)
    assert tenants.STRIDE_ONE == jax_tenants.STRIDE_ONE == 2.0 ** 20


ADDRESSES = ("127.0.0.1:9000", ":0", "[::1]:80", "host:0", "a:b:7",
             "nope", "host:port", "host:-1", "host:", "h:+5", "")


@pytest.mark.parametrize("address", ADDRESSES)
def test_gateway_address_parsing_equals_jax(address):
    def parse(mod):
        try:
            return mod.parse_gateway_address(address)
        except ValueError as e:
            return ("error", str(e))
    assert parse(gateway_mod) == parse(jax_gateway)


def test_gateway_address_parsing():
    assert parse_gateway_address("127.0.0.1:9000") == ("127.0.0.1", 9000)
    assert parse_gateway_address(":0") == ("127.0.0.1", 0)
    for bad in ("nope", "host:port", "host:-1"):
        with pytest.raises(ValueError):
            parse_gateway_address(bad)
    assert parse_tcp_address("127.0.0.1:9000") == ("127.0.0.1", 9000)
    assert parse_tcp_address("/tmp/racon.sock") is None
    assert parse_tcp_address("racon.sock:9000") == ("racon.sock", 9000)
    assert gateway_mod.DEFAULT_RESULT_TIMEOUT_S == \
        jax_gateway.DEFAULT_RESULT_TIMEOUT_S == 600.0


# ------------------------------------------------- registry and leases

def test_host_beacon_lifecycle(short_tmp, fast_fleet):
    """Announce -> alive; a stale mtime -> not alive, healed by the
    keeper; stop -> withdrawn."""
    beacon = HostBeacon(short_tmp, socket_path="/tmp/h0.sock",
                        name="h0").start()
    try:
        hosts = read_hosts(short_tmp)
        assert "h0" in hosts and hosts["h0"]["alive"]
        assert hosts["h0"]["socket"] == "/tmp/h0.sock"
        stale = time.time() - 10 * host_ttl_s()
        os.utime(beacon.path, (stale, stale))
        assert not read_hosts(short_tmp)["h0"]["alive"]
        deadline = time.monotonic() + 10
        while not read_hosts(short_tmp).get("h0", {}).get("alive"):
            assert time.monotonic() < deadline, \
                "beacon keeper never refreshed the heartbeat"
            time.sleep(0.05)
    finally:
        beacon.stop()
    assert "h0" not in read_hosts(short_tmp)


@pytest.mark.parametrize("path", ["/tmp/node-7.sock", "/x/racon.sock",
                                  "/x/a b+c.s.sock", "/x/.sock",
                                  "/x/plain", "rel/h1.sock"])
def test_host_name_equals_jax(path):
    assert registry.host_name(path) == jax_registry.host_name(path)


def test_beacons_read_across_packages(short_tmp, fast_fleet):
    """The same socket gives both packages' beacons the same member name
    and keys; each package's ``read_hosts`` reads the other's beacon."""
    sock = os.path.join(short_tmp, "node-7.sock")
    port_dir = os.path.join(short_tmp, "pf")
    jax_dir = os.path.join(short_tmp, "jf")
    pb = HostBeacon(port_dir, sock)
    jb = jax_registry.HostBeacon(jax_dir, sock)
    pb.announce()
    jb.announce()
    with open(pb.path) as f:
        port_doc = json.load(f)
    with open(jb.path) as f:
        jax_doc = json.load(f)
    assert pb.name == jb.name == "node-7"
    assert os.path.relpath(pb.path, port_dir) == \
        os.path.relpath(jb.path, jax_dir) == "hosts/node-7.json"
    assert set(port_doc) == set(jax_doc)
    assert {k: v for k, v in port_doc.items() if k != "registered_unix"} \
        == {k: v for k, v in jax_doc.items() if k != "registered_unix"}
    for reader, d in ((jax_registry.read_hosts, port_dir),
                      (read_hosts, jax_dir)):
        hosts = reader(d)
        assert list(hosts) == ["node-7"]
        assert hosts["node-7"]["alive"]
        assert hosts["node-7"]["socket"] == sock
    stale = time.time() - 60
    os.utime(pb.path, (stale, stale))
    assert not jax_registry.read_hosts(port_dir)["node-7"]["alive"]


def _age(path, seconds):
    """Set a lease file's mtime ``seconds`` into the past: a lease whose
    heartbeats stopped that long ago."""
    past = time.time() - seconds
    os.utime(path, (past, past))


def test_job_leases_match_jax_and_age_out(tmp_path):
    """String job ids and integer shard ids name JAX's lease files; a
    lease claimed with the keeper off stays held while heartbeats come by
    hand (each one undoes an aged mtime), then ages out and exactly one of
    eight claimants breaks it, after which the old owner's heartbeat
    reports the loss."""
    d = str(tmp_path)
    for sid in ("job_g1", "job_g12", 0, 7, 1234):
        assert lease_mod.lease_path(d, sid) == jax_lease.lease_path(d, sid)
    assert lease_mod.lease_path(d, 7).endswith("lease_0007.json")
    ttl = 30.0
    lease = lease_mod.try_claim(d, "job_g1", worker="h0", ttl_s=ttl,
                                keeper=False)
    assert lease is not None and lease._keeper is None
    assert os.path.basename(lease.path) == "lease_job_g1.json"
    info = lease_mod.read_lease(d, "job_g1")
    assert info["worker"] == "h0"
    assert set(jax_lease.read_lease(d, "job_g1")) >= \
        {"worker", "pid", "host", "claimed_unix"}
    for _ in range(3):
        _age(lease.path, ttl / 2)
        assert lease.heartbeat()
        assert time.time() - os.stat(lease.path).st_mtime < ttl / 4
        assert lease_mod.try_claim(d, "job_g1", worker="h1", ttl_s=ttl,
                                   keeper=False) is None
    _age(lease.path, 2 * ttl)
    won = []
    barrier = threading.Barrier(8)

    def claim(i):
        barrier.wait()
        got = lease_mod.try_claim(d, "job_g1", worker=f"c{i}", ttl_s=ttl,
                                  keeper=False)
        if got is not None:
            won.append(got)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(won) == 1
    assert not lease.heartbeat() and lease.lost.is_set()
    assert lease_mod.read_lease(d, "job_g1")["worker"] == won[0].worker
    assert won[0].heartbeat()
    assert not os.path.exists(lease.path + lease_mod.BREAK_SUFFIX)
    lease.release()           # lost: the winner's file stays
    assert lease_mod.read_lease(d, "job_g1")["worker"] == won[0].worker
    won[0].release()
    assert not os.path.exists(won[0].path)
    kept = lease_mod.try_claim(d, 3, worker="w")
    assert kept is not None and kept._keeper is not None
    kept.release()


def test_job_lease_reused_inode_is_lost(tmp_path, monkeypatch):
    """A reclaimer's lease that the filesystem gives the broken lease's
    inode number (forced: every stat in the lease module reports the old
    inode) is still another claim: the old owner's heartbeat returns
    False and its release leaves the reclaimer's file."""
    d = str(tmp_path)
    ttl = 30.0
    old = lease_mod.try_claim(d, "job_g2", worker="h0", ttl_s=ttl,
                              keeper=False)
    old_ino = os.stat(old.path).st_ino
    _age(old.path, 2 * ttl)
    real_stat, real_fstat = os.stat, os.fstat

    def same_ino(st):
        fields = list(st)
        fields[1] = old_ino
        extra = {k: getattr(st, k) for k in dir(st)
                 if k.startswith("st_") and k not in (
                     "st_mode", "st_ino", "st_dev", "st_nlink", "st_uid",
                     "st_gid", "st_size")}
        return os.stat_result(fields, extra)

    with monkeypatch.context() as m:
        m.setattr(lease_mod.os, "stat",
                  lambda *a, **k: same_ino(real_stat(*a, **k)))
        m.setattr(lease_mod.os, "fstat",
                  lambda fd: same_ino(real_fstat(fd)))
        new = lease_mod.try_claim(d, "job_g2", worker="h1", ttl_s=ttl,
                                  keeper=False)
        assert new is not None
        assert os.stat(new.path).st_ino == old_ino
        assert not old.heartbeat() and old.lost.is_set()
        assert new.heartbeat() and not new.lost.is_set()
    old.release()
    assert lease_mod.read_lease(d, "job_g2")["worker"] == "h1"
    new.release()
    assert not os.path.exists(new.path)


def test_job_lease_break_has_one_winner(tmp_path, monkeypatch):
    """The interleaving that let one break yield two winners, forced
    through a hook on the breaker's first removal of the stale lease from
    its path (an unlink, or a rename to a tombstone): while claimant A
    breaks it, B tries to break it too (just before A's removal) and C
    finds the path empty (just after it). Exactly one of the three holds
    a lease, it is the one on disk, and the old owner has lost it."""
    d = str(tmp_path)
    ttl = 30.0
    old = lease_mod.try_claim(d, "job_g3", worker="h0", ttl_s=ttl,
                              keeper=False)
    _age(old.path, 2 * ttl)
    got = {}
    hooked = []

    def hook(real):
        def remove(path, *a, **k):
            if hooked or not str(path).endswith("lease_job_g3.json"):
                return real(path, *a, **k)
            hooked.append(path)
            got["B"] = lease_mod.try_claim(d, "job_g3", worker="B",
                                           ttl_s=ttl, keeper=False)
            real(path, *a, **k)
            got["C"] = lease_mod.try_claim(d, "job_g3", worker="C",
                                           ttl_s=ttl, keeper=False)
        return remove

    with monkeypatch.context() as m:
        m.setattr(lease_mod.os, "unlink", hook(os.unlink))
        m.setattr(lease_mod.os, "rename", hook(os.rename))
        got["A"] = lease_mod.try_claim(d, "job_g3", worker="A", ttl_s=ttl,
                                       keeper=False)
    assert hooked
    won = [k for k, v in got.items() if v is not None]
    assert len(won) == 1, got
    (winner,) = won
    assert lease_mod.read_lease(d, "job_g3")["worker"] == winner
    assert got[winner].heartbeat()
    assert not old.heartbeat() and old.lost.is_set()
    assert [n for n in os.listdir(d)] == ["lease_job_g3.json"]
    got[winner].release()


def test_job_lease_break_lock_handover(tmp_path, monkeypatch):
    """The break lock's handover, forced through a hook on ``flock``:
    claimant B opens the lock file while A holds it, and before B's flock
    lands A lets go (unlinking the file) and C takes a fresh lock file. B's
    flock then succeeds on A's unlinked file, which B must see and give
    up: only C holds the lock, on the file the path names."""
    path = lease_mod.lease_path(str(tmp_path), "job_g4")
    lock = path + lease_mod.BREAK_SUFFIX
    a_fd = lease_mod._take_break_lock(path)
    assert a_fd is not None and os.path.exists(lock)
    real = lease_mod.fcntl
    held = {}

    class Hooked:
        LOCK_EX, LOCK_NB = real.LOCK_EX, real.LOCK_NB

        @staticmethod
        def flock(fd, op):
            if "C" not in held:
                lease_mod.fcntl = real
                lease_mod._drop_break_lock(path, a_fd)
                held["C"] = lease_mod._take_break_lock(path)
                lease_mod.fcntl = Hooked
            return real.flock(fd, op)

    with monkeypatch.context() as m:
        m.setattr(lease_mod, "fcntl", Hooked)
        b_fd = lease_mod._take_break_lock(path)
    assert held["C"] is not None and b_fd is None
    assert os.fstat(held["C"]).st_ino == os.stat(lock).st_ino
    assert lease_mod._take_break_lock(path) is None
    lease_mod._drop_break_lock(path, held["C"])
    assert not os.path.exists(lock)


_HOLD_LOCKS = (
    "import fcntl, os, sys, time\n"
    "fds = [os.open(p, os.O_CREAT | os.O_RDWR) for p in sys.argv[1:]]\n"
    "for fd in fds:\n"
    "    fcntl.flock(fd, fcntl.LOCK_EX)\n"
    "print('held', flush=True)\n"
    "time.sleep(600)\n")


def test_job_lease_dead_breaker_lock(tmp_path):
    """A claimant that dies holding a break lock (a process SIGKILLed
    with the lock's flock held) blocks breaks only while it lives: then a
    claim of the stale lease backs off, and a release gives up after its
    bounded wait and leaves the lease; once it is dead, exactly one of
    eight claimants breaks the stale lease, the release goes through, and
    no lock file stays."""
    d = str(tmp_path)
    ttl = 30.0
    old = lease_mod.try_claim(d, "job_g5", worker="h0", ttl_s=ttl,
                              keeper=False)
    _age(old.path, 2 * ttl)
    live = lease_mod.try_claim(d, "job_g6", worker="h0", ttl_s=0.2,
                               keeper=False)
    proc = subprocess.Popen(
        [sys.executable, "-c", _HOLD_LOCKS,
         old.path + lease_mod.BREAK_SUFFIX,
         live.path + lease_mod.BREAK_SUFFIX],
        stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "held"
        assert lease_mod.try_claim(d, "job_g5", worker="h1", ttl_s=ttl,
                                   keeper=False) is None
        t0 = time.monotonic()
        live.release()
        assert time.monotonic() - t0 < 10.0
        assert lease_mod.read_lease(d, "job_g6")["worker"] == "h0"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
    won = []
    barrier = threading.Barrier(8)

    def claim(i):
        barrier.wait()
        got = lease_mod.try_claim(d, "job_g5", worker=f"c{i}", ttl_s=ttl,
                                  keeper=False)
        if got is not None:
            won.append(got)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(won) == 1
    assert lease_mod.read_lease(d, "job_g5")["worker"] == won[0].worker
    assert not old.heartbeat() and old.lost.is_set()
    assert not os.path.exists(old.path + lease_mod.BREAK_SUFFIX)
    won[0].release()
    live.release()        # the dead holder's lock file is taken and removed
    assert os.listdir(d) == []


def test_cost_cache_fingerprint(short_tmp):
    """Repeat estimates of one spec hit the fingerprint cache; rewriting
    an input misses it."""
    reads, paf, layout = _assembly(short_tmp, [1200], seed=7, prefix="cc")
    h0 = metrics.counter("fleet.cost_cache_hits")
    m0 = metrics.counter("fleet.cost_cache_misses")
    cost = cached_job_cost(reads, paf, layout)
    assert cost > 0
    assert cached_job_cost(reads, paf, layout) == cost
    assert metrics.counter("fleet.cost_cache_hits") == h0 + 1
    assert metrics.counter("fleet.cost_cache_misses") == m0 + 1
    with open(reads, "ab") as f:
        f.write(b"")
    os.utime(reads, (time.time() + 5, time.time() + 5))
    assert cached_job_cost(reads, paf, layout) == cost
    assert metrics.counter("fleet.cost_cache_misses") == m0 + 2


# ------------------------------------------ one job through both fleets

@pytest.fixture(scope="module")
def triple():
    """The shared input (a 2 kbp contig) and the JAX one-shot CLI's
    bytes for it."""
    td = tempfile.mkdtemp(dir="/tmp", prefix="tfm")
    files = _assembly(td, [2000], prefix="rt")
    yield files, _oneshot("racon_tpu", files)
    shutil.rmtree(td, ignore_errors=True)


def _fleet_run(td, files, server_cls, gateway_cls):
    """One job through a gateway and two hosts of one package: submit
    under tenant alpha, wait for ``done``, copy the fleet dir (the
    done-but-uncollected state, hosts removed), fetch, fetch again,
    resubmit under the key, read stats and the journal."""
    fleet_dir = os.path.join(td, "fleet")
    out = {"files": files}
    with _Host(td, "h0", fleet_dir, server_cls), \
            _Host(td, "h1", fleet_dir, server_cls), \
            _Gate(fleet_dir, gateway_cls) as gate:
        gate.wait_hosts(2)
        with gate.client() as c:
            spec = _spec(*files, tenant="alpha", priority=1)
            sub = c.submit(spec, key="rt-1")
            assert sub["ok"] and sub["tenant"] == "alpha", sub
            deadline = time.monotonic() + 240
            while c.status(sub["job"]).get("state") != "done":
                assert time.monotonic() < deadline
                time.sleep(0.05)
            out["done_dir"] = os.path.join(td, "done")
            shutil.copytree(fleet_dir, out["done_dir"],
                            ignore=shutil.ignore_patterns("hosts",
                                                          "lease_*"))
            out["header"], out["payload"] = c.result(sub["job"],
                                                     timeout_s=240)
            out["again"] = c.result(sub["job"], timeout_s=10)
            out["dup"] = c.submit(spec, key="rt-1")
            out["stats"] = c.stats()
        out["sub"] = sub
        out["records"] = journal_records(fleet_dir)
    return out


@pytest.fixture(scope="module")
def fleet_runs(triple):
    """The same job through the JAX fleet and through the port's."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, value in FLEET_ENV.items():
            mp.setenv(name, value)
        mp.setenv("RACON_TPU_FLEET_TENANTS", "alpha:3,beta:1")
        mp.delenv("RACON_TPU_FAULTS", raising=False)
        for pkg, server_cls, gateway_cls in (
                ("jax", jax_service.PolishServer, jax_gateway.Gateway),
                ("port", PolishServer, Gateway)):
            td = tempfile.mkdtemp(dir="/tmp", prefix=f"tf{pkg[0]}")
            runs[pkg] = _fleet_run(td, triple[0], server_cls, gateway_cls)
            runs[pkg]["td"] = td
    yield runs
    for run in runs.values():
        shutil.rmtree(run["td"], ignore_errors=True)


def test_gateway_round_trip_byte_identity(fleet_runs, triple):
    """The port's gateway and hosts give the JAX one-shot CLI's bytes;
    the payload goes out once; the key dedupes fleet-wide; stats report
    tenants, hosts and the fleet counters."""
    run, want = fleet_runs["port"], triple[1]
    header, payload = run["header"], run["payload"]
    assert header["ok"] and header["state"] == "done", header
    assert payload == want, "gateway result diverged from the JAX CLI"
    assert payload == fleet_runs["jax"]["payload"]
    assert header["host"] in ("h0", "h1")
    again, payload2 = run["again"]
    assert payload2 is None and not again["ok"]
    assert "already collected" in again["error"], again
    assert run["dup"]["ok"] and run["dup"]["existing"]
    assert run["dup"]["job"] == run["sub"]["job"]
    st = run["stats"]
    assert st["ok"] and st["done"] >= 1 and st["hosts"]["alive"] == 2
    assert isinstance(st["tenants"], dict)
    assert set(st) == set(fleet_runs["jax"]["stats"])
    assert st["fleet"]["jobs_accepted"] >= 1
    assert st["fleet"]["jobs_placed"] >= 1


def _masked(records, job):
    out = []
    for r in records:
        if r.get("job") != job:
            continue
        r = dict(r, job="<job>")
        for key in ("unix", "wall_s"):
            if key in r:
                r[key] = "<time>"
        if "host" in r:
            r["host"] = "<host>"
        if "hkey" in r:
            r["hkey"] = r["hkey"].replace(job, "<job>")
        out.append(r)
    return out


def test_gateway_journal_equals_jax(fleet_runs):
    """The port gateway's records for the job equal the JAX gateway's for
    the same sequence, times and ids masked: submitted, running, done and
    collected, once each, and every step an edge of ``TENANT_MACHINE``."""
    port, jax = fleet_runs["port"], fleet_runs["jax"]
    port_recs = _masked(port["records"], port["sub"]["job"])
    jax_recs = _masked(jax["records"], jax["sub"]["job"])
    assert port_recs == jax_recs
    assert [r["rec"] for r in port_recs] == \
        ["submitted", "running", "done", "collected"]
    assert tenant_walk(port["records"]) == []


@pytest.mark.parametrize("source,target", [("jax", "port"),
                                           ("port", "jax")])
def test_fleet_dir_carries_across_packages(fleet_runs, triple, short_tmp,
                                           fast_fleet, source, target):
    """A fleet dir that one package's gateway left with a job done and not
    collected is served by the other package's gateway from its spool,
    with no host at all."""
    fleet_dir = os.path.join(short_tmp, "fleet")
    shutil.copytree(fleet_runs[source]["done_dir"], fleet_dir)
    jid = fleet_runs[source]["sub"]["job"]
    gateway_cls = Gateway if target == "port" else jax_gateway.Gateway
    with _Gate(fleet_dir, gateway_cls) as gate:
        assert gate.gateway.recovery["results_served"] == 1
        with gate.client() as c:
            assert c.ping()["hosts"] == {"alive": 0, "dead": 0}
            dup = c.submit(_spec(*triple[0], tenant="alpha", priority=1),
                           key="rt-1")
            assert dup["ok"] and dup["existing"] and dup["job"] == jid
            header, payload = c.result(jid, timeout_s=60)
            assert header["ok"], header
            assert payload == triple[1]
        kinds = _kinds(journal_records(fleet_dir), jid)
        assert kinds == {"submitted": 1, "running": 1, "done": 1,
                         "collected": 1}


def test_report_fleet_section(fleet_runs, tmp_path):
    """After a gateway run in this process the report's ``fleet`` section
    (``fleet_summary``) has JAX's keys and counts the admission and the
    placement; both validators pass the report. A plain polish's report
    has the section as zeros, and ``obs check`` passes it."""
    rep = report_mod.build_report("cli")
    assert set(rep["fleet"]) == set(jax_metrics.fleet_summary())
    assert set(rep["fleet"]) == contracts.schema_keys()["fleet"]
    assert rep["fleet"]["jobs_accepted"] > 0
    assert rep["fleet"]["jobs_placed"] > 0
    assert rep["fleet"] == metrics.fleet_summary()
    assert report_mod.validate_report(rep) == []
    assert jax_validate(rep) == []
    path = str(tmp_path / "r.json")
    proc = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch", "-w", "150", "-t", "2",
         "--run-report", path, *fleet_runs["port"]["files"]],
        capture_output=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    with open(path) as f:
        plain = json.load(f)
    assert plain["fleet"] == {k: 0 for k in rep["fleet"]}
    check = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.obs", "check", path],
        capture_output=True, timeout=120, cwd=REPO, env=_env())
    assert check.returncode == 0, check.stdout + check.stderr


# --------------------------------------------------- gateway integration

def test_device_engine_host_equals_port_cli(short_tmp, fast_fleet):
    """A host on the device engines (their plain PyTorch versions on the
    CPU) gives, through the gateway, the port CLI's ``-c 1
    --cudaaligner-batches 1`` bytes."""
    triple = _assembly(short_tmp, [1800], seed=5, prefix="de")
    want = _oneshot("racon_tpu_torch", triple, "-c", "1",
                    "--cudaaligner-batches", "1", "--device", "cpu")
    fleet_dir = os.path.join(short_tmp, "fleet")
    with _Host(short_tmp, "d0", fleet_dir, aligner_backend="cuda",
               consensus_backend="cuda") as host, \
            _Gate(fleet_dir) as gate:
        assert not host.primary_on_card()
        gate.wait_hosts(1)
        with gate.client() as c:
            sub = c.submit(_spec(*triple))
            assert sub["ok"], sub
            header, payload = c.result(sub["job"], timeout_s=240)
    assert header["ok"] and header["host"] == "d0", header
    assert payload == want
    assert header["report"]["pack"]["align_chunks"] > 0


def test_serve_stats_tenants_and_slots(short_tmp, fast_fleet):
    """The host's ``stats``: per-tenant queue depths and the slots'
    health."""
    reads, paf, layout = _assembly(short_tmp, [1500], prefix="st")
    server = PolishServer(os.path.join(short_tmp, "racon.sock"),
                          num_threads=2, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    assert server.started.wait(60)
    try:
        with ServiceClient(server.socket_path) as c:
            first = c.submit(_spec(reads, paf, layout))
            assert first["ok"]
            a = c.submit(_spec(reads, paf, layout, tenant="alpha"))
            b = c.submit(_spec(reads, paf, layout, tenant="beta"))
            assert a["ok"] and b["ok"]
            st = c.stats()
            assert st["ok"]
            assert st["slots"] == {"healthy": 1, "quarantined": 0}
            depth = st["tenants"]
            assert depth.get("alpha", 0) + depth.get("beta", 0) >= 1
            for jid in (first["job"], a["job"], b["job"]):
                header, _ = c.result(jid, timeout_s=240)
                assert header["ok"], header
            st = c.stats()
            assert st["tenants"] == {}
            assert st["slots"]["healthy"] == 1
    finally:
        server.shutdown()
        thread.join(timeout=60)
        buildwatch.reset()


def test_gateway_budget_rejects_with_reason(short_tmp, fast_fleet):
    """A tenant over its budget is rejected with JAX's reason and nothing
    is journaled."""
    fast_fleet.setenv("RACON_TPU_FLEET_TENANTS", "cap:1:1K")
    reads, paf, layout = _assembly(short_tmp, [1500], prefix="bg")
    spec = _spec(reads, paf, layout, tenant="cap")
    answers = []
    for gateway_cls, sub in ((Gateway, "p"), (jax_gateway.Gateway, "j")):
        fleet_dir = os.path.join(short_tmp, f"fleet_{sub}")
        with _Gate(fleet_dir, gateway_cls) as gate:
            with gate.client() as c:
                resp = c.submit(spec)
                assert not resp["ok"] and resp["rejected"]
                assert "budget exhausted" in resp["error"]
                assert c.stats()["rejected"] == 1
                answers.append(resp)
        assert not any(r.get("rec") == "submitted"
                       for r in journal_records(fleet_dir))
    assert answers[0] == answers[1]


def test_gateway_restart_serves_done_from_spool(short_tmp, fast_fleet,
                                                triple):
    """A job done and not collected at shutdown is served by the restarted
    gateway from the fleet spool, with no host running."""
    fleet_dir = os.path.join(short_tmp, "fleet")
    with _Host(short_tmp, "h0", fleet_dir):
        with _Gate(fleet_dir) as gate:
            gate.wait_hosts(1)
            with gate.client() as c:
                sub = c.submit(_spec(*triple[0]), key="rc-1")
                assert sub["ok"]
                jid = sub["job"]
                deadline = time.monotonic() + 240
                while True:
                    st = c.status(jid)
                    if st.get("state") == "done":
                        break
                    assert st.get("state") not in ("failed",
                                                   "cancelled"), st
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
    with _Gate(fleet_dir) as gate:
        with gate.client() as c:
            dup = c.submit(_spec(*triple[0]), key="rc-1")
            assert dup["ok"] and dup["existing"] and dup["job"] == jid
            header, payload = c.result(jid, timeout_s=60)
            assert header["ok"], header
            assert payload == triple[1]


def test_gateway_shutdown_now_requeues_on_restart(short_tmp, fast_fleet):
    """``shutdown now`` with a job queued answers FAILED in memory but
    keeps it journaled live; the restarted gateway queues it again and a
    host runs it."""
    reads, paf, layout = _assembly(short_tmp, [1500], prefix="sn")
    fleet_dir = os.path.join(short_tmp, "fleet")
    with _Gate(fleet_dir) as gate:
        with gate.client() as c:
            sub = c.submit(_spec(reads, paf, layout), key="sn-1")
            assert sub["ok"]
            jid = sub["job"]
    kinds = [r["rec"] for r in journal_records(fleet_dir)
             if r.get("job") == jid]
    assert "submitted" in kinds
    assert "failed" not in kinds, \
        "shutdown(now) made a queued job durably FAILED"
    with _Host(short_tmp, "h0", fleet_dir), _Gate(fleet_dir) as gate:
        assert gate.gateway.recovery["jobs_recovered"] >= 1
        gate.wait_hosts(1)
        with gate.client() as c:
            dup = c.submit(_spec(reads, paf, layout), key="sn-1")
            assert dup["ok"] and dup["existing"] and dup["job"] == jid
            header, payload = c.result(jid, timeout_s=240)
            assert header["ok"], header
            assert payload.startswith(b">ctg0")


def test_host_local_rejection_routes_to_another_host(short_tmp,
                                                     fast_fleet):
    """A host-local rejection (a member with a one-KB ``--serve-budget``)
    requeues the job and the next tick tries another host."""
    reads, paf, layout = _assembly(short_tmp, [1500], prefix="hr")
    fleet_dir = os.path.join(short_tmp, "fleet")
    before = metrics.counter("fleet.reject_requeued")
    with _Host(short_tmp, "a0", fleet_dir, workers=2, budget_bytes=1024), \
            _Host(short_tmp, "z1", fleet_dir, num_threads=1), \
            _Gate(fleet_dir) as gate:
        gate.wait_hosts(2)
        with gate.client() as c:
            sub = c.submit(_spec(reads, paf, layout))
            assert sub["ok"]
            header, payload = c.result(sub["job"], timeout_s=240)
            assert header["ok"], header
            assert header["host"] == "z1"
            assert payload.startswith(b">ctg0")
    assert metrics.counter("fleet.reject_requeued") > before
    assert not any(r.get("rec") == "failed"
                   for r in journal_records(fleet_dir))


def test_host_worker_cache_invalidation(short_tmp, fast_fleet):
    """The cached worker count drops when a host dies or registers again
    under its name, and a beacon first seen already stale walks the
    registered -> dead edge."""
    fleet_dir = os.path.join(short_tmp, "fleet")
    hx = HostBeacon(fleet_dir, os.path.join(short_tmp, "hx.sock"))
    hy = HostBeacon(fleet_dir, os.path.join(short_tmp, "hy.sock"))
    stale = time.time() - 60
    gw = Gateway("127.0.0.1:0", fleet_dir)
    try:
        hx.announce()
        hy.announce()
        os.utime(hy.path, (stale, stale))
        gw._refresh_hosts()
        assert gw._host_stage["hx"] == "alive"
        assert gw._host_stage["hy"] == "dead"
        gw._host_workers["hx"] = (4, time.monotonic())
        os.utime(hx.path, (stale, stale))
        gw._refresh_hosts()
        assert gw._host_stage["hx"] == "dead"
        assert "hx" not in gw._host_workers
        time.sleep(0.01)
        hx.announce()
        gw._refresh_hosts()
        assert gw._host_stage["hx"] == "alive"
        gw._host_workers["hx"] = (4, time.monotonic())
        time.sleep(0.01)
        hx.announce()
        gw._refresh_hosts()
        assert "hx" not in gw._host_workers
    finally:
        gw._journal.close()


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_gateway_cli_entry(short_tmp, fast_fleet, triple):
    """``racon --gateway HOST:PORT --fleet-dir DIR`` and ``racon --submit
    HOST:PORT --tenant --priority`` through the port's CLI give the JAX
    one-shot CLI's bytes; the gateway process drains on SIGTERM."""
    fleet_dir = os.path.join(short_tmp, "fleet")
    port = _free_port()
    with open(os.path.join(short_tmp, "gw.log"), "wb") as log:
        gw = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch",
             "--gateway", f"127.0.0.1:{port}", "--fleet-dir", fleet_dir],
            cwd=REPO, env=_env(), stderr=log)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert gw.poll() is None, "gateway process died"
            assert time.monotonic() < deadline, "gateway never answered"
            try:
                with ServiceClient(f"127.0.0.1:{port}", timeout_s=5,
                                   retries=0) as c:
                    if c.ping().get("ok"):
                        break
            except (OSError, ConnectionError):
                time.sleep(0.1)
        with _Host(short_tmp, "h0", fleet_dir):
            proc = subprocess.run(
                [sys.executable, "-m", "racon_tpu_torch",
                 "--submit", f"127.0.0.1:{port}",
                 "--tenant", "alpha", "--priority", "2",
                 "-w", "150", "-t", "2", *triple[0]],
                capture_output=True, timeout=300, cwd=REPO, env=_env())
            assert proc.returncode == 0, proc.stderr.decode()[-2000:]
            assert proc.stdout == triple[1], (
                "--submit through the gateway diverged from the JAX "
                "one-shot CLI")
            with ServiceClient(f"127.0.0.1:{port}", timeout_s=30) as c:
                st = c.stats()
            assert st["done"] == 1 and st["hosts"]["alive"] == 1
            subs = [r for r in journal_records(fleet_dir)
                    if r.get("rec") == "submitted"]
            assert len(subs) == 1
            assert subs[0]["spec"]["tenant"] == "alpha"
            assert subs[0]["spec"]["priority"] == 2
        gw.terminate()
        assert gw.wait(timeout=60) == 0
    finally:
        if gw.poll() is None:
            gw.kill()
            gw.wait()
    with open(os.path.join(short_tmp, "gw.log"), "rb") as f:
        log = f.read().decode()
    assert "gateway listening on" in log and "gateway stopped" in log


@pytest.mark.parametrize("argv,message", [
    (["--gateway", "127.0.0.1:0"], "--gateway requires --fleet-dir"),
    (["--gateway", "127.0.0.1:0", "--fleet-dir", "D", "--serve", "s"],
     "--gateway is mutually exclusive"),
    (["--gateway", "127.0.0.1:0", "--fleet-dir", "D", "r", "o", "d"],
     "--gateway takes no positional inputs"),
    (["--fleet-dir", "D", "r", "o", "d"],
     "--fleet-dir only makes sense"),
])
def test_gateway_parser_errors_equal_jax(argv, message, capsys):
    """The CLI's fleet parser errors are JAX's, word for word."""
    from racon_tpu import cli as jax_cli
    from racon_tpu_torch import cli
    errors = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(list(argv))
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and message in errors[0]
