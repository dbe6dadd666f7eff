"""The port's lifecycle machines, report backing, lock-order witness and
contract audit, against the JAX package's.

- ``SHARD_MACHINE`` and ``LEASE_MACHINE`` equal JAX's in name, states,
  edges and initial states; ``exec/manifest.py`` binds its shard states to
  them; ``selfcheck()`` is clean; ``REPORT_BACKING`` is JAX's less the
  entries listed here, and each section emitter returns its section's
  keys;
- every status the runner writes for a shard across a faulted, resumed
  and re-verified run is an edge of ``SHARD_MACHINE`` (the writes are
  recorded by wrapping ``manifest.save_shard_state``);
- the witness fires on an inverted order, stays silent on an ordered one,
  composes edges taken on two threads, and reports at process exit;
  ``named_lock`` is a plain lock with the sanitizer off and a witnessed
  one, usable under ``threading.Condition``, with it on; a sharded run
  under ``RACON_TPU_SANITIZE=1`` leaves an acyclic graph;
- the contract audit is silent before any emission, diffs the registry
  against what was written, and runs at process exit under the flag.

These mirror ``tests/test_contracts.py`` and ``tests/test_sanitize.py``.
"""

import io
import os
import pathlib
import subprocess
import sys
import threading

import pytest
import torch

from racon_tpu import contracts as jax_contracts
from racon_tpu_torch import contracts, faults, sanitize
from racon_tpu_torch.exec import ShardRunner
from racon_tpu_torch.exec import manifest as mf
from racon_tpu_torch.obs import buildwatch, metrics
from racon_tpu_torch.utils.simulate import simulate

REPO = pathlib.Path(__file__).resolve().parent.parent

# the JAX REPORT_BACKING entries the port leaves out: the fleet's (ROADMAP
# Queue 1 item 6), and the per-window ins-overflow attribution the port
# does not emit
LEFT_OUT_BACKING = frozenset((
    "fleet.jobs_accepted", "fleet.jobs_rejected", "fleet.jobs_placed",
    "fleet.jobs_migrated", "fleet.jobs_preempted", "fleet.hosts_alive",
    "fleet.hosts_dead", "fleet.cost_cache_hits", "fleet.cost_cache_misses",
    "dataflow.ins_overflow_windows",
))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("RACON_TPU_SANITIZE", "RACON_TPU_FAULTS",
                 "RACON_TPU_EXEC_FAULT_SHARD"):
        monkeypatch.delenv(name, raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    faults.reset()
    yield
    faults.reset()
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    reads, paf, draft, _ = simulate(0.008, seed=7, mean_read=1000,
                                    max_read=1300, min_read=700,
                                    n_contigs=4)
    d = pathlib.Path(tmp_path_factory.mktemp("contracts"))
    out = []
    for name, blob in (("reads.fastq", reads), ("ovl.paf", paf),
                       ("draft.fasta", draft)):
        (d / name).write_bytes(blob)
        out.append(str(d / name))
    return tuple(out)


# ------------------------------------------------------------- registry

def test_selfcheck_is_clean():
    assert contracts.selfcheck() == []


@pytest.mark.parametrize("name", ["SHARD_MACHINE", "LEASE_MACHINE"])
def test_machines_equal_jax(name):
    port, jax = getattr(contracts, name), getattr(jax_contracts, name)
    assert port.name == jax.name
    assert port.states == jax.states
    assert port.edges == jax.edges
    assert port.initial == jax.initial
    assert port.terminal == jax.terminal
    assert port in contracts.MACHINES


def test_machines_declare_the_recovery_edges():
    shard, lease = contracts.SHARD_MACHINE, contracts.LEASE_MACHINE
    assert shard.has_edge("done", "pending")         # part-CRC re-queue
    assert shard.has_edge("quarantined", "pending")  # retry
    assert shard.has_edge("running", "running")      # reclaim
    assert not shard.has_edge("quarantined", "running")
    assert shard.terminal == ()
    assert lease.has_edge("expired", "claimed")
    assert "pending" in shard and "zombie" not in shard
    with pytest.raises(ValueError, match="undeclared"):
        contracts.StateMachine("x", ("a",), (("a", "b"),), ("a",))


def test_manifest_binds_the_shard_states():
    assert mf.PENDING is contracts.SHARD_PENDING
    assert mf.RUNNING is contracts.SHARD_RUNNING
    assert mf.DONE is contracts.SHARD_DONE
    assert mf.QUARANTINED is contracts.SHARD_QUARANTINED


def test_report_backing_is_jax_less_the_left_out_entries():
    port, jax = contracts.REPORT_BACKING, jax_contracts.REPORT_BACKING
    assert set(jax) - set(port) == LEFT_OUT_BACKING
    assert set(port) <= set(jax)
    differ = {k for k in port if port[k] != jax[k]}
    # the port's compile seconds are its nvcc/g++ library builds
    assert differ == {"dispatch_fetch.compile_s"}
    assert port["dispatch_fetch.compile_s"] == "compile.build_s"


def test_section_emitters_return_their_sections():
    import importlib
    assert set(contracts.SECTION_EMITTERS) == \
        set(jax_contracts.SECTION_EMITTERS)
    keys = contracts.schema_keys()
    for section, (path, fn) in contracts.SECTION_EMITTERS.items():
        mod = importlib.import_module(
            path[:-len(".py")].replace("/", "."))
        func = getattr(mod, fn)
        if fn != "build_report":
            assert set(func()) == keys[section], section
    rep = importlib.import_module("racon_tpu_torch.obs.report") \
        .build_report("cli")
    for section in ("dispatch_fetch", "recovery", "fleet"):
        assert set(rep[section]) == keys[section]
    assert set(rep) >= keys["top"] - {"shards"}
    assert set(buildwatch.summary()) == keys["compiles"]


def test_seen_names_survive_run_boundaries(monkeypatch):
    monkeypatch.setattr(metrics, "_seen", set())
    metrics.inc("align.chunks")
    metrics.set_gauge("queue.depth", 2)
    metrics.add_time("align.dispatch", 0.01)
    metrics.clear_run()
    assert metrics.counter("align.chunks", None) is None
    assert metrics.seen_names() == {"align.chunks", "queue.depth",
                                    "align.dispatch"}
    assert {"sanitize.lock_order_cycles", "sanitize.contract_never_emitted",
            "sanitize.contract_defaulted_keys"} <= contracts.METRICS


# ------------------------------------------------ the runner's state writes

def test_every_shard_write_is_a_machine_edge(assembly, tmp_path,
                                             monkeypatch):
    """A run with a transient fault and a quarantined shard, its resume
    (the quarantined shard retried), and a resume after a part was
    corrupted (the done shard re-queued): each shard's written statuses,
    from its initial ``pending``, walk ``SHARD_MACHINE``'s edges."""
    writes = []
    real = mf.save_shard_state

    def record(work_dir, entry):
        writes.append((int(entry["id"]), entry["status"]))
        return real(work_dir, entry)

    monkeypatch.setattr(mf, "save_shard_state", record)
    wd = tmp_path / "w"

    def run(**kw):
        runner = ShardRunner(*assembly, n_shards=4, num_threads=2,
                             work_dir=str(wd), keep_work_dir=True, **kw)
        runner.run(io.BytesIO())
        return runner.summary

    monkeypatch.setenv("RACON_TPU_FAULTS", "exec.polish:io@1")
    monkeypatch.setenv("RACON_TPU_EXEC_BACKOFF_S", "0.01")
    monkeypatch.setenv("RACON_TPU_EXEC_FAULT_SHARD", "2*")
    first = run()
    assert [e["status"] for e in first["shards"]] == \
        ["done", "done", "quarantined", "done"]
    monkeypatch.delenv("RACON_TPU_FAULTS")
    monkeypatch.delenv("RACON_TPU_EXEC_FAULT_SHARD")
    faults.reset()
    assert [e["status"] for e in run(resume=True)["shards"]] == ["done"] * 4
    part = wd / first["shards"][1]["part"]
    blob = bytearray(part.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    part.write_bytes(bytes(blob))
    assert [e["status"] for e in run(resume=True)["shards"]] == ["done"] * 4

    machine = contracts.SHARD_MACHINE
    walks = {}
    for si, status in writes:
        walks.setdefault(si, list(machine.initial)).append(status)
    assert sorted(walks) == [0, 1, 2, 3]
    for si, walk in walks.items():
        bad = [(a, b) for a, b in zip(walk, walk[1:])
               if not machine.has_edge(a, b)]
        assert bad == [], (si, walk)
    # the retried and the re-queued shards walked back through pending
    assert walks[2][-4:] == ["quarantined", "pending", "running", "done"]
    assert walks[1][-4:] == ["done", "pending", "running", "done"]


# --------------------------------------------------- lock-order witness

def test_witness_fires_on_an_inverted_order():
    w = sanitize.LockOrderWitness()
    a = sanitize.WitnessedLock("exec.A", witness=w)
    b = sanitize.WitnessedLock("exec.B", witness=w)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    cycles = w.cycles()
    assert len(cycles) == 1 and set(cycles[0]) == {"exec.A", "exec.B"}
    buf = io.StringIO()
    assert w.report(buf) == 1
    out = buf.getvalue()
    assert "potential deadlock" in out
    assert "edge exec.A -> exec.B" in out and "edge exec.B -> exec.A" in out
    assert out.count("test_witness_fires_on_an_inverted_order") >= 2
    assert metrics.gauge("sanitize.lock_order_cycles") == 1


def test_witness_silent_on_an_ordered_acquisition():
    w = sanitize.LockOrderWitness()
    a = sanitize.WitnessedLock("exec.A", witness=w)
    b = sanitize.WitnessedLock("exec.B", witness=w)
    for _ in range(3):
        with a:
            with b:
                pass
    assert w.cycles() == [] and list(w.edges()) == [("exec.A", "exec.B")]
    buf = io.StringIO()
    assert w.report(buf) == 0 and buf.getvalue() == ""


def test_witness_composes_edges_from_two_threads():
    w = sanitize.LockOrderWitness()
    a = sanitize.WitnessedLock("exec.A", witness=w)
    b = sanitize.WitnessedLock("exec.B", witness=w)
    c = sanitize.WitnessedLock("exec.C", witness=w)

    def take(first, second):
        with first:
            with second:
                pass

    # one after the other: the edges, never the hang
    for pair in ((a, b), (b, c), (c, a)):
        t = threading.Thread(target=take, args=pair)
        t.start()
        t.join()
    cycles = w.cycles()
    assert len(cycles) == 1 and sorted(cycles[0]) == \
        ["exec.A", "exec.B", "exec.C"]


def test_named_lock_is_plain_with_the_sanitizer_off():
    lock = sanitize.named_lock("exec.x")
    assert isinstance(lock, type(threading.Lock()))


def test_named_lock_is_witnessed_and_works_under_a_condition(monkeypatch):
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    lock = sanitize.named_lock("exec.test")
    assert isinstance(lock, sanitize.WitnessedLock)
    cond = threading.Condition(lock)
    ready = threading.Event()

    def waker():
        ready.wait(5.0)
        with cond:
            cond.notify_all()

    t = threading.Thread(target=waker)
    t.start()
    with cond:
        ready.set()
        assert cond.wait(5.0)
    t.join()
    assert not lock.locked()
    assert sanitize.lock_witness().cycles() == []


def test_sharded_run_under_the_sanitizer_is_acyclic(assembly, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    runner = ShardRunner(*assembly, n_shards=2, num_threads=2,
                         work_dir=str(tmp_path / "w"))
    out = io.BytesIO()
    runner.run(out)
    assert out.getvalue().startswith(b">contig_0")
    assert isinstance(runner.index._groups_lock, sanitize.WitnessedLock)
    assert isinstance(runner._beat._lock, sanitize.WitnessedLock)
    assert sanitize.lock_witness().cycles() == []


# ------------------------------------------------------ contract audit

def test_contract_audit_silent_before_any_emission(monkeypatch):
    monkeypatch.setattr(metrics, "_seen", set())
    assert sanitize.contract_audit() == {"never_emitted": [],
                                         "defaulted_keys": []}


def test_contract_audit_diffs_the_registry(monkeypatch, capsys):
    monkeypatch.setattr(metrics, "_seen", set())
    metrics.inc("queue.depth", 0)
    metrics.add_time("align.dispatch", 0.01)
    metrics.add_time("overlap.seed.dispatch", 0.01)
    audit = sanitize.contract_audit(stream=sys.stderr)
    assert "queue.depth" not in audit["never_emitted"]
    assert "lease.reclaimed" in audit["never_emitted"]
    # a key backed by a span timer counts the span's children too
    assert "dispatch_fetch.align_dispatch_s" not in audit["defaulted_keys"]
    assert "overlap.seed_dispatch_s" not in audit["defaulted_keys"]
    assert "queue.depth" not in audit["defaulted_keys"]
    assert "pack.groups" in audit["defaulted_keys"]
    assert set(audit["defaulted_keys"]) <= set(contracts.REPORT_BACKING)
    assert metrics.gauge("sanitize.contract_never_emitted") == \
        len(audit["never_emitted"])
    assert metrics.gauge("sanitize.contract_defaulted_keys") == \
        len(audit["defaulted_keys"])
    assert "contract audit" in capsys.readouterr().err


_EXIT = """
from racon_tpu_torch import sanitize
from racon_tpu_torch.obs import metrics
metrics.inc("queue.depth")
w = sanitize.lock_witness()
a = sanitize.WitnessedLock("exec.a", witness=w)
b = sanitize.WitnessedLock("exec.b", witness=w)
with a:
    with b:
        pass
with b:
    with a:
        pass
"""


@pytest.mark.parametrize("on", [True, False])
def test_exit_reports(on):
    """At exit: the witness's cycle report always (the witness exists
    only where named locks were witnessed), the contract audit only under
    the flag."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RACON_TPU_")}
    if on:
        env["RACON_TPU_SANITIZE"] = "1"
    proc = subprocess.run([sys.executable, "-c", _EXIT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "cycle exec.a -> exec.b -> exec.a" in proc.stderr
    assert ("contract audit" in proc.stderr) == on
