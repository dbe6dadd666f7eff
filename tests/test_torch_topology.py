"""The port's multi-device topology against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's device list is substituted with ``[cpu] * k``
(``monkeypatch`` on ``topology.local_devices``), so every slot, pin, plan
assignment, per-device row and merge runs as it would on k cards, with the
kernels' plain versions. Held here:

- ``Topology``, ``ChipSlot`` and ``resolve_chips`` follow JAX's rules
  (request, then ``RACON_TPU_CHIPS``, then every device; clamped; floored);
- ``plan_shards`` in ``chips`` mode and ``assign_devices``, with
  ``MESH_DEVICE``, give JAX's plans on the stub index of
  ``tests/test_topology.py``;
- the heartbeat's per-worker field equals JAX's;
- ``ShardRunner(chips=2)`` writes the bytes of ``chips=1`` and of JAX's
  ``chips=2`` run, with ``device``/``worker`` manifest fields and
  ``devices`` report rows (keys as JAX's, ``validate_report`` clean); the
  mesh-dominant plan (one contig over both devices) too;
- ``cli.main(["--chips", "2", ...])`` in-process, and ``--chips -1``'s
  error;
- ``PolishServer(chips=2, workers=3)``'s slots;
- the lock-order witness with the runner's three named locks.

Small geometry throughout (``poa.BAND`` 64 in both packages, window 150,
``tests/test_topology.py``'s assembly sizes), the consensus on the device
engines and the alignment on the host engines, as the JAX tests run it.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

import racon_tpu.ops.poa as jax_poa
from racon_tpu.exec import ShardRunner as JaxShardRunner
from racon_tpu.exec import planner as jax_planner
from racon_tpu.exec.heartbeat import Heartbeat as JaxHeartbeat
from racon_tpu.parallel import topology as jax_topology
from racon_tpu_torch import cli, sanitize
from racon_tpu_torch.exec import ShardRunner, load_manifest
from racon_tpu_torch.exec import planner
from racon_tpu_torch.exec.heartbeat import Heartbeat
from racon_tpu_torch.obs.report import validate_report
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.parallel import topology

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_topology import _StubIndex, _assembly  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """Two torch threads (tier-1 runs six test processes), the JAX
    tests' small consensus band in both packages."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(tpoa, "BAND", 64)
    monkeypatch.setattr(jax_poa, "BAND", 64)
    monkeypatch.delenv("RACON_TPU_CHIPS", raising=False)
    yield
    torch.set_num_threads(saved)


def _devices(monkeypatch, k):
    monkeypatch.setattr(topology, "local_devices", lambda: [CPU] * k)


# --------------------------------------------------------------- topology

def test_local_devices_on_this_host():
    if torch.cuda.is_available():
        assert topology.local_devices() == [
            torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    else:
        assert topology.local_devices() == [CPU]


@pytest.mark.parametrize("k", [1, 3, 8])
def test_topology_slots_follow_jax(monkeypatch, k):
    _devices(monkeypatch, 8)
    mine, theirs = topology.Topology(k), jax_topology.Topology(k)
    assert mine.n_chips == theirs.n_chips
    assert [s.key for s in mine.slots] == [s.key for s in theirs.slots]
    assert [s.ordinal for s in mine.slots] == \
        [s.ordinal for s in theirs.slots]
    # one unpinned slot for k <= 1, one pinned slot a device above
    assert [s.device is None for s in mine.slots] == \
        [s.device is None for s in theirs.slots]
    d, jd = mine.describe(), theirs.describe()
    assert (d["n_chips"], d["n_local_devices"], d["platform"]) == \
        (jd["n_chips"], jd["n_local_devices"], "cpu")
    assert jd["platform"] == "cpu"


@pytest.mark.parametrize("requested,env,want", [
    (0, None, 8), (3, None, 3), (64, None, 8), (0, "5", 5), (2, "5", 2),
    (-1, None, 8), (0, "0", 8), (0, "99", 8)])
def test_resolve_chips_follows_jax(monkeypatch, requested, env, want):
    _devices(monkeypatch, 8)
    if env is not None:
        monkeypatch.setenv("RACON_TPU_CHIPS", env)
    assert topology.resolve_chips(requested) == want
    assert jax_topology.resolve_chips(requested) == want


def test_resolve_chips_floors_at_one_on_one_device(monkeypatch):
    _devices(monkeypatch, 1)
    assert topology.resolve_chips(4) == topology.resolve_chips(0) == 1


def test_chip_slot_pin(monkeypatch):
    entered = []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    card = topology.ChipSlot(1, torch.device("cuda", 1))
    with card.pin():
        pass
    with topology.ChipSlot(0, None).pin(), topology.ChipSlot(0, CPU).pin():
        pass
    assert entered == [torch.device("cuda", 1)]
    assert card.key == "chip1"


# ---------------------------------------------------------------- planner

@pytest.mark.parametrize("bases,kw", [
    ([100] * 8, dict(n_devices=4)),
    ([100] * 4, {}),
    ([10000, 100, 100, 100], dict(n_devices=4)),
    ([100] * 6, dict(n_shards=3, n_devices=2)),
    ([5000, 4000, 300, 200, 100, 90, 80], dict(n_devices=3)),
    ([9000, 8000, 100], dict(n_devices=2, shards_per_chip=1)),
    ([700] * 3, dict(n_devices=8)),
])
def test_plans_equal_jax(bases, kw):
    mine = planner.plan_shards(_StubIndex(bases), **kw)
    theirs = jax_planner.plan_shards(_StubIndex(bases), **kw)
    assert (mine.mode, mine.shards, mine.costs, mine.devices) == \
        (theirs.mode, theirs.shards, theirs.costs, theirs.devices)


def test_dominant_contig_is_mesh_marked():
    plan = planner.plan_shards(_StubIndex([10000, 100, 100, 100]),
                               n_devices=4)
    big = next(si for si, s in enumerate(plan.shards) if s == [0])
    assert plan.devices[big] == planner.MESH_DEVICE == -1
    assert all(d >= 0 for si, d in enumerate(plan.devices) if si != big)
    assert (planner.MESH_DOMINANT_FACTOR, planner.SHARDS_PER_CHIP) == \
        (jax_planner.MESH_DOMINANT_FACTOR, jax_planner.SHARDS_PER_CHIP)


@pytest.mark.parametrize("seed", range(4))
def test_assign_devices_equals_jax(seed):
    rng = np.random.default_rng(seed)
    cost = rng.integers(1, 10000, 12).astype(np.int64)
    cost[0] *= 40
    bins = [[0], [1, 2], [3], [4, 5, 6], [7], [8, 9, 10, 11]]
    for n in (1, 2, 3, 5):
        assert planner.assign_devices(bins, cost, n) == \
            jax_planner.assign_devices(bins, cost, n)


# -------------------------------------------------------------- heartbeat

@pytest.mark.parametrize("credits", [
    [("host:1#chip0", 1.0), ("host:1#chip1", 2.0)],
    [("host:1#chip0", 1.0), ("host:1#chip1", 2.0), ("host:1#chip0", -5.0)],
    [("host:1", 1.5)],
    [(None, 0.5), ("other:9", 0.25)],
])
def test_heartbeat_per_worker_field_equals_jax(credits):
    mine, theirs = Heartbeat(4), JaxHeartbeat(4)
    for key, mbp in credits:
        mine.add_mbp(key, mbp)
        theirs.add_mbp(key, mbp)
    assert mine._per == theirs._per and mine._mbp == theirs._mbp
    assert mine._per_worker_str(2.0) == theirs._per_worker_str(2.0)
    out = io.StringIO()
    beat = Heartbeat(2, stream=out, worker="w0")
    for key, mbp in credits:
        beat.add_mbp(key, mbp)
    beat.emit("t")
    assert ("per[" in out.getvalue()) == (len(set(k for k, _ in credits))
                                          > 1)


# ---------------------------------------------------- multi-device runs

def _port_run(inputs, work, **kw):
    runner = ShardRunner(*map(str, inputs), work_dir=str(work),
                         num_threads=2, consensus="cuda", device="cpu",
                         window_length=150, **kw)
    buf = io.BytesIO()
    summary = runner.run(buf)
    return buf.getvalue(), summary, runner


def _jax_run(inputs, work, **kw):
    runner = JaxShardRunner(*map(str, inputs), work_dir=str(work),
                            num_threads=2, consensus_backend="tpu",
                            window_length=150, **kw)
    buf = io.BytesIO()
    summary = runner.run(buf)
    return buf.getvalue(), summary, runner


# the row keys of a chip worker's devices row that are not span timers
ROW_COUNTERS = {"shards", "mbp", "polish_s"}


def test_two_chip_workers_equal_one_and_jax(tmp_path, monkeypatch):
    inputs = _assembly(tmp_path, [2000, 2000, 2000, 2000])
    _devices(monkeypatch, 2)
    want, s1, _ = _port_run(inputs, tmp_path / "one", chips=1)
    assert s1["chips"] == 1 and s1["devices"] == {}
    assert {e["worker"].rsplit("#", 1)[-1] for e in s1["shards"]} == \
        {"chip0"}
    got, s2, runner = _port_run(inputs, tmp_path / "two", chips=2)
    jax_got, js2, jrunner = _jax_run(inputs, tmp_path / "jax", chips=2)
    assert got == want == jax_got
    assert (s2["chips"], s2["mode"], s2["n_shards"]) == \
        (js2["chips"], js2["mode"], js2["n_shards"]) == (2, "chips", 4)
    # the advisory plan is JAX's; where a shard ran is the lease race's
    assert runner.plan.devices == jrunner.plan.devices == [1, 0, 1, 0]
    assert {e["worker"].rsplit("#", 1)[-1] for e in s2["shards"]} == \
        {"chip0", "chip1"}
    stored = load_manifest(str(tmp_path / "two"))["shards"]
    assert {e["device"] for e in stored} == {0, 1}
    assert all("#chip" in e["worker"] for e in stored)
    # per-device rows: one a chip worker, with JAX's counters; which
    # worker ran which shard is the lease race's, so the totals compare
    assert set(s2["devices"]) == set(js2["devices"]) == {"0", "1"}
    for rows in (s2["devices"], js2["devices"]):
        assert sum(r["shards"] for r in rows.values()) == 4
        assert all(r["shards"] >= 1 for r in rows.values())
    assert sum(r["mbp"] for r in s2["devices"].values()) == \
        pytest.approx(sum(r["mbp"] for r in js2["devices"].values()))
    for dev, row in s2["devices"].items():
        jrow = js2["devices"][dev]
        assert ROW_COUNTERS <= set(row) and ROW_COUNTERS <= set(jrow)
        # the span mirrors the two packages share land in both rows
        shared = {"exec.shard", "exec.extract", "poa.pack", "poa.fetch"}
        assert shared <= set(row) and shared <= set(jrow)
    assert set(runner.report["devices"]) == set(jrunner.report["devices"])
    assert validate_report(runner.report) == []


def test_mesh_dominant_plan_equals_one_chip_and_jax(tmp_path, monkeypatch):
    inputs = _assembly(tmp_path, [6000, 700, 700], seed=37)
    _devices(monkeypatch, 2)
    want, _, _ = _port_run(inputs, tmp_path / "one", chips=1)
    got, summary, runner = _port_run(inputs, tmp_path / "two", chips=2)
    jax_got, jsummary, jrunner = _jax_run(inputs, tmp_path / "jax", chips=2)
    assert got == want == jax_got
    assert runner.plan.devices == jrunner.plan.devices
    assert planner.MESH_DEVICE in runner.plan.devices
    rows = [e for e in summary["shards"]
            if e.get("device") == planner.MESH_DEVICE]
    assert len(rows) == 1 and rows[0]["status"] == "done"
    assert rows[0]["worker"].endswith("#chip0")  # slot 0 runs mesh shards
    assert "mesh" in summary["devices"] and "mesh" in jsummary["devices"]
    mesh_eng = runner._chip_slots()[0].mesh_engines[1]
    assert mesh_eng.mesh.devices == (CPU, CPU)
    assert mesh_eng.stats["groups"] > 0
    assert validate_report(runner.report) == []


def test_cli_chips_in_process(tmp_path, monkeypatch, capsysbinary):
    inputs = list(map(str, _assembly(tmp_path, [2000, 1500])))
    _devices(monkeypatch, 2)
    base = ["-t", "2", "-w", "150", "-c", "1", "--device", "cpu"]
    assert cli.main(base + ["--chips", "1", "--shard-dir",
                            str(tmp_path / "w1")] + inputs) == 0
    one = capsysbinary.readouterr().out
    assert cli.main(base + ["--chips", "2", "--shard-dir",
                            str(tmp_path / "w2")] + inputs) == 0
    out = capsysbinary.readouterr()
    assert out.out == one and one.startswith(b">ctg0")
    assert b"chip scheduler: 2 in-process chip workers" in out.err
    # RACON_TPU_CHIPS routes the run to the shard runner as --chips does
    monkeypatch.setenv("RACON_TPU_CHIPS", "2")
    assert cli.main(base + ["--shard-dir", str(tmp_path / "w3")]
                    + inputs) == 0
    out = capsysbinary.readouterr()
    assert out.out == one and b"2 in-process chip workers" in out.err


def test_cli_negative_chips_is_jax_error(capsys):
    from racon_tpu import cli as jax_cli
    msgs = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["--chips", "-1", "a.fasta", "b.paf", "c.fasta"])
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0].split("error: ", 1)[1] == msgs[1].split("error: ", 1)[1]
    assert "--chips must be >= 0 (got -1)" in msgs[0]


def test_server_chip_slots_equal_jax(tmp_path, monkeypatch):
    from racon_tpu.serve.service import PolishServer as JaxServer
    from racon_tpu_torch.serve.service import PolishServer
    _devices(monkeypatch, 2)
    mine = PolishServer(str(tmp_path / "a.sock"), consensus_backend="cuda",
                        chips=2, workers=3, device="cpu", autostart=False)
    theirs = JaxServer(str(tmp_path / "b.sock"), consensus_backend="tpu",
                       chips=2, workers=3, autostart=False)
    ms, ts = mine._chip_slots(), theirs._chip_slots()
    assert [(w.slot.key, w.worker, w.ordinal) for w in ms] == \
        [(w.slot.key, w.worker, w.ordinal) for w in ts]
    assert [w.device is None for w in ms] == [w.device is None for w in ts]
    assert [w.device for w in ms[:2]] == [CPU, CPU]
    eng = ms[0].get_engines(cpu=False)[1]
    assert eng.pinned and eng.mesh is None
    # without --chips on the CPU: the unpinned pool of --workers
    plain = PolishServer(str(tmp_path / "c.sock"),
                         consensus_backend="cuda", workers=2, device="cpu",
                         autostart=False)
    assert [w.worker.rsplit("#", 1)[-1] for w in plain._chip_slots()][1:] \
        == ["w1"] and plain._chip_slots()[0].device is None


def test_runner_locks_join_the_witness_in_jax_order(tmp_path, monkeypatch):
    """Under the sanitizer the runner's three named locks are witnessed,
    made in JAX's order, and a two-worker run leaves no lock-order
    cycle."""
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    monkeypatch.setattr(sanitize, "_witness", None)
    inputs = _assembly(tmp_path, [2000, 1500, 1200])
    _devices(monkeypatch, 2)
    got, summary, runner = _port_run(inputs, tmp_path / "w", chips=2)
    locks = [runner._mf_lock, runner._note_lock, runner._states_lock]
    assert all(isinstance(lk, sanitize.WitnessedLock) for lk in locks)
    assert [lk.name for lk in locks] == \
        ["exec.manifest", "exec.notes", "exec.states"]
    jrunner = JaxShardRunner(*map(str, inputs), work_dir=str(tmp_path / "j"))
    assert [lk.name for lk in (jrunner._mf_lock, jrunner._note_lock,
                               jrunner._states_lock)] == \
        [lk.name for lk in locks]
    assert sanitize.lock_witness().cycles() == []
    assert len({e["worker"] for e in summary["shards"]}) == 2
    assert got.startswith(b">ctg")


def test_explicit_one_chip_pins_and_auto_stays_unpinned(tmp_path,
                                                      monkeypatch):
    inputs = _assembly(tmp_path, [1500])
    _devices(monkeypatch, 2)
    auto = ShardRunner(*map(str, inputs), work_dir=str(tmp_path / "a"),
                       consensus="cuda", device="cpu")
    assert [(w.device, w.worker) for w in auto._chip_slots()] == \
        [(None, auto.worker)]
    one = ShardRunner(*map(str, inputs), work_dir=str(tmp_path / "b"),
                      consensus="cuda", device="cpu", chips=1)
    assert [(w.device, w.worker) for w in one._chip_slots()] == \
        [(CPU, one.worker + "#chip0")]
    many = ShardRunner(*map(str, inputs), work_dir=str(tmp_path / "c"),
                       consensus="cuda", device="cpu", chips=5)
    assert [w.slot.key for w in many._chip_slots()] == ["chip0", "chip1"]
    # --workers never engages the scheduler on its own
    sec = ShardRunner(*map(str, inputs), work_dir=str(tmp_path / "d"),
                      consensus="cuda", device="cpu", secondary=True)
    assert len(sec._chip_slots()) == 1


@pytest.mark.parametrize("argv,env", [
    (["--chips", "1"], None), (["--chips", "2"], None), ([], "1")])
def test_explicit_chips_without_a_card_raises(tmp_path, monkeypatch,
                                              capsys, argv, env):
    """An explicit --chips (or RACON_TPU_CHIPS) on the default ``cuda``
    device pins the card: with no card the run raises the no-card error
    and writes nothing, as the one-shot path does; it never pins the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    if env is not None:
        monkeypatch.setenv("RACON_TPU_CHIPS", env)
    inputs = list(map(str, _assembly(tmp_path, [1500])))
    assert cli.main(argv + ["--shard-dir", str(tmp_path / "w")]
                    + inputs) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "torch.cuda.is_available() is False" in out.err
    runner = ShardRunner(*inputs, work_dir=str(tmp_path / "r"),
                         consensus="cuda", chips=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner._chip_slots()


def test_runner_and_server_share_the_slot_rule(tmp_path, monkeypatch):
    """One rule makes the runner's and the service's chip slots: an
    explicit --chips 1 pins device 0 in both (the CPU on a --device cpu
    run), and the service tops the pool up with its unpinned slots."""
    from racon_tpu_torch.serve.service import PolishServer
    inputs = _assembly(tmp_path, [1500])
    _devices(monkeypatch, 2)
    for chips, want in ((0, [None]), (1, [CPU]), (2, [CPU, CPU])):
        slots = topology.executor_slots(chips, ("native", "cuda"), "cpu")
        assert [s.device for s in slots] == want
        runner = ShardRunner(*map(str, inputs),
                             work_dir=str(tmp_path / f"r{chips}"),
                             consensus="cuda", device="cpu", chips=chips)
        server = PolishServer(str(tmp_path / f"s{chips}.sock"),
                              consensus_backend="cuda", chips=chips,
                              workers=3, device="cpu", autostart=False)
        rs, ss = runner._chip_slots(), server._chip_slots()
        assert [(w.slot.key, w.device) for w in rs] == \
            [(w.slot.key, w.device) for w in ss[:len(rs)]]
        assert [w.device for w in ss[len(rs):]] == [None] * (3 - len(rs))
    # a run across processes never engages on its own; a request does
    assert len(topology.executor_slots(0, ("cuda",), "cpu",
                                       multi_process=True)) == 1
    assert len(topology.executor_slots(2, ("cuda",), "cpu",
                                       multi_process=True)) == 2
