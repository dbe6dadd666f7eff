"""The port's observability (``racon_tpu_torch/obs``) on the CPU.

- the metrics registry: the three kinds, groups, clears, thread safety;
- spans: off they record nothing; on they land in their timer and in the
  exported Chrome trace; the ring is bounded; under ``obs.profile`` they
  are ``record_function`` ranges of the torch profile;
- run reports: a round trip through the file, the validator's findings,
  ``python -m racon_tpu_torch.obs check``;
- the port's CLI report passes the JAX package's ``validate_report`` and
  the JAX CLI's report passes the port's, with the same key set in every
  section (both CLIs on the host engines, on ``write_inputs(0.02,
  seed=11)``);
- the flags: the JAX package's names, kinds, defaults and boolean
  semantics (``RACON_TPU_JAX_PROFILE`` renamed ``RACON_TPU_TORCH_PROFILE``),
  and ``flags.py`` is the port's only reader of the environment;
- the contract in both directions: every metric and span name that traced
  polisher runs emit (the PAF path on the device engines, the auto path,
  a consensus stream forced through stage B, a shard runner's run, a
  job through the fleet gateway and a host, the host's job scope taken
  off) is declared in ``racon_tpu_torch/contracts.py``, and every
  declared span is emitted.

The counters' equality with the JAX engines' is in
``test_torch_obs_counters.py``.
"""

import io
import json
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from racon_tpu import contracts as jax_contracts
from racon_tpu import flags as jax_flags
from racon_tpu.obs import report as jax_report
from racon_tpu_torch import contracts, flags, obs
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.exec import ShardRunner
from racon_tpu_torch.obs import metrics, report, trace
from racon_tpu_torch.ops import overlap_seed
from racon_tpu_torch.ops import poa as tpoa
from racon_tpu_torch.utils.simulate import simulate, write_inputs

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts and ends with recording off and a clean run."""
    trace.deactivate()
    metrics.clear_run()
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
    trace.deactivate()


# ---------------------------------------------------------------- flags

def test_flags_are_the_jax_flags():
    renamed = {"RACON_TPU_TORCH_PROFILE": "RACON_TPU_JAX_PROFILE"}
    for name, f in flags.REGISTRY.items():
        ref = jax_flags.REGISTRY[renamed.get(name, name)]
        assert (f.default, f.kind) == (ref.default, ref.kind), name
    assert "RACON_TPU_JAX_PROFILE" not in flags.REGISTRY


@pytest.mark.parametrize("value", ["", "0", "false", "No", " off ", "1",
                                   "yes", "2"])
def test_bool_semantics_equal_jax(monkeypatch, value):
    monkeypatch.setenv("RACON_TPU_SANITIZE", value)
    assert flags.get_bool("RACON_TPU_SANITIZE") == \
        jax_flags.get_bool("RACON_TPU_SANITIZE")


def test_numbers_and_undeclared_names(monkeypatch):
    monkeypatch.delenv("RACON_TPU_SANITIZE_SAMPLE", raising=False)
    assert flags.get_int("RACON_TPU_SANITIZE_SAMPLE") == 8
    monkeypatch.setenv("RACON_TPU_SANITIZE_SAMPLE", "")
    assert flags.get_int("RACON_TPU_SANITIZE_SAMPLE") == 0
    undeclared = "RACON_TPU_" + "NOT_A_FLAG"
    with pytest.raises(KeyError, match="not declared"):
        flags.raw(undeclared)


def test_flags_module_is_the_only_environment_reader():
    env = re.compile(r"\benviron\b|\bgetenv\b")
    readers = sorted(str(p.relative_to(REPO))
                     for p in (REPO / "racon_tpu_torch").rglob("*.py")
                     if env.search(p.read_text()))
    assert readers == ["racon_tpu_torch/flags.py"]


# ------------------------------------------------------------- registry

def test_registry_kinds_groups_and_clears():
    metrics.inc("align.chunks")
    metrics.inc("align.chunks", 4)
    metrics.set_gauge("queue.depth", 3)
    metrics.set_gauge("queue.depth", 1)
    metrics.add_time("queue.producer_wait_s", 0.25)
    metrics.add_time("queue.producer_wait_s", 0.5)
    metrics.inc("sanitize_probe", 7)          # not a run prefix
    assert metrics.counter("align.chunks") == 5
    assert metrics.gauge("queue.depth") == 1
    assert metrics.timer_s("queue.producer_wait_s") == 0.75
    assert metrics.group("queue.") == {"depth": 1, "producer_wait_s": 0.75}
    snap = metrics.snapshot()
    assert snap["counters"]["align.chunks"] == 5
    assert snap["timers"]["queue.producer_wait_s"] == 0.75
    metrics.clear("queue.")
    assert metrics.group("queue.") == {}
    metrics.clear_run()
    assert metrics.counter("align.chunks") == 0
    assert metrics.counter("sanitize_probe") == 7   # survives the run
    metrics.clear()
    assert metrics.counter("sanitize_probe") == 0


def test_registry_is_thread_safe():
    def work():
        for _ in range(20000):
            metrics.inc("align.chunks")
            metrics.add_time("align.fetch", 1.0)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert metrics.counter("align.chunks") == 120000
    assert metrics.timer_s("align.fetch") == 120000.0


def test_summaries_read_the_registry():
    metrics.inc("consensus.lanes_total", 100)
    metrics.inc("consensus.lanes_occupied", 25)
    metrics.inc("consensus.groups", 2)
    metrics.inc("consensus.group_windows", 9)
    metrics.inc("align.lanes_total", 10)
    metrics.inc("align.lanes_occupied", 5)
    metrics.add_time("queue.consumer_wait_s", 1.5)
    metrics.add_time("overlap.chain.fetch", 0.5)
    metrics.set_gauge("overlap.mode_auto", 1)
    assert metrics.pack_summary()["pack_efficiency"] == 0.25
    assert metrics.pack_summary()["windows_per_group"] == 4.5
    assert metrics.pack_summary()["align_pad_fraction"] == 0.5
    assert metrics.queue_summary()["stall_s"] == 1.5
    ov = metrics.overlap_summary()
    assert ov["mode"] == "auto" and ov["chain_fetch_s"] == 0.5


# ---------------------------------------------------------------- spans

def test_disabled_span_records_nothing(tmp_path):
    assert obs.span("align.dispatch") is trace.NULL_SPAN
    with obs.span("align.dispatch", pairs=3):
        pass
    assert metrics.timer_s("align.dispatch", -1.0) == -1.0
    out = trace.export(str(tmp_path / "t.json"))
    assert out == {"events": 1, "dropped": 0}    # the process row only


def test_enabled_span_lands_in_timer_and_trace(tmp_path):
    obs.begin(str(tmp_path / "t.json"), None)

    def other():
        with obs.span("poa.fetch", windows=2):
            pass

    with obs.span("align.dispatch", pairs=3):
        t = threading.Thread(target=other, name="racon-layers")
        t.start()
        t.join()
    with obs.track("contig 7"), obs.span("stitch"):
        pass
    assert metrics.timer_s("align.dispatch") > 0
    assert metrics.timer_s("poa.fetch") > 0
    trace.export(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    assert spans["align.dispatch"]["args"] == {"pairs": 3}
    assert spans["align.dispatch"]["cat"] == "align"
    assert spans["poa.fetch"]["tid"] != spans["align.dispatch"]["tid"]
    threads = {e["args"]["name"] for e in events
               if e["name"] == "thread_name"}
    assert "racon-layers" in threads
    assert {"MainThread/contig 7"} <= threads
    assert spans["stitch"]["tid"] != spans["align.dispatch"]["tid"]


def test_span_ring_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "RING_CAP", 8)
    obs.begin(str(tmp_path / "t.json"), None)
    for _ in range(20):
        with obs.span("queue.get"):
            pass
    out = trace.export(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert sum(e["ph"] == "X" for e in events) == 8
    assert out["dropped"] == 12
    assert metrics.gauge("trace.dropped_events") == 12
    # the timer still counts every exit
    assert metrics.snapshot()["timers"]["queue.get"] >= 0


def test_spans_are_record_function_ranges_under_profile(tmp_path):
    """With only a profile recording, spans enter record_function; a
    second profile inside the first is a no-op (one profiler a
    process)."""
    with obs.profile(str(tmp_path / "p")):
        assert trace.is_active()
        with obs.profile(str(tmp_path / "nested")):
            with obs.span("align.dispatch"):
                torch.ones(4).sum()
    assert not trace.is_active()
    files = list((tmp_path / "p").glob("torch_trace.*.json"))
    assert len(files) == 1 and not (tmp_path / "nested").exists()
    assert "align.dispatch" in files[0].read_text()


def test_kernel_ranges_only_while_a_profile_records(tmp_path):
    """``obs.profile_range`` (the kernel wrappers' range) is one shared
    no-op without a profile, and a ``record_function`` range in the trace
    while ``obs.profile`` records."""
    assert obs.profile_range("breaking_points") is obs.profile_range("x")
    with obs.profile_range("breaking_points"):
        pass
    with obs.profile(str(tmp_path / "p")):
        rng = obs.profile_range("breaking_points")
        assert isinstance(rng, torch.profiler.record_function)
        with rng:
            torch.ones(4).sum()
    assert not isinstance(obs.profile_range("breaking_points"),
                          torch.profiler.record_function)
    files = list((tmp_path / "p").glob("torch_trace.*.json"))
    assert len(files) == 1 and "breaking_points" in files[0].read_text()


# -------------------------------------------------------------- reports

def test_report_round_trip(tmp_path):
    metrics.inc("align.chunks", 3)
    metrics.add_time("poa.fetch", 0.5)
    metrics.inc("faults.injected.align.fetch")
    metrics.inc("swallowed.obs: probe|RuntimeError", 2)
    rep = report.build_report("cli", argv=["a", 1], started_unix=1.0,
                              wall_s=2.0, phases={"align_s": 0.25})
    path = str(tmp_path / "r.json")
    report.write_report(path, rep)
    back = json.loads(pathlib.Path(path).read_text())
    assert back == rep
    assert report.validate_report(back) == []
    assert back["dispatch_fetch"]["consensus_fetch_s"] == 0.5
    assert back["pack"]["align_chunks"] == 3
    assert back["faults"] == {"injected.align.fetch": 1}
    assert back["swallowed"] == {"obs: probe|RuntimeError": 2}
    assert back["argv"] == ["a", "1"] and back["retrace"] == {}


@pytest.mark.parametrize("corrupt,finding", [
    (lambda r: r.pop("queue"), "missing required key 'queue'"),
    (lambda r: r.update(extra=1), "unknown key 'extra'"),
    (lambda r: r.update(schema_version=10), "schema_version 10"),
    (lambda r: r["pack"].pop("groups"), "pack['groups']"),
    (lambda r: r["overlap"].update(mode="minimap"), "overlap['mode']"),
    (lambda r: r["compiles"]["events"].append({"fn": 1}),
     "compiles.events[0]"),
    (lambda r: r["metrics"]["counters"].update(x="y"), "metrics.counters"),
])
def test_validator_findings(corrupt, finding):
    # no build of an earlier test in this process in the report's events
    from racon_tpu_torch.obs import buildwatch
    buildwatch.reset()
    rep = report.build_report("cli")
    corrupt(rep)
    errors = report.validate_report(rep)
    assert any(finding in e for e in errors), errors


def test_obs_check_command(tmp_path):
    good = tmp_path / "good.json"
    report.write_report(str(good), report.build_report("cli"))
    bad = tmp_path / "bad.json"
    rep = report.build_report("cli")
    del rep["fleet"]
    bad.write_text(json.dumps(rep))
    torn = tmp_path / "torn.json"
    torn.write_text("{")
    rcs = {}
    for name, path in (("good", good), ("bad", bad), ("torn", torn)):
        proc = subprocess.run(
            [sys.executable, "-m", "racon_tpu_torch.obs", "check",
             str(path)], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        rcs[name] = proc.returncode
        if name == "bad":
            assert "fleet" in proc.stderr
    assert rcs == {"good": 0, "bad": 1, "torn": 2}


@pytest.fixture(scope="module")
def cli_reports(tmp_path_factory):
    """The port's and the JAX package's CLI reports of one input, both on
    the host engines."""
    d = tmp_path_factory.mktemp("cli")
    paths = write_inputs(0.02, str(d), seed=11)
    inputs = [paths["reads"], paths["overlaps"], paths["draft"]]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for pkg in ("racon_tpu", "racon_tpu_torch"):
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-m", pkg, "-t", "2", "--run-report",
             str(d / f"{pkg}.json"), *inputs], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    out = {}
    for pkg, proc in procs.items():
        stdout, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0
        out[pkg] = (stdout, json.loads((d / f"{pkg}.json").read_text()))
    return out


def test_cli_reports_pass_each_others_validator(cli_reports):
    port_bytes, port_rep = cli_reports["racon_tpu_torch"]
    jax_bytes, jax_rep = cli_reports["racon_tpu"]
    assert port_bytes == jax_bytes and port_bytes.startswith(b">")
    assert jax_report.validate_report(port_rep) == []
    assert report.validate_report(jax_rep) == []
    assert port_rep["kind"] == jax_rep["kind"] == "cli"


def test_cli_report_key_sets_equal_jax(cli_reports):
    """Section by section, the same keys as the JAX report. ``retrace``
    is the one exception: the port traces nothing and reports ``{}``,
    the JAX CLI reports its per-phase retrace deltas (all 0 on the host
    engines)."""
    port_rep = cli_reports["racon_tpu_torch"][1]
    jax_rep = cli_reports["racon_tpu"][1]
    assert set(port_rep) == set(jax_rep)
    for key, value in jax_rep.items():
        if key in ("phases", "metrics", "retrace", "argv"):
            continue
        if isinstance(value, dict):
            assert set(port_rep[key]) == set(value), key
    assert port_rep["retrace"] == {}
    assert set(jax_rep["retrace"].values()) <= {0}
    for kind in ("counters", "gauges", "timers"):
        assert kind in port_rep["metrics"]
    # the host engines' runs open the same spans (a process that built
    # its native library also has the build's timer)
    spans = [{k for k in rep["metrics"]["timers"] if k in names}
             for rep, names in ((port_rep, contracts.SPANS),
                                (jax_rep, jax_contracts.SPANS))]
    assert spans[0] == spans[1] and "align" in spans[0]


# ------------------------------------------------------------- contract

def _declared(name):
    """A declared metric, span timer or member of a dynamic family."""
    return (name in contracts.METRICS or name in contracts.SPANS
            or name.startswith(contracts.DYNAMIC_METRIC_PREFIXES))


def _emitted_names():
    snap = metrics.snapshot()
    return set(snap["counters"]) | set(snap["gauges"]) | set(snap["timers"])


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """Names emitted by traced polisher runs on simulate(0.01, seed=5)
    with 0.7-1.3 kbp reads: the PAF path on the device engines, the auto
    path (device aligner, host consensus, so the consensus takes the
    per-range run), and a device consensus stream forced through stage
    B, a shard runner's run on the host engines (its ``exec.*`` spans),
    and a job through a fleet gateway and one host on the host engines
    (``gateway.admit``, ``fleet.place``; the host's ``job.<id>.`` scope
    taken off its names). Returns (names per run, the exported trace
    events)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("traced")
    reads, paf, draft, _ = simulate(0.01, seed=5, coverage=30,
                                    mean_read=1000, max_read=1300,
                                    min_read=700)
    (d / "r.fastq").write_bytes(reads)
    (d / "o.paf").write_bytes(paf)
    (d / "d.fasta").write_bytes(draft)
    names, events = {}, []
    for key, ovl, consensus in (("paf", "o.paf", "cuda"),
                                ("auto", "auto", "native")):
        trace.deactivate()
        overlap_seed.clear_table_cache()
        obs.begin(str(d / f"{key}.json"), str(d / "r.json"))
        create_polisher(str(d / "r.fastq"), ovl if ovl == "auto"
                        else str(d / ovl), str(d / "d.fasta"),
                        num_threads=2, aligner="cuda", consensus=consensus,
                        device="cpu").run()
        trace.export(str(d / f"{key}.json"))
        events += json.loads((d / f"{key}.json").read_text())["traceEvents"]
        names[key] = _emitted_names()

    from tests.test_ragged import _mixed_windows
    from tests.test_torch_consensus_stream import _port_copy
    trace.deactivate()
    obs.begin(None, str(d / "r.json"))
    patched = {"MAX_GROUP_WINDOWS": 4, "STAGE_B_MAX_SURVIVOR_FRAC": 1.0}
    old = {k: getattr(tpoa, k) for k in patched}
    for k, v in patched.items():
        setattr(tpoa, k, v)
    try:
        from racon_tpu_torch.core.backends import NativePoaConsensus
        eng = tpoa.CudaPoaConsensus(
            3, -5, -4, fallback=NativePoaConsensus(3, -5, -4), band=128,
            rounds=4, device="cpu")
        eng.run(_port_copy(_mixed_windows(np.random.default_rng(100),
                                          with_quality=False)), trim=True)
    finally:
        for k, v in old.items():
            setattr(tpoa, k, v)
    assert eng.stats["stage_b_windows"] > 0
    names["stage_b"] = _emitted_names()
    trace.deactivate()
    obs.begin(None, str(d / "r.json"))
    ShardRunner(str(d / "r.fastq"), str(d / "o.paf"), str(d / "d.fasta"),
                num_threads=2, work_dir=str(d / "exec")).run(io.BytesIO())
    names["exec"] = _emitted_names()
    trace.deactivate()
    obs.begin(None, str(d / "r.json"))
    names["fleet"] = _fleet_run_names(d)
    trace.deactivate()
    torch.set_num_threads(saved)
    return names, events


def _fleet_run_names(d):
    """One job through an in-process gateway and host (the host engines,
    ``device="cpu"``): the names emitted, a job scope's prefix removed."""
    import tempfile

    from racon_tpu_torch.fleet.gateway import Gateway
    from racon_tpu_torch.obs import buildwatch
    from racon_tpu_torch.serve.client import ServiceClient
    from racon_tpu_torch.serve.service import PolishServer
    mp = pytest.MonkeyPatch()
    mp.setenv("RACON_TPU_SERVE_WARM_SHAPES", "")
    mp.setenv("RACON_TPU_FLEET_POLL_S", "0.05")
    sock_dir = tempfile.mkdtemp(dir="/tmp", prefix="tob")
    fleet_dir = str(d / "fleet")
    host = PolishServer(os.path.join(sock_dir, "h0.sock"), num_threads=2,
                        fleet_dir=fleet_dir, device="cpu")
    gateway = Gateway("127.0.0.1:0", fleet_dir)
    threads = [threading.Thread(target=t.serve_forever, daemon=True)
               for t in (host, gateway)]
    try:
        for t in threads:
            t.start()
        assert host.started.wait(60) and gateway.started.wait(60)
        with ServiceClient(f"127.0.0.1:{gateway.port}",
                           timeout_s=300) as c:
            sub = c.submit({"sequences": str(d / "r.fastq"),
                            "overlaps": str(d / "o.paf"),
                            "target_sequences": str(d / "d.fasta"),
                            "threads": 2})
            assert sub["ok"], sub
            header, payload = c.result(sub["job"], timeout_s=240)
            assert header["ok"] and payload, header
    finally:
        gateway.shutdown("now")
        host.shutdown()
        for t in threads:
            t.join(timeout=60)
        buildwatch.reset()
        mp.undo()
    scope = re.compile("^" + re.escape(contracts.JOB_SCOPE_ROOT) + r"[^.]+\.")
    return {scope.sub("", n, count=1) for n in _emitted_names()}


def test_every_emitted_name_is_declared(traced_runs):
    names, events = traced_runs
    for key, emitted in names.items():
        undeclared = sorted(n for n in emitted
                            if not _declared(n))
        assert undeclared == [], key
        assert all(contracts.METRIC_NAME_RE.match(n) for n in emitted
                   if not n.startswith("swallowed.")), key
    spans = {e["name"] for e in events if e["ph"] == "X"}
    assert spans <= contracts.SPANS


def test_every_declared_span_is_emitted(traced_runs):
    names, _ = traced_runs
    emitted = set().union(*names.values())
    assert contracts.SPANS - emitted == set()
    assert {"align.chunks", "consensus.groups", "overlap.chains_kept",
            "queue.depth", "overlap.mode_auto"} <= emitted
