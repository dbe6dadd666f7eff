"""The port's fault classification and injection (``racon_tpu_torch/
faults.py``) against the JAX package's ``racon_tpu/faults.py``, on the CPU:

- ``classify`` gives the JAX class on a list of exceptions, a
  ``torch.cuda.OutOfMemoryError`` (``device-oom``) among them;
- ``parse_spec`` parses the grammar of ``tests/test_faults.py`` as JAX
  does at the port's three engine sites and its five service sites,
  rejects the same malformed entries, and rejects the JAX package's fleet
  sites as unknown;
- one-shot, persistent and seeded-probability specs fire at the same calls
  in both packages;
- ``align.dispatch``, ``align.fetch`` and ``consensus.dispatch`` injected
  into a small polisher run on the device engines raise their class and
  produce no output; through the CLI the run report counts the injection.
"""

import errno
import json

import pytest
import torch

from racon_tpu import faults as jax_faults
from racon_tpu_torch import cli, faults
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.obs import trace
from racon_tpu_torch.utils.simulate import simulate


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("RACON_TPU_FAULTS", raising=False)
    monkeypatch.delenv("RACON_TPU_FAULTS_SEED", raising=False)
    faults.reset()
    jax_faults.reset()
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
    trace.deactivate()
    faults.reset()
    jax_faults.reset()


# ------------------------------------------------------------- classify

EXCEPTIONS = [
    lambda m: OSError(errno.EIO, "x"),
    lambda m: OSError(errno.ENOSPC, "disk full"),
    lambda m: FileNotFoundError(2, "gone"),
    lambda m: RuntimeError("RESOURCE_EXHAUSTED: out of memory while trying "
                           "to allocate"),
    lambda m: m.DeviceOOMError("boom"),
    lambda m: m.StallError("wedged"),
    lambda m: m.TransientIOError(errno.EIO, "injected"),
    lambda m: m.InjectedFault("injected"),
    lambda m: ValueError("bad input"),
    lambda m: MemoryError("Out of memory"),
    lambda m: RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
    lambda m: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)"),
]


@pytest.mark.parametrize("make", EXCEPTIONS)
def test_classify_equals_jax(make):
    assert faults.classify(make(faults)) == \
        jax_faults.classify(make(jax_faults))


def test_cuda_oom_is_device_oom():
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 MiB")
    assert faults.classify(exc) == faults.CLASS_OOM == "device-oom"
    assert faults.CLASSES == jax_faults.CLASSES


@pytest.mark.parametrize("k,token", [(0, "a"), (3, "shard-7"), (5, "")])
def test_backoff_equals_jax(k, token):
    assert faults.backoff_s(0.5, k, token) == jax_faults.backoff_s(0.5, k,
                                                                   token)


# ------------------------------------------------------------- grammar

def _specs(mod, raw):
    return {site: [(s.site, s.kind, s.at, s.every, s.prob) for s in specs]
            for site, specs in mod.parse_spec(raw).items()}


@pytest.mark.parametrize("raw", [
    # tests/test_faults.py's grammar string on the port's sites
    "align.fetch:io@3,consensus.dispatch:oom*,align.dispatch:enospc,"
    "align.dispatch:kill@2,consensus.dispatch:io%0.5",
    "align.fetch:stall@2*, align.fetch:err",
    "",
])
def test_parse_spec_equals_jax(raw):
    assert _specs(faults, raw) == _specs(jax_faults, raw)


@pytest.mark.parametrize("raw,match", [
    ("nosuch.site:io", "unknown"),
    ("align.fetch:frobnicate", "unknown"),
    ("align.fetch:io@0", "1-based"),
    ("align.fetch:io%1.5", "probability"),
    ("align.fetch", "no ':'"),
])
def test_parse_spec_rejects_like_jax(raw, match):
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match=match):
            mod.parse_spec(raw)


@pytest.mark.parametrize("site", ["fleet.place", "gateway.accept"])
def test_jax_only_sites_are_unknown_to_the_port(site):
    jax_faults.parse_spec(f"{site}:io")
    with pytest.raises(ValueError, match="unknown"):
        faults.parse_spec(f"{site}:io")


@pytest.mark.parametrize("site", ["serve.journal", "server.kill",
                                  "serve.socket", "serve.polish",
                                  "serve.slot"])
def test_service_sites_parse_like_jax(site):
    raw = f"{site}:io@2*"
    assert _specs(faults, raw) == _specs(jax_faults, raw)


# ------------------------------------------------------------- firing

def _fired(mod, sites, n):
    out = []
    for i in range(n):
        site = sites[i % len(sites)]
        try:
            mod.check(site)
            out.append(None)
        except (RuntimeError, OSError) as e:
            out.append((site, type(e).__name__))
    return out


@pytest.mark.parametrize("raw,seed", [
    ("align.fetch:io@2", "0"),                        # one-shot
    ("align.fetch:io@1*", "0"),                       # persistent
    ("align.dispatch:oom@3*,align.fetch:stall@2", "0"),
    ("consensus.dispatch:err%0.5", "11"),             # seeded
    ("consensus.dispatch:err%0.5", "99"),
    ("align.fetch:enospc%0.3,align.dispatch:err@4", "5"),
])
def test_firing_sequence_equals_jax(monkeypatch, raw, seed):
    monkeypatch.setenv("RACON_TPU_FAULTS", raw)
    monkeypatch.setenv("RACON_TPU_FAULTS_SEED", seed)
    sites = ("align.dispatch", "align.fetch", "consensus.dispatch")
    got = _fired(faults, sites, 48)
    want = _fired(jax_faults, sites, 48)
    assert got == want
    assert any(got)


def test_seeded_draws_replay_and_differ_by_seed(monkeypatch):
    def draws(seed):
        monkeypatch.setenv("RACON_TPU_FAULTS", "align.fetch:err%0.5")
        monkeypatch.setenv("RACON_TPU_FAULTS_SEED", seed)
        faults.reset()
        return _fired(faults, ("align.fetch",), 32)

    a, b, c = draws("11"), draws("11"), draws("99")
    assert a == b and a != c and 0 < sum(x is not None for x in a) < 32


# ------------------------------------------- injection into a polish run

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    reads, paf, draft, _ = simulate(0.004, seed=5, coverage=10,
                                    mean_read=1000, max_read=1300,
                                    min_read=700)
    (d / "r.fastq").write_bytes(reads)
    (d / "o.paf").write_bytes(paf)
    (d / "d.fasta").write_bytes(draft)
    return [str(d / "r.fastq"), str(d / "o.paf"), str(d / "d.fasta")]


@pytest.mark.parametrize("site,kind,exc,cls", [
    ("align.dispatch", "oom", faults.DeviceOOMError, "device-oom"),
    ("align.fetch", "io", faults.TransientIOError, "transient-io"),
    ("consensus.dispatch", "err", faults.InjectedFault,
     "deterministic-compute"),
])
def test_injected_site_raises_its_class(tiny, monkeypatch, site, kind, exc,
                                        cls):
    monkeypatch.setenv("RACON_TPU_FAULTS", f"{site}:{kind}")
    polisher = create_polisher(*tiny, num_threads=2, aligner="cuda",
                               consensus="cuda", device="cpu")
    with pytest.raises(exc) as info:
        polisher.run()
    assert faults.classify(info.value) == cls
    assert site in str(info.value)


def test_cli_injection_writes_no_bytes_and_reports_it(tiny, monkeypatch,
                                                      tmp_path,
                                                      capsysbinary):
    monkeypatch.setenv("RACON_TPU_FAULTS", "align.dispatch:oom")
    with pytest.raises(faults.DeviceOOMError):
        cli.main(["-t", "2", "-c", "1", "--cudaaligner-batches", "1",
                  "--device", "cpu", "--run-report",
                  str(tmp_path / "r.json"), *tiny])
    assert capsysbinary.readouterr().out == b""
    rep = json.loads((tmp_path / "r.json").read_text())
    assert rep["faults"] == {"injected.align.dispatch": 1}
