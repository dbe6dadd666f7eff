"""The port CLI's observability flags, on the CPU and the host engines
(``write_inputs(0.02, seed=11)``, the CLI called in this process):

- the polished bytes with ``--trace`` + ``--run-report``, with their
  environment equivalents, with ``--profile`` or ``RACON_TPU_TORCH_PROFILE``
  and with the sanitizer on equal the bytes with none of them;
- ``--trace`` alone writes ``run_report.json`` next to the trace;
- ``--profile`` supersedes ``RACON_TPU_TORCH_PROFILE`` with a note;
- a ``create_polisher`` error still writes the report.
"""

import json

import pytest
import torch

from racon_tpu_torch import cli
from racon_tpu_torch.obs import report, trace
from racon_tpu_torch.utils.simulate import write_inputs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    p = write_inputs(0.02, str(tmp_path_factory.mktemp("sim")), seed=11)
    return [p["reads"], p["overlaps"], p["draft"]]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("RACON_TPU_TRACE", "RACON_TPU_RUN_REPORT",
                 "RACON_TPU_TORCH_PROFILE", "RACON_TPU_SANITIZE"):
        monkeypatch.delenv(name, raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.deactivate()
    yield
    trace.deactivate()
    torch.set_num_threads(saved)


def _run(capsysbinary, args):
    rc = cli.main(["-t", "2", *args])
    return rc, capsysbinary.readouterr()


def _plain(capsysbinary, inputs):
    rc, cap = _run(capsysbinary, inputs)
    assert rc == 0 and cap.out.startswith(b">")
    return cap.out


@pytest.mark.parametrize("mode", ["flags", "env", "profile", "env_profile",
                                  "sanitize"])
def test_bytes_equal_with_observability_on(inputs, tmp_path, monkeypatch,
                                           capsysbinary, mode):
    plain = _plain(capsysbinary, inputs)
    args = []
    if mode == "flags":
        args = ["--trace", str(tmp_path / "t.json"), "--run-report",
                str(tmp_path / "r.json")]
    elif mode == "env":
        monkeypatch.setenv("RACON_TPU_TRACE", str(tmp_path / "t.json"))
        monkeypatch.setenv("RACON_TPU_RUN_REPORT", str(tmp_path / "r.json"))
    elif mode == "profile":
        args = ["--profile", str(tmp_path / "prof")]
    elif mode == "env_profile":
        # the polish phase alone, bracketed by the polisher
        monkeypatch.setenv("RACON_TPU_TORCH_PROFILE", str(tmp_path / "prof"))
    else:
        monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    rc, cap = _run(capsysbinary, [*args, *inputs])
    assert rc == 0 and cap.out == plain
    if mode in ("flags", "env"):
        rep = json.loads((tmp_path / "r.json").read_text())
        assert report.validate_report(rep) == []
        assert rep["phases"]["align_s"] >= 0
        events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        names = {e["name"] for e in events if e["ph"] == "X"}
        assert {"parse.targets", "align", "consensus", "stitch"} <= names
    if mode in ("profile", "env_profile"):
        files = list((tmp_path / "prof").glob("torch_trace.*.json"))
        assert len(files) == 1
        text = files[0].read_text()
        assert "queue.get" in text
        # the run-wide session holds the parse too, the polish phase's not
        assert ("parse.targets" in text) == (mode == "profile")


def test_trace_alone_writes_the_report_beside_it(inputs, tmp_path,
                                                 capsysbinary):
    plain = _plain(capsysbinary, inputs)
    rc, cap = _run(capsysbinary, ["--trace", str(tmp_path / "t.json"),
                                  *inputs])
    assert rc == 0 and cap.out == plain
    rep = json.loads((tmp_path / "run_report.json").read_text())
    assert report.validate_report(rep) == []
    assert rep["argv"][-3:] == inputs


def test_profile_supersedes_the_env_profile(inputs, tmp_path, monkeypatch,
                                            capsysbinary):
    monkeypatch.setenv("RACON_TPU_TORCH_PROFILE", str(tmp_path / "env"))
    rc, cap = _run(capsysbinary, ["--profile", str(tmp_path / "cli"),
                                  *inputs])
    assert rc == 0
    assert b"--profile supersedes RACON_TPU_TORCH_PROFILE" in cap.err
    assert len(list((tmp_path / "cli").glob("torch_trace.*.json"))) == 1
    assert not (tmp_path / "env").exists()


def test_create_polisher_error_still_writes_the_report(inputs, tmp_path,
                                                      capsysbinary):
    rc, cap = _run(capsysbinary, ["-w", "0", "--run-report",
                                  str(tmp_path / "r.json"), *inputs])
    assert rc == 1 and cap.out == b""
    assert b"invalid window length" in cap.err
    rep = json.loads((tmp_path / "r.json").read_text())
    assert report.validate_report(rep) == []
    assert rep["phases"] == {}
