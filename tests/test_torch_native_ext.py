"""The port's CPython extension over the overlap parser
(``racon_tpu_torch/native/pyext.cpp``) and its ASan/UBSan native build
(``RACON_TPU_NATIVE_SANITIZE``), against the JAX package.

- ``native.parse_ovlfile`` goes through the extension where Python's
  headers exist; its records equal the ctypes route's and the JAX native
  parser's, field for field and type for type, on PAF, MHAP and SAM made
  from ``write_inputs(0.02, seed=13)``, plain and gzipped;
- without the headers the ctypes route parses and the reason lands once in
  the report's ``swallowed`` section; with them a failed build raises;
- ``pyext.cpp`` is built into its own module, never into the ctypes
  library;
- the port of ``ci/checks/native_sanitize.sh``: under the preloaded ASan
  runtime and ``RACON_TPU_NATIVE_SANITIZE=1`` the library builds as
  ``libracon_torch_native_san.so`` and the ``bp.cpp`` thread pool and the
  chunked gzip parser run clean (skipped only where ``libasan.so`` does
  not resolve, as the script skips); without the runtime ``load`` raises
  the JAX package's message.
"""

import ctypes
import gzip
import os
import pathlib
import subprocess
import sys

import pytest

from racon_tpu import native as jax_native
from racon_tpu_torch import native
from racon_tpu_torch.io import parsers
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.utils.simulate import write_inputs

from test_torch_parsers import paf_to_mhap, paf_to_sam  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CODES = {"paf": 0, "mhap": 1, "sam": 2}
INPUTS = [f"{kind}{gz}" for kind in CODES for gz in ("", ".gz")]


@pytest.fixture(scope="module")
def ovl_files(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("ext"))
    sim = write_inputs(0.02, str(d / "sim"), seed=13)
    paf = pathlib.Path(sim["overlaps"]).read_bytes()
    reads = {r.name: r.data for r in parsers._parse_fastq_py(sim["reads"])}
    targets = {t.name: t.data
               for t in parsers._parse_fasta_py(sim["draft"])}
    blobs = {"paf": paf,
             "mhap": paf_to_mhap(paf, list(reads), list(targets), seed=3),
             "sam": paf_to_sam(paf, reads, targets)}
    out = {}
    for kind, blob in blobs.items():
        plain = d / f"o.{kind}"
        plain.write_bytes(blob)
        gz = d / f"o.{kind}.gz"
        gz.write_bytes(gzip.compress(blob, compresslevel=1))
        out[kind] = (kind, str(plain))
        out[kind + ".gz"] = (kind, str(gz))
    return out


def _typed(records) -> list:
    return [tuple((type(v).__name__, v) for v in r) for r in records]


@pytest.mark.parametrize("name", INPUTS)
def test_extension_records_equal_ctypes_and_jax(ovl_files, name):
    kind, path = ovl_files[name]
    code = CODES[kind]
    calls = native.PARSE_CALLS["ovlfile"]
    via_ext = native.parse_ovlfile(path, code)
    assert native.PARSE_CALLS["ovlfile"] == calls + 1
    # the extension parsed wherever Python's headers exist
    assert native.EXT_STATE == ("loaded" if native._python_headers()
                                .exists() else "no_headers")
    assert isinstance(via_ext, list) and len(via_ext) > 50
    via_ctypes = native._parse_ovlfile_ctypes(path, code)
    want = [r.fields for r in jax_native.parse_ovlfile(path, code)]
    assert _typed(via_ext) == _typed(via_ctypes) == _typed(want)
    assert _typed(via_ext) == _typed(
        r.fields for r in getattr(parsers, f"_parse_{kind}_py")(path))


def test_extension_raises_the_parser_message(tmp_path):
    bad = tmp_path / "bad.paf"
    bad.write_bytes(b"q\t10\t0\t5\n")
    with pytest.raises(ValueError) as ext_err:
        native.parse_ovlfile(str(bad), 0)
    with pytest.raises(ValueError) as ctypes_err:
        native._parse_ovlfile_ctypes(str(bad), 0)
    assert str(ext_err.value) == str(ctypes_err.value)


def test_no_headers_takes_ctypes_and_logs_it_once(ovl_files, tmp_path,
                                                  monkeypatch):
    kind, path = ovl_files["paf"]
    monkeypatch.setattr(native, "EXT_STATE", None)
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_python_headers",
                        lambda: tmp_path / "include" / "Python.h")
    metrics.clear("swallowed.")
    got = native.parse_ovlfile(path, 0)
    again = native.parse_ovlfile(path, 0)
    assert native.EXT_STATE == "no_headers" and native._ext is None
    assert got == again == native._parse_ovlfile_ctypes(path, 0)
    logged = metrics.group("swallowed.")
    assert list(logged.values()) == [1], logged
    assert "ctypes overlap parser" in next(iter(logged))


def test_failed_extension_build_raises_where_headers_exist(tmp_path,
                                                           monkeypatch):
    broken = tmp_path / "pyext.cpp"
    broken.write_text("#include <Python.h>\nthis is not C++;\n")
    headers = tmp_path / "include" / "Python.h"
    headers.parent.mkdir()
    headers.write_text("")
    monkeypatch.setattr(native, "EXT_STATE", None)
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_EXT_SOURCES", [broken])
    monkeypatch.setattr(native, "_python_headers", lambda: headers)
    monkeypatch.setattr(native, "_ext_path",
                        lambda: tmp_path / "racon_torch_native_ext.so")
    with pytest.raises(native.NativeBuildError, match="pyext.cpp|failed"):
        native.parse_ovlfile(str(broken), 0)
    assert native.EXT_STATE is None


def test_pyext_is_not_in_the_ctypes_library():
    names = [s.name for s in native._SOURCES]
    assert "pyext.cpp" not in names
    # the JAX package's four sources and the aligner's upload packer
    assert sorted(names) == ["bp.cpp", "nw.cpp", "pack.cpp", "parsers.cpp",
                             "poa.cpp"]
    assert [s.name for s in native._EXT_SOURCES] == ["pyext.cpp",
                                                     "parsers.cpp"]
    lib = ctypes.CDLL(str(native.build()))
    assert hasattr(lib, "rt_parse_ovlfile")
    assert not hasattr(lib, "PyInit_racon_torch_native_ext")
    assert native._lib_path().name == "libracon_torch_native.so"


def _libasan() -> str:
    try:
        out = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except FileNotFoundError:
        return ""
    return out if out and os.path.isabs(out) and os.path.exists(out) else ""


# the two probes of ci/checks/native_sanitize.sh, on the port's library
_PROBES = r"""
import gzip
import pathlib
import re
import sys
import tempfile

from racon_tpu_torch import native

path = native.build(force=True)
assert path.name == "libracon_torch_native_san.so", path
assert native.load() is not None

# 1) bp.cpp: the thread-pool breaking-points decoder (threaded writes
#    into one shared output buffer at per-overlap offsets)
cigars = ["5M2I3M1D10M", "20M", "", "3M1I1D3M" * 40, "7M"] * 50
n = len(cigars)
ends = [sum(int(c[:-1]) for c in re.findall(r"\d+[MD]", s))
        for s in cigars]
arrs = native.bp_from_cigar_batch(cigars, [0] * n, [0] * n, ends, 5,
                                  num_threads=4)
assert len(arrs) == n and arrs[0].shape[1] == 4
print("BP", sum(len(a) for a in arrs), int(sum(a.sum() for a in arrs)))

# 2) parsers.cpp: the chunked gzip inflate (the rolling buffer refilled
#    across chunk edges) on 20 reads of 200 kbp
with tempfile.TemporaryDirectory() as d:
    tmp = pathlib.Path(d) / "long.fastq.gz"
    long_seq = b"ACGT" * 50000
    with gzip.open(tmp, "wb") as gz:
        for i in range(20):
            gz.write(b"@r%d\n" % i + long_seq + b"\n+\n"
                     + b"9" * len(long_seq) + b"\n")
    recs = native.parse_seqfile(str(tmp), True)
assert len(recs) == 20 and all(r[1] == long_seq for r in recs)
print("GZIP", len(recs), len(recs[0][1]))
print("SAN OK", path.name)
"""


def _probe_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RACON_TPU_") and k != "LD_PRELOAD"}
    env.update(PYTHONPATH=str(ROOT), RACON_TPU_NATIVE_SANITIZE="1",
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1", **extra)
    return env


def test_sanitized_build_runs_the_probes_clean():
    libasan = _libasan()
    if not libasan:
        pytest.skip("no libasan runtime (g++ -print-file-name=libasan.so)")
    proc = subprocess.run([sys.executable, "-c", _PROBES], cwd=ROOT,
                          env=_probe_env(LD_PRELOAD=libasan),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    # the same cigars through the plain library give the same rows
    cigars = ["5M2I3M1D10M", "20M", "", "3M1I1D3M" * 40, "7M"] * 50
    import re
    n = len(cigars)
    ends = [sum(int(c[:-1]) for c in re.findall(r"\d+[MD]", s))
            for s in cigars]
    arrs = native.bp_from_cigar_batch(cigars, [0] * n, [0] * n, ends, 5,
                                      num_threads=4)
    assert f"BP {sum(len(a) for a in arrs)} " \
        f"{int(sum(a.sum() for a in arrs))}" in lines
    assert "GZIP 20 200000" in lines
    assert "SAN OK libracon_torch_native_san.so" in lines
    assert "AddressSanitizer" not in proc.stderr
    assert "runtime error" not in proc.stderr


def test_sanitized_load_without_the_runtime_names_the_fix():
    code = ("from racon_tpu_torch import native\n"
            "try:\n"
            "    native.load()\n"
            "except native.NativeBuildError as e:\n"
            "    print('RAISED', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_probe_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert "RAISED loading the RACON_TPU_NATIVE_SANITIZE build requires " \
        "the ASan runtime preloaded" in proc.stdout
