"""Host-native core of the port: the C++ aligner, POA engine, CIGAR
breaking-point decoder and streaming FASTA/FASTQ/PAF/MHAP/SAM parsers
(copies of ``racon_tpu/native/{nw,poa,bp,parsers}.cpp``), loaded with
ctypes, and the CPython extension over the overlap parser
(``pyext.cpp``, a copy of the JAX package's).

Built on demand with g++ (linked with zlib, which the parsers inflate
gzip with) into ``build/native`` at the root of the checkout and rebuilt
when a source is newer. Every input file is parsed here
(``io/parsers.py``), the device engines send the pairs and windows they
reject here, and the smoke scores polished contigs with
:func:`edit_distance`. ``PARSE_CALLS`` counts the files parsed without
error, by entry point.

:func:`parse_ovlfile` goes through the extension wherever Python's headers
exist (its build or load failing there raises :class:`NativeBuildError`)
and through ctypes where they do not (the reason is logged once to the
run report's ``swallowed`` section); ``EXT_STATE`` says which
(``"loaded"`` or ``"no_headers"``, ``None`` before the first parse).

``RACON_TPU_NATIVE_SANITIZE=1`` builds the ctypes library with ASan and
UBSan (``-fsanitize=address,undefined``) into its own
``libracon_torch_native_san.so``, so the fast build is never evicted;
loading it needs the ASan runtime preloaded (``LD_PRELOAD=$(g++
-print-file-name=libasan.so)``), so the variant is fixed per process at
its first load.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sysconfig
import threading
import time

import numpy as np

from .. import flags
from .._paths import build_root
from ..obs import buildwatch

_DIR = pathlib.Path(__file__).resolve().parent
# pyext.cpp needs Python's headers: it is built into its own module, so
# the ctypes library never depends on them
_SOURCES = sorted(s for s in _DIR.glob("*.cpp") if s.name != "pyext.cpp")
_EXT_SOURCES = [_DIR / "pyext.cpp", _DIR / "parsers.cpp"]
_EXT_NAME = "racon_torch_native_ext"
_lock = threading.Lock()
_lib = None
_ext = None
# which route parse_ovlfile takes: "loaded" (the extension) or
# "no_headers" (ctypes); None until the first overlap parse
EXT_STATE = None
PARSE_CALLS = {"seqfile": 0, "ovlfile": 0}

# the sanitized build keeps frame pointers and -O1, so the sanitizers'
# reports carry usable stacks (the JAX package's options)
_SANITIZE_OPTS = ["-O1", "-g", "-fno-omit-frame-pointer",
                  "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=undefined"]


class NativeBuildError(RuntimeError):
    pass


def _sanitize_build() -> bool:
    """ASan/UBSan build mode (``RACON_TPU_NATIVE_SANITIZE=1``)."""
    return flags.get_bool("RACON_TPU_NATIVE_SANITIZE")


def _lib_path() -> pathlib.Path:
    name = ("libracon_torch_native_san.so" if _sanitize_build()
            else "libracon_torch_native.so")
    return build_root() / "native" / name


def _ext_path() -> pathlib.Path:
    return build_root() / "native" / f"{_EXT_NAME}.so"


def _compile(path: pathlib.Path, sources, opts, library: str,
             force: bool) -> pathlib.Path:
    """g++ ``sources`` into ``path`` when it is missing or older than one
    of them (into a temporary file renamed into place, so concurrent
    processes never load a half-written one); the build's seconds go to
    ``obs.buildwatch`` as ``library``."""
    if not force and path.exists() and all(
            s.stat().st_mtime <= path.stat().st_mtime for s in sources):
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    cmd = ["g++", *opts, "-std=c++17", "-shared", "-fPIC", "-pthread",
           *[str(s) for s in sources], "-o", str(tmp), "-lz"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(f"native build of {path.name} failed:\n"
                               f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    buildwatch.record(library, time.perf_counter() - t0, "g++")
    return path


def build(force: bool = False) -> pathlib.Path:
    """Compile the ctypes library if needed (the ASan/UBSan variant under
    ``RACON_TPU_NATIVE_SANITIZE``); returns its path."""
    san = _sanitize_build()
    return _compile(_lib_path(), _SOURCES,
                    _SANITIZE_OPTS if san else ["-O3", "-march=native"],
                    "native_san" if san else "native", force)


def _python_headers() -> pathlib.Path:
    return pathlib.Path(sysconfig.get_paths()["include"]) / "Python.h"


def _load_ext():
    """The CPython extension (built at first use), or None where Python's
    headers are missing: then the ctypes route parses, and the reason is
    logged once to the report's ``swallowed`` section. Where the headers
    exist a failed build or load raises :class:`NativeBuildError`."""
    global _ext, EXT_STATE
    with _lock:
        if EXT_STATE is not None:
            return _ext
        headers = _python_headers()
        if not headers.exists():
            from ..utils.logger import log_swallowed
            log_swallowed("native: CPython extension not built, the ctypes "
                          "overlap parser in use",
                          FileNotFoundError(f"no {headers}"))
            EXT_STATE = "no_headers"
            return None
        path = _compile(_ext_path(), _EXT_SOURCES,
                        ["-O3", "-march=native",
                         f"-I{headers.parent}"], "native_ext", False)
        import importlib.machinery
        import importlib.util
        try:
            loader = importlib.machinery.ExtensionFileLoader(_EXT_NAME,
                                                             str(path))
            spec = importlib.util.spec_from_loader(_EXT_NAME, loader)
            ext = importlib.util.module_from_spec(spec)
            loader.exec_module(ext)
        except ImportError as e:
            raise NativeBuildError(f"loading {path} failed: {e}") from e
        _ext, EXT_STATE = ext, "loaded"
        return _ext


def _asan_preloaded() -> bool:
    """Whether the ASan runtime is in this process (its entry resolves in
    the global symbol namespace)."""
    return hasattr(ctypes.CDLL(None), "__asan_init")


def load():
    """The ctypes library handle (built at first use). The sanitized
    variant raises :class:`NativeBuildError` naming the fix when the ASan
    runtime is not preloaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        if _sanitize_build() and not _asan_preloaded():
            # the ASan runtime ends the process, with no exception, when
            # an instrumented object is opened in a Python without it
            raise NativeBuildError(
                "loading the RACON_TPU_NATIVE_SANITIZE build requires "
                "the ASan runtime preloaded: run under LD_PRELOAD="
                '"$(g++ -print-file-name=libasan.so)"')
        lib = ctypes.CDLL(str(path))
        i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        lib.rt_edit_distance.restype = i64
        lib.rt_edit_distance.argtypes = [ctypes.c_char_p, i64,
                                         ctypes.c_char_p, i64]
        lib.rt_nw_cigar_batch.restype = None
        lib.rt_nw_cigar_batch.argtypes = [
            i64, ctypes.POINTER(ctypes.c_char_p), i64p,
            ctypes.POINTER(ctypes.c_char_p), i64p, i64,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.rt_poa_consensus_batch.restype = None
        lib.rt_poa_consensus_batch.argtypes = [
            i64, i64p, ctypes.POINTER(ctypes.c_char_p), i64p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint8),
            i64p, i64p, i64p, i64p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, i64, i64, i64, i64,
            ctypes.POINTER(ctypes.c_void_p), i64p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
        lib.rt_free.restype = None
        lib.rt_free.argtypes = [ctypes.c_void_p]
        lib.rt_parse_seqfile.restype = i64
        lib.rt_parse_seqfile.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_char_p]
        lib.rt_parse_ovlfile.restype = i64
        lib.rt_parse_ovlfile.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p]
        lib.rt_bp_from_cigar_batch.restype = None
        lib.rt_bp_from_cigar_batch.argtypes = [
            i64, ctypes.POINTER(ctypes.c_char_p), i64p, i64p, i64p, i64,
            i64, i64p, ctypes.POINTER(ctypes.c_int32), i64p]
        _lib = lib
        return _lib


def edit_distance(a: bytes, b: bytes) -> int:
    """Unit-cost edit distance (Myers bit-parallel)."""
    return load().rt_edit_distance(a, len(a), b, len(b))


def nw_cigar_batch(pairs, num_threads: int = 1) -> list:
    """Global unit-cost alignment of many (query, target) byte pairs on a
    C++ thread pool; CIGARs use M/I/D with I consuming the query."""
    lib = load()
    count = len(pairs)
    if count == 0:
        return []
    qs = (ctypes.c_char_p * count)(*[q for q, _ in pairs])
    ts = (ctypes.c_char_p * count)(*[t for _, t in pairs])
    qns = (ctypes.c_int64 * count)(*[len(q) for q, _ in pairs])
    tns = (ctypes.c_int64 * count)(*[len(t) for _, t in pairs])
    outs = (ctypes.c_void_p * count)()
    lib.rt_nw_cigar_batch(count, qs, qns, ts, tns, num_threads, outs)
    result = []
    for i in range(count):
        result.append(ctypes.string_at(outs[i]).decode())
        lib.rt_free(outs[i])
    return result


def poa_consensus_batch(windows, trim: bool, match: int, mismatch: int,
                        gap: int, num_threads: int = 1) -> list:
    """Spoa-semantics consensus for a batch of windows on the C++ thread
    pool. Returns ``[(consensus bytes, polished, failed), ...]``."""
    lib = load()
    nw = len(windows)
    if nw == 0:
        return []
    from ..core.window import WindowType
    first = [0]
    seqs, lens, quals, has_qual, begins, ends = [], [], [], [], [], []
    ids, ranks, is_tgs = [], [], []
    for w in windows:
        for i, seq in enumerate(w.sequences):
            seqs.append(seq)
            lens.append(len(seq))
            q = w.qualities[i]
            quals.append(q if q is not None else b"")
            has_qual.append(1 if q is not None else 0)
            b, e = w.positions[i]
            begins.append(b)
            ends.append(e)
        first.append(len(seqs))
        ids.append(w.id)
        ranks.append(w.rank)
        is_tgs.append(1 if w.type == WindowType.TGS else 0)
    ns = len(seqs)
    c_out = (ctypes.c_void_p * nw)()
    c_outlen = (ctypes.c_int64 * nw)()
    c_pol = (ctypes.c_uint8 * nw)()
    c_status = (ctypes.c_uint8 * nw)()
    lib.rt_poa_consensus_batch(
        nw, (ctypes.c_int64 * (nw + 1))(*first),
        (ctypes.c_char_p * ns)(*seqs), (ctypes.c_int64 * ns)(*lens),
        (ctypes.c_char_p * ns)(*quals), (ctypes.c_uint8 * ns)(*has_qual),
        (ctypes.c_int64 * ns)(*begins), (ctypes.c_int64 * ns)(*ends),
        (ctypes.c_int64 * nw)(*ids), (ctypes.c_int64 * nw)(*ranks),
        (ctypes.c_uint8 * nw)(*is_tgs), 1 if trim else 0, match, mismatch,
        gap, num_threads, c_out, c_outlen, c_pol, c_status)
    result = []
    for i in range(nw):
        if c_out[i]:
            data = ctypes.string_at(c_out[i], c_outlen[i])
            lib.rt_free(c_out[i])
        else:
            data = b""
        result.append((data, bool(c_pol[i]), bool(c_status[i])))
    return result


def bp_from_cigar_batch(cigars, q_offs, t_begins, t_ends,
                        window_length: int, num_threads: int = 1) -> list:
    """Decode CIGARs into per-window breaking-point rows ``(t_first,
    q_first, t_end_excl, q_end_excl)`` on the C++ thread pool; one int32
    ``(k, 4)`` array per CIGAR, row-identical to
    ``core.overlap.breaking_points_from_cigar``."""
    lib = load()
    count = len(cigars)
    if count == 0:
        return []
    enc = [c.encode() if isinstance(c, str) else (c or b"")
           for c in cigars]
    qo = np.ascontiguousarray(q_offs, dtype=np.int64)
    tb = np.ascontiguousarray(t_begins, dtype=np.int64)
    te = np.ascontiguousarray(t_ends, dtype=np.int64)
    w = int(window_length)
    caps = np.maximum(0, (np.maximum(te, 1) - 1) // w - tb // w) + 1
    offs = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(caps, out=offs[1:])
    out = np.empty(int(offs[-1]) * 4, dtype=np.int32)
    counts = np.zeros(count, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rt_bp_from_cigar_batch(
        count, (ctypes.c_char_p * count)(*enc),
        qo.ctypes.data_as(i64p), tb.ctypes.data_as(i64p),
        te.ctypes.data_as(i64p), w, num_threads,
        offs.ctypes.data_as(i64p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(i64p))
    return [out[int(offs[i]) * 4: (int(offs[i]) + int(counts[i])) * 4]
            .reshape(-1, 4) for i in range(count)]


def reset_parse_calls() -> None:
    for key in PARSE_CALLS:
        PARSE_CALLS[key] = 0


def parse_seqfile(path: str, is_fastq: bool) -> list:
    """Parse a (possibly gzipped) FASTA or FASTQ file; returns a list of
    ``(name, data, quality | None)`` byte tuples. Raises ValueError with
    the parser's message on malformed input."""
    lib = load()
    blob = ctypes.c_void_p()
    offs = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    n = lib.rt_parse_seqfile(os.fsencode(path), 1 if is_fastq else 0,
                             ctypes.byref(blob), ctypes.byref(offs), err)
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    PARSE_CALLS["seqfile"] += 1
    try:
        o = ((ctypes.c_int64 * (6 * n)).from_address(offs.value)[:]
             if n else [])
        base = blob.value
        out = []
        for i in range(0, 6 * n, 6):
            no, nl, so, sl, qo, ql = o[i:i + 6]
            out.append((ctypes.string_at(base + no, nl),
                        ctypes.string_at(base + so, sl),
                        ctypes.string_at(base + qo, ql) if qo >= 0 else None))
        return out
    finally:
        lib.rt_free(blob)
        lib.rt_free(offs)


# per-format (strings, numbers) of one rt_parse_ovlfile record:
# 0 = PAF, 1 = MHAP, 2 = SAM
_OVL_ARITY = {0: (2, 7), 1: (0, 12), 2: (3, 2)}


def parse_ovlfile(path: str, fmt: int) -> list:
    """Parse a (possibly gzipped) overlap file, ``fmt`` 0 = PAF, 1 = MHAP,
    2 = SAM; returns one field tuple per record, equal to the Python
    parsers' ``OverlapRecord.fields``: PAF ``(qname, qlen, qstart, qend,
    strand, tname, tlen, tstart, tend)``, MHAP its twelve numbers
    (``jaccard`` a float), SAM ``(qname, flag, rname, pos, cigar)``.
    Raises ValueError with the parser's message on malformed input. The
    CPython extension builds the tuples where it loaded (``EXT_STATE``),
    ctypes elsewhere; both give the same records."""
    ext = _load_ext()
    if ext is not None:
        out = ext.parse_ovlfile(os.fsdecode(path), fmt)
        PARSE_CALLS["ovlfile"] += 1
        return out
    return _parse_ovlfile_ctypes(path, fmt)


def _parse_ovlfile_ctypes(path: str, fmt: int) -> list:
    """:func:`parse_ovlfile` through the ctypes library."""
    lib = load()
    blob = ctypes.c_void_p()
    soffs = ctypes.c_void_p()
    nums = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    n = lib.rt_parse_ovlfile(os.fsencode(path), fmt, ctypes.byref(blob),
                             ctypes.byref(soffs), ctypes.byref(nums), err)
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    PARSE_CALLS["ovlfile"] += 1
    ns, nn = _OVL_ARITY[fmt]
    try:
        so = ((ctypes.c_int64 * (2 * ns * n)).from_address(soffs.value)[:]
              if n and ns else [])
        nu = ((ctypes.c_double * (nn * n)).from_address(nums.value)[:]
              if n else [])
        base = blob.value
        out = []
        for i in range(n):
            strs = [ctypes.string_at(base + so[2 * (ns * i + k)],
                                     so[2 * (ns * i + k) + 1])
                    for k in range(ns)]
            num = nu[nn * i: nn * i + nn]
            if fmt == 0:
                b = int(num[3])
                out.append((strs[0], int(num[0]), int(num[1]), int(num[2]),
                            chr(b) if b else "", strs[1], int(num[4]),
                            int(num[5]), int(num[6])))
            elif fmt == 1:
                out.append((int(num[0]), int(num[1]), num[2], int(num[3]),
                            *[int(x) for x in num[4:]]))
            else:
                out.append((strs[0], int(num[0]), strs[1], int(num[1]),
                            strs[2]))
        return out
    finally:
        lib.rt_free(blob)
        lib.rt_free(soffs)
        lib.rt_free(nums)
