"""Build and load the port's CUDA kernels.

Each ``kernels/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, all sources
in parallel (one ``nvcc`` process each), into ``build/cuda`` at the root of
the checkout; a library is rebuilt when any kernel source is newer. The
first library loaded builds every stale one, so a run builds before its
first launch and never between launches (``obs.buildwatch`` records each
build). Nothing here runs at import time: the CPU tests import every module
of the package on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict

from .._paths import build_root
from ..obs import buildwatch

KERNEL_DIR = pathlib.Path(__file__).resolve().parent / "kernels"
# library name -> source file (K1 and K4 share nw_fwd.cu)
SOURCES = {
    "nw_fwd": "nw_fwd.cu",
    "walk_ops": "walk_ops.cu",
    "walk_vote": "walk_vote.cu",
    "chain_dp": "chain_dp.cu",
    "breaking_points": "breaking_points.cu",
    "build_rows": "build_rows.cu",
}
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported C function -> (library, argtypes); every function returns the
# cudaError_t of its launch
SIGNATURES = {
    "rt_nw_fwd_i32": ("nw_fwd", [_P] * 6 + [_I] * 5 + [_P]),
    "rt_nw_fwd_i32_warp": ("nw_fwd", [_P] * 6 + [_I] * 5 + [_P]),
    "rt_nw_fwd_i32_wide": ("nw_fwd", [_P] * 6 + [_I] * 5 + [_P]),
    "rt_nw_fwd_i16x2": ("nw_fwd", [_P] * 6 + [_I] * 5 + [_P]),
    # ... B, max_len, band, bpt, width, steps, stream
    "rt_nw_fwd_i16x2_wide": ("nw_fwd", [_P] * 6 + [_I] * 6 + [_P]),
    "rt_walk_ops": ("walk_ops", [_P] * 6 + [_I] * 3 + [_P]),
    "rt_walk_ops_thread": ("walk_ops", [_P] * 6 + [_I] * 3 + [_P]),
    "rt_walk_vote": ("walk_vote", [_P] * 9 + [_I] * 8 + [_P]),
    # ts, qs, ns, parent, out, B, S, k, smem_slots, stream
    "rt_chain_dp": ("chain_dp", [_P] * 5 + [_I] * 4 + [_P]),
    # ops, n, m, first_rel, nb, bp_first, bp_last, B, S4, w, NW, stream
    "rt_breaking_points": ("breaking_points", [_P] * 7 + [_I] * 4 + [_P]),
    # qblk, tblk, n, m, qrp, tp, B, max_len, band, bits, stream
    "rt_build_rows": ("build_rows", [_P] * 6 + [_I] * 4 + [_P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# exported C function -> its ctypes function, once looked up
_functions: Dict[str, Callable[..., int]] = {}
# name -> {"seconds": ..., "ptxas": ...} of builds made by this process
build_log: Dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    pass


def build_dir() -> pathlib.Path:
    return build_root() / "cuda"


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _lib_path(name: str) -> pathlib.Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [KERNEL_DIR / SOURCES[name],
                           *KERNEL_DIR.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build_all(force: bool = False,
              verbose_ptxas: bool = False) -> Dict[str, str]:
    """Compile every stale (or, with ``force``, every) kernel library, one
    ``nvcc`` per source, all started together. Returns name -> path.
    Raises :class:`KernelBuildError` with the compiler's output when a
    build fails."""
    with _lock:
        return _build_locked([n for n in SOURCES if force or _stale(n)],
                             verbose_ptxas)


def _build_locked(names, verbose_ptxas: bool) -> Dict[str, str]:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo",
               "-shared", "-Xcompiler", "-fPIC",
               "-I", str(KERNEL_DIR), str(KERNEL_DIR / SOURCES[name]),
               "-o", str(tmp)]
        if verbose_ptxas:
            cmd[1:1] = ["-Xptxas", "-v"]
        try:
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, time.perf_counter())
        except FileNotFoundError as e:
            for proc, _, _ in procs.values():
                proc.kill()
                proc.wait()
            raise KernelBuildError(f"nvcc not found ({nvcc}): {e}") from e
    failures = []
    for name, (proc, tmp, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{text[-4000:]}")
            continue
        os.replace(tmp, _lib_path(name))
        seconds = time.perf_counter() - t0
        build_log[name] = {"seconds": seconds, "ptxas": text.strip()}
        buildwatch.record(name, seconds, "nvcc")
    if failures:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return {name: str(_lib_path(name)) for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building stale sources first)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _build_locked([n for n in SOURCES if _stale(n)], False)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (owner, argtypes) in SIGNATURES.items():
            if owner == name:
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = argtypes
        _libs[name] = lib
        return lib


def function(fn: str):
    """The ctypes function ``fn`` of its kernel library, looked up once."""
    f = _functions.get(fn)
    if f is None:
        f = _functions[fn] = getattr(load(SIGNATURES[fn][0]), fn)
    return f
