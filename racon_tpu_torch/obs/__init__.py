"""racon_tpu_torch.obs: spans, the metrics registry and run reports
(counterpart of ``racon_tpu/obs``).

- spans (:mod:`.trace`): ``with obs.span("align.dispatch"): ...`` through
  the pipeline, exported as Chrome trace-event JSON (``--trace FILE`` /
  ``RACON_TPU_TRACE``). A disabled span costs one branch;
- metrics (:mod:`.metrics`): the process-wide counters, gauges and
  timers the engines, the polisher and the sanitizer publish;
- run reports (:mod:`.report`): the schema-versioned ``run_report.json``
  (``--run-report FILE`` / ``RACON_TPU_RUN_REPORT``);
- kernel-library builds (:mod:`.buildwatch`).

:func:`profile` brackets a phase in one ``torch.profiler`` session
(``--profile DIR`` / ``RACON_TPU_TORCH_PROFILE``), with the spans as
``record_function`` ranges in it.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext

from . import buildwatch, metrics, report, trace  # noqa: F401
# the public span surface
from .trace import profile_range, span, track  # noqa: F401


def begin(trace_path=None, report_path=None) -> None:
    """A run boundary: drop the per-run metrics and build records, and arm
    the span timers when either output was requested (ring buffers only
    for a trace file)."""
    metrics.clear_run()
    buildwatch.reset()
    if trace_path or report_path:
        trace.activate(tracing=bool(trace_path))


# PyTorch runs one profiler per process: the first profile() to start
# holds this lock, and a nested or concurrent one runs unprofiled
_profile_lock = threading.Lock()


def profile(directory=None):
    """A context manager recording the enclosed phase in one
    ``torch.profiler.profile`` session (CPU activity, and CUDA activity
    when a card is present) whose Chrome trace lands in ``directory``
    (default ``RACON_TPU_TORCH_PROFILE``) as
    ``torch_trace.<pid>.json``. A no-op when no directory is given or
    another profile of this process is recording."""
    if directory is None:
        from .. import flags
        directory = flags.get_str("RACON_TPU_TORCH_PROFILE")
    if not directory or not _profile_lock.acquire(blocking=False):
        return nullcontext()

    @contextmanager
    def _held():
        try:
            import torch
            from torch.profiler import (ProfilerActivity, record_function,
                                        profile as torch_profile)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = torch_profile(activities=acts)
            try:
                prof.__enter__()
            except RuntimeError as e:
                # another profiler of this process (one outside obs)
                from ..utils.logger import log_swallowed
                log_swallowed("obs: torch.profiler did not start (the "
                              "phase runs unprofiled)", e)
                yield
                return
            trace.set_record_function(record_function)
            try:
                yield
            finally:
                trace.set_record_function(None)
                t0 = time.perf_counter()
                prof.__exit__(None, None, None)
                os.makedirs(directory, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    directory, f"torch_trace.{os.getpid()}.json"))
                # the profiler's own cost after the phase: its stop (the
                # device activity's collection) and the export
                metrics.add_time("trace.profile_stop_s",
                                 time.perf_counter() - t0)
        finally:
            _profile_lock.release()

    return _held()
