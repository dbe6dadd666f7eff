#!/usr/bin/env python3
"""The resident align->layers dataflow (``RACON_TPU_RESIDENT=1``) against
the host path on one GPU, in one process: the main path of
``chip_smoke.py`` (a simulated 1 Mbp genome at 30x, seed 23, both device
engines, ``num_threads=8``) polished once to warm up, then in turns host,
resident, resident, host, ``REPS`` times (default 2).

    python3 tools/resident_ab.py [REPS]

Per run, one JSON line: the leg, the card (``nvidia-smi`` name and power
limit), the wall, the SHA-256 of the polished FASTA (every run must give
the same), the stage seconds of ``Polisher.timings`` (``build_windows_s``,
``window_derive_s``, ``layer_store_s``, ``consensus_s`` and, on the
resident leg, ``lane_upload_saved_s`` among them), the span timers that
carry the wall (``build.windows``, ``build.store``, ``queue.get``,
``align.fetch``, ``poa.pack``, ``poa.dispatch``), the
``dataflow`` counters, the consensus engine's ``lane_upload_saved_bytes``,
the aligner's fetched bytes and the peak device bytes. Last, the median,
minimum and maximum of each leg's wall, its ``build.windows``,
``poa.pack`` and ``poa.dispatch`` span seconds and its ``consensus_s``
(``Polisher.timings``). Span timers are
on for every run. All lines go to ``chiprun_out/resident_ab.json`` too.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPANS = ("build.windows", "build.store", "queue.get", "align.fetch",
         "poa.pack", "poa.dispatch")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    from racon_tpu_torch import native, obs
    from racon_tpu_torch.core.polisher import create_polisher
    from racon_tpu_torch.obs import metrics
    from racon_tpu_torch.ops import _build
    from racon_tpu_torch.utils.simulate import write_inputs

    if not torch.cuda.is_available():
        print("resident_ab: no CUDA device", file=sys.stderr)
        return 2
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = torch.device("cuda", 0)
    _build.build_all()
    native.build()
    paths = write_inputs(1.0, str(ROOT / "build" / "ab_data"), seed=23,
                         coverage=30)
    card = gpu_line()

    def polish(leg: str) -> dict:
        if leg == "resident":
            os.environ["RACON_TPU_RESIDENT"] = "1"
        else:
            os.environ.pop("RACON_TPU_RESIDENT", None)
        obs.begin()
        obs.trace.activate()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        polisher = create_polisher(paths["reads"], paths["overlaps"],
                                   paths["draft"], num_threads=8,
                                   aligner="cuda", consensus="cuda",
                                   device=dev)
        out = polisher.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        obs.trace.deactivate()
        fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n"
                         for s in out)
        return dict(leg=leg, card=card, wall_s=wall,
                    fasta_sha256=hashlib.sha256(fasta).hexdigest(),
                    stages_s=dict(polisher.timings),
                    spans_s={k: metrics.timer_s(k) for k in SPANS},
                    dataflow=metrics.dataflow_summary(),
                    lane_upload_saved_bytes=polisher.consensus.stats[
                        "lane_upload_saved_bytes"],
                    aligner_fetched_bytes=polisher.aligner.stats[
                        "fetched_bytes"],
                    peak_device_bytes=torch.cuda.max_memory_allocated(dev))

    lines = [dict(polish("host"), warmup=True)]
    print(json.dumps(lines[0]), flush=True)
    for _ in range(reps):
        for leg in ("host", "resident", "resident", "host"):
            lines.append(polish(leg))
            print(json.dumps(lines[-1]), flush=True)
    runs = [r for r in lines if not r.get("warmup")]
    summary = {"summary": {}, "card": card,
               "same_bytes": len({r["fasta_sha256"] for r in lines}) == 1}
    def value(run, key):
        if key == "wall_s":
            return run["wall_s"]
        if key == "consensus_s":
            return run["stages_s"][key]
        return run["spans_s"][key]

    for leg in ("host", "resident"):
        for key in ("wall_s", "build.windows", "poa.pack", "poa.dispatch",
                    "consensus_s"):
            vals = [value(r, key) for r in runs if r["leg"] == leg]
            summary["summary"][f"{leg}.{key}"] = dict(
                median=statistics.median(vals), min=min(vals),
                max=max(vals), n=len(vals))
    print(json.dumps(summary), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "resident_ab.json").write_text(
        json.dumps(lines + [summary], indent=1))
    return 0 if summary["same_bytes"] else 1


if __name__ == "__main__":
    sys.exit(main())
