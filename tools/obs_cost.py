#!/usr/bin/env python3
"""What the port's observability costs on one GPU: ``chip_smoke.py``'s PAF
main path (a simulated 1 Mbp genome at 30x, seed 23, both device engines)
through the port's CLI, one fresh process a run, once per variant and then
again in the reverse order:

- ``off``: no flag;
- ``report``: ``--run-report`` (span timers on, no ring buffers);
- ``trace``: ``--trace`` (spans in rings, the report beside the trace);
- ``sanitize``: ``--run-report`` with ``RACON_TPU_SANITIZE=1`` and
  ``RACON_TPU_SANITIZE_SAMPLE=1`` (every K4 chunk and group shadowed by K1);
- ``profile``: ``--run-report`` and ``--profile`` (one ``torch.profiler``
  session around the run, CPU and CUDA activity);
- ``all``: all of them, as the smoke's ``obs`` phase runs them.

    python3 tools/obs_cost.py [VARIANT ...]

Per run, one JSON line: the card (``nvidia-smi`` name and power limit), the
process's wall, the report's ``wall_s`` (from the CLI's start to the
report), the polisher's stages (parse, align, breaking-point decode,
consensus, stitch: the run's critical path) and their sum, the report's
wall outside them, ``trace.profile_stop_s`` (the profile's stop and
export) and the SHA-256 of the FASTA, which must be the same for every run.
The lines go to ``chiprun_out/obs_cost.json`` too.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ("off", "report", "trace", "sanitize", "profile", "all")
STAGES = ("parse_s", "align_s", "bp_decode_s", "consensus_s", "stitch_s")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def run(variant: str, paths: dict, work: pathlib.Path) -> dict:
    trace = work / variant / "trace.json"
    # --trace alone puts the report beside the trace
    report = work / variant / "run_report.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    report.unlink(missing_ok=True)
    flags, env = [], dict(os.environ)
    if variant in ("report", "sanitize", "profile", "all"):
        flags += ["--run-report", str(report)]
    if variant in ("trace", "all"):
        flags += ["--trace", str(trace)]
    if variant in ("profile", "all"):
        flags += ["--profile", str(work / variant / "profile")]
    if variant in ("sanitize", "all"):
        env.update(RACON_TPU_SANITIZE="1", RACON_TPU_SANITIZE_SAMPLE="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch", "-t", "8", "-c", "1",
         "--cudaaligner-batches", "1", *flags, paths["reads"],
         paths["overlaps"], paths["draft"]], cwd=ROOT, env=env,
        capture_output=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{variant}: rc {proc.returncode}\n"
                           f"{proc.stderr.decode()[-3000:]}")
    rec = dict(variant=variant, card=card(), process_wall_s=wall,
               fasta_sha256=hashlib.sha256(proc.stdout).hexdigest())
    if variant != "off":
        rep = json.loads(report.read_text())
        stages = {k: rep["phases"].get(k, 0.0) for k in STAGES}
        rec.update(report_wall_s=rep["wall_s"], stages_s=stages,
                   stages_sum_s=sum(stages.values()),
                   outside_stages_s=rep["wall_s"] - sum(stages.values()),
                   profile_stop_s=rep["metrics"]["timers"].get(
                       "trace.profile_stop_s", 0.0),
                   shadows=[rep["metrics"]["counters"].get(k, 0) for k in
                            ("align.shadow_chunks",
                             "consensus.shadow_groups")])
    return rec


def main(argv) -> int:
    variants = argv or [*VARIANTS, *reversed(VARIANTS)]
    sys.path.insert(0, str(ROOT))
    from racon_tpu_torch import native
    from racon_tpu_torch.ops import _build
    from racon_tpu_torch.utils.simulate import write_inputs
    _build.build_all()
    native.build()
    work = ROOT / "build" / "obs_cost"
    work.mkdir(parents=True, exist_ok=True)
    paths = write_inputs(1.0, str(work / "data"), seed=23, coverage=30)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    recs = []
    for variant in variants:
        rec = run(variant, paths, work)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    (out / "obs_cost.json").write_text(json.dumps(recs, indent=1))
    if len({r["fasta_sha256"] for r in recs}) != 1:
        print("obs_cost: the variants polished different bytes",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
