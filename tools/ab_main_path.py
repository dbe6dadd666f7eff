#!/usr/bin/env python3
"""Main-path A/B of the PyTorch/CUDA port on one GPU: runs the main path of
``chip_smoke.py`` (a simulated 1 Mbp genome at 30x, seed 23, both device
engines) in each given checkout, in the order given, one process each.

    python3 tools/ab_main_path.py PARENT CHANGE CHANGE PARENT

Each checkout is the root of a tree holding ``racon_tpu_torch`` (a ``git
archive`` of a commit, or the working tree ``.``). Per run, one JSON line:
the card (``nvidia-smi`` name and power limit), the stage seconds and wall
of a first pass (cold, as ``chip_smoke.py``'s main phase), the aligner's
and the consensus engine's counters (and its group shapes, where the tree
records them), launches per kernel, the SHA-256 of the polished FASTA (it must
be the same for every tree), then a second pass under ``torch.profiler``:
its wall, the device's busy seconds and idle share, and the device seconds
of the forward kernels, the walks and the ``breaking_points`` range. It
skips what the smoke's other phases do (kernel parity, edit distances).
All lines go to ``chiprun_out/ab_main_path.json`` too.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

RUN = r"""
import hashlib, json, subprocess, time
import torch
from racon_tpu_torch import native
from racon_tpu_torch.core.polisher import create_polisher
from racon_tpu_torch.ops import _build, cuda_nw
from racon_tpu_torch.utils.simulate import write_inputs

dev = torch.device("cuda", 0)
_build.build_all()
native.build()
paths = write_inputs(1.0, "build/ab_data", seed=23, coverage=30)


def polish():
    polisher = create_polisher(paths["reads"], paths["overlaps"],
                               paths["draft"], num_threads=8,
                               aligner="cuda", consensus="cuda", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = polisher.run()
    torch.cuda.synchronize()
    return polisher, out, time.perf_counter() - t0


cuda_nw.reset_launches()
polisher, out, wall = polish()
fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n" for s in out)
st = polisher.aligner.stats
keys = ("device", "fallback_length", "fallback_band", "band_escalated",
        "chunks", "ladder_narrow", "lanes_occupied", "lanes_total",
        "wavefront_work", "fetched_bytes", "chunk_shapes")
rec = dict(card=subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           wall_s=wall, stages_s=polisher.timings,
           aligner={k: st[k] for k in keys if k in st},
           consensus={k: v for k, v in polisher.consensus.stats.items()
                      if k != "group_shapes"},
           consensus_group_shapes=polisher.consensus.stats.get(
               "group_shapes"),
           launches=dict(cuda_nw.LAUNCHES),
           fasta_sha256=hashlib.sha256(fasta).hexdigest())

from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    polisher, _, wall = polish()
busy, groups = 0.0, {"forward": 0.0, "walk_ops": 0.0, "walk_vote": 0.0}
bp = 0.0
for e in prof.key_averages():
    on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
    if e.key == "breaking_points":
        # the host range carries its kernels' device time; the device
        # range is no kernel of its own
        if not on_device:
            bp += (getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0)) / 1e6
        continue
    if not on_device:
        continue
    us = getattr(e, "self_device_time_total", None)
    if us is None:
        us = getattr(e, "self_cuda_time_total", 0)
    busy += us / 1e6
    if "nw_fwd_" in e.key:
        groups["forward"] += us / 1e6
    elif "walk_ops" in e.key:
        groups["walk_ops"] += us / 1e6
    elif "walk_vote" in e.key:
        groups["walk_vote"] += us / 1e6
rec["profiled"] = dict(wall_s=wall, stages_s=polisher.timings,
                       device_busy_s=busy, idle_share=1.0 - busy / wall,
                       device_s=dict(groups, breaking_points=bp))
print("AB " + json.dumps(rec), flush=True)
"""


def main(trees) -> int:
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    records = []
    for k, tree in enumerate(trees):
        tree = pathlib.Path(tree).resolve()
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                              env={**os.environ, "PYTHONPATH": str(tree)},
                              capture_output=True, text=True)
        line = next((x[3:] for x in proc.stdout.splitlines()
                     if x.startswith("AB ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = dict(run=k, tree=str(tree), **json.loads(line))
        records.append(rec)
        print(json.dumps(rec), flush=True)
    (out_dir / "ab_main_path.json").write_text(json.dumps(records, indent=1))
    shas = {r["fasta_sha256"] for r in records}
    if len(shas) != 1:
        print(f"the trees polish different bytes: {sorted(shas)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
