#!/usr/bin/env python3
"""Where the port's main path spends host time, on one GPU.

    python3 tools/host_profile.py [TOP]

Runs the main path of ``chip_smoke.py`` (a simulated 1 Mbp genome at 30x,
seed 23, both device engines, eight threads) once to warm up, then once
under ``cProfile``, enabled on the calling thread, which runs the aligner,
feeds the consensus stream and stitches (on Python 3.12 the listing holds
the layer-assembly thread's calls too, under ``produce``, and the calling
thread's waits for it under ``queue.get``). Prints the card
(``nvidia-smi`` name and power limit), the profiled run's stage seconds,
the split of ``Polisher._load`` (targets, reads, overlaps, filter,
transmute: the ``load_*_s``, ``filter_s`` and ``transmute_s`` timings) in
the warm-up pass and in the profiled one, and the ``TOP`` (default 40)
functions by cumulative time, and writes the
whole listing to ``host_profile.txt`` in ``chip_smoke.py``'s output
directory (``OUT_DIR``). Host times are wall seconds on the card
machine's CPU, with the device running beside them.
"""

from __future__ import annotations

import cProfile
import io
import json
import pathlib
import pstats
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import OUT_DIR  # noqa: E402
from racon_tpu_torch import native  # noqa: E402
from racon_tpu_torch.core.polisher import create_polisher  # noqa: E402
from racon_tpu_torch.ops import _build  # noqa: E402
from racon_tpu_torch.utils.simulate import write_inputs  # noqa: E402


def main(top: int) -> int:
    if not torch.cuda.is_available():
        print("host_profile: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.build_all()
    native.build()
    paths = write_inputs(1.0, str(ROOT / "build" / "profile_data"),
                         seed=23, coverage=30)

    def polish():
        polisher = create_polisher(paths["reads"], paths["overlaps"],
                                   paths["draft"], num_threads=8,
                                   aligner="cuda", consensus="cuda",
                                   device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        polisher.run()
        torch.cuda.synchronize()
        return polisher, time.perf_counter() - t0

    warm, warm_wall = polish()
    prof = cProfile.Profile()
    prof.enable()
    polisher, wall = polish()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats()
    text = out.getvalue()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "host_profile.txt").write_text(text)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    split = ("load_targets_s", "load_reads_s", "load_overlaps_s",
             "filter_s", "transmute_s")
    print(json.dumps(dict(card=card, wall_s=wall,
                          stages_s=polisher.timings,
                          load_split_s={
                              "warm_up": {k: warm.timings[k] for k in split},
                              "profiled": {k: polisher.timings[k]
                                           for k in split}},
                          warm_up_wall_s=warm_wall)))
    lines = text.splitlines()
    head = next(i for i, line in enumerate(lines) if "ncalls" in line)
    print("\n".join(lines[head:head + top + 1]))
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 40))
