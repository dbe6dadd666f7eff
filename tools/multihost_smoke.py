#!/usr/bin/env python3
"""The multihost phase of ``chip_smoke.py`` alone on one GPU: builds the
kernels and the native library, runs the smoke's main phase (the
simulated 1 Mbp genome at 30x, seed 23, polished in process on both
device engines), then ``chip_smoke.phase_multihost``: two child processes
join one gloo group, and each polishes the same inputs over the global
mesh (a slot a process, both on this card) to the main phase's bytes.
Every shard-local shape the children launched is then held against the
plain versions (``tools/chips_smoke._hold``), so a shape the full smoke
would report as ``unheld`` fails here first.

    python3 tools/multihost_smoke.py

Prints the smoke's ``main`` and ``multihost`` lines, then one JSON line
with the phase's seconds, each rank's wall, launches, peak device bytes
and all-gathers, the held shapes and the card. A few minutes of chip
time.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from racon_tpu_torch import native
    from racon_tpu_torch.ops import _build
    from tools.chips_smoke import _hold
    if not torch.cuda.is_available():
        print("multihost_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    _build.build_all(force=True)
    native.build(force=True)
    main_rec, paths, seq = cs.phase_main(dev)
    del seq
    rec = cs.phase_multihost(main_rec, paths)
    held = _hold(cs, dev, rec)
    print(json.dumps(dict(multihost_s=rec["seconds"],
                          main_wall_s=main_rec["wall_s"],
                          ranks={r["rank"]: dict(wall_s=r["wall_s"],
                                                 gathers=r["gathers"],
                                                 peak=r["peak_device_bytes"])
                                 for r in rec["ranks"]},
                          launches=rec["launches"], held=held,
                          total_s=time.perf_counter() - t_all,
                          card=cs.gpu_line())), flush=True)
    if not all(r["ok"] for r in held):
        raise RuntimeError(f"a kernel disagrees with its plain version at "
                           f"a multihost shape: {held}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
