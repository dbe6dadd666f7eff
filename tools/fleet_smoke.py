#!/usr/bin/env python3
"""The fleet phase of ``chip_smoke.py`` alone on one GPU: builds the
kernels and the native library, runs the smoke's main phase (the
simulated 1 Mbp genome at 30x, seed 23, polished in process on both
device engines) and the shards phase's single shot of the 4-contig genome
(its SHA-256 is what the fleet's 4-contig job must give), then
``chip_smoke.phase_fleet``: a gateway and two card hosts in child
processes, two jobs at once, a wedged third host SIGKILLed holding a job,
the migration, the drains.

    python3 tools/fleet_smoke.py

Prints the smoke's ``main`` and ``fleet`` lines, then one JSON line with
the phase's seconds, the hosts' launches and the card; on a failure the
tail of every child's log. About 1.5 min of chip time.
"""

from __future__ import annotations

import hashlib
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
    from racon_tpu_torch.core.polisher import create_polisher
    from racon_tpu_torch.ops import _build
    from racon_tpu_torch.utils.simulate import write_inputs
    if not torch.cuda.is_available():
        print("fleet_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    _build.build_all(force=True)
    native.build(force=True)
    main_rec, paths, seq = cs.phase_main(dev)
    del seq
    sim = write_inputs(1.0, str(ROOT / "build" / "smoke_shards"), seed=23,
                       coverage=30, n_contigs=4)
    t0 = time.perf_counter()
    out = create_polisher(sim["reads"], sim["overlaps"], sim["draft"],
                          num_threads=8, aligner="cuda", consensus="cuda",
                          device=dev).run()
    fasta = b"".join(b">" + s.name + b"\n" + s.data + b"\n" for s in out)
    shards = {"inputs": sim,
              "single_sha256": hashlib.sha256(fasta).hexdigest(),
              "single_wall_s": time.perf_counter() - t0}
    del out
    t0 = time.perf_counter()
    try:
        fleet = cs.phase_fleet(main_rec, shards, paths)
    except RuntimeError:
        for log in sorted((ROOT / "build" / "smoke_fleet").glob("*.log")):
            print(f"===== {log.name}\n"
                  + log.read_text(errors="replace")[-4000:], flush=True)
        raise
    print(json.dumps(dict(fleet_s=time.perf_counter() - t0,
                          launches=fleet["launches"],
                          total_s=time.perf_counter() - t_all,
                          card=cs.gpu_line())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
