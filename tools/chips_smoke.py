#!/usr/bin/env python3
"""The chips phase of ``chip_smoke.py`` alone on one GPU: builds the
kernels and the native library, runs the smoke's main phase (the
simulated 1 Mbp genome at 30x, seed 23, polished in process on both
device engines) and the shards phase's single shot of the 4-contig genome
(its SHA-256 is what the two chip workers must give), then
``chip_smoke.phase_chips``: the 1 Mbp polish on a mesh that names the
card twice, two chip workers on the 4-contig genome, and the 1 Mbp genome
through two chip workers whose plan mesh-shards its dominant contig.
Every launch of the phase is then held against the plain version at its
shard-local shape (a prefix of the pairs, as the smoke's kernels phase
does for its new shapes), so a shape the full smoke would report as
``unheld`` fails here first.

    python3 tools/chips_smoke.py

Prints the smoke's ``main`` and ``chips`` lines, then one JSON line with
the phase's seconds, launches, peak device bytes, the held shapes and the
card. A few minutes of chip time.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# pairs a held aligner shape runs through both forward kernels, the walk
# and their plain versions
HELD_PAIRS = 8


def _hold(cs, dev, chips) -> list:
    """Each aligner (max_len, band) and consensus (Lq, band) the phase
    launched at, once, on ``HELD_PAIRS`` pairs (the consensus on its
    largest shard-local group's geometry): K1, K4 and the walk that
    follows against their plain versions. Returns one row a shape."""
    rows = []
    seen = set()
    for ml, bnd, _, _, _ in chips["aligner_chunk_shapes"]:
        if (ml, bnd) in seen:
            continue
        seen.add((ml, bnd))
        inp = cs.aligner_bucket_inputs(dev, (ml, bnd), HELD_PAIRS,
                                       700 + len(rows),
                                       chips["aligner_div_obs"])
        inp.pop("pairs")
        (dirs, _), k1, k4 = cs.fwd_rows(inp, 1)
        k2 = cs.walk_rows(dirs, inp, 1)
        rows.append(dict(shape=inp["shape"],
                         ok=all(r["max_abs_err"] == 0
                                for r in k1 + k4 + k2)))
    for Lq, band, B in cs.consensus_shapes(chips["consensus_group_shapes"]):
        if (Lq, band) in seen:
            continue
        seen.add((Lq, band))
        inp = cs.consensus_shape_inputs(dev, Lq, band, min(B, 64),
                                        window=min(500, Lq - band))
        (dirs, _), k1, k4 = cs.fwd_rows(inp, 1)
        k3, _ = cs.vote_entry(dirs, inp, 1)
        rows.append(dict(shape=inp["shape"],
                         ok=all(r["max_abs_err"] == 0
                                for r in k1 + k4 + [k3])))
    return rows


def main() -> int:
    import torch

    import chip_smoke as cs
    from racon_tpu_torch import native
    from racon_tpu_torch.core.polisher import create_polisher
    from racon_tpu_torch.ops import _build
    from racon_tpu_torch.utils.simulate import write_inputs
    if not torch.cuda.is_available():
        print("chips_smoke: no CUDA device", file=sys.stderr)
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
    chips = cs.phase_chips(dev, main_rec, shards, paths)
    held = _hold(cs, dev, chips)
    print(json.dumps(dict(chips_s=chips["seconds"],
                          launches=chips["launches"],
                          peak_device_bytes=chips["peak_device_bytes"],
                          legs={leg["leg"]: leg["wall_s"]
                                for leg in chips["legs"]},
                          held=held,
                          total_s=time.perf_counter() - t_all,
                          card=cs.gpu_line())), flush=True)
    if not all(r["ok"] for r in held):
        raise RuntimeError(f"a kernel disagrees with its plain version at "
                           f"a chips shape: {held}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
