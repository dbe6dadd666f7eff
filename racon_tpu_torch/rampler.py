"""rampler: sequence subsampler and splitter (the port of
``racon_tpu/rampler.py``; its outputs and plan JSON are byte-identical).

The command line of the reference's vendored ``rampler`` as the wrapper
calls it:

- ``rampler -o DIR subsample <sequences> <reference_length> <coverage>``
  writes ``DIR/<basename>_<coverage>x.<ext>``, a random subset of the
  sequences of about reference_length x coverage bases;
- ``rampler -o DIR split <sequences> <chunk_size>`` writes
  ``DIR/<basename>_<i>.<ext>``, chunks of at most ``chunk_size`` sequence
  bytes each (a record larger than that alone), in input order.

And ``rampler plan <sequences> <overlaps> <targets> [--shards N |
--max-ram SIZE | --split BYTES]`` prints the shard runner's plan (each
shard's contigs and estimated resident megabytes, JSON) without running
it; with ``auto`` for the overlaps, it plans from the read and target
sizes alone.

Outputs are plain FASTA, or FASTQ when the records carry qualities. The
subsample is deterministic (``--seed``, default 0).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
from typing import List

from .io import parsers


def _base_and_ext(path: str, has_quality: bool):
    base = os.path.basename(path).split(".")[0]
    return base, (".fastq" if has_quality else ".fasta")


def _write(records, path: str) -> None:
    with open(path, "wb") as f:
        for rec in records:
            if rec.quality is not None:
                f.write(b"@" + rec.name + b"\n" + rec.data + b"\n+\n"
                        + rec.quality + b"\n")
            else:
                f.write(b">" + rec.name + b"\n" + rec.data + b"\n")


def _load(path: str):
    parse = parsers.sequence_parser_for(path)
    if parse is None:
        print(f"[rampler::] error: file {path} has unsupported format",
              file=sys.stderr)
        sys.exit(1)
    return list(parse(path))


def subsample(sequences_path: str, reference_length: int, coverage: int,
              out_dir: str, seed: int = 0) -> str:
    records = _load(sequences_path)
    target = reference_length * coverage
    order = list(range(len(records)))
    random.Random(seed).shuffle(order)
    picked: List[int] = []
    total = 0
    for i in order:
        if total >= target:
            break
        picked.append(i)
        total += len(records[i].data)
    picked.sort()  # the sample keeps the input order
    has_quality = any(records[i].quality is not None for i in picked)
    base, ext = _base_and_ext(sequences_path, has_quality)
    out_path = os.path.join(out_dir, f"{base}_{coverage}x{ext}")
    _write((records[i] for i in picked), out_path)
    return out_path


def split(sequences_path: str, chunk_size: int, out_dir: str) -> List[str]:
    records = _load(sequences_path)
    has_quality = any(r.quality is not None for r in records)
    base, ext = _base_and_ext(sequences_path, has_quality)
    out_paths: List[str] = []
    chunk: List = []
    chunk_bytes = 0
    for rec in records:
        if chunk and chunk_bytes + len(rec.data) > chunk_size:
            path = os.path.join(out_dir, f"{base}_{len(out_paths)}{ext}")
            _write(chunk, path)
            out_paths.append(path)
            chunk, chunk_bytes = [], 0
        chunk.append(rec)
        chunk_bytes += len(rec.data)
    if chunk:
        path = os.path.join(out_dir, f"{base}_{len(out_paths)}{ext}")
        _write(chunk, path)
        out_paths.append(path)
    return out_paths


def plan(sequences_path: str, overlaps_path: str, target_path: str,
         n_shards: int = 0, max_ram: str = "", split_bytes: int = 0,
         fragment_correction: bool = False,
         error_threshold: float = 0.3) -> dict:
    """The shard plan of a run, without running it: index the inputs, run
    the planner and return the plan as JSON-ready data. ``-f`` and ``-e``
    must be the run's: they change the global overlap filter, and with it
    each shard's cost."""
    from .core.polisher import PolisherType
    from .exec import build_index, parse_ram, plan_shards
    from .exec.index import build_index_readsonly
    from .obs.metrics import peak_rss_bytes

    if parsers.is_auto_overlaps(overlaps_path):
        # no overlaps file exists before the overlapper runs: the cost
        # comes from the read and target sizes (the read bases charged to
        # the contigs by their size)
        index = build_index_readsonly(sequences_path, target_path)
    else:
        index = build_index(sequences_path, overlaps_path, target_path,
                            PolisherType.F if fragment_correction
                            else PolisherType.C, error_threshold)
    sp = plan_shards(index, n_shards,
                     parse_ram(max_ram) if max_ram else 0, split_bytes,
                     base_rss=peak_rss_bytes())
    return {
        "mode": sp.mode,
        "n_contigs": len(index.targets),
        "n_overlaps": int(len(index.ov_start)),
        "total_mbp": round(sum(t.bases for t in index.targets) / 1e6, 4),
        "budget_bytes": sp.budget_bytes,
        "avail_bytes": sp.avail_bytes,
        "shards": [{
            "id": si,
            "contigs": [index.targets[ci].name.decode("utf-8", "replace")
                        for ci in shard],
            "est_resident_mb": sp.costs[si] >> 20,
        } for si, shard in enumerate(sp.shards)],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="rampler",
        description="sampling module for raw de novo DNA assembly of long "
                    "uncorrected reads")
    p.add_argument("-o", "--out-directory", default=".",
                   help="path in which sampled files will be created")
    p.add_argument("--seed", type=int, default=0,
                   help="subsampling RNG seed (deterministic by default)")
    sub = p.add_subparsers(dest="mode", required=True)

    ps = sub.add_parser("subsample", help="subsample sequences to coverage")
    ps.add_argument("sequences")
    ps.add_argument("reference_length", type=int)
    ps.add_argument("coverage", type=int)

    pp = sub.add_parser("split", help="split sequences into byte chunks")
    pp.add_argument("sequences")
    pp.add_argument("chunk_size", type=int)

    pl = sub.add_parser("plan", help="print the streaming shard runner's "
                                     "plan without running anything")
    pl.add_argument("sequences")
    pl.add_argument("overlaps")
    pl.add_argument("target_sequences")
    pl.add_argument("--shards", type=int, default=0)
    pl.add_argument("--max-ram", default="")
    pl.add_argument("--split", type=int, default=0)
    pl.add_argument("-f", "--fragment-correction", action="store_true",
                    help="plan for fragment correction (keep-all overlap "
                         "filter) — must match the racon invocation")
    pl.add_argument("-e", "--error-threshold", type=float, default=0.3,
                    help="overlap error threshold — must match the racon "
                         "invocation")

    args = p.parse_args(argv)

    if args.mode == "plan":
        print(json.dumps(plan(args.sequences, args.overlaps,
                              args.target_sequences, args.shards,
                              args.max_ram, args.split,
                              args.fragment_correction,
                              args.error_threshold), indent=1))
        return 0

    os.makedirs(args.out_directory, exist_ok=True)
    if args.mode == "subsample":
        subsample(args.sequences, args.reference_length, args.coverage,
                  args.out_directory, args.seed)
    else:
        split(args.sequences, args.chunk_size, args.out_directory)
    return 0


if __name__ == "__main__":
    sys.exit(main())
