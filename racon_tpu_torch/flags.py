"""The port's registry of ``RACON_TPU_*`` environment flags (counterpart of
``racon_tpu/flags.py``, trimmed to the flags the port reads).

This module is the port's only reader of ``RACON_TPU_*`` variables: every
flag is declared here with its type, default and one doc line, and call
sites read it through :func:`get_bool` / :func:`get_int` /
:func:`get_float` / :func:`get_str`. Reading an undeclared name raises.
Names, types, defaults and boolean semantics are the JAX package's, with
one rename: ``RACON_TPU_JAX_PROFILE`` is ``RACON_TPU_TORCH_PROFILE`` here.

Boolean semantics: unset/empty/``0``/``false``/``no``/``off`` mean false,
anything else true. Numbers: unset -> the default, set but empty -> 0.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable

_FALSE = ("", "0", "false", "no", "off")


@dataclass(frozen=True)
class Flag:
    name: str
    default: str
    kind: str  # "bool" | "int" | "float" | "str" | "path"
    help: str


def _declare(flags: Iterable[Flag]) -> Dict[str, Flag]:
    reg: Dict[str, Flag] = {}
    for f in flags:
        if not f.name.startswith("RACON_TPU_") or f.name in reg:
            raise ValueError(f"bad or duplicate flag {f.name!r}")
        reg[f.name] = f
    return reg


REGISTRY: Dict[str, Flag] = _declare([
    # ------------------------------------------------------------- engines
    Flag("RACON_TPU_SWAR", "1", "bool",
         "The packed int16x2 forward kernel (K4) where ops/swar.py picks "
         "it, and the aligner's 2-bit upload of chunks of at most 4 "
         "symbols (ops/swar.py swar_choice); set 0 to force the int32 "
         "kernel (K1) in both engines and nibble or raw uploads for A/B "
         "measurement."),
    Flag("RACON_TPU_ALIGN_RAGGED", "1", "bool",
         "Ragged pair packing in the device aligner: pairs bucket by "
         "their own sweep cost and chunks greedy-fill the direction-"
         "matrix budget through the streaming _AlignStream session; set 0 "
         "to force the bucketed wave driver (the path a mesh takes) for "
         "A/B measurement."),
    Flag("RACON_TPU_BAND_LADDER", "1", "bool",
         "Adaptive alignment band ladder: each pair's starting band is "
         "seeded from its overlap's estimated divergence (a rung of "
         "ops/nw.py BAND_RUNGS below its bucket band) and escapees "
         "re-dispatch batched at the rung >= 2x the failed band; set 0 to "
         "start every pair at its bucket's band for A/B measurement."),
    Flag("RACON_TPU_RAGGED", "1", "bool",
         "Ragged window packing in the consensus engine: windows bucket "
         "by their own size and groups greedy-fill a fixed lane arena; set "
         "0 to force the padded single-geometry path (the path a mesh "
         "takes) for A/B measurement."),
    Flag("RACON_TPU_CHIPS", "", "int",
         "In-process chip workers of the shard runner and pinned slots of "
         "the resident service (the CLI --chips flag): each local card "
         "gets its own pinned engine pair draining manifest shards "
         "through the lease protocol. Unset/0 = automatic (every local "
         "card when the cuda backend runs on a multi-card host); 1 pins "
         "card 0; above the card count it is clamped to it."),
    Flag("RACON_TPU_TRACE", "", "path",
         "Write a Chrome trace-event JSON of the run's spans to this file "
         "(Perfetto / chrome://tracing); the CLI --trace flag."),
    Flag("RACON_TPU_TORCH_PROFILE", "", "path",
         "Bracket the polish phase in one torch.profiler session (CPU and "
         "CUDA activities) and write its Chrome trace into this "
         "directory; the spans show up as record_function ranges."),
    Flag("RACON_TPU_RUN_REPORT", "", "path",
         "Write the schema-versioned run_report.json to this file; the "
         "CLI --run-report flag."),
    Flag("RACON_TPU_SANITIZE", "0", "bool",
         "Runtime sanitizer: K1 (int32) shadow of sampled K4 (int16x2) "
         "aligner chunks and consensus groups, kernel-output canaries and "
         "the pipelined polish's queue watchdog."),
    Flag("RACON_TPU_SANITIZE_SAMPLE", "8", "int",
         "Shadow every Nth packed chunk or group under the sanitizer (1 = "
         "every one; the first of a run is always checked)."),
    Flag("RACON_TPU_SANITIZE_WATCHDOG_S", "120", "float",
         "Queue watchdog timeout in seconds: with the sanitizer on, a "
         "producer/consumer stall longer than this dumps every thread's "
         "stack to stderr."),
    Flag("RACON_TPU_NATIVE_SANITIZE", "0", "bool",
         "Build the native C++ core with ASan/UBSan "
         "(-fsanitize=address,undefined) into its own shared object "
         "(libracon_torch_native_san.so); loading it requires the ASan "
         "runtime preloaded (LD_PRELOAD=$(g++ -print-file-name="
         "libasan.so))."),
    Flag("RACON_TPU_FAULTS", "", "str",
         "Seeded site-addressed fault injection: 'site:kind[@N][*][%P],...' "
         "with sites consensus.dispatch / align.dispatch / align.fetch / "
         "part.write / manifest.write / worker.kill / exec.polish / "
         "serve.polish / serve.journal / serve.socket / serve.slot / "
         "server.kill and kinds io, enospc, oom, err, stall, kill (see "
         "faults.py)."),
    Flag("RACON_TPU_FAULTS_SEED", "0", "int",
         "Seed of the probabilistic (%P) fault draws."),
    # ------------------------------------------ the resident dataflow
    Flag("RACON_TPU_RESIDENT", "0", "bool",
         "Device-resident align->consensus dataflow: accepted breaking-"
         "point tables stay on the device, window assignment and "
         "per-window layer rows are derived there (min-span and "
         "mean-PHRED filters, window arithmetic, one stable sort by "
         "window), the host fetches one layer table, and the consensus "
         "engine gathers weight<<3|code lanes from the device-resident "
         "pool instead of uploading host-gathered lanes; the overlapper "
         "compacts its minimizer tables on the device and gathers its "
         "chain arenas from the device-resident seed join. Byte-identical "
         "to the host path (the parity oracle); falls back per run when a "
         "precondition fails (fractional quality threshold, sub-33 "
         "quality bytes)."),
    # ------------------------------------------------ the overlapper
    Flag("RACON_TPU_OVERLAP", "", "str",
         "Overlap source override: 'auto' runs the first-party minimizer-"
         "seed + chain overlapper in-process whatever the overlaps "
         "argument names; 'paf' (or unset) follows the positional "
         "argument, which itself accepts the literal sentinel 'auto'."),
    Flag("RACON_TPU_OVERLAP_K", "15", "int",
         "Overlapper minimizer k-mer length (clipped to 4..16; canonical "
         "codes live in 32 bits)."),
    Flag("RACON_TPU_OVERLAP_W", "5", "int",
         "Overlapper minimizer window: each run of w consecutive k-mers "
         "contributes its leftmost minimum-hash k-mer (at least 1)."),
    Flag("RACON_TPU_OVERLAP_MAX_OCC", "64", "int",
         "Overlapper seed frequency cap: hash buckets whose total "
         "occurrence count (reads + targets) exceeds this drop whole "
         "before matching (counted in the run report's overlap section)."),
    Flag("RACON_TPU_OVERLAP_MIN_SEEDS", "4", "int",
         "Minimum chained seeds for an overlapper candidate pair to emit "
         "an overlap row (pairs and chains below it count as "
         "chains_dropped)."),
    Flag("RACON_TPU_OVERLAP_DEVICE_JOIN", "1", "bool",
         "Device seed join: sort both minimizer tables on the device and "
         "join them there with the counted frequency cap (byte-identical "
         "to the host join; 0 forces the numpy match_seeds oracle)."),
    Flag("RACON_TPU_OVERLAP_CACHE", "1", "bool",
         "Target seed-table cache: key the target minimizer table by "
         "(content fingerprint, k, w) and reuse it across the runs of one "
         "process (hits and misses counted in the run report's overlap "
         "section and credited to the dataflow bytes ledger)."),
    # ------------------------------------------------ the shard runner
    Flag("RACON_TPU_HEARTBEAT_S", "30", "float",
         "Shard runner progress line interval in seconds (0 disables the "
         "periodic line; a line at every shard's end always prints)."),
    Flag("RACON_TPU_EXEC_FAULT_SHARD", "", "str",
         "Test hook: fault the named shard's polish ('2' its first "
         "attempt, exercising the CPU retry of host engines or the "
         "quarantine of card engines; '2*' every attempt, exercising "
         "quarantine)."),
    Flag("RACON_TPU_EXEC_SLEEP_S", "0", "float",
         "Test hook: sleep this many seconds before polishing every shard "
         "after the first (widens the window of kill/resume tests)."),
    Flag("RACON_TPU_WORKER", "", "str",
         "Worker identity in shard leases, manifest entries and progress "
         "lines (default hostname:pid)."),
    Flag("RACON_TPU_EXEC_LEASE_TTL_S", "30", "float",
         "Shard lease time-to-live in seconds: a lease whose mtime is "
         "older marks a dead worker, and its shard may be reclaimed."),
    Flag("RACON_TPU_EXEC_POLL_S", "1", "float",
         "Idle wait between shard-claim passes while every remaining "
         "shard is leased by another worker."),
    Flag("RACON_TPU_EXEC_RETRIES", "3", "int",
         "Transient-io retries of a shard, with exponential backoff on the "
         "same engines, before it moves down the ladder."),
    Flag("RACON_TPU_EXEC_BACKOFF_S", "0.5", "float",
         "Base of the transient-fault backoff (doubled each retry, with a "
         "deterministic jitter)."),
    # ------------------------------------- the resident polishing service
    Flag("RACON_TPU_SERVE_WARM_SHAPES", "500:131072:8192:8", "str",
         "Expected-shape profile of the resident service (racon --serve): "
         "comma-separated 'window_length:pairs:windows[:contigs]' entries. "
         "Parsed and counted at startup (a malformed entry fails it); the "
         "port compiles nothing per shape, so the shapes drive no "
         "compile (empty = no profile)."),
    Flag("RACON_TPU_SERVE_BUDGET", "8G", "str",
         "Resident service admission budget: the summed resident-"
         "footprint estimate (the exec planner's cost model) of "
         "running jobs is kept under this size, and a single job "
         "estimated over it is rejected with the reason instead of "
         "OOMing the server (plain number = MB; K/M/G/T suffixes; "
         "the CLI --serve-budget flag overrides)."),
    Flag("RACON_TPU_SERVE_QUEUE", "64", "int",
         "Maximum queued (admitted, not yet running) jobs the "
         "resident service holds before rejecting submissions with "
         "'queue full'."),
    Flag("RACON_TPU_SERVE_DIR", "", "path",
         "Durable serve directory (equivalent to the CLI --serve-dir "
         "flag): the append-only fsync'd job journal and the "
         "CRC-verified result spool live here, so a server killed "
         "mid-batch restarts with no lost or duplicated work — "
         "completed jobs serve from the spool, queued/running jobs "
         "re-admit down the crash ladder (empty = in-memory only)."),
    Flag("RACON_TPU_SERVE_DRAIN_S", "600", "float",
         "Bound on the graceful-drain wait (SIGTERM or the protocol's "
         "shutdown mode=drain): the server stops admission and "
         "finishes queued + in-flight jobs, but exits anyway after "
         "this many seconds (0 = wait forever)."),
    Flag("RACON_TPU_CLIENT_RETRIES", "5", "int",
         "Bounded retry budget for ServiceClient / racon --submit: "
         "failed connects and connections lost mid-job reconnect this "
         "many times with exponential backoff, resubmitting under the "
         "same idempotency key so a server restart never duplicates "
         "compute."),
    Flag("RACON_TPU_CLIENT_BACKOFF_S", "0.25", "float",
         "Base of the client reconnect exponential backoff (doubled "
         "per attempt, deterministic CRC32 jitter added — the shared "
         "faults.backoff_s formula the exec ladder uses)."),
    # ------------------------------------------------------- fleet serving
    Flag("RACON_TPU_FLEET_TENANTS", "", "str",
         "Fleet tenant configuration for the gateway (racon --gateway): "
         "comma-separated 'name:weight:budget' entries. The weight is the "
         "stride-scheduling share (higher drains faster), the budget "
         "bounds the tenant's summed in-flight cost estimate (plain "
         "number = MB; K/M/G/T suffixes; 0 or empty = unbounded). "
         "Unknown tenants get weight 1 and no budget; empty = every "
         "tenant equal."),
    Flag("RACON_TPU_FLEET_HOST_TTL_S", "10", "float",
         "Member-host heartbeat time-to-live in seconds: a serve host "
         "whose beacon file (under --fleet-dir) goes unrefreshed for "
         "longer is declared dead, its job leases are broken and its "
         "jobs are re-placed on surviving hosts."),
    Flag("RACON_TPU_FLEET_POLL_S", "0.2", "float",
         "Gateway placement-loop poll interval in seconds: how often "
         "the fleet scheduler re-scans tenant queues, host beacons and "
         "in-flight job status between placement events."),
])


def raw(name: str) -> str:
    """The raw value of a declared flag (its default when unset)."""
    try:
        f = REGISTRY[name]
    except KeyError:
        raise KeyError(f"environment flag {name!r} is not declared in "
                       f"racon_tpu_torch/flags.py") from None
    return os.environ.get(name, f.default)


def get_bool(name: str) -> bool:
    return raw(name).strip().lower() not in _FALSE


def get_int(name: str) -> int:
    v = raw(name).strip()
    return int(v) if v else 0


def get_float(name: str) -> float:
    v = raw(name).strip()
    return float(v) if v else 0.0


def get_str(name: str) -> str:
    return raw(name)


# ------------------------------------------------------- README generation

# a header of its own, so the table cannot collide with the JAX package's
# generated "## Environment flags" block in the same README
_TABLE_HEADER = "### Environment flags (port)"
_TABLE_NOTE = ("<!-- generated by `python -m racon_tpu_torch.flags` from "
               "racon_tpu_torch/flags.py — do not edit by hand -->")


def readme_table() -> str:
    """The README's port flag table, generated from the registry (one row
    a flag, declaration order), as ``racon_tpu.flags.readme_table`` makes
    the JAX package's."""
    lines = [_TABLE_HEADER, "", _TABLE_NOTE, "",
             "| Flag | Type | Default | Effect |",
             "| --- | --- | --- | --- |"]
    for f in REGISTRY.values():
        default = f.default if f.default != "" else "(unset)"
        lines.append(f"| `{f.name}` | {f.kind} | `{default}` | {f.help} |")
    return "\n".join(lines) + "\n"


def check_readme(path: str) -> bool:
    """True when ``path`` holds the current generated table verbatim."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return readme_table() in fh.read()
    except OSError:
        return False


def _main(argv) -> int:
    if argv and argv[0] == "--check-readme":
        if check_readme(argv[1] if len(argv) > 1 else "README.md"):
            return 0
        import sys
        print("README port flag table is stale — regenerate with "
              "`python -m racon_tpu_torch.flags` and paste the output",
              file=sys.stderr)
        return 1
    print(readme_table(), end="")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
