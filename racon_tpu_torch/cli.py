"""`racon` command line of the port: one-shot contig polishing.

The option table of ``racon_tpu/cli.py`` (positional ``<sequences>
<overlaps> <target sequences>``, the reference's option names and
defaults, FASTA on stdout as ``>{name}{tags}\\n{data}``) with racon-gpu's
CUDA names for the accelerator knobs: ``-c/--cudapoa-batches``,
``-b/--cuda-banded-alignment`` and ``--cudaaligner-batches``. Without
``-c`` the consensus runs on the host engine, without
``--cudaaligner-batches`` the alignment does. ``--device`` (default
``cuda``) is where the device engines and the ``auto`` overlapper run;
``cpu`` runs the kernels' plain PyTorch versions.

Observability (``racon_tpu/cli.py``'s): ``--trace FILE`` writes the run's
spans as Chrome trace-event JSON, ``--run-report FILE`` the
schema-versioned run report (next to the trace as ``run_report.json`` when
only ``--trace`` is given), ``--profile DIR`` a ``torch.profiler`` trace of
the run; ``RACON_TPU_TRACE`` and ``RACON_TPU_RUN_REPORT`` are the first
two's environment equivalents. The trace and the report are written on the
error paths too. None of them changes an output byte.

The streaming shard runner (``racon_tpu_torch.exec``): ``--shards N``,
``--max-ram SIZE``, ``--resume``, ``--shard-dir DIR``, ``--workers N`` and
``--chips N`` (or ``RACON_TPU_CHIPS``) route the run through
``ShardRunner``, whose output bytes equal the one-shot run's; its run
report is of kind ``exec`` with one row a shard. ``--chips N`` drives N
local cards from this process, one in-process chip worker a card. ``--workers N`` starts N-1 secondary processes of this CLI on
the same device (``--exec-secondary``, hidden), which drain the same
work dir and write no FASTA; this process merges, reaps them, and then
removes a derived work dir and writes its trace and report.

The resident polishing service (``racon_tpu_torch.serve``): ``--serve
SOCK`` runs this process as a server on the unix socket SOCK (no
positional inputs; ``-m/-x/-g/-b`` fix its engine profile, ``-c`` and
``--cudaaligner-batches`` put its engines on ``--device``, ``--chips N``
pins one slot a card, ``--workers N`` sizes its slot pool, ``--serve-budget`` bounds the in-flight footprint,
``--serve-dir`` makes it crash-safe, ``--fleet-dir`` registers it with a
fleet); ``--submit SOCK`` sends this command's polish to such a server
and streams the FASTA to stdout as the one-shot run would print it (the
device is the server's, so the client never touches CUDA).

The fleet (``racon_tpu_torch.fleet``): ``--gateway HOST:PORT
--fleet-dir DIR`` runs a TCP gateway that places jobs on the ``--serve
--fleet-dir DIR`` hosts under per-job leases and moves a dead host's
jobs to survivors; it does no device work. ``--submit HOST:PORT
[--tenant NAME] [--priority N]`` submits through it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from . import __version__, flags, obs
from .core.polisher import PolisherType, create_polisher
from .params import DEFAULT_GAP, DEFAULT_MATCH, DEFAULT_MISMATCH


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon",
        description="consensus module for raw de novo DNA assembly of long "
                    "uncorrected reads (PyTorch/CUDA implementation)")
    # the positionals are optional only because --serve runs without them;
    # every polishing mode (one-shot, sharded, --submit) still requires all
    # three, enforced in main() with argparse's own error text
    p.add_argument("sequences", nargs="?", default=None,
                   help="FASTA/FASTQ file (may be gzipped) with sequences "
                        "used for correction")
    p.add_argument("overlaps", nargs="?", default=None,
                   help="MHAP/PAF/SAM file (may be gzipped) with overlaps "
                        "between sequences and targets, or the literal "
                        "'auto' to compute overlaps in-process with the "
                        "first-party minimizer-chain overlapper (on "
                        "--device)")
    p.add_argument("target_sequences", nargs="?", default=None,
                   help="FASTA/FASTQ file (may be gzipped) with targets to "
                        "correct")
    p.add_argument("-u", "--include-unpolished", action="store_true",
                   help="output unpolished target sequences")
    p.add_argument("-f", "--fragment-correction", action="store_true",
                   help="perform fragment correction instead of contig "
                        "polishing (overlaps file should contain dual/self "
                        "overlaps!)")
    p.add_argument("-w", "--window-length", type=int, default=500,
                   help="size of window on which POA is performed")
    p.add_argument("-q", "--quality-threshold", type=float, default=10.0,
                   help="threshold for average base quality of windows used "
                        "in POA")
    p.add_argument("-e", "--error-threshold", type=float, default=0.3,
                   help="maximum allowed error rate used for filtering "
                        "overlaps")
    p.add_argument("--no-trimming", action="store_true",
                   help="disables consensus trimming at window ends")
    p.add_argument("-m", "--match", type=int, default=DEFAULT_MATCH,
                   help="score for matching bases")
    p.add_argument("-x", "--mismatch", type=int, default=DEFAULT_MISMATCH,
                   help="score for mismatching bases")
    p.add_argument("-g", "--gap", type=int, default=DEFAULT_GAP,
                   help="gap penalty (must be negative)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="number of threads")
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-c", "--cudapoa-batches", type=int, nargs="?", const=1,
                   default=0,
                   help="number of batches for CUDA accelerated polishing")
    p.add_argument("-b", "--cuda-banded-alignment", action="store_true",
                   help="use banding approximation for alignment on GPU")
    p.add_argument("--cudaaligner-batches", type=int, default=0,
                   help="number of batches for CUDA accelerated alignment")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device engines and the 'auto' "
                        "overlapper run (cpu: the kernels' plain PyTorch "
                        "versions)")
    p.add_argument("--trace", metavar="FILE", default=None,
                   help="write a Chrome trace-event JSON of the run's "
                        "spans (Perfetto / chrome://tracing) to FILE")
    p.add_argument("--run-report", metavar="FILE", default=None,
                   help="write the schema-versioned run_report.json to "
                        "FILE (with --trace alone: next to the trace)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="record the run in torch.profiler and write its "
                        "Chrome trace into DIR")
    p.add_argument("--shards", type=int, default=0, metavar="N",
                   help="polish through the streaming shard runner with "
                        "N memory-bounded shards of target contigs")
    p.add_argument("--max-ram", default=None, metavar="SIZE",
                   help="shard the run to keep peak RSS under SIZE "
                        "(plain number = MB; K/M/G/T suffixes accepted); "
                        "implies the streaming shard runner")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted shard run: completed "
                        "shards are skipped via the checkpoint manifest, "
                        "only the interrupted one re-runs")
    p.add_argument("--shard-dir", default=None, metavar="DIR",
                   help="work directory for shard inputs, part files and "
                        "the checkpoint manifest (default: a directory "
                        "derived from the input paths and parameters, "
                        "removed after a fully successful run; an "
                        "explicit DIR is kept)")
    p.add_argument("--workers", type=int, default=1, metavar="N",
                   help="drain the shard manifest with N cooperating "
                        "worker processes on --device (this one plus N-1 "
                        "spawned secondaries): workers claim shards "
                        "through O_EXCL lease files with heartbeats, a "
                        "dead worker's lease expires and its shard is "
                        "reclaimed, and the output stays byte-identical "
                        "to a single-shot run; independently launched "
                        "processes sharing one --shard-dir cooperate the "
                        "same way (implies the streaming shard runner; "
                        "with --serve it instead sizes the resident "
                        "worker-slot pool)")
    p.add_argument("--chips", type=int, default=0, metavar="N",
                   help="drive N local cards from this one process: the "
                        "streaming shard runner starts one in-process "
                        "chip worker per card, each with its own pinned "
                        "engines, all draining one shard manifest through "
                        "the lease protocol (implies the shard runner; "
                        "default: every local card when a cuda backend "
                        "runs on a multi-card host, 1 otherwise; N above "
                        "the card count is clamped to it; "
                        "RACON_TPU_CHIPS is the environment equivalent; "
                        "with --serve: one pinned worker slot per card)")
    # the resident polishing service (racon_tpu_torch.serve): one warm
    # engine pool serves every job it runs
    p.add_argument("--serve", metavar="SOCK", default=None,
                   help="run as a resident polishing service on the "
                        "unix socket SOCK (no positional inputs): a "
                        "warm engine pool on --device executes submitted "
                        "jobs through the normal pipeline, so a job's "
                        "latency is compute, not the one-shot start; "
                        "-m/-x/-g/-b fix the resident engine profile, "
                        "--serve-budget bounds the in-flight job "
                        "footprint (see README 'Polishing as a "
                        "service')")
    p.add_argument("--submit", metavar="SOCK", default=None,
                   help="submit this invocation as a job to the "
                        "resident service listening on SOCK (or a "
                        "fleet gateway's HOST:PORT) and stream the "
                        "polished FASTA to stdout — byte-identical to "
                        "running the same command one-shot")
    p.add_argument("--serve-budget", metavar="SIZE", default=None,
                   help="admission budget for --serve: the summed "
                        "resident-footprint estimate of running jobs "
                        "stays under SIZE (plain number = MB; K/M/G/T "
                        "suffixes; default RACON_TPU_SERVE_BUDGET)")
    p.add_argument("--serve-dir", metavar="DIR", default=None,
                   help="durable directory for --serve (crash-safe "
                        "serving): every job lifecycle transition is "
                        "journaled (append-only, fsync'd) and results "
                        "spool to CRC-verified files, so a server "
                        "killed mid-batch restarts from the same DIR "
                        "with no lost or duplicated work — completed "
                        "jobs serve from the spool, queued/running "
                        "jobs re-run down the crash ladder "
                        "(RACON_TPU_SERVE_DIR is the env equivalent; "
                        "unset = in-memory only)")
    # fleet serving (racon_tpu_torch.fleet): a TCP gateway places jobs
    # on registered --serve hosts under per-job leases
    p.add_argument("--gateway", metavar="HOST:PORT", default=None,
                   help="run the fleet gateway: a TCP front door "
                        "speaking the serve protocol verbatim that "
                        "journals every accepted job durably (same "
                        "machinery as --serve-dir) before "
                        "acknowledging, schedules tenants "
                        "weighted-fair (RACON_TPU_FLEET_TENANTS), and "
                        "places jobs across the hosts registered in "
                        "--fleet-dir under per-job leases — a host "
                        "dead past RACON_TPU_FLEET_HOST_TTL_S has its "
                        "jobs re-placed on survivors; it does no "
                        "device work")
    p.add_argument("--fleet-dir", metavar="DIR", default=None,
                   help="fleet membership + durable gateway state "
                        "directory: with --serve the host registers a "
                        "heartbeat beacon under DIR/hosts/ so the "
                        "gateway can place work on it; with --gateway "
                        "it holds the fleet journal, result spool, "
                        "and per-job leases")
    p.add_argument("--tenant", metavar="NAME", default=None,
                   help="tenant to submit under (--submit only): the "
                        "gateway schedules tenants weighted-fair and "
                        "enforces per-tenant cost budgets "
                        "(RACON_TPU_FLEET_TENANTS); unset = 'default'")
    p.add_argument("--priority", metavar="N", type=int, default=None,
                   help="job priority for --submit (higher first "
                        "within a tenant; default 0): at the gateway "
                        "a high-priority job may preempt a running "
                        "lower-priority one, draining it back to the "
                        "queue at a ladder boundary — never killing "
                        "it mid-window")
    # internal: a spawned cooperating worker, which adopts the primary's
    # manifest, polishes shards and emits no merged FASTA
    p.add_argument("--exec-secondary", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def _preprocess_argv(argv):
    """``-c`` consumes a following token only when it is an integer, like
    the reference's getopt optional argument."""
    out = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-c", "--cudapoa-batches"):
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            if nxt is not None and not nxt.startswith("-"):
                try:
                    int(nxt)
                except ValueError:
                    out.append("--cudapoa-batches=1")
                    i += 1
                    continue
        out.append(tok)
        i += 1
    return out


def _obs_paths(args):
    """(trace_path, report_path) from the flags and their environment
    equivalents; ``--trace`` without ``--run-report`` puts the report
    next to the trace."""
    trace_path = args.trace or flags.get_str("RACON_TPU_TRACE") or None
    report_path = (args.run_report
                   or flags.get_str("RACON_TPU_RUN_REPORT") or None)
    if trace_path and report_path is None:
        report_path = os.path.join(
            os.path.dirname(os.path.abspath(trace_path)),
            "run_report.json")
    return trace_path, report_path


def _finish_obs(trace_path, report_path, argv, t_start, t0,
                phases=None, kind="cli", shards=None) -> None:
    """Write the requested artifacts (on the error paths too). The trace
    goes first, so its ring-overflow gauge lands in the report."""
    if trace_path:
        obs.trace.export(trace_path)
    if report_path:
        obs.report.write_report(report_path, obs.report.build_report(
            kind, argv=argv, started_unix=t_start,
            wall_s=time.perf_counter() - t0, phases=phases,
            shards=shards))


def _secondary_argv(argv, n: int):
    """The argv of the N-1 spawned secondaries: the command line without
    ``--workers`` (a secondary spawns none) and with the secondary
    marker."""
    child = []
    skip = False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == "--workers":
            skip = True
            continue
        if tok.startswith("--workers="):
            continue
        child.append(tok)
    child.append("--exec-secondary")
    return [child] * n


def _reap(children) -> None:
    """Wait for the secondaries. Every shard was terminal before the
    primary's run returned, so they are in their last poll; one that
    hangs must not fail a finished run (its FASTA is on stdout): it is
    killed with a warning."""
    for proc in children:
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            print("[racon::] warning: a secondary worker did not exit "
                  "after the run completed — killing it",
                  file=sys.stderr)
            proc.kill()
            proc.wait()


def _run_sharded(args, argv, trace_path, report_path, t_start, t0) -> int:
    """The run through the streaming shard runner, with its spawned
    secondaries under ``--workers``."""
    from .exec import ShardRunner, parse_ram
    workers = max(1, args.workers)
    secondary = bool(args.exec_secondary)
    children = []
    try:
        runner = ShardRunner(
            args.sequences, args.overlaps, args.target_sequences,
            type_=PolisherType.F if args.fragment_correction
            else PolisherType.C,
            window_length=args.window_length,
            quality_threshold=args.quality_threshold,
            error_threshold=args.error_threshold,
            trim=not args.no_trimming,
            match=args.match, mismatch=args.mismatch, gap=args.gap,
            num_threads=args.threads,
            aligner="cuda" if args.cudaaligner_batches > 0 else "native",
            consensus="cuda" if args.cudapoa_batches > 0 else "native",
            aligner_batches=max(1, args.cudaaligner_batches),
            consensus_batches=max(1, args.cudapoa_batches),
            banded=args.cuda_banded_alignment,
            include_unpolished=args.include_unpolished,
            n_shards=args.shards,
            max_ram_bytes=parse_ram(args.max_ram) if args.max_ram else 0,
            resume=args.resume, work_dir=args.shard_dir,
            secondary=secondary, defer_cleanup=workers > 1,
            device=args.device, chips=args.chips)
        if workers > 1 and not secondary:
            # the secondaries poll for the manifest this process is about
            # to publish, then claim shards on the same device
            for child_argv in _secondary_argv(argv, workers - 1):
                children.append(subprocess.Popen(
                    [sys.executable, "-m", "racon_tpu_torch"] + child_argv,
                    stdout=subprocess.DEVNULL))
        with obs.profile(args.profile or ""):
            if secondary:
                with open(os.devnull, "wb") as sink:
                    runner.run(sink)
            else:
                runner.run(sys.stdout.buffer)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"[racon::] error: {e}", file=sys.stderr)
        for proc in children:
            proc.terminate()
        _reap(children)
        _finish_obs(trace_path, report_path, argv, t_start, t0,
                    kind="exec")
        return 1
    # the cleanup and this process's trace and report come after the
    # secondaries exit, so the report left at the path is this one's
    _reap(children)
    if workers > 1 and not secondary:
        runner.cleanup_work_dir()
    _finish_obs(trace_path, report_path, argv, t_start, t0, kind="exec",
                shards=runner.summary.get("shards"))
    if runner.summary.get("quarantined"):
        # the output lacks these shards' contigs: not a finished polish
        print(f"[racon::] error: shard(s) "
              f"{runner.summary['quarantined']} quarantined; their "
              f"contigs are missing from the output. The work dir "
              f"{runner.work_dir} is kept: rerun with --resume to retry "
              f"them.", file=sys.stderr)
        return 1
    return 0


def _serve(args) -> int:
    """``--serve``: run the resident polishing service until it stops."""
    from .exec import parse_ram
    from .serve.service import PolishServer
    server = None
    try:
        server = PolishServer(
            args.serve,
            match=args.match, mismatch=args.mismatch, gap=args.gap,
            banded=args.cuda_banded_alignment,
            num_threads=args.threads,
            aligner_backend="cuda" if args.cudaaligner_batches > 0
            else "native",
            consensus_backend="cuda" if args.cudapoa_batches > 0
            else "native",
            aligner_batches=max(1, args.cudaaligner_batches),
            consensus_batches=max(1, args.cudapoa_batches),
            chips=args.chips,
            # --workers N with --serve: N slots in the pool (the chips'
            # pinned slots first)
            workers=args.workers if args.workers > 1 else 0,
            budget_bytes=parse_ram(args.serve_budget)
            if args.serve_budget else 0,
            serve_dir=args.serve_dir, fleet_dir=args.fleet_dir,
            device=args.device)
        return server.serve_forever()
    except KeyboardInterrupt:
        if server is not None:
            server.shutdown()
        return 0
    except (ValueError, RuntimeError, OSError) as e:
        print(f"[racon_tpu::serve] error: {e}", file=sys.stderr)
        return 1


def _gateway(args) -> int:
    """``--gateway``: run the fleet gateway until it stops. It does no
    device work, whatever ``--device`` says."""
    from .fleet.gateway import Gateway
    gateway = None
    try:
        gateway = Gateway(args.gateway, args.fleet_dir)
        return gateway.serve_forever()
    except KeyboardInterrupt:
        if gateway is not None:
            gateway.shutdown()
        return 0
    except (ValueError, RuntimeError, OSError) as e:
        print(f"[racon_tpu::fleet] error: {e}", file=sys.stderr)
        return 1


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    parser = build_parser()
    args = parser.parse_args(_preprocess_argv(list(argv)))
    if args.chips < 0:
        parser.error(f"--chips must be >= 0 (got {args.chips}); "
                     f"0 means automatic")
    trace_path, report_path = _obs_paths(args)
    obs.begin(trace_path, report_path)
    t_start = time.time()
    t0 = time.perf_counter()

    if args.serve_dir and not args.serve:
        parser.error("--serve-dir only makes sense with --serve "
                     "(the shard runner's checkpoint directory is "
                     "--shard-dir)")
    if args.fleet_dir and not (args.serve or args.gateway):
        parser.error("--fleet-dir only makes sense with --serve (to "
                     "register the host) or --gateway (to hold the "
                     "fleet journal and host registry)")
    if args.gateway:
        if args.serve or args.submit:
            parser.error("--gateway is mutually exclusive with "
                         "--serve and --submit")
        if args.sequences or args.overlaps or args.target_sequences:
            parser.error("--gateway takes no positional inputs (jobs "
                         "submit theirs over the socket)")
        if not args.fleet_dir:
            parser.error("--gateway requires --fleet-dir (the fleet "
                         "journal, host registry, and leases live "
                         "there)")
        return _gateway(args)
    if args.serve:
        if args.sequences or args.overlaps or args.target_sequences:
            parser.error("--serve takes no positional inputs (jobs "
                         "submit theirs over the socket)")
        if args.submit:
            parser.error("--serve and --submit are mutually exclusive")
        return _serve(args)

    # every polishing mode (one-shot, sharded, --submit) needs the input
    # triple; only --serve runs without it
    if not (args.sequences and args.overlaps and args.target_sequences):
        parser.error("the following arguments are required: sequences, "
                     "overlaps, target_sequences")

    if args.submit:
        from .serve import client as serve_client
        try:
            return serve_client.submit_and_stream(
                args.submit, serve_client.spec_from_args(args),
                sys.stdout.buffer, report_path=report_path)
        except (ValueError, RuntimeError, OSError) as e:
            print(f"[racon_tpu::serve] error: {e}", file=sys.stderr)
            return 1

    # RACON_TPU_CHIPS, the --chips environment equivalent, routes the run
    # into the shard runner (where the chip scheduler lives) as --chips does
    if args.shards or args.max_ram or args.resume or args.shard_dir \
            or args.workers > 1 or args.exec_secondary or args.chips \
            or flags.get_int("RACON_TPU_CHIPS") > 0:
        return _run_sharded(args, list(argv), trace_path, report_path,
                            t_start, t0)
    try:
        polisher = create_polisher(
            args.sequences, args.overlaps, args.target_sequences,
            PolisherType.F if args.fragment_correction else PolisherType.C,
            window_length=args.window_length,
            quality_threshold=args.quality_threshold,
            error_threshold=args.error_threshold,
            trim=not args.no_trimming,
            match=args.match, mismatch=args.mismatch, gap=args.gap,
            num_threads=args.threads,
            aligner="cuda" if args.cudaaligner_batches > 0 else "native",
            consensus="cuda" if args.cudapoa_batches > 0 else "native",
            aligner_batches=max(1, args.cudaaligner_batches),
            consensus_batches=max(1, args.cudapoa_batches),
            banded=args.cuda_banded_alignment, device=args.device)
    except (ValueError, RuntimeError) as e:
        print(f"[racon::createPolisher] error: {e}", file=sys.stderr)
        _finish_obs(trace_path, report_path, list(argv), t_start, t0)
        return 1
    if args.profile and flags.get_str("RACON_TPU_TORCH_PROFILE"):
        # one profiler a process: the run-wide session holds it, and the
        # polish phase's bracket becomes a no-op
        print("[racon::] note: --profile supersedes "
              "RACON_TPU_TORCH_PROFILE (nested torch profiler sessions "
              "are not supported)", file=sys.stderr)
    try:
        with obs.profile(args.profile or ""):
            polished = polisher.run(not args.include_unpolished)
    except (ValueError, OSError) as e:
        print(f"[racon::] error: {e}", file=sys.stderr)
        _finish_obs(trace_path, report_path, list(argv), t_start, t0,
                    phases=dict(polisher.timings))
        return 1
    except BaseException:
        # a fault that propagates (a kernel's, an injected one) still
        # leaves its trace and report
        _finish_obs(trace_path, report_path, list(argv), t_start, t0,
                    phases=dict(polisher.timings))
        raise
    out = sys.stdout.buffer
    for seq in polished:
        out.write(b">" + seq.name + b"\n" + seq.data + b"\n")
    out.flush()
    _finish_obs(trace_path, report_path, list(argv), t_start, t0,
                phases=dict(polisher.timings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
