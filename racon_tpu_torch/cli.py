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
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .core.polisher import PolisherType, create_polisher
from .params import DEFAULT_GAP, DEFAULT_MATCH, DEFAULT_MISMATCH


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon",
        description="consensus module for raw de novo DNA assembly of long "
                    "uncorrected reads (PyTorch/CUDA implementation)")
    p.add_argument("sequences",
                   help="FASTA/FASTQ file (may be gzipped) with sequences "
                        "used for correction")
    p.add_argument("overlaps",
                   help="MHAP/PAF/SAM file (may be gzipped) with overlaps "
                        "between sequences and targets, or the literal "
                        "'auto' to compute overlaps in-process with the "
                        "first-party minimizer-chain overlapper (on "
                        "--device)")
    p.add_argument("target_sequences",
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


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(_preprocess_argv(list(argv)))
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
        return 1
    try:
        polished = polisher.run(not args.include_unpolished)
    except (ValueError, OSError) as e:
        print(f"[racon::] error: {e}", file=sys.stderr)
        return 1
    out = sys.stdout.buffer
    for seq in polished:
        out.write(b">" + seq.name + b"\n" + seq.data + b"\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
