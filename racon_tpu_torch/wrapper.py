"""racon_wrapper: out-of-core orchestration (the port of
``racon_tpu/wrapper.py``).

The reference's ``scripts/racon_wrapper.py``: optionally subsample the
reads to a coverage and split the targets into chunks of a byte size with
:mod:`racon_tpu_torch.rampler`, then polish the chunks one after another;
the polished FASTA goes to stdout.

``--split`` runs through the streaming shard runner
(:mod:`racon_tpu_torch.exec`) in this process: the same byte-bounded
chunks of targets, each reading only its own overlaps and reads through
the index, one engine pair for every chunk, and the checkpoint manifest in
a work dir derived from the inputs, so a crashed ``--split`` run picks up
its finished chunks when it is run again. ``--legacy-split`` keeps the
reference's path: ``rampler split``, then one ``racon_tpu_torch`` process
a chunk (each chunk's memory goes back to the system with its process).
``--device`` (default ``cuda``) is where the device engines of either
path run; without ``-c``/``--cudaaligner-batches`` the host engines run.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import time


def eprint(*args, **kwargs):
    print(*args, file=sys.stderr, **kwargs)


class RaconWrapper:
    def __init__(self, sequences, overlaps, target_sequences, split,
                 subsample, include_unpolished, fragment_correction,
                 window_length, quality_threshold, error_threshold, match,
                 mismatch, gap, threads, cudapoa_batches=0,
                 cuda_banded_alignment=False, cudaaligner_batches=0,
                 legacy_split=False, device="cuda"):
        self.legacy_split = legacy_split
        self.sequences = os.path.abspath(sequences)
        self.overlaps = os.path.abspath(overlaps)
        self.target_sequences = os.path.abspath(target_sequences)
        self.chunk_size = split
        self.reference_length, self.coverage = (
            subsample if subsample is not None else (None, None))
        self.include_unpolished = include_unpolished
        self.fragment_correction = fragment_correction
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.threads = threads
        self.cudapoa_batches = cudapoa_batches
        self.cuda_banded_alignment = cuda_banded_alignment
        self.cudaaligner_batches = cudaaligner_batches
        self.device = device
        self.work_directory = os.path.join(
            os.getcwd(), f"racon_work_directory_{time.time()}")

    def __enter__(self):
        try:
            os.makedirs(self.work_directory, exist_ok=True)
        except OSError:
            eprint("[RaconWrapper::__enter__] error: unable to create work "
                   "directory!")
            sys.exit(1)

    def __exit__(self, exception_type, exception_value, traceback):
        try:
            shutil.rmtree(self.work_directory)
        except OSError:
            eprint("[RaconWrapper::__exit__] warning: unable to clean work "
                   "directory!")

    def _run_module(self, module, args):
        cmd = [sys.executable, "-m", module] + args
        try:
            p = subprocess.Popen(cmd)
        except OSError:
            eprint(f"[RaconWrapper::run] error: unable to run {module}!")
            sys.exit(1)
        p.communicate()
        if p.returncode != 0:
            sys.exit(1)

    def run(self) -> None:
        eprint("[RaconWrapper::run] preparing data with rampler")
        if self.reference_length is not None and self.coverage is not None:
            self._run_module("racon_tpu_torch.rampler",
                             ["-o", self.work_directory, "subsample",
                              self.sequences, str(self.reference_length),
                              str(self.coverage)])
            base = os.path.basename(self.sequences).split(".")[0]
            # rampler names its output by the records (.fasta or .fastq)
            found = glob.glob(os.path.join(
                self.work_directory, f"{base}_{self.coverage}x.*"))
            if not found:
                eprint("[RaconWrapper::run] error: unable to find "
                       "subsampled sequences!")
                sys.exit(1)
            subsampled = found[0]
        else:
            subsampled = self.sequences

        if self.chunk_size is not None and not self.legacy_split:
            from .core.polisher import PolisherType
            from .exec import ShardRunner

            eprint("[RaconWrapper::run] processing data with the "
                   "streaming shard runner")
            runner = ShardRunner(
                subsampled, self.overlaps, self.target_sequences,
                type_=PolisherType.F if self.fragment_correction
                else PolisherType.C,
                window_length=self.window_length,
                quality_threshold=self.quality_threshold,
                error_threshold=self.error_threshold,
                match=self.match, mismatch=self.mismatch, gap=self.gap,
                num_threads=self.threads,
                aligner="cuda" if self.cudaaligner_batches > 0
                else "native",
                consensus="cuda" if self.cudapoa_batches > 0
                else "native",
                aligner_batches=max(1, self.cudaaligner_batches),
                consensus_batches=max(1, self.cudapoa_batches),
                banded=self.cuda_banded_alignment,
                include_unpolished=self.include_unpolished,
                max_target_bytes=self.chunk_size,
                # a work dir derived from the inputs, outside this
                # wrapper's throwaway directory, and resume: a crashed
                # run continues when run again, and a fresh one starts
                # clean, since a stale manifest cannot match its inputs
                work_dir=None, resume=True, keep_work_dir=False,
                device=self.device)
            runner.run(sys.stdout.buffer)
            return

        split_targets = []
        if self.chunk_size is not None:
            self._run_module("racon_tpu_torch.rampler",
                             ["-o", self.work_directory, "split",
                              self.target_sequences, str(self.chunk_size)])
            base = os.path.basename(self.target_sequences).split(".")[0]
            i = 0
            while True:
                found = glob.glob(os.path.join(
                    self.work_directory, f"{base}_{i}.*"))
                if not found:
                    break
                split_targets.append(found[0])
                i += 1
            if not split_targets:
                eprint("[RaconWrapper::run] error: unable to find split "
                       "target sequences!")
                sys.exit(1)
        else:
            split_targets.append(self.target_sequences)

        params = []
        if self.include_unpolished:
            params.append("-u")
        if self.fragment_correction:
            params.append("-f")
        if self.cudapoa_batches:
            params.extend(["-c", str(self.cudapoa_batches)])
        if self.cuda_banded_alignment:
            params.append("-b")
        if self.cudaaligner_batches:
            params.extend(["--cudaaligner-batches",
                           str(self.cudaaligner_batches)])
        params.extend(["-w", str(self.window_length),
                       "-q", str(self.quality_threshold),
                       "-e", str(self.error_threshold),
                       "-m", str(self.match),
                       "-x", str(self.mismatch),
                       "-g", str(self.gap),
                       "-t", str(self.threads),
                       "--device", self.device,
                       subsampled, self.overlaps, ""])

        for part in split_targets:
            eprint("[RaconWrapper::run] processing data with racon")
            params[-1] = part
            self._run_module("racon_tpu_torch", params)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="racon_wrapper",
        description="Racon_wrapper encapsulates racon and adds two "
                    "features: sequences can be subsampled to decrease "
                    "total execution time, and target sequences can be "
                    "split into smaller chunks run sequentially to "
                    "decrease memory consumption. The usage equals racon.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("sequences", help="FASTA/FASTQ (may be gzipped) "
                                          "sequences used for correction")
    parser.add_argument("overlaps", help="MHAP/PAF/SAM (may be gzipped) "
                                         "overlaps")
    parser.add_argument("target_sequences", help="FASTA/FASTQ (may be "
                                                 "gzipped) targets")
    parser.add_argument("--split", type=int,
                        help="split target sequences into chunks of desired "
                             "size in bytes (runs through the streaming "
                             "shard runner; see --legacy-split)")
    parser.add_argument("--legacy-split", action="store_true",
                        help="use the original rampler-split + sequential "
                             "per-chunk subprocess path instead of the "
                             "in-process streaming shard runner")
    parser.add_argument("--subsample", nargs=2, type=int,
                        metavar=("REFERENCE_LENGTH", "COVERAGE"),
                        help="subsample sequences to desired coverage given "
                             "the reference length")
    parser.add_argument("-u", "--include-unpolished", action="store_true",
                        help="output unpolished target sequences")
    parser.add_argument("-f", "--fragment-correction", action="store_true",
                        help="perform fragment correction instead of contig "
                             "polishing")
    parser.add_argument("-w", "--window-length", type=int, default=500)
    parser.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    parser.add_argument("-e", "--error-threshold", type=float, default=0.3)
    # the reference wrapper defaults to 5/-4/-8 where racon defaults to
    # 3/-5/-4 (scripts/racon_wrapper.py:175-180 against
    # src/main.cpp:49-64); the difference is kept
    parser.add_argument("-m", "--match", type=int, default=5)
    parser.add_argument("-x", "--mismatch", type=int, default=-4)
    parser.add_argument("-g", "--gap", type=int, default=-8)
    parser.add_argument("-t", "--threads", type=int, default=1)
    parser.add_argument("-c", "--cudapoa-batches", type=int, default=0,
                        help="number of batches for CUDA accelerated "
                             "polishing")
    parser.add_argument("-b", "--cuda-banded-alignment", action="store_true",
                        help="use banding approximation for alignment on "
                             "GPU")
    parser.add_argument("--cudaaligner-batches", type=int, default=0,
                        help="number of batches for CUDA accelerated "
                             "alignment")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the device engines run (cpu: the "
                             "kernels' plain PyTorch versions)")

    args = parser.parse_args(argv)

    racon = RaconWrapper(
        args.sequences, args.overlaps, args.target_sequences, args.split,
        args.subsample, args.include_unpolished, args.fragment_correction,
        args.window_length, args.quality_threshold, args.error_threshold,
        args.match, args.mismatch, args.gap, args.threads,
        args.cudapoa_batches, args.cuda_banded_alignment,
        args.cudaaligner_batches, args.legacy_split, args.device)
    with racon:
        racon.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
