"""The port CLI against the JAX CLI on the host engines, on the CPU.

Both CLIs run with no ``-c`` and no ``--*aligner-batches``, so both
align and build consensus with their native C++ engines; what differs is
the Python around them: the parsers (the port's native parser, the JAX
package's), the filter, the transmute, the windows and the stitch. On
``write_inputs(0.01, seed=5)`` each variant's stdout must be
byte-identical: gzipped reads, overlaps and draft; MHAP and SAM overlaps
made from the PAF; FASTA reads; ``-u`` with an extra 3 kbp contig that no
overlap reaches; ``-w 1000``; ``-m 5 -x -4 -g -8``; ``--overlaps auto``
(the first-party overlapper; the port's on ``--device cpu``, its plain
versions) in contig and fragment (``-f``) mode. The two CLIs of a case run
side by side.
"""

import gzip
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from racon_tpu_torch.io import parsers
from racon_tpu_torch.utils.simulate import write_inputs
from tests.test_torch_parsers import fastq_to_fasta, paf_to_mhap, paf_to_sam

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("cli"))
    sim = write_inputs(0.01, str(d), seed=5)
    reads_fq = pathlib.Path(sim["reads"]).read_bytes()
    paf = pathlib.Path(sim["overlaps"]).read_bytes()
    draft = pathlib.Path(sim["draft"]).read_bytes()
    reads = {r.name: r.data for r in parsers.parse_fastq(sim["reads"])}
    targets = {t.name: t.data for t in parsers.parse_fasta(sim["draft"])}
    extra = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(5).integers(0, 4, 3000)].tobytes()
    out = dict(sim)
    for key, name, blob in (
            ("reads_gz", "reads.fastq.gz", reads_fq),
            ("overlaps_gz", "ovl.paf.gz", paf),
            ("draft_gz", "draft.fasta.gz", draft)):
        out[key] = str(d / name)
        pathlib.Path(out[key]).write_bytes(gzip.compress(blob, 1))
    for key, name, blob in (
            ("mhap", "ovl.mhap", paf_to_mhap(paf, list(reads),
                                             list(targets))),
            ("sam", "ovl.sam", paf_to_sam(paf, reads, targets)),
            ("reads_fasta", "reads.fasta", fastq_to_fasta(reads_fq)),
            ("draft_extra", "draft_extra.fasta",
             draft + b">contig_extra\n" + extra + b"\n")):
        out[key] = str(d / name)
        pathlib.Path(out[key]).write_bytes(blob)
    out["auto"] = parsers.AUTO_OVERLAPS
    return out


# case -> (options, reads, overlaps, draft) as keys of the files fixture
CASES = {
    "gzip": ([], "reads_gz", "overlaps_gz", "draft_gz"),
    "mhap": ([], "reads", "mhap", "draft"),
    "sam": ([], "reads", "sam", "draft"),
    "fasta_reads": ([], "reads_fasta", "overlaps", "draft"),
    "include_unpolished": (["-u"], "reads", "overlaps", "draft_extra"),
    "window_1000": (["-w", "1000"], "reads", "overlaps", "draft"),
    "scores": (["-m", "5", "-x", "-4", "-g", "-8"], "reads", "overlaps",
               "draft"),
    "auto": ([], "reads", "auto", "draft"),
    "auto_fragment": (["-f"], "reads", "auto", "reads"),
}
# options only the port CLI takes: its overlapper runs on the card unless
# told otherwise
PORT_OPTIONS = {"auto": ["--device", "cpu"],
                "auto_fragment": ["--device", "cpu"]}


def _cli(module, args, extra_env):
    env = dict(os.environ, **extra_env)
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


@pytest.mark.parametrize("case", list(CASES))
def test_port_cli_matches_jax_cli_on_host_engines(files, case):
    opts, *keys = CASES[case]
    args = ["-t", "2", *opts, *[files[k] for k in keys]]
    jax_proc = _cli("racon_tpu", args,
                    {"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                     "--xla_force_host_platform_device_count=1"})
    port_proc = _cli("racon_tpu_torch", PORT_OPTIONS.get(case, []) + args,
                     {"OMP_NUM_THREADS": "2"})
    port_out, port_err = port_proc.communicate(timeout=300)
    jax_out, jax_err = jax_proc.communicate(timeout=300)
    assert port_proc.returncode == 0, port_err.decode()[-2000:]
    assert jax_proc.returncode == 0, jax_err.decode()[-2000:]
    assert port_out.startswith(b">read_" if case == "auto_fragment"
                               else b">contig_0 LN:i:")
    assert port_out == jax_out
    if case == "include_unpolished":
        assert b">contig_extra" in port_out
