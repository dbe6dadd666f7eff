"""The port's native input path against the JAX package's, on the CPU.

Every ``racon_tpu_torch.io.parsers.parse_*`` runs the port's native
streaming parser (``racon_tpu_torch/native/parsers.cpp``). Its records
must equal, field for field and type for type, three things on the same
file: the JAX package's native parser (``racon_tpu.native.parse_seqfile``
/ ``parse_ovlfile``), the JAX package's Python oracle
(``racon_tpu.io.parsers._parse_*_py``) and the port's own Python oracle
(``racon_tpu_torch.io.parsers._parse_*_py``).

Inputs come from ``write_inputs(0.02, seed=7)``: FASTQ and FASTA reads,
the FASTA draft, the PAF, and MHAP and SAM made from the PAF (SAM CIGARs
from the port's native aligner), each plain and gzipped. Besides: a
FASTQ over 2.5 MB (``write_inputs(0.05, seed=9)``) whose header lines at
the parser's 1 MiB and 2 MiB chunk edges are lengthened to straddle them
(a line cut there would end up in the sequence), a PAF over 2.5 MB (the
small PAF's lines repeated under new names; a PAF line cut anywhere is a
different record), the big FASTQ as a gzip of two members split inside a
record (bgzip-style), and multi-line FASTA and FASTQ with descriptions
after the names, trailing whitespace, blank lines and an all-``!``
quality.

Malformed inputs raise ``ParseError`` with the JAX native parser's
messages, and a failed native build raises ``NativeBuildError`` (there is
no Python fallback).
"""

import gzip
import pathlib

import numpy as np
import pytest

from racon_tpu import native as jax_native
from racon_tpu.io import parsers as jax_parsers
from racon_tpu_torch import native
from racon_tpu_torch.io import parsers
from racon_tpu_torch.utils.simulate import write_inputs

# file kind -> (the port's parse_* name, the JAX native entry and its code)
KINDS = {"fasta": ("fasta", "seq", 0), "fastq": ("fastq", "seq", 1),
         "paf": ("paf", "ovl", 0), "mhap": ("mhap", "ovl", 1),
         "sam": ("sam", "ovl", 2)}


def paf_to_mhap(paf: bytes, read_names, target_names, seed=0) -> bytes:
    """MHAP lines for PAF records: 1-based file ordinals of the read and
    the target, the strand as ``arc``, and jaccard tokens of several
    spellings (so the parsed double is checked against Python's
    ``float``)."""
    rid = {n: i + 1 for i, n in enumerate(read_names)}
    tid = {n: i + 1 for i, n in enumerate(target_names)}
    rng = np.random.default_rng(seed)
    spellings = (lambda x: repr(x), lambda x: "%.3g" % x,
                 lambda x: "%.6e" % x, lambda x: "0.1")
    out = []
    for k, line in enumerate(paf.splitlines()):
        f = line.split(b"\t")
        jac = spellings[k % len(spellings)](float(rng.random()))
        out.append(b" ".join([
            b"%d" % rid[f[0]], b"%d" % tid[f[5]], jac.encode(), b"%d" % k,
            b"1" if f[4] == b"-" else b"0", f[2], f[3], f[1],
            b"0", f[7], f[8], f[6]]) + b"\n")
    return b"".join(out)


def paf_to_sam(paf: bytes, reads: dict, targets: dict) -> bytes:
    """SAM records for PAF records, each read aligned end to end (on its
    PAF strand) to its target span by the port's native aligner; a
    header comes first."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    recs, pairs = [], []
    for line in paf.splitlines():
        f = line.split(b"\t")
        q = reads[f[0]][int(f[2]):int(f[3])]
        if f[4] == b"-":
            q = q.translate(comp)[::-1]
        pairs.append((q, targets[f[5]][int(f[7]):int(f[8])]))
        recs.append(f)
    cigars = native.nw_cigar_batch(pairs, num_threads=2)
    head = [b"@HD\tVN:1.6\tSO:unsorted"] + [
        b"@SQ\tSN:%s\tLN:%d" % (n, len(s)) for n, s in targets.items()]
    body = [b"\t".join([f[0], b"16" if f[4] == b"-" else b"0", f[5],
                        b"%d" % (int(f[7]) + 1), b"60", c.encode(),
                        b"*", b"0", b"0", b"*", b"*"])
            for f, c in zip(recs, cigars)]
    return b"\n".join(head + body) + b"\n"


CHUNK = 1 << 20  # the native parser's read quantum (parsers.cpp kChunk)


def straddle_edges(fastq: bytes, edges) -> bytes:
    """``fastq`` with the last header line that starts before each edge
    lengthened (a description of ``x``s) to run across it."""
    out = fastq
    for edge in edges:
        head = out.rindex(b"\n@", 0, edge - 1) + 1
        end = out.index(b"\n", head)
        if end <= edge:
            out = out[:end] + b" " + b"x" * (edge - end + 40) + out[end:]
    return out


def repeat_paf(paf: bytes, min_bytes: int) -> bytes:
    """The PAF's lines again and again, each copy's query names suffixed
    with its copy number, until the text passes ``min_bytes``."""
    lines, out, size, k = paf.splitlines(True), [], 0, 0
    while size <= min_bytes:
        for line in lines:
            f = line.split(b"\t", 1)
            out.append(f[0] + b"_%d\t" % k + f[1])
            size += len(out[-1])
        k += 1
    return b"".join(out)


def fastq_to_fasta(fastq: bytes) -> bytes:
    lines = fastq.splitlines()
    return b"".join(b">" + lines[i][1:] + b"\n" + lines[i + 1] + b"\n"
                    for i in range(0, len(lines), 4))


def gzip_members(blob: bytes, cuts=()) -> bytes:
    """``blob`` as one gzip member, or as one member per piece between
    the byte offsets ``cuts``."""
    edges = [0, *cuts, len(blob)]
    return b"".join(gzip.compress(blob[a:b], compresslevel=1)
                    for a, b in zip(edges, edges[1:]))


def _wrap(seq: bytes, width: int) -> bytes:
    return b"\n".join(seq[i:i + width] for i in range(0, len(seq), width))


def multiline_fasta(fastq: bytes) -> bytes:
    lines = fastq.splitlines()
    out = []
    for k, i in enumerate(range(0, len(lines), 4)):
        out.append(b">" + lines[i][1:] + b" desc=%d\tx \n" % k
                   + _wrap(lines[i + 1], 61 + k % 7) + b"  \r\n\n")
    return b"".join(out)


def multiline_fastq(fastq: bytes) -> bytes:
    lines = fastq.splitlines()
    out = []
    for k, i in enumerate(range(0, len(lines), 4)):
        seq, qual = lines[i + 1], lines[i + 3]
        if k == 1:
            qual = b"!" * len(qual)       # dropped by Sequence, not here
        if k == 2:
            qual = b"@" + qual[1:]        # a quality line that starts '@'
        out.append(b"@" + lines[i][1:] + b" len=%d\n" % len(seq)
                   + _wrap(seq, 70 + k % 5) + b"\n+" + lines[i][1:] + b"\n"
                   + _wrap(qual, 33 + k % 11) + b"\n")
    return b"".join(out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("parse"))
    sim = write_inputs(0.02, str(d / "sim"), seed=7)
    reads_fq = pathlib.Path(sim["reads"]).read_bytes()
    paf = pathlib.Path(sim["overlaps"]).read_bytes()
    draft = pathlib.Path(sim["draft"]).read_bytes()
    reads = {r.name: r.data for r in parsers._parse_fastq_py(sim["reads"])}
    targets = {t.name: t.data
               for t in parsers._parse_fasta_py(sim["draft"])}
    # one record with an empty strand field (Python's t[4][:1] is "")
    f = paf.splitlines()[0].split(b"\t")
    paf_edge = paf + b"\t".join(f[:4] + [b""] + f[5:]) + b"\n"
    big = pathlib.Path(write_inputs(0.05, str(d / "big"), seed=9)["reads"])
    big_fq = straddle_edges(big.read_bytes(), (CHUNK, 2 * CHUNK))
    assert len(big_fq) > 2_500_000
    blobs = {
        "reads_fasta": ("fasta", fastq_to_fasta(reads_fq)),
        "reads_fastq": ("fastq", reads_fq),
        "draft_fasta": ("fasta", draft),
        "paf": ("paf", paf_edge),
        "mhap": ("mhap", paf_to_mhap(paf, list(reads), list(targets))),
        "sam": ("sam", paf_to_sam(paf, reads, targets)),
        "big_fastq": ("fastq", big_fq),
        "big_paf": ("paf", repeat_paf(paf, 2_500_000)),
        "multiline_fasta": ("fasta", multiline_fasta(reads_fq)),
        "multiline_fastq": ("fastq", multiline_fastq(reads_fq)),
    }
    out = {}
    for name, (kind, blob) in blobs.items():
        plain = d / f"{name}.{kind}"
        plain.write_bytes(blob)
        gz = d / f"{name}.{kind}.gz"
        gz.write_bytes(gzip_members(blob))
        out[name] = (kind, str(plain))
        out[name + ".gz"] = (kind, str(gz))
    # two members, the cut inside a record line past the first 1 MiB
    cut = len(big_fq) // 2 + 17
    two = d / "two_members.fastq.gz"
    two.write_bytes(gzip_members(big_fq, (cut,)))
    assert len(gzip.decompress(two.read_bytes())) == len(big_fq)
    out["two_members.gz"] = ("fastq", str(two))
    return out


INPUTS = [f"{name}{gz}" for name in
          ("reads_fasta", "reads_fastq", "draft_fasta", "paf", "mhap",
           "sam", "big_fastq", "big_paf", "multiline_fasta",
           "multiline_fastq")
          for gz in ("", ".gz")] + ["two_members.gz"]


def _typed(values) -> tuple:
    return tuple((type(v).__name__, v) for v in values)


def _port_native(kind, path) -> list:
    recs = getattr(parsers, f"parse_{KINDS[kind][0]}")(path)
    assert isinstance(recs, list)
    if KINDS[kind][1] == "seq":
        return [_typed((r.name, r.data, r.quality)) for r in recs]
    assert {r.fmt for r in recs} <= {kind}
    return [_typed(r.fields) for r in recs]


def _reference(source, kind, path) -> list:
    fn, entry, code = KINDS[kind]
    if source == "jax_native":
        if entry == "seq":
            return [_typed(r) for r in jax_native.parse_seqfile(path,
                                                                bool(code))]
        return [_typed(r.fields)
                for r in jax_native.parse_ovlfile(path, code)]
    mod = jax_parsers if source == "jax_py" else parsers
    recs = list(getattr(mod, f"_parse_{fn}_py")(path))
    if entry == "seq":
        return [_typed((r.name, r.data, r.quality)) for r in recs]
    return [_typed(r.fields) for r in recs]


@pytest.mark.parametrize("source", ["jax_native", "jax_py", "port_py"])
@pytest.mark.parametrize("name", INPUTS)
def test_native_records_equal_reference(files, name, source):
    kind, path = files[name]
    got = _port_native(kind, path)
    want = _reference(source, kind, path)
    assert len(got) > 0
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, (name, source, k)


def test_inputs_hold_the_edge_cases(files):
    """The inputs above hold what each edge case needs."""
    sam = pathlib.Path(files["sam"][1]).read_bytes()
    assert sam.startswith(b"@HD") and b"\t16\t" in sam and b"\t0\t" in sam
    paf = parsers.parse_paf(files["paf"][1])
    assert {r.fields[4] for r in paf} == {"+", "-", ""}
    mhap = parsers.parse_mhap(files["mhap"][1])
    assert all(isinstance(r.fields[2], float) for r in mhap)
    assert len({r.fields[2] for r in mhap}) > 3
    multi = parsers.parse_fastq(files["multiline_fastq"][1])
    assert multi[1].quality == b"!" * len(multi[1].data)
    assert all(b" " not in r.name for r in multi)
    # the big files span three of the parser's 1 MiB chunks, and a header
    # line of the big FASTQ runs across each edge between them
    big = pathlib.Path(files["big_fastq"][1]).read_bytes()
    assert len(big) > 2 * CHUNK
    for edge in (CHUNK, 2 * CHUNK):
        head = big.rindex(b"\n@", 0, edge - 1) + 1
        assert big.index(b"\n", head) > edge
    assert pathlib.Path(files["big_paf"][1]).stat().st_size > 2 * CHUNK


MALFORMED = {
    "fastq_header": ("fastq", b"@r1\nACGT\n+\nIIII\nr2\nACGT\n+\nIIII\n",
                     "malformed FASTQ header in {path}"),
    "fastq_truncated": ("fastq", b"@r1 x\nACGTAC\n+\nIII\n",
                        "truncated FASTQ record for r1"),
    "fastq_mismatch": ("fastq", b"@r1\nACGT\n+\nIII\nII\n",
                       "FASTQ quality/sequence length mismatch for r1"),
    "paf_short": ("paf", b"q\t10\t0\t10\t+\tt\t20\t0\t10\t9\t10\t60\n"
                  b"q\t10\t0\t10\t+\tt\t20\n",
                  "malformed line 2 in {path}"),
    "paf_not_a_number": ("paf", b"q\t1x\t0\t10\t+\tt\t20\t0\t10\n",
                         "malformed line 1 in {path}"),
    "mhap_short": ("mhap", b"1 2 0.1 5 0 0 10 10 0 0 10\n",
                   "malformed line 1 in {path}"),
    "sam_short": ("sam", b"@HD\tVN:1.6\nq\t0\tt\t1\t60\n",
                  "malformed line 1 in {path}"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_input_raises_the_jax_native_message(tmp_path, case):
    kind, blob, msg = MALFORMED[case]
    path = tmp_path / f"bad.{kind}"
    path.write_bytes(blob)
    msg = msg.format(path=path)
    fn, entry, code = KINDS[kind]
    with pytest.raises(parsers.ParseError) as got:
        getattr(parsers, f"parse_{fn}")(str(path))
    assert got.value.msg == msg and got.value.path == str(path)
    with pytest.raises(ValueError) as want:
        if entry == "seq":
            jax_native.parse_seqfile(str(path), bool(code))
        else:
            jax_native.parse_ovlfile(str(path), code)
    assert str(want.value) == msg


def test_failed_native_build_raises_without_fallback(files, monkeypatch):
    def broken(force=False):
        raise native.NativeBuildError("native build failed: forced")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    kind, path = files["reads_fastq"]
    calls = dict(native.PARSE_CALLS)
    with pytest.raises(native.NativeBuildError, match="forced"):
        parsers.parse_fastq(path)
    with pytest.raises(native.NativeBuildError, match="forced"):
        parsers.parse_paf(files["paf"][1])
    assert native.PARSE_CALLS == calls


def test_parse_calls_count_each_file(files, tmp_path):
    native.reset_parse_calls()
    parsers.parse_fasta(files["draft_fasta"][1])
    parsers.parse_fastq(files["reads_fastq.gz"][1])
    parsers.parse_sam(files["sam"][1])
    assert native.PARSE_CALLS == {"seqfile": 2, "ovlfile": 1}
    list(parsers._parse_fastq_py(files["reads_fastq"][1]))
    bad_fastq = tmp_path / "bad.fastq"
    bad_fastq.write_bytes(b"@r\nACGT\n+\n!!\n")
    bad_paf = tmp_path / "bad.paf"
    bad_paf.write_bytes(b"q\t10\t0\n")
    with pytest.raises(parsers.ParseError):
        parsers.parse_fastq(str(bad_fastq))
    with pytest.raises(parsers.ParseError):
        parsers.parse_paf(str(bad_paf))
    assert native.PARSE_CALLS == {"seqfile": 2, "ovlfile": 1}
