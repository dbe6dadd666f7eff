"""Vectorized ONT-like read/assembly simulator (copy of
``tools/simulate.py``, so ``chip_smoke.py`` imports nothing outside the
port).

Generates, for a random truth genome: a draft assembly (the polishing
target, mutated from truth like a raw-read-consensus layout), a read set
at a given coverage with independent errors, and the true PAF overlap of
every read against the draft — the full input triple the reference's CI
golden pipeline consumes (reads + overlaps + contigs), at arbitrary
scale.

Error injection is fully vectorized (np.repeat over per-base copy counts
for indels + one flat substitution mask), so generating a 300 Mbp read
set takes seconds, not the minutes a per-read loop costs. Coordinates of
each read's span are mapped through the draft's indel profile
(cumulative copy-count sums), so PAF target coordinates are exact in
draft space.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutate(seq, rng, del_p, ins_p, sub_p):
    """Apply indels via copy counts + substitutions; returns (mutated,
    copy_counts) where ``counts[i]`` is how many output bases truth base
    ``i`` produced (0 = deleted, 2 = insertion after)."""
    r = rng.random(len(seq))
    counts = np.ones(len(seq), np.int64)
    counts[r < del_p] = 0
    counts[(r >= del_p) & (r < del_p + ins_p)] = 2
    out = np.repeat(seq, counts)
    sub = rng.random(len(out)) < sub_p
    out[sub] = BASES[rng.integers(0, 4, int(sub.sum()))]
    return out, counts


_COMP = np.zeros(256, np.uint8)
_COMP[ord("A")] = ord("T")
_COMP[ord("T")] = ord("A")
_COMP[ord("C")] = ord("G")
_COMP[ord("G")] = ord("C")


def _revcomp(arr):
    return _COMP[arr[::-1]]


def simulate(mbp: float, seed: int = 23, coverage: int = 30,
             mean_read: int = 7000, max_read: int = 8000,
             min_read: int = 2000, n_contigs: int = 0):
    """Returns (reads_fastq_bytes, paf_bytes, contigs_fasta_bytes,
    truths) for a ``mbp``-megabase genome. ``truths`` is the list of
    truth contig byte strings (for post-polish quality checks)."""
    rng = np.random.default_rng(seed)
    total = int(mbp * 1e6)
    if not n_contigs:
        n_contigs = max(1, total // 2_000_000)
    sizes = [total // n_contigs] * n_contigs
    sizes[-1] += total - sum(sizes)

    fastq_parts = []
    paf_lines = []
    fasta_parts = []
    truths = []
    read_id = 0
    for ci, size in enumerate(sizes):
        truth = BASES[rng.integers(0, 4, size)]
        truths.append(truth.tobytes())
        tname = f"contig_{ci}".encode()

        # draft assembly: raw-read-layout error profile (~10%)
        draft, counts = _mutate(truth, rng, 0.02, 0.02, 0.06)
        # truth position -> draft position (exclusive prefix sum)
        t2d = np.concatenate(([0], np.cumsum(counts)))
        fasta_parts.append(b">" + tname + b"\n" + draft.tobytes() + b"\n")

        # reads: sample spans over truth, then inject independent errors
        n_reads = max(1, int(size * coverage) // mean_read)
        lens = np.clip(rng.normal(mean_read, 1500, n_reads).astype(np.int64),
                       min_read, min(max_read, size))
        starts = rng.integers(0, np.maximum(1, size - lens))
        order = np.argsort(starts)  # deterministic, irrelevant to output
        lens, starts = lens[order], starts[order]
        seg_bounds = np.concatenate(([0], np.cumsum(lens)))
        cat = np.empty(seg_bounds[-1], np.uint8)
        for k in range(n_reads):
            cat[seg_bounds[k]:seg_bounds[k + 1]] = \
                truth[starts[k]:starts[k] + lens[k]]
        mut, mcounts = _mutate(cat, rng, 0.03, 0.03, 0.06)
        out_lens = np.add.reduceat(mcounts, seg_bounds[:-1])
        out_bounds = np.concatenate(([0], np.cumsum(out_lens)))
        strands = rng.random(n_reads) < 0.5

        dlen = len(draft)
        for k in range(n_reads):
            rb = mut[out_bounds[k]:out_bounds[k + 1]]
            if strands[k]:
                rb = _revcomp(rb)
            name = f"read_{read_id}".encode()
            read_id += 1
            qual = b"9" * len(rb)
            fastq_parts.append(b"@" + name + b"\n" + rb.tobytes()
                               + b"\n+\n" + qual + b"\n")
            tb = int(t2d[starts[k]])
            te = int(t2d[starts[k] + lens[k]])
            te = max(te, tb + 1)
            paf_lines.append(b"\t".join([
                name, str(len(rb)).encode(), b"0", str(len(rb)).encode(),
                b"-" if strands[k] else b"+",
                tname, str(dlen).encode(), str(tb).encode(),
                str(min(te, dlen)).encode(),
                str(min(len(rb), te - tb)).encode(),
                str(max(len(rb), te - tb)).encode(), b"255"]) + b"\n")

    return (b"".join(fastq_parts), b"".join(paf_lines),
            b"".join(fasta_parts), truths)


def write_inputs(mbp: float, out_dir: str, seed: int = 23,
                 coverage: int = 30, n_contigs: int = 0) -> dict:
    """Generate and write the input triple (+ truth contigs) to
    ``out_dir``; ``n_contigs`` cuts the genome into that many contigs
    (default: one per 2 Mbp). Exists as a CLI so benches can generate big workloads in
    a THROWAWAY subprocess: a 100 Mbp set materializes several GB of read
    bytes, and generating in-process would bake that into the parent's
    peak RSS — exactly the number the shard-runner bench budgets."""
    import os

    reads, paf, contigs, truths = simulate(mbp, seed=seed,
                                           coverage=coverage,
                                           n_contigs=n_contigs)
    os.makedirs(out_dir, exist_ok=True)
    paths = {"reads": os.path.join(out_dir, "reads.fastq"),
             "overlaps": os.path.join(out_dir, "ovl.paf"),
             "draft": os.path.join(out_dir, "draft.fasta"),
             "truth": os.path.join(out_dir, "truth.fasta")}
    truth_fa = b"".join(b">contig_%d\n%s\n" % (i, t)
                        for i, t in enumerate(truths))
    for key, blob in (("reads", reads), ("overlaps", paf),
                      ("draft", contigs), ("truth", truth_fa)):
        with open(paths[key], "wb") as f:
            f.write(blob)
    return paths


def adversarial_chain_arena(rng, S, B):
    """Lanes that probe the DP's edges: ``ns`` cycling through 0, 1, 15,
    16, 17 and S (a dead lane's slot 0 holds non-zero pad coordinates, as
    the kernel and the plain version both report them); successors at
    exactly ``MAX_GAP`` and ``BAND_DIAG`` from a predecessor and one past;
    runs of equal-scoring predecessors (a square lattice of seeds, so
    several predecessors give one candidate score) and chains of equal
    score (the lowest end slot wins). ``ts``, ``qs`` int32 ``[B, S]`` (each
    lane's seeds sorted by (t, q)) and ``ns`` int32 ``[B]``: the inputs of
    ``ops.chain.chain_dp``, whose CPU tests, card tests and smoke run all
    use this arena."""
    from ..ops import chain as port_chain
    mg, bd = port_chain.MAX_GAP, port_chain.BAND_DIAG
    counts = (0, 1, 15, 16, 17, S)
    ts = rng.integers(0, 50, (B, S)).astype(np.int32)
    qs = rng.integers(0, 50, (B, S)).astype(np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = min(S, counts[b % len(counts)])
        kind = (b // len(counts)) % 5
        if kind == 0:      # the gap limits: steps at, and one past, them
            dt = rng.choice([mg, mg + 1, 100, bd + 100], n)
            dq = dt + rng.choice([0, bd, bd + 1, -bd, -bd - 1], n)
            dq = np.maximum(dq, 1)
        elif kind == 1:    # ties: a lattice of equal steps
            dt = np.full(n, 20)
            dq = np.where(np.arange(n) % 2 == 0, 20, 0)
        elif kind == 2:    # equal-score chains ending apart
            dt = np.where(np.arange(n) % 4 == 3, 3 * mg, 30)
            dq = dt.copy()
        elif kind == 3:    # a chain among off-diagonal noise seeds: the
            # best predecessor lies several slots back
            dt = rng.integers(0, 60, n)
            noise = rng.random(n) < 0.6
            dq = np.where(noise, 0, dt)
            q_off = np.where(noise, rng.choice([-1, 1], n)
                             * rng.integers(2 * bd, 5 * bd, n), 0)
        else:
            dt = rng.integers(0, 400, n)
            dq = dt + rng.integers(-30, 30, n)
        t = np.cumsum(dt).astype(np.int64)
        q = np.cumsum(dq).astype(np.int64)
        if kind == 3:
            q = q + q_off + 5 * bd
        q = np.maximum(q, 0)
        order = np.lexsort((q, t))
        ts[b, :n] = t[order]
        qs[b, :n] = q[order]
        ns[b] = n
    # two predecessors give C one candidate score: the nearer (slot 1) wins
    ts[B - 1, :3], qs[B - 1, :3], ns[B - 1] = (0, 10, 100), (10, 0, 100), 3
    return ts, qs, ns


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="write a simulated assembly input triple "
                    "(reads.fastq, ovl.paf, draft.fasta, truth.fasta)")
    ap.add_argument("mbp", type=float)
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--coverage", type=int, default=30)
    a = ap.parse_args()
    write_inputs(a.mbp, a.out_dir, seed=a.seed, coverage=a.coverage)
