"""The port's minimizer seeding (``racon_tpu_torch/ops/overlap_seed.py``)
against the JAX package's (``racon_tpu/ops/overlap_seed.py``), on the CPU.

- ``minimizer_scan`` against the JAX ``_minimizer_kernel`` on the same
  code batch: hashes, strands and the selection mask, at (k, w, L) of
  (15, 5, 256), (16, 10, 512) and (4, 1, 64), on random codes with
  ambiguous bases, palindromic k-mers (even k), short rows and rows that
  own fewer windows than they hold;
- ``build_seed_table`` against JAX's, array for array, with ``SEED_SLICE``
  shrunk in both modules so that long sequences are cut into overlapping
  spans, and sequences too short for one window;
- ``minimizers_np`` against JAX's, and against ``build_seed_table``;
- the target-table cache: a hit returns the same arrays and counts
  ``cache_hits``.
"""

import numpy as np
import pytest
import torch

from racon_tpu.ops import overlap_seed as jax_seed
from racon_tpu_torch.ops import chain as port_chain
from racon_tpu_torch.ops import overlap_seed as port_seed

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _rand_seq(rng, n, n_ambiguous=0):
    s = bytearray(rng.choice(_ACGT, size=n).tobytes())
    for j in rng.integers(0, n, n_ambiguous):
        s[int(j)] = ord("N")
    return bytes(s)


def _code_batch(rng, B, L, k):
    """Codes 0..3 with ambiguous bases (4), palindromic k-mers written in
    for even k (a k-mer equal to its reverse complement), rows shorter
    than L, and window counts below the row's own."""
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.01] = 4
    if k % 2 == 0:
        for b in range(B):
            for at in rng.integers(0, L - k, 4):
                half = rng.integers(0, 4, k // 2).astype(np.uint8)
                codes[b, at:at + k] = np.concatenate([half,
                                                      3 - half[::-1]])
    lens = rng.integers(k, L + 1, B).astype(np.int32)
    lens[0] = L
    nwin = np.maximum(lens - k + 1, 0).astype(np.int32)
    nwin[1::3] //= 2
    for b in range(B):
        codes[b, lens[b]:] = 4
    return codes, lens, nwin


@pytest.mark.parametrize("k,w,L", [(15, 5, 256), (16, 10, 512),
                                   (4, 1, 64)])
def test_minimizer_scan_matches_jax_kernel(k, w, L):
    rng = np.random.default_rng(k * 1000 + L)
    codes, lens, nwin = _code_batch(rng, 8, L, k)
    wh, ws, wsel = (np.asarray(x) for x in jax_seed._minimizer_kernel(
        codes, lens, nwin, k=k, w=w, L=L))
    h, strand, sel = port_seed.minimizer_scan(
        torch.from_numpy(codes), torch.from_numpy(lens),
        torch.from_numpy(nwin), k=k, w=w)
    assert h.dtype == torch.int64
    assert np.array_equal(h.numpy(), wh.astype(np.int64))
    assert np.array_equal(strand.numpy(), ws)
    assert np.array_equal(sel.numpy(), wsel)
    # the batch exercised the cases it was built for
    assert (wh == np.uint32(jax_seed._HASH_MAX)).any() and wsel.any()
    assert (wh >= np.uint32(1 << 31)).any() and ws.any() and (~ws).any()


def _tables_equal(got, want):
    assert len(got) == len(want) == 4
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        assert np.array_equal(g, x)


def test_build_seed_table_matches_jax_with_small_slices(monkeypatch):
    rng = np.random.default_rng(7)
    seqs = [_rand_seq(rng, 1500, 5), _rand_seq(rng, 10),
            _rand_seq(rng, 700), _rand_seq(rng, 19),
            _rand_seq(rng, 3000, 20)]
    monkeypatch.setattr(jax_seed, "SEED_SLICE", 300)
    monkeypatch.setattr(port_seed, "SEED_SLICE", 300)
    want = jax_seed.build_seed_table(seqs, k=15, w=5)
    got = port_seed.build_seed_table(seqs, k=15, w=5, device="cpu")
    _tables_equal(got, want)
    assert got[0].dtype == np.uint32 and got[0].size > 300
    # the spans' table equals the whole-sequence scan
    monkeypatch.setattr(port_seed, "SEED_SLICE", 1 << 17)
    _tables_equal(port_seed.build_seed_table(seqs, device="cpu"), got)


@pytest.mark.parametrize("k,w", [(15, 5), (8, 7), (4, 1)])
def test_minimizers_np_matches_jax_and_the_table(k, w):
    rng = np.random.default_rng(k + w)
    seq = _rand_seq(rng, 900, 9)
    want = jax_seed.minimizers_np(seq, k, w)
    assert port_seed.minimizers_np(seq, k, w) == want
    h, sid, pos, strand = port_seed.build_seed_table([seq], k=k, w=w,
                                                     device="cpu")
    assert list(zip(h.tolist(), pos.tolist(),
                    strand.astype(int).tolist())) == want
    assert (sid == 0).all()


def test_table_cache_hit_returns_the_same_arrays():
    rng = np.random.default_rng(9)
    seqs = [_rand_seq(rng, 2000)]
    port_seed.clear_table_cache()
    port_chain.reset_stats()
    first = port_seed.build_seed_table(seqs, cache=True, device="cpu")
    assert port_chain.STATS["cache_hits"] == 0
    again = port_seed.build_seed_table(seqs, cache=True, device="cpu")
    assert again is first
    assert port_chain.STATS["cache_hits"] == 1
    # another (k, w) or another sequence set misses
    port_seed.build_seed_table(seqs, k=13, cache=True, device="cpu")
    port_seed.build_seed_table(seqs + [b"ACGT" * 10], cache=True,
                               device="cpu")
    assert port_chain.STATS["cache_hits"] == 1
    _tables_equal(first, jax_seed.build_seed_table(seqs))
