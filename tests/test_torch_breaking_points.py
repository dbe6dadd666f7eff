"""The port's device breaking points against the JAX package's, on the CPU.

- ``racon_tpu_torch.ops.nw.breaking_points`` (one ``scatter_reduce_`` per
  table) == ``racon_tpu.ops.nw._breaking_points_kernel`` (NW masked
  reduces) on seeded random packed op streams: walks with code 3 both
  interleaved (as the Pallas walk leaves it) and trailing, walks cut short,
  a walk with no match, arbitrary codes, spans inside one window (``nb =
  1``, ``first_rel = m - 1``), at window lengths 100, 500 and 1000. The
  tables must be exactly equal.
- ``CudaAligner.breaking_points_batch`` rows == ``TpuAligner.
  breaking_points_batch`` rows on the same pairs (both on their default
  ragged stream and band ladder; the JAX engine without a mesh).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from racon_tpu.core.backends import NativeAligner as JaxNativeAligner
from racon_tpu.ops.nw import TpuAligner, _breaking_points_kernel
from racon_tpu_torch.core.backends import NativeAligner
from racon_tpu_torch.ops import cuda_nw
from racon_tpu_torch.ops.nw import CudaAligner, breaking_points

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The plain kernels run thousands of small ops; two intra-op threads
    are as fast as eight alone and keep parallel test workers from
    oversubscribing the cores (eight threads each slowed one polisher run
    about twenty-fold)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _walk(rng, n, m, kind):
    """A backward walk's op codes from (n, m): ``clean`` ends at (0, 0),
    ``gaps`` interleaves code 3 after some steps, ``cut`` stops early (an
    escape), ``nomatch`` has no M step, ``any`` is arbitrary codes."""
    if kind == "any":
        return list(rng.integers(0, 4, int(rng.integers(0, n + m + 1))))
    ops, i, j = [], n, m
    while i > 0 or j > 0:
        if kind == "nomatch":
            op = 1 if i > 0 else 2
        elif i == 0:
            op = 2
        elif j == 0:
            op = 1
        else:
            op = int(rng.choice(3, p=(0.8, 0.1, 0.1)))
        ops.append(op)
        i -= op in (0, 1)
        j -= op in (0, 2)
        if kind == "gaps" and rng.random() < 0.1:
            ops.append(3)
    if kind == "cut":
        ops = ops[:int(rng.integers(0, len(ops) + 1))]
    return ops


KINDS = ("clean", "gaps", "cut", "nomatch", "any", "clean", "clean")


def _streams(seed, B, max_len, w):
    """Packed op streams ``[B, S/4]`` with ``S = 2 * max_len``, their (n,
    m) and the per-pair boundary geometry (first_rel, nb) as the aligner
    derives it from a target start; every fourth pair's span lies inside
    one window (nb = 1, first_rel = m - 1)."""
    rng = np.random.default_rng(seed)
    S = 2 * max_len
    ops = np.full((B, S), 3, np.uint8)
    n = rng.integers(1, max_len + 1, B).astype(np.int32)
    m = rng.integers(1, max_len + 1, B).astype(np.int32)
    tb = rng.integers(0, 5 * w, B)
    for b in range(B):
        if b % 4 == 3:
            m[b] = int(rng.integers(1, w // 2))
            tb[b] = int(rng.integers(0, w - m[b])) + 3 * w
        path = _walk(rng, int(n[b]), int(m[b]), KINDS[b % len(KINDS)])
        ops[b, :min(len(path), S)] = path[:S]
    te = tb + m
    n_reg = (te - 1) // w - tb // w
    nb = (n_reg + 1).astype(np.int32)
    first_rel = np.where(n_reg != 0, (tb // w + 1) * w - 1 - tb,
                         m - 1).astype(np.int32)
    packed = cuda_nw.pack_ops(torch.from_numpy(ops)).numpy()
    return packed, n, m, first_rel, nb


@pytest.mark.parametrize("w", [100, 500, 1000])
def test_breaking_points_matches_jax(w):
    max_len = 2048
    NW = max_len // w + 2
    packed, n, m, first_rel, nb = _streams(w, 28, max_len, w)
    assert (nb == 1).any() and (nb > 1).any()
    want = _breaking_points_kernel(
        jnp.asarray(packed), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(first_rel), jnp.asarray(nb), w=w, NW=NW)
    got = breaking_points(*(torch.from_numpy(a) for a in
                            (packed, n, m, first_rel, nb)), w=w, NW=NW)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (28, NW)
        assert np.array_equal(g.numpy(), np.asarray(x))
    first = got[0].numpy()
    # the no-match walk has no first match in any interval
    assert (first[KINDS.index("nomatch")] == 1 << 30).all()
    assert (first < 1 << 30).any()


def _pairs(seed, count=40):
    """Pairs of 100-1100 bp at 3-15% error (every seventh at 45%, which
    escapes its seeded band), one pair longer than any test bucket (host
    fallback), one empty pair; overlap-filter error estimates; metas."""
    rng = np.random.default_rng(seed)
    pairs, errors = [], []
    for k in range(count):
        t = BASES[rng.integers(0, 4, int(rng.integers(100, 1100)))]
        q = t.copy()
        flips = rng.random(len(q)) < (0.45 if k % 7 == 0 else 0.03 + k % 4
                                      * 0.04)
        q[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        q = np.delete(q, rng.integers(0, len(q), max(1, len(q) // 80)))
        pairs.append((q.tobytes(), t.tobytes()))
        errors.append(1.0 - min(len(q), len(t)) / max(len(q), len(t)))
    pairs.append((BASES[rng.integers(0, 4, 1500)].tobytes(),
                  BASES[rng.integers(0, 4, 1500)].tobytes()))
    errors.append(0.0)
    pairs.append((b"", b"ACGT"))
    errors.append(0.0)
    metas = [(int(rng.integers(0, 2000)), int(rng.integers(0, 500)))
             for _ in pairs]
    return pairs, metas, errors


@pytest.mark.parametrize("w", [100, 500])
def test_breaking_points_batch_matches_tpu_aligner(w):
    buckets = ((256, 128), (1024, 384))
    pairs, metas, errors = _pairs(11 + w)
    ref = TpuAligner(fallback=JaxNativeAligner(2), buckets=buckets,
                     mesh=None)
    want = ref.breaking_points_batch(pairs, metas, w, errors=errors)
    port = CudaAligner(fallback=NativeAligner(2), buckets=buckets,
                       device="cpu")
    got = port.breaking_points_batch(pairs, metas, w, errors=errors)
    assert len(got) == len(want) == len(pairs)
    for g, x in zip(got, want):
        assert g.dtype == np.int32 and g.shape[1:] == (4,)
        assert np.array_equal(g, x)
    for key in ("device", "fallback_length", "fallback_band",
                "band_escalated", "ladder_narrow", "chunks"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["ladder_narrow"] > 0
    assert port.stats["fallback_length"] >= 1
    assert sum(len(g) > 0 for g in got) >= len(pairs) - 5
