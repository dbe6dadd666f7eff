"""The resident align->layers dataflow's device functions and align stream
(``RACON_TPU_RESIDENT``) against the JAX package's, on the CPU.

- ``derive_layer_rows`` == JAX ``_derive_layer_rows`` bit for bit on
  seeded tables: dead lanes, lanes without qualities, query spans shorter
  than the bucket, empty intervals, the sentinel, and ``q_need`` 0, 7,
  3 * 2^17 and 2^20 - 1 with spans long enough that ``q_need * span`` wraps
  in int32 (the JAX function's arithmetic, which the port keeps);
- ``finalize_layer_table`` == JAX ``finalize_layer_table`` with tied
  window ids, sentinels and host rows;
- one resident ``bp_stream`` against the same pairs without it: every
  ``_DevBp.decode_host()`` equals the host rows, a host-fallback pair's
  rows are plain rows, and the ``dataflow.*`` counters equal the JAX
  resident stream's.

The polisher-level parity (resident against host bytes, the bail-outs,
the JAX resident polish) is in ``test_torch_resident_polish.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.core.backends import NativeAligner as JaxNativeAligner
from racon_tpu.obs import metrics as jax_metrics
from racon_tpu.ops import nw as jax_nw
from racon_tpu_torch.core.backends import NativeAligner
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.ops import nw as port_nw
from tests.test_torch_align_stream import _mixed_pairs

BIG = 1 << 30


@pytest.fixture(autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _derive_inputs(rng, B, NW, Lq, w):
    """Per-lane tables like ``breaking_points``' (span-relative ``tpos <<
    14 | qpos``, monotone along a lane, ``bp_last`` a running max, empty
    intervals BIG in ``bp_first``), query spans of short, mid and
    near-whole-bucket lengths, and the per-lane values of a chunk."""
    bp_first = np.full((B, NW), BIG, np.int32)
    bp_last = np.full((B, NW), -1, np.int32)
    qlen = np.where(rng.random(B) < 0.3, rng.integers(Lq // 2, Lq, B),
                    Lq).astype(np.int32)
    for b in range(B):
        t = int(rng.integers(0, w))
        q = 0
        last = -1
        for k in range(NW):
            if rng.random() < 0.15 or q >= Lq - 2:
                bp_last[b, k] = last           # an interval with no match
                continue
            kind = rng.random()
            if kind < 0.4:
                span = int(rng.integers(0, 4))  # brackets s_min
            elif kind < 0.8:
                span = int(rng.integers(4, 600))
            else:
                span = Lq                       # the rest of the bucket
            q_last = min(q + max(span - 1, 0), Lq - 2)
            t_last = min(t + int(rng.integers(1, 2 * w)), 16383)
            bp_first[b, k] = (t << 14) | q
            last = (t_last << 14) | q_last
            bp_last[b, k] = last
            t = min(t_last + 1, 16383)
            q = q_last + int(rng.integers(0, 2))
    pool_len = B * Lq
    # weight << 3 | code, weights around 7 so the q_need = 7 compare
    # lands on both sides and on exact equality
    qpw = ((rng.integers(4, 11, pool_len).astype(np.uint16) << 3)
           | rng.integers(0, 5, pool_len).astype(np.uint16))
    lanes = dict(
        live=rng.random(B) < 0.85,
        tb=rng.integers(0, 100000, B).astype(np.int32),
        qo_read=rng.integers(0, 500, B).astype(np.int32),
        qo_pool=(np.arange(B) * Lq).astype(np.int32),
        n_reg=rng.integers(0, NW, B).astype(np.int32),
        win_base=rng.integers(0, 5000, B).astype(np.int32),
        ov_idx=rng.permutation(B).astype(np.int32),
        has_q=rng.random(B) < 0.7, qlen=qlen)
    return bp_first, bp_last, qpw, lanes


LANE_ORDER = ("live", "tb", "qo_read", "qo_pool", "n_reg", "win_base",
              "ov_idx", "has_q", "qlen")


@pytest.mark.parametrize("q_need,Lq", [(0, 256), (7, 256),
                                       (3 << 17, 16384),
                                       ((1 << 20) - 1, 4096)])
def test_derive_layer_rows_matches_jax(q_need, Lq):
    rng = np.random.default_rng(q_need + Lq)
    B, w = 16, 100
    NW = Lq // w + 2
    s_min = int(np.ceil(0.02 * w))
    fp, lp, qpw, lanes = _derive_inputs(rng, B, NW, Lq, w)
    want = np.asarray(jax_nw._derive_layer_rows(
        jnp.asarray(fp), jnp.asarray(lp), jnp.asarray(qpw),
        *[jnp.asarray(lanes[k]) for k in LANE_ORDER],
        np.int32(s_min), np.int32(q_need), w=w, NW=NW, Lq=Lq))
    pool = port_nw.upload_qpw_pool(qpw, "cpu")
    got = port_nw.derive_layer_rows(
        torch.from_numpy(fp), torch.from_numpy(lp), pool,
        *[torch.from_numpy(lanes[k]) for k in LANE_ORDER],
        s_min, q_need, w=w, NW=NW, Lq=Lq)
    assert got.dtype == torch.int32 and got.shape == (B * NW, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    kept = want[:, 0] != port_nw._ROW_SENTINEL
    assert kept.any() and (~kept).any()
    # the chunk wrapper: one upload of the lane arrays, the same rows
    chunk = port_nw._DevChunkBp(torch.from_numpy(fp), torch.from_numpy(lp),
                                w, Lq)
    np.testing.assert_array_equal(chunk.derive(
        pool, *[lanes[k] for k in LANE_ORDER], s_min, q_need).numpy(), want)
    if q_need >= 1 << 17:
        # the exercised case: live rows whose q_need * span exceeds int32
        span = ((lp & 0x3FFF) + 1 - (fp & 0x3FFF)).astype(np.int64)
        live = (lanes["live"][:, None] & lanes["has_q"][:, None]
                & (fp < BIG)
                & (np.arange(NW)[None, :] <= lanes["n_reg"][:, None]))
        assert (live & (span * q_need >= 1 << 31)).any()


def test_finalize_layer_table_matches_jax():
    rng = np.random.default_rng(3)
    blocks = []
    for n in (48, 80, 16):
        b = rng.integers(0, 1000, (n, 6)).astype(np.int32)
        # few window ids: ties the stable sort must keep in gather order
        b[:, 0] = rng.integers(0, 6, n)
        b[rng.random(n) < 0.3, 0] = port_nw._ROW_SENTINEL
        blocks.append(b)
    host = rng.integers(0, 1000, (20, 6)).astype(np.int32)
    host[:, 0] = rng.integers(0, 6, 20)
    total = sum(len(b) for b in blocks) + len(host)
    src = rng.permutation(total)[:total - 30]
    want = jax_nw.finalize_layer_table([jnp.asarray(b) for b in blocks],
                                       host, src)
    got = port_nw.finalize_layer_table([torch.from_numpy(b) for b in blocks],
                                       host, src)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:-1, 0] <= got[1:, 0]).all()


def _stream(aligner, pairs, metas, errors, w, resident):
    sess = aligner.bp_stream(w, total=len(pairs), resident=resident)
    for k in range(0, len(pairs), 20):
        sess.feed(pairs[k:k + 20], metas[k:k + 20], errors[k:k + 20])
    return sess.finish()


def test_resident_stream_handles_and_counters_match():
    rng = np.random.default_rng(11)
    pairs, metas, errors = _mixed_pairs(rng, n=24)
    # a span asymmetry no bucket's band admits: a host-fallback pair
    t = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)])
    pairs.append((t[:50], t))
    metas.append((40, 0))
    errors.append(0.99)
    w = 100
    metrics.clear_run()
    host = _stream(port_nw.CudaAligner(fallback=NativeAligner(2),
                                       device="cpu"),
                   pairs, metas, errors, w, False)
    assert metrics.dataflow_summary()["bytes_fetched"] == 0
    metrics.clear_run()
    got = _stream(port_nw.CudaAligner(fallback=NativeAligner(2),
                                      device="cpu"),
                  pairs, metas, errors, w, True)
    port_df = metrics.dataflow_summary()
    handles = [r for r in got if getattr(r, "is_device_resident", False)]
    assert 0 < len(handles) < len(pairs)
    for g, h in zip(got, host):
        if getattr(g, "is_device_resident", False):
            assert len(g) >= len(h)
            g = g.decode_host()
        np.testing.assert_array_equal(g, h)
    # one host copy of a chunk's tables, shared by its handles
    chunk = handles[0].chunk
    assert chunk.fetch() is chunk.fetch()
    assert chunk.bp_first.shape == (chunk.B, chunk.NW)

    jax_metrics.clear_run()
    jax_al = jax_nw.TpuAligner(fallback=JaxNativeAligner(2), mesh=None)
    _stream(jax_al, pairs, metas, errors, w, True)
    want = jax_metrics.dataflow_summary()
    assert port_df == want
    assert want["fallback_pairs"] > 0 and want["bytes_avoided"] > 0
