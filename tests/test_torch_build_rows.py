"""The aligner's packed uploads and its row-building functions against
the JAX package's, on the CPU.

A chunk goes to the device in the form the JAX chunk launcher picks
(``racon_tpu/ops/nw.py``): 2-bit codes where its alphabet has at most four
symbols and the int16 path may run (``swar.swar_choice``), nibbles up to 15
symbols, raw bytes otherwise. Every comparison is exact:

- ``pack_bases_2bit`` and ``pack_chunk``'s blocks equal the JAX package's
  bytes (its ``pack_bases_2bit(lut[qcat])``, its nibble pack, its dense
  block) over ACGT, ACGTN, mixed case, 20 symbols and all-'A' reads;
- each chunk of ``CudaAligner(device="cpu")`` uploads what
  ``TpuAligner(mesh=None)`` uploads for the same chunk (form and bytes,
  caught at the two packages' row-building functions), with
  ``RACON_TPU_SWAR`` on and off and with the overflow guard failing
  (``swar_guard_int32`` counted alike), and gives its CIGARs and breaking
  points;
- ``build_rows_plain`` in each form equals ``_build_rows``,
  ``_build_rows_packed`` and ``_build_rows_packed2``, on the packer's
  blocks and on blocks whose padding holds stray bytes;
- a numpy mirror of ``kernels/build_rows.cu`` (its 16-code groups, the
  2-bit and nibble spreads, the byte reversal, the zero and byte-loop
  chunks) equals ``build_rows_plain``;
- the forward pass (K1 and K4 plain), the walk and ``breaking_points``
  give the same outputs from raw, nibble and 2-bit rows of one chunk, on
  all-'A' pairs (every 2-bit code 0, the padding's code), pairs whose ends
  lie on the band's edges and pairs of length 1; so do the numpy mirrors
  of K1's warp and wide bodies and K4's wide body (the DPX body with its
  16 B character loads and ``run_mismatch``).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops import nw as jax_nw
from racon_tpu.ops import swar as jax_swar
from racon_tpu.ops.nw import TpuAligner
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.ops import cuda_nw, swar
from racon_tpu_torch.ops import nw as tnw
from racon_tpu_torch.ops.nw import CudaAligner

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fwd_lanes import warp_fwd_mirror, wide_fwd_mirror  # noqa: E402
from test_torch_fwd_packed import i16_wide_mirror  # noqa: E402

ALPHABETS = {
    "acgt": b"ACGT",
    "acgtn": b"ACGTN",
    "mixed_case": b"ACGTacgtN",
    "wide": bytes(range(ord("A"), ord("A") + 20)),
    "all_a": b"A",
}
# the forms each alphabet fits
FORMS = {name: [b for b in (2, 4, 8)
                if b == 8 or len(ALPHABETS[name]) <= (4 if b == 2 else 15)]
         for name in ALPHABETS}


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    monkeypatch.delenv("RACON_TPU_SWAR", raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pairs(alphabet, count, seed, lo=40, hi=200, err=0.1):
    """Mutated (query, target) byte pairs over ``alphabet``."""
    rng = np.random.default_rng(seed)
    sym = np.frombuffer(alphabet, np.uint8)
    out = []
    for _ in range(count):
        t = sym[rng.integers(0, len(sym), int(rng.integers(lo, hi)))]
        q = t.copy()
        flips = rng.random(len(q)) < err
        q[flips] = sym[rng.integers(0, len(sym), int(flips.sum()))]
        q = np.delete(q, rng.integers(0, len(q), 2))
        out.append((q.tobytes(), t.tobytes()))
    return out


def _dense(seqs, B, max_len):
    """The JAX launcher's dense byte block."""
    cat = np.zeros(B * max_len, np.uint8)
    for k, s in enumerate(seqs):
        cat[k * max_len:k * max_len + len(s)] = np.frombuffer(s, np.uint8)
    return cat


def _jax_blocks(qs, ts, B, max_len, bits):
    """The JAX launcher's upload blocks in form ``bits`` (its statements,
    ``racon_tpu/ops/nw.py`` chunk launcher)."""
    qcat, tcat = _dense(qs, B, max_len), _dense(ts, B, max_len)
    hist = np.bincount(qcat, minlength=256)
    hist += np.bincount(tcat, minlength=256)
    alphabet = np.flatnonzero(hist[1:]) + 1
    lut = np.zeros(256, np.uint8)
    if bits == 2:
        lut[alphabet] = np.arange(len(alphabet), dtype=np.uint8)
        return (jax_swar.pack_bases_2bit(lut[qcat]),
                jax_swar.pack_bases_2bit(lut[tcat]))
    if bits == 4:
        lut[alphabet] = np.arange(1, len(alphabet) + 1, dtype=np.uint8)
        q4, t4 = lut[qcat], lut[tcat]
        return q4[0::2] | (q4[1::2] << 4), t4[0::2] | (t4[1::2] << 4)
    return qcat, tcat


JAX_ROWS = {2: jax_nw._build_rows_packed2, 4: jax_nw._build_rows_packed,
            8: jax_nw._build_rows}


def _lens(seqs, B):
    out = np.ones(B, np.int32)
    out[:len(seqs)] = [len(s) for s in seqs]
    return out


# ------------------------------------------------------------- the packer

@pytest.mark.parametrize("length", [0, 1, 4, 7, 1001])
def test_pack_bases_2bit_matches_jax(length):
    codes = np.random.default_rng(length).integers(0, 4, length).astype(
        np.uint8)
    got = swar.pack_bases_2bit(codes)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jax_swar.pack_bases_2bit(codes))


@pytest.mark.parametrize("name", ALPHABETS)
def test_pack_chunk_blocks_match_jax(name):
    B, max_len = 8, 256
    pairs = _pairs(ALPHABETS[name], 6, seed=len(name))
    # a pair of length 1 on both sides, and one filling its slot
    pairs[1] = (pairs[1][0][:1], pairs[1][1][:1])
    pairs[2] = (pairs[2][0] * 3)[:max_len], (pairs[2][1] * 3)[:max_len]
    qs, ts = [q for q, _ in pairs], [t for _, t in pairs]
    ql, tl = _lens(qs, B)[:6], _lens(ts, B)[:6]
    for bits in FORMS[name]:
        q, t, got_bits = tnw.pack_chunk(qs, ts, ql, tl, B, max_len,
                                        swar=True, bits=bits)
        want = _jax_blocks(qs, ts, B, max_len, bits)
        assert got_bits == bits
        assert q.dtype == torch.uint8 and q.shape == (B * max_len * bits // 8,)
        assert np.array_equal(q.numpy(), want[0]), (name, bits)
        assert np.array_equal(t.numpy(), want[1]), (name, bits)
    # the form the chunk picks by itself, with the int16 path allowed and
    # not
    n_sym = len(ALPHABETS[name])
    for sw, want_bits in ((True, 2 if n_sym <= 4 else 4 if n_sym <= 15
                           else 8), (False, 4 if n_sym <= 15 else 8)):
        assert tnw.pack_chunk(qs, ts, ql, tl, B, max_len,
                              swar=sw)[2] == want_bits
    too_small = [b for b in (2, 4) if b not in FORMS[name]]
    for bits in too_small:
        with pytest.raises(ValueError, match="do not fit"):
            tnw.pack_chunk(qs, ts, ql, tl, B, max_len, swar=True, bits=bits)


class _Uploads:
    """Both packages' row-building functions, spied: each chunk's (form,
    query block, target block) in launch order."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        for bits, fn in JAX_ROWS.items():
            monkeypatch.setattr(jax_nw, fn.__name__, self._jax(bits, fn))
        port_fn = tnw.build_rows

        def port(q, t, n, m, **kw):
            self.port.append((kw["bits"], q.numpy().copy(),
                              t.numpy().copy()))
            return port_fn(q, t, n, m, **kw)
        monkeypatch.setattr(tnw, "build_rows", port)

    def _jax(self, bits, fn):
        def spy(q, t, n, m, **kw):
            self.jax.append((bits, np.asarray(q), np.asarray(t)))
            return fn(q, t, n, m, **kw)
        return spy

    def assert_equal(self):
        assert len(self.port) == len(self.jax) > 0
        for (pb, pq, pt), (jb, jq, jt) in zip(self.port, self.jax):
            assert pb == jb
            assert np.array_equal(pq, jq) and np.array_equal(pt, jt)
        return [b for b, _, _ in self.port]


def _aligners(**kw):
    return (CudaAligner(device="cpu", **kw), TpuAligner(mesh=None, **kw))


@pytest.mark.parametrize("swar_flag", ["1", "0"])
@pytest.mark.parametrize("name", ALPHABETS)
def test_engine_uploads_match_jax(monkeypatch, name, swar_flag):
    """Each chunk's upload, form and bytes, equals the JAX aligner's, and
    so do the CIGARs."""
    monkeypatch.setenv("RACON_TPU_SWAR", swar_flag)
    spies = _Uploads(monkeypatch)
    pairs = _pairs(ALPHABETS[name], 12, seed=7)
    mine, theirs = _aligners(buckets=((256, 128),), use_ladder=False)
    assert mine.align_batch(pairs) == theirs.align_batch(pairs)
    forms = spies.assert_equal()
    n_sym = len(ALPHABETS[name])
    want = (2 if n_sym <= 4 and swar_flag == "1"
            else 4 if n_sym <= 15 else 8)
    assert set(forms) == {want}
    assert mine.stats["upload_forms"][want] == mine.stats["chunks"]
    assert mine.stats["upload_bytes"][want] == sum(
        q.size + t.size for _, q, t in spies.port)
    assert mine.stats["swar_guard_int32"] == \
        theirs.stats["swar_guard_int32"] == 0


@pytest.mark.parametrize("swar_flag", ["1", "0"])
def test_swar_guard_keeps_the_nibble_form_as_jax(monkeypatch, swar_flag):
    """A bucket the int16 overflow guard turns away uploads nibbles in both
    packages, and both count it in ``swar_guard_int32`` whatever the flag
    (the port in the metric ``aligner.swar_guard_int32`` too)."""
    monkeypatch.setenv("RACON_TPU_SWAR", swar_flag)
    monkeypatch.setattr(swar, "swar_fits", lambda max_len: False)
    monkeypatch.setattr(jax_swar, "swar_fits", lambda max_len: False)
    spies = _Uploads(monkeypatch)
    pairs = _pairs(b"ACGT", 12, seed=8)
    before = metrics.counter("aligner.swar_guard_int32")
    mine, theirs = _aligners(buckets=((256, 128),), use_ladder=False)
    assert mine.align_batch(pairs) == theirs.align_batch(pairs)
    assert set(spies.assert_equal()) == {4}
    assert mine.stats["swar_guard_int32"] == \
        theirs.stats["swar_guard_int32"] == mine.stats["chunks"] > 0
    after = metrics.counter("aligner.swar_guard_int32")
    assert after - before == mine.stats["chunks"]


@pytest.mark.parametrize("name", ["acgt", "acgtn", "wide", "all_a"])
def test_breaking_points_match_tpu_aligner_in_each_form(monkeypatch, name):
    """``breaking_points_batch`` of the port equals the JAX aligner's on
    chunks of each form (ladder on: several bands)."""
    spies = _Uploads(monkeypatch)
    pairs = _pairs(ALPHABETS[name], 16, seed=9, lo=300, hi=700)
    rng = np.random.default_rng(3)
    metas = [(int(rng.integers(0, 5000)), int(rng.integers(0, 50)))
             for _ in pairs]
    mine, theirs = _aligners(buckets=((1024, 384),))
    got = mine.breaking_points_batch(pairs, metas, 100)
    want = theirs.breaking_points_batch(pairs, metas, 100)
    assert len(got) == len(want) == len(pairs)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    forms = set(spies.assert_equal())
    assert forms == {{"acgt": 2, "acgtn": 4, "wide": 8, "all_a": 2}[name]}


# ------------------------------------------------------------- the rows

def _chunk(name, B, max_len, band, seed):
    """A chunk of ``B - 1`` pairs over an alphabet (one padding slot):
    random pairs, pairs of length 1, and pairs whose length difference
    puts their ends on the band's edges (|n - m| = band/2 - 2 and - 1)."""
    pairs = _pairs(ALPHABETS[name], B - 1, seed,
                   lo=min(max(10, band // 2 + 4), max_len // 2), hi=max_len)
    pairs[0] = (pairs[0][0][:1], pairs[0][1][:1])
    pairs[1] = (pairs[1][0][:1], pairs[1][1][:5])
    for k, d in ((2, band // 2 - 2), (3, band // 2 - 1)):
        t = pairs[k][1][:max_len]
        pairs[k] = (t[:max(1, len(t) - d)], t)
    return pairs


def _blocks(pairs, B, max_len, bits):
    qs, ts = [q for q, _ in pairs], [t for _, t in pairs]
    n, m = _lens(qs, B), _lens(ts, B)
    q, t, _ = tnw.pack_chunk(qs, ts, n[:len(qs)], m[:len(ts)], B, max_len,
                             swar=True, bits=bits)
    return q, t, torch.from_numpy(n), torch.from_numpy(m)


GEOMETRIES = [(256, 128), (256, 96), (256, 64), (1024, 384)]


@pytest.mark.parametrize("max_len,band", GEOMETRIES)
@pytest.mark.parametrize("name", ["acgt", "acgtn", "wide", "all_a"])
def test_build_rows_plain_matches_jax(name, max_len, band):
    B = 8
    pairs = _chunk(name, B, max_len, band, seed=band)
    for bits in FORMS[name]:
        q, t, n, m = _blocks(pairs, B, max_len, bits)
        got = tnw.build_rows(q, t, n, m, max_len=max_len, band=band,
                             bits=bits)
        want = JAX_ROWS[bits](jnp.asarray(q.numpy()), jnp.asarray(t.numpy()),
                              jnp.asarray(n.numpy()), jnp.asarray(m.numpy()),
                              max_len=max_len, band=band)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8
            assert g.shape == (B, band // 2 + max_len + band)
            assert np.array_equal(g.numpy(), np.asarray(w)), (bits, name)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_build_rows_plain_masks_stray_padding_as_jax(bits):
    """Blocks with random bytes past every pair's length, and a pair whose
    length passes max_len (the JAX functions clip its index): the rows are
    the JAX functions' all the same."""
    B, max_len, band = 6, 128, 64
    rng = np.random.default_rng(bits)
    size = B * max_len * bits // 8
    q = rng.integers(0, 256, size).astype(np.uint8)
    t = rng.integers(0, 256, size).astype(np.uint8)
    n = rng.integers(0, max_len, B).astype(np.int32)
    m = rng.integers(0, max_len, B).astype(np.int32)
    n[0], m[1], n[2], m[2] = max_len + 20, max_len + 5, 0, 0
    got = tnw.build_rows(*(torch.from_numpy(a) for a in (q, t, n, m)),
                         max_len=max_len, band=band, bits=bits)
    want = JAX_ROWS[bits](*(jnp.asarray(a) for a in (q, t, n, m)),
                          max_len=max_len, band=band)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_build_rows_checks_its_inputs():
    q = torch.zeros(8 * 256 // 4, dtype=torch.uint8)
    n = torch.ones(8, dtype=torch.int32)
    kw = dict(max_len=256, band=128)
    with pytest.raises(ValueError, match="bits 3"):
        tnw.build_rows(q, q, n, n, bits=3, **kw)
    with pytest.raises(ValueError, match="uint8"):
        tnw.build_rows(q, q, n, n, bits=4, **kw)
    with pytest.raises(ValueError, match="whole bytes"):
        tnw.build_rows(q, q, n, n, bits=2, max_len=258, band=128)
    with pytest.raises(ValueError, match="int32"):
        tnw.build_rows(q, q, n.long(), n, bits=2, **kw)


# ---------------------------------------------- the kernel, mirrored

def _spread2(b):
    b = (b | (b << 12)) & 0x000F000F
    return (b | (b << 6)) & 0x03030303


def _spread4(h):
    h = (h | (h << 8)) & 0x00FF00FF
    return (h | (h << 4)) & 0x0F0F0F0F


def _group16(s, g, bits):
    """``group16<BITS>``: codes 16 g .. 16 g + 15 of a slot as 16 bytes."""
    if bits == 2:
        w = int.from_bytes(s[4 * g:4 * g + 4].tobytes(), "little")
        words = [_spread2((w >> (8 * j)) & 0xFF) for j in range(4)]
    elif bits == 4:
        w = int.from_bytes(s[8 * g:8 * g + 8].tobytes(), "little")
        words = [_spread4((w >> (16 * j)) & 0xFFFF) for j in range(4)]
    else:
        return s[16 * g:16 * g + 16].copy()
    return np.frombuffer(b"".join(x.to_bytes(4, "little") for x in words),
                         np.uint8)


def _reversed(v):
    """``reversed``: four ``__byte_perm(w, 0, 0x0123)`` of the words in
    reverse order."""
    words = [int.from_bytes(v[4 * j:4 * j + 4].tobytes(), "little")
             for j in range(4)]
    out = [int.from_bytes(w.to_bytes(4, "little")[::-1], "little")
           for w in words[::-1]]
    return np.frombuffer(b"".join(x.to_bytes(4, "little") for x in out),
                         np.uint8)


def _code_at(s, i, bits):
    per = 8 // bits
    return (int(s[i // per]) >> ((i % per) * bits)) & ((1 << bits) - 1)


def _row_bytes(s, row, x0, width, base, sign, length, max_len, bits):
    for x in range(x0, min(x0 + 16, width)):
        i = x - base if sign > 0 else base - x
        row[x] = (_code_at(s, min(i, max_len - 1), bits)
                  if 0 <= i < length else 0)


def build_rows_mirror(qblk, tblk, n, m, *, max_len, band, bits,
                      aligned=True, paths=None):
    """``build_rows_kernel<BITS>`` chunk by chunk: the fast flag of
    ``rt_build_rows`` (``aligned`` stands for the pointers' alignment),
    then per 16-byte chunk of each row the zero store, the group store or
    the byte loop. ``paths`` counts the chunks of each kind."""
    B = len(n)
    c = band // 2
    width = c + max_len + band
    slot = max_len * bits // 8
    fast = aligned and (c | max_len | width) % 16 == 0
    qrp = np.full((B, width), 0xEE, np.uint8)
    tp = np.full((B, width), 0xEE, np.uint8)
    paths = {} if paths is None else paths

    def count(kind):
        paths[kind] = paths.get(kind, 0) + 1

    qtop = c + max_len - 1
    for b in range(B):
        qs = qblk[b * slot:(b + 1) * slot]
        ts = tblk[b * slot:(b + 1) * slot]
        nb, mb = int(n[b]), int(m[b])
        for x0 in range(0, width, 16):
            if not fast:
                count("bytes")
                _row_bytes(qs, qrp[b], x0, width, qtop, -1, nb, max_len,
                           bits)
                _row_bytes(ts, tp[b], x0, width, c, 1, mb, max_len, bits)
                continue
            qhi = qtop - x0
            if qhi < 0 or qhi - 15 >= nb:
                count("zero")
                qrp[b, x0:x0 + 16] = 0
            elif qhi - 15 >= 0 and qhi < min(nb, max_len):
                count("group")
                assert (qhi - 15) % 16 == 0
                qrp[b, x0:x0 + 16] = _reversed(
                    _group16(qs, (qhi - 15) // 16, bits))
            else:
                count("bytes")
                _row_bytes(qs, qrp[b], x0, width, qtop, -1, nb, max_len,
                           bits)
            tlo = x0 - c
            if tlo + 15 < 0 or tlo >= mb:
                count("zero")
                tp[b, x0:x0 + 16] = 0
            elif tlo >= 0 and tlo + 15 < min(mb, max_len):
                count("group")
                assert tlo % 16 == 0
                tp[b, x0:x0 + 16] = _group16(ts, tlo // 16, bits)
            else:
                count("bytes")
                _row_bytes(ts, tp[b], x0, width, c, 1, mb, max_len, bits)
    return qrp, tp


# (max_len, band, aligned): the aligner's geometries (the fast flag set),
# one whose c is not a multiple of 16 and one whose max_len is not (the
# byte loop throughout), and unaligned pointers
MIRROR_GEOMETRIES = [(256, 128, True), (256, 96, True), (512, 64, True),
                     (256, 40, True), (100, 64, True), (256, 128, False)]


@pytest.mark.parametrize("max_len,band,aligned", MIRROR_GEOMETRIES)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_kernel_mirror_matches_plain(bits, max_len, band, aligned):
    B = 6
    pairs = _chunk("acgt", B, max_len, band, seed=max_len + band)
    q, t, n, m = _blocks(pairs, B, max_len, bits)
    # a pair past max_len (clipped indices) and a padding slot with stray
    # bytes: the kernel masks both as the plain version does
    slot = max_len * bits // 8
    q[(B - 1) * slot:] = 0x5A
    n[B - 1], m[B - 2] = max_len + 9, max_len + 16
    paths = {}
    got = build_rows_mirror(q.numpy(), t.numpy(), n.numpy(), m.numpy(),
                            max_len=max_len, band=band, bits=bits,
                            aligned=aligned, paths=paths)
    want = tnw.build_rows_plain(q, t, n, m, max_len=max_len, band=band,
                                bits=bits)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    if aligned and (band // 2) % 16 == 0 and max_len % 16 == 0:
        assert paths["zero"] and paths["group"] and paths["bytes"]
    else:
        assert set(paths) == {"bytes"}


def test_mirror_spreads_every_byte():
    """The 2-bit and nibble spreads against the shift-and-mask unpack on
    every byte value."""
    for b in range(256):
        want2 = [(b >> (2 * k)) & 3 for k in range(4)]
        assert _spread2(b).to_bytes(4, "little") == bytes(want2)
    for h in range(1 << 16):
        want4 = [(h >> (4 * k)) & 15 for k in range(4)]
        assert _spread4(h).to_bytes(4, "little") == bytes(want4)


# --------------------------------------- outputs are the same from each form

ROW_CASES = {
    # name: (alphabet, max_len, band)
    "random": ("acgt", 256, 128),
    "all_a": ("all_a", 256, 128),
    "random_wide_band": ("acgt", 1024, 384),
    "all_a_wide_band": ("all_a", 1024, 384),
}


def _outputs(rows, n, m, *, max_len, band, packed16, w=50):
    qrp, tp = rows
    steps = tnw.sweep_bound(int((n + m).max()), max_len)
    ops, score, fi, fj = tnw.align_chain(qrp, tp, n, m, max_len=max_len,
                                         band=band, steps=steps,
                                         packed16=packed16)
    B = len(n)
    first_rel = torch.full((B,), w - 1, dtype=torch.int32)
    nb = (m // w + 1).to(torch.int32)
    bp = tnw.breaking_points(ops, n, m, first_rel, nb, w=w,
                             NW=max_len // w + 2)
    return (ops, score, fi, fj) + bp


@pytest.mark.parametrize("packed16", [False, True])
@pytest.mark.parametrize("case", ROW_CASES)
def test_align_chain_same_from_each_form(case, packed16):
    """K1 or K4 (plain), the walk and ``breaking_points`` give the same
    ints from raw, nibble and 2-bit rows of one chunk."""
    name, max_len, band = ROW_CASES[case]
    B = 8
    pairs = _chunk(name, B, max_len, band, seed=11)
    outs = {}
    for bits in (2, 4, 8):
        q, t, n, m = _blocks(pairs, B, max_len, bits)
        rows = tnw.build_rows(q, t, n, m, max_len=max_len, band=band,
                              bits=bits)
        outs[bits] = _outputs(rows, n, m, max_len=max_len, band=band,
                              packed16=packed16)
    assert (outs[8][1] < cuda_nw.BIG32).any()
    for bits in (2, 4):
        for got, want in zip(outs[bits], outs[8]):
            assert torch.equal(got, want), (case, bits)


def _mirror_rows(pairs, B, max_len, band, bits):
    q, t, n, m = _blocks(pairs, B, max_len, bits)
    qrp, tp = tnw.build_rows(q, t, n, m, max_len=max_len, band=band,
                             bits=bits)
    return qrp.numpy(), tp.numpy(), n.numpy(), m.numpy()


# body -> (mirror, max_len, band, extra keywords)
MIRRORS = {
    "k1_warp": (warp_fwd_mirror, 256, 128, {}),
    "k1_wide": (wide_fwd_mirror, 768, 1024, {}),
    "k4_wide_bpt2": (i16_wide_mirror, 256, 512, {"bpt": 2}),
    "k4_wide_bpt4": (i16_wide_mirror, 768, 1024, {"bpt": 4}),
}


@pytest.mark.parametrize("name", ["acgt", "all_a"])
@pytest.mark.parametrize("body", MIRRORS)
def test_cuda_body_mirrors_same_from_each_form(body, name):
    """The numpy mirrors of the CUDA forward bodies read a character only
    at interior cells: from 2-bit rows (code 0 is both 'A' and padding),
    nibble rows and raw rows of one chunk they give the same scores, and
    the walk over their direction rows the same ops."""
    mirror, max_len, band, kw = MIRRORS[body]
    B = 6
    pairs = _chunk(name, B, max_len, band, seed=5)
    outs = {}
    for bits in (2, 4, 8):
        qrp, tp, n, m = _mirror_rows(pairs, B, max_len, band, bits)
        steps = tnw.sweep_bound(int((n + m).max()), max_len)
        dirs, score = mirror(qrp, tp, n, m, max_len=max_len, band=band,
                             steps=steps, **kw)
        nt, mt = torch.from_numpy(n), torch.from_numpy(m)
        ops, fi, fj = cuda_nw.walk_ops(torch.from_numpy(dirs), nt, mt,
                                       band=band)
        outs[bits] = (np.asarray(score), ops.numpy(), fi.numpy(),
                      fj.numpy())
    for bits in (2, 4):
        for got, want in zip(outs[bits], outs[8]):
            assert np.array_equal(got, want), (body, name, bits)
