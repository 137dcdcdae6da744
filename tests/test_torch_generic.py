"""The port's generic indexed decode and un-indexed device decode against
the JAX package and CPython zlib.

The same streams (CPython zlib output with and without full flushes, the
host model's indexed streams, a preset dictionary's) go through the JAX
``decode_tokens`` / ``resolve_global`` / ``plan_groups`` /
``inflate_raw_indexed`` (XLA programs, run on the CPU) and through the
port's counterparts (plain PyTorch versions on the CPU).  Every array is an
integer array or bytes, so every comparison is exact.  The indexes come
from the port's own ``build_index``; the JAX index is rebuilt from its
arrays.  The JAX package is the reference only: every error expected from
a port call is the port's own class.
"""
import dataclasses
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from zlibes_tpu.codec import inflate_pipeline as jip
from zlibes_tpu.ops import huffman as jhuff
from zlibes_tpu.ops import inflate_kernel as jik
from zlibes_tpu.spec import refmodel as jrm

import zlibes_tpu_torch
from zlibes_tpu_torch import CorruptError, HeaderError
from zlibes_tpu_torch.codec import inflate_pipeline as ip
from zlibes_tpu_torch.ops import inflate_kernel as ik
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.ops import wide_kernel as wk
from zlibes_tpu_torch.runtime import native
from zlibes_tpu_torch.spec import constants as C
from test_torch_contract_cases import zlib_flushed

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "golden"
RAW = (GOLDEN / "raw.bin").read_bytes()


def mixed_data() -> bytes:
    """40,000 B of text, 40,000 random bytes, 40,000 B of text: at 16 KiB
    full flushes zlib stores the random middle block (output 49,152-65,536)
    between dynamic blocks."""
    rnd = np.random.default_rng(0).integers(0, 256, 40000, np.uint8)
    return RAW[:40000] + rnd.tobytes() + RAW[40000:80000]


def jax_index(index):
    """The JAX package's StreamIndex with the port's index's fields."""
    return jrm.StreamIndex(
        [jrm.BlockInfo(b.btype, b.bfinal, b.start_bit, b.payload_start_bit,
                       b.end_bit, b.out_start, b.out_len)
         for b in index.blocks],
        np.asarray(index.anchor_bit), np.asarray(index.anchor_out),
        np.asarray(index.anchor_block), index.self_contained,
        index.chunk_reset, index.turbo, index.max_tokens, index.wide)


def scan_index(comp: bytes, anchor_every: int, zdict: bytes = b""):
    """``build_index`` of a stream, at the FDICT body offset for a stream
    with a preset dictionary."""
    if not zdict:
        return zlibes_tpu_torch.build_index(comp, anchor_every=anchor_every)
    _, _, index, _, _ = native.scan(comp, bit_offset=48,
                                    anchor_every=anchor_every,
                                    dict_len=len(zdict))
    return index


STREAMS = {
    # name -> (data, stream, anchor_every, dictionary)
    "full_flush": lambda: (RAW[:60000], zlib_flushed(RAW[:60000], 16384),
                           2048, b""),
    # memLevel 4: blocks of 4,096 symbols, copies across them
    "chained": lambda: (RAW[:90000], (lambda c: c.compress(RAW[:90000])
                                      + c.flush())(
        zlib.compressobj(6, zlib.DEFLATED, 15, 4)), 4096, b""),
    "mixed_stored": lambda: (mixed_data(), zlib_flushed(mixed_data(), 16384),
                             4096, b""),
    "sync_chained": lambda: (mixed_data(), zlib_flushed(
        mixed_data(), 16384, mode=zlib.Z_SYNC_FLUSH), 4096, b""),
    "fdict": lambda: (RAW[:50000], zlib_flushed(RAW[:50000], 16384,
                                                zdict=RAW[-20000:]), 2048,
                      RAW[-20000:]),
}


@pytest.fixture(scope="module")
def streams():
    out = {}
    for name, make in STREAMS.items():
        data, comp, every, zd = make()
        out[name] = (data, comp, scan_index(comp, every, zd), zd)
    return out


def test_streams_hold_their_features(streams):
    assert streams["full_flush"][2].self_contained
    assert len(streams["full_flush"][2].blocks) > 4
    chained = streams["chained"][2]
    assert not chained.self_contained and len(chained.blocks) > 1
    mixed = streams["mixed_stored"][2]
    assert mixed.self_contained
    assert [(b.btype, b.out_start, b.out_len) for b in mixed.blocks
            if b.out_len][3] == (C.BTYPE_STORED, 49152, 16384)
    sync = streams["sync_chained"][2]
    assert not sync.self_contained
    assert any(b.btype == C.BTYPE_STORED and b.out_len for b in sync.blocks)
    for name, (data, comp, index, zd) in streams.items():
        zo = zlib.decompressobj(zdict=zd) if zd else zlib.decompressobj()
        assert zo.decompress(comp) == data, name
        assert not index.turbo and not index.wide


# ---------------------------------------------------------------------------
# decode_tokens

def _flat_tables(code_lengths):
    ll = np.zeros((len(code_lengths), C.NUM_LITLEN_SYMBOLS), np.int64)
    dl = np.zeros((len(code_lengths), C.NUM_DIST_SYMBOLS), np.int64)
    for r, (a, b) in enumerate(code_lengths):
        ll[r, : len(a)] = a
        dl[r, : len(b)] = b
    return (jhuff.build_litlen_tables(ll, 15),
            jhuff.build_dist_tables(dl, 15))


def _jax_stream(words_i32: np.ndarray):
    """(w32, bytes) as the JAX decode reads them, for a stream given as
    words."""
    data = words_i32.astype("<i4").tobytes()
    w32, b = jik.make_windows(data)
    nb = jip._bucket(w32.size)
    return (np.pad(w32, (0, nb - w32.size)),
            np.pad(b, (0, nb + 8 - b.size)))


def _unpack(tokens: np.ndarray):
    val = tokens & wk.TOK_VAL_MASK
    dist = np.where(tokens & wk.TOK_MATCH_BIT,
                    (tokens >> wk.TOK_DIST_SHIFT) & wk.TOK_DIST_MASK, 0)
    return val, dist


def both_decodes(words, code_lengths, rows, bit0, endb, active, T):
    """The port's ``decode_tokens`` (plain, CPU) and the JAX one on the same
    lanes; asserts that they agree and returns the port's outputs."""
    lt = np.zeros((len(code_lengths), wk.LL_W), np.int32)
    dt = np.zeros((len(code_lengths), wk.D_W), np.int32)
    for r, (a, b) in enumerate(code_lengths):
        lt[r], dt[r] = wk.wide_decode_tables(a, b)
    t = torch.from_numpy
    got = ik.decode_tokens(t(words), t(lt), t(dt),
                           t(rows.astype(np.int32)), t(bit0.astype(np.int64)),
                           t(endb.astype(np.int64)), t(active), T=T)
    tokens, starts, count, bitpos, still, err = (x.numpy() for x in got)
    w32, bts = _jax_stream(words)
    ll_tab, d_tab = _flat_tables(code_lengths)
    jv, jd, jc, jb, ja, je = (np.asarray(x) for x in jik.decode_tokens(
        w32, bts, ll_tab, d_tab, rows.astype(np.int32),
        bit0.astype(np.int32), endb.astype(np.int32), active, T=T, M=15,
        D=15))
    assert np.array_equal(count, jc)
    assert np.array_equal(bitpos, jb)
    assert np.array_equal(still, ja)
    assert np.array_equal(err, je)
    val, dist = _unpack(tokens.T)
    emitted = np.arange(T)[None, :] < count[:, None]
    assert np.array_equal(val[emitted], jv[emitted])
    assert np.array_equal(dist[emitted], jd[emitted])
    # starts: each token's offset in its lane's output
    lens = np.where(dist > 0, val, 1) * emitted
    want = np.cumsum(lens, axis=1) - lens
    assert np.array_equal(starts.T[emitted], want[emitted])
    return tokens, starts, count, bitpos, still, err


def _group_lanes(data, comp, index):
    """The port's first group plan of ``index`` on the CPU, as numpy."""
    p = ip.plan_groups(comp, index, "cpu")[0]
    lengths = [ip._block_code_lengths(comp, index.blocks[int(b)])
               for b in np.unique(np.asarray(index.anchor_block)[
                   : p.B])]
    return (p, lengths, p.rows.numpy(), p.bit0.numpy(), p.endb.numpy(),
            np.ones(p.B, bool))


@pytest.mark.parametrize("name", ["full_flush", "chained"])
def test_decode_tokens_plain_matches_reference_on_a_group(streams, name):
    data, comp, index, _ = streams[name]
    p, lengths, rows, bit0, endb, active = _group_lanes(data, comp, index)
    words = ik.stream_words(comp)
    _, _, count, bitpos, still, err = both_decodes(words, lengths, rows,
                                                   bit0, endb, active, p.T)
    assert not err.any() and not still.any()
    assert np.array_equal(bitpos, p.lane_end)


def test_decode_tokens_plain_matches_reference_when_resumed(streams):
    """T cut to 256: lanes stop while active and resume from their bit
    position, call after call, until every lane is done."""
    data, comp, index, _ = streams["chained"]
    p, lengths, rows, bit0, endb, active = _group_lanes(data, comp, index)
    words = ik.stream_words(comp)
    calls = 0
    total = np.zeros(p.B, np.int64)
    while active.any():
        _, _, count, bit0, active, err = both_decodes(
            words, lengths, rows, bit0, endb, active, 256)
        assert not err.any()
        total += count
        calls += 1
    assert calls > 3
    assert np.array_equal(bit0, p.lane_end)
    assert total.max() > 256


def _random_lengths(rng, n: int, max_len: int) -> np.ndarray:
    """Code lengths of a complete prefix code over ``n`` random symbols
    (none longer than ``max_len``), by splitting random leaves."""
    lengths = [1, 1]
    while len(lengths) < n:
        i = int(rng.integers(len(lengths)))
        if lengths[i] < max_len:
            lengths[i] += 1
            lengths.insert(i, lengths[i])
    out = np.zeros(n if n > 30 else 30, np.int64)
    out[rng.permutation(out.size)[: len(lengths)]] = lengths
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_tokens_plain_matches_reference_on_random_bits(seed):
    """Random stream bits under the fixed tables, a complete dynamic code
    (codes of 1-15 bits) and a code with invalid symbols: errors, lanes
    that end past their end bit, reads past the stream, inactive lanes."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, 3000, dtype=np.int64).astype(np.int32)
    ll = _random_lengths(rng, 288, 15)
    dl = _random_lengths(rng, 32, 15)
    lengths = [(C.fixed_litlen_code_lengths(), C.fixed_dist_code_lengths()),
               (ll[:288], dl[:30]),
               (ll[:288], dl[:32])]
    B = 96
    rows = rng.integers(0, 3, B)
    bit0 = rng.integers(0, 3000 * 32, B)
    endb = bit0 + rng.integers(0, 4000, B)
    active = rng.random(B) < 0.9
    *_, err = both_decodes(words, lengths, rows, bit0, endb, active, 128)
    assert err.any() and not err.all()


# ---------------------------------------------------------------------------
# resolve_global

def both_resolves(tokens, starts, count, out_base, total, prefix, O):
    """The port's ``resolve_global`` (plain) and the JAX one on the same
    tokens; asserts that bytes below ``total`` and the error flags agree
    and returns (bytes, err)."""
    t = torch.from_numpy
    out, err = ik.resolve_global(t(tokens), t(starts), t(count),
                                 t(out_base.astype(np.int32)), total,
                                 t(prefix))
    val, dist = _unpack(tokens.T)
    jout, jerr = jik.resolve_global(
        val.astype(np.int32), dist.astype(np.int32), count,
        out_base.astype(np.int32), np.int32(total), prefix, O=O)
    assert out.numel() == total
    assert np.array_equal(out.numpy(), np.asarray(jout)[:total])
    assert bool(err) == bool(jerr)
    return out.numpy(), bool(err)


@pytest.fixture(scope="module")
def chained_tokens(streams):
    """The chained stream's lanes decoded by the port: (data, tokens,
    starts, count, lane output offsets)."""
    data, comp, index, _ = streams["chained"]
    p, lengths, rows, bit0, endb, active = _group_lanes(data, comp, index)
    got = ik.decode_tokens(torch.from_numpy(ik.stream_words(comp)), p.lt,
                           p.dt, p.rows, p.bit0, p.endb, p.active, T=p.T)
    tokens, starts, count = (x.numpy() for x in got[:3])
    Tc = int(count.max())
    return (data, np.ascontiguousarray(tokens[:Tc]),
            np.ascontiguousarray(starts[:Tc]), count,
            np.asarray(index.anchor_out, np.int64))


@pytest.mark.parametrize("case", ["no_prefix", "prefix_32k", "straddle",
                                  "below_zero"])
def test_resolve_global_plain_matches_reference(chained_tokens, case):
    """Lanes of a chained stream (copies across blocks and lanes): all of
    them from 0; those from lane k0 on behind the 32 KiB before them; the
    same with the span starting 5 bytes into the lane (the token over the
    edge straddles it); and without a prefix, so that copies reach below
    0."""
    data, tokens, starts, count, lane_out = chained_tokens
    raw = np.frombuffer(data, np.uint8)
    O = 131072
    P = C.WINDOW_SIZE
    # a lane whose first token is a literal: without a prefix its byte 0 is
    # final
    k0 = 12 + int(np.argmax((tokens[0, 12:] & wk.TOK_MATCH_BIT) == 0))
    if case == "no_prefix":
        out, err = both_resolves(tokens, starts, count, lane_out, len(data),
                                 np.zeros(0, np.uint8), O)
        assert not err and out.tobytes() == data
        return
    cut = int(lane_out[k0]) + (5 if case == "straddle" else 0)
    sub = (np.ascontiguousarray(tokens[:, k0:]),
           np.ascontiguousarray(starts[:, k0:]), count[k0:].copy())
    if case == "below_zero":
        out, err = both_resolves(*sub, lane_out[k0:] - cut, len(data) - cut,
                                 np.zeros(0, np.uint8), O)
        assert err
        return
    prefix = raw[cut - P : cut].copy()
    out, err = both_resolves(*sub, lane_out[k0:] - cut + P,
                             P + len(data) - cut, prefix, O)
    assert not err and out[P:].tobytes() == data[cut:]
    assert out[:P].tobytes() == prefix.tobytes()


# ---------------------------------------------------------------------------
# plan_groups and the group pipeline

@pytest.mark.parametrize("name", ["full_flush", "chained", "mixed_stored",
                                  "sync_chained"])
def test_plan_groups_matches_reference(streams, name):
    """Group bounds, lane spans and table rows equal the reference's; a
    chained index splits at stored blocks (``sync_chained``: at every
    empty stored block of a sync flush and at the stored middle)."""
    data, comp, index, _ = streams[name]
    got = ip.plan_groups(comp, index, "cpu")
    want = jip.plan_groups(comp, jax_index(index))
    assert len(got) == len(want)
    if name == "sync_chained":
        assert len(got) > 3
    for p, q in zip(got, want):
        B = p.B
        assert (B, p.T, p.d_base, p.d_total) == (q.B, q.T, q.d_base,
                                                q.d_total)
        assert np.array_equal(p.lane_end, q.lane_end)
        for f in ("bit0", "endb", "rows", "out_base"):
            assert np.array_equal(getattr(p, f).numpy(),
                                  np.asarray(getattr(q, f))[:B]), f
        assert tuple(p.lt.shape) == (int(p.rows.max()) + 1, wk.LL_W)


@pytest.mark.parametrize("name", ["full_flush", "chained", "fdict",
                                  "sync_chained"])
def test_inflate_raw_indexed_matches_reference(streams, name):
    """Self-contained groups, chained groups behind their prefix (across
    blocks and across stored blocks) and the dictionary halo, against the
    JAX package and CPython zlib."""
    data, comp, index, zd = streams[name]
    got = ip.inflate_raw_indexed(comp, index, "cpu", dictionary=zd or None)
    assert got.dtype == torch.uint8 and got.numpy().tobytes() == data
    if name != "sync_chained":
        want = jip.inflate_raw_indexed(comp, jax_index(index),
                                       dictionary=zd or None)
        assert want.tobytes() == data


def test_stored_block_between_dynamic_blocks(streams):
    """A self-contained index whose one group spans a stored block: the
    port splices the stored bytes after the groups.  (The reference's
    inflate_raw_indexed copies them first and lets the group write over
    them; its inflate_to_device never places them: 16,327 of the 16,384
    bytes came out wrong there.)"""
    data, comp, index, _ = streams["mixed_stored"]
    assert len(ip.plan_groups(comp, index, "cpu")) == 1
    got = ip.inflate_raw_indexed(comp, index, "cpu")
    assert got.numpy().tobytes() == data == zlib.decompress(comp)
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                        device="cpu")
    assert (off, n) == (0, len(data)) and out.numpy().tobytes() == data
    for start, length in ((50000, 300), (49000, 2000), (65530, 12)):
        assert zlibes_tpu_torch.inflate_range(
            comp, index, start, length, device="cpu") == \
            data[start : start + length]


@pytest.mark.parametrize("start,length", [(16380, 300), (0, 60000),
                                          (30000, 1), (59999, 1),
                                          (20000, 0)])
def test_inflate_range_on_a_generic_index(streams, start, length):
    data, comp, index, _ = streams["full_flush"]
    assert zlibes_tpu_torch.inflate_range(comp, index, start, length,
                                          device="cpu") == \
        data[start : start + length]


@pytest.fixture(scope="module")
def refmodel_stream():
    data = RAW[100000:130000]
    comp, index = zlibes_tpu_torch.deflate_indexed(data, backend="refmodel",
                                                   block_size=8192)
    return data, comp, index


def test_refmodel_index_is_generic(refmodel_stream):
    data, comp, index = refmodel_stream
    assert not index.turbo and not index.wide and index.self_contained
    assert len(index.blocks) >= 4 and zlib.decompress(comp) == data


@pytest.mark.parametrize("start,length", [(8190, 300), (100, 29000),
                                          (29999, 1)])
def test_inflate_range_on_a_refmodel_index(refmodel_stream, start, length):
    data, comp, index = refmodel_stream
    assert zlibes_tpu_torch.inflate_range(comp, index, start, length,
                                          device="cpu") == \
        data[start : start + length]


@pytest.mark.parametrize("name", ["full_flush", "refmodel"])
def test_inflate_to_device_on_a_generic_index(streams, refmodel_stream,
                                              name):
    data, comp, index = (refmodel_stream if name == "refmodel"
                         else streams[name][:3])
    tk.LAUNCHES.clear()
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                        device="cpu")
    assert (out.device.type, out.dtype, off, n) == ("cpu", torch.uint8, 0,
                                                    len(data))
    assert out.numpy().tobytes() == data
    assert not tk.LAUNCHES


@pytest.mark.parametrize("entry", ["inflate_range", "inflate_to_device"])
def test_fdict_stream_is_refused(streams, entry):
    """A preset-dictionary stream's own index: the seek and the device
    output refuse it (the reference decodes it without the dictionary)."""
    data, comp, index, zd = streams["fdict"]
    # the stream's own index (chained: its first block copies from the
    # dictionary) and the same marked self-contained
    for idx in (index, dataclasses.replace(index, self_contained=True)):
        with pytest.raises(HeaderError, match="inflate\\(..., dictionary="):
            if entry == "inflate_range":
                zlibes_tpu_torch.inflate_range(comp, idx, 0, 10,
                                               device="cpu")
            else:
                zlibes_tpu_torch.inflate_to_device(comp, idx, device="cpu")


# ---------------------------------------------------------------------------
# no index: the scan path

SCAN_CASES = {
    "level6": lambda d: zlib.compress(d, 6),
    "level1": lambda d: zlib.compress(d, 1),
    "fixed": lambda d: (lambda c: c.compress(d) + c.flush())(
        zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)),
    "stored": lambda d: zlib.compress(d, 0),
    "sync_flush": lambda d: zlib_flushed(d, 7000, mode=zlib.Z_SYNC_FLUSH),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_inflate_raw_scan_on_the_device_path(case):
    data = RAW[200000:224000]
    comp = SCAN_CASES[case](data)
    out, blocks, end_bit = ip.inflate_raw_scan(comp, 2, device="cpu")
    assert out.numpy().tobytes() == data
    assert (end_bit + 7) >> 3 == len(comp) - 4
    assert sum(b.out_len for b in blocks) == len(data) and blocks[-1].bfinal


def test_inflate_raw_scan_dictionary_and_far_reference():
    """The first window sits behind the dictionary's tail; without it a
    copy into the dictionary reaches before the stream and raises."""
    data, zd = RAW[:20000], RAW[-8000:]
    co = zlib.compressobj(6, zdict=zd)
    comp = co.compress(data) + co.flush()
    out, _, _ = ip.inflate_raw_scan(comp, 6, dictionary=zd, device="cpu")
    assert out.numpy().tobytes() == data
    with pytest.raises(CorruptError, match="before start"):
        ip.inflate_raw_scan(comp, 6, device="cpu")


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("case", ["no_index", "generic_index",
                                  "chained_index", "fdict_no_index",
                                  "fdict_index"])
def test_inflate_without_native_decodes_on_the_device_path(streams,
                                                           no_native, case):
    """Without the native runtime, ``inflate()`` takes the scan for an
    un-indexed stream and the group decode for a generic or chained index,
    with the preset dictionary where the stream has one."""
    name = {"no_index": "chained", "generic_index": "full_flush",
            "chained_index": "chained", "fdict_no_index": "fdict",
            "fdict_index": "fdict"}[case]
    data, comp, index, zd = streams[name]
    use = index if case in ("generic_index", "chained_index",
                            "fdict_index") else None
    assert zlibes_tpu_torch.inflate(comp, index=use, dictionary=zd or None,
                                    device="cpu") == data


def test_inflate_without_native_refuses_bad_streams(streams, no_native):
    data, comp, index, _ = streams["full_flush"]
    bad = bytearray(comp)
    bad[-1] ^= 1
    with pytest.raises(zlibes_tpu_torch.ChecksumError):
        zlibes_tpu_torch.inflate(bytes(bad), device="cpu")
    with pytest.raises(zlibes_tpu_torch.ChecksumError):
        zlibes_tpu_torch.inflate(bytes(bad), index=index, device="cpu")
    other = streams["chained"][1]
    with pytest.raises(CorruptError):
        zlibes_tpu_torch.inflate(other, index=index, device="cpu")


# ---------------------------------------------------------------------------
# wrappers

def test_wrappers_check_their_inputs():
    words = torch.zeros(16, dtype=torch.int32)
    lt = torch.zeros((1, wk.LL_W), dtype=torch.int32)
    dt = torch.zeros((1, wk.D_W), dtype=torch.int32)
    lanes = (torch.zeros(2, dtype=torch.int32), torch.zeros(2,
                                                          dtype=torch.int64),
             torch.ones(2, dtype=torch.int64), torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="bit0 has dtype"):
        ik.decode_tokens(words, lt, dt, lanes[0], lanes[0], *lanes[2:], T=4)
    with pytest.raises(ValueError, match="shape"):
        ik.decode_tokens(words, lt[:, :5], dt, *lanes, T=4)
    with pytest.raises(ValueError, match="T must be positive"):
        ik.decode_tokens(words, lt, dt, *lanes, T=0)
    with pytest.raises(ValueError, match="without a table row"):
        ik.decode_tokens(words, lt[:0], dt[:0], *lanes, T=4)
    tok = torch.zeros((4, 2), dtype=torch.int32)
    cnt = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="total"):
        ik.resolve_global(tok, tok, cnt, cnt, 3,
                          torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="prefix has dtype"):
        ik.resolve_global(tok, tok, cnt, cnt, 8,
                          torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device"):
        ik.resolve_global(tok.to("meta"), tok.to("meta"), cnt.to("meta"),
                          cnt.to("meta"), 8,
                          torch.zeros(0, dtype=torch.uint8, device="meta"))
