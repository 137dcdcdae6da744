"""The PyTorch port's general encoder (levels 0-9, preset dictionaries),
stage by stage and as a whole, against the JAX package.

The same seeded inputs go through each JAX stage (XLA ops on the CPU) and
through the port's counterpart (torch ops and the plain version of
``select_tokens`` on the CPU), at small shapes: blocks of 8-16 KiB, two
blocks a dispatch.  Every array is an integer array or bytes, so every
comparison is exact.  The JAX package is the reference only: its encoder
gets its own config, the port the copy made by ``config_from_reference``.
"""
import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as jdp
from zlibes_tpu.config import CodecConfig as JaxCodecConfig
from zlibes_tpu.ops import deflate_kernel as jdk
from zlibes_tpu.ops import lz77 as jlz

import zlibes_tpu_torch
from zlibes_tpu_torch import (
    CodecStats,
    config_from_reference,
    index_from_reference,
)
from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.ops import deflate_kernel as dk
from zlibes_tpu_torch.ops import lz77
from zlibes_tpu_torch.spec import constants as C

from shared_tables_cases import skewed_data as _skewed_data
from test_matcher import CASES, _verify_matches

torch.set_num_threads(2)

BS = 8192       # block size of the stage tests
BP = 2          # blocks a dispatch


def _mixed_data(n=40000, seed=0):
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)
    rnd = rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()
    rle = b"A" * 1200 + b"ab" * 700 + bytes(range(256)) * 4
    out = (text + rnd + rle) * 3
    return out[:n]


def _rows(data: bytes, N=BS, B=BP, prefix=0):
    """(B, prefix + N + 8) block rows behind ``prefix`` seeded bytes, and
    (B,) valid counts, the prefix counted in."""
    arr = np.frombuffer(data, np.uint8)
    blk = np.zeros((B, prefix + N + 8), np.uint8)
    nv = np.full(B, prefix, np.int32)
    if prefix:
        blk[:, :prefix] = np.frombuffer(_mixed_data(B * prefix, seed=9),
                                        np.uint8).reshape(B, prefix)
    for i in range(min(B, -(-arr.size // N))):
        c = arr[i * N:(i + 1) * N]
        blk[i, prefix:prefix + c.size] = c
        nv[i] += c.size
    return blk, nv


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# find_matches: the full ranking

@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("reset", [0, 512, 4096])
def test_find_matches_full_ranking_matches_reference(reset, with_ctx):
    """A short last block, zero runs, and (with a context) rows whose first
    real byte lies at 0, inside and at the end of a prefix of 4 KiB."""
    blk, nv = _rows(bytes([4, 255, 255, 255]) + bytes(300)
                    + _mixed_data(BS + 3000, seed=1), B=3,
                    prefix=4096 if with_ctx else 0)
    N = blk.shape[1] - 8
    ctx = np.array([0, 1000, 4096], np.int32) if with_ctx else None
    want = np.asarray(jlz.find_matches(
        jnp.asarray(blk), jnp.asarray(nv), N=N, S=4, J=6, reset=reset,
        ctx_start=None if ctx is None else jnp.asarray(ctx)))
    got = lz77.find_matches(_t(blk), _t(nv), N=N, S=4, J=6, reset=reset,
                            ctx_start=None if ctx is None else _t(ctx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    ml, dist = want >> 16, want & 0xFFFF
    assert (ml >= 3).any() and (ml == C.MAX_MATCH).any()
    if with_ctx:
        # no source below a row's first real byte
        pos = np.broadcast_to(np.arange(N), ml.shape)
        m = ml >= 3
        assert (pos[m] - dist[m] >= np.broadcast_to(ctx[:, None],
                                                    ml.shape)[m]).all()


@pytest.mark.parametrize("reset", [0, 512, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_match_is_real(case, reset):
    """The twin of tests/test_matcher.py::test_every_match_is_real for the
    port's full ranking: every claimed (len, dist) is in the data."""
    N = 8192
    arr = np.frombuffer(CASES[case](), np.uint8)
    n = min(arr.size, N)
    buf = np.zeros((1, N + 8), np.uint8)
    buf[0, :n] = arr[:n]
    m = lz77.find_matches(_t(buf), torch.tensor([n], dtype=torch.int32),
                          N=N, S=8, J=8, reset=reset).numpy()[0]
    bad = _verify_matches(arr[:n], n, m, reset)
    assert not bad, f"fabricated matches: {bad[:5]}"


# ---------------------------------------------------------------------------
# select_tokens

def _same_tokens(got, want):
    tv, td, cnt = (x.numpy() for x in got)
    jtv, jtd, jcnt = (np.asarray(x) for x in want)
    assert np.array_equal(cnt, jcnt)
    v = np.arange(jtv.shape[1])[None, :] < jcnt[:, None]
    assert np.array_equal(tv[v], jtv[v]) and np.array_equal(td[v], jtd[v])
    assert not tv[~v].any() and not td[~v].any()
    return jcnt


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("SEG,start", [(4096, 0), (1024, 0), (4096, 4096),
                                       (1024, 1024)])
def test_select_tokens_plain_matches_reference_on_real_matches(SEG, start,
                                                               lazy):
    blk, nv = _rows(_mixed_data(BS + 2500, seed=3), prefix=start)
    N = start + BS
    ctx = np.full(BP, start // 2, np.int32)
    m = jlz.find_matches(jnp.asarray(blk), jnp.asarray(nv), N=N, S=4, J=6,
                         ctx_start=jnp.asarray(ctx))
    want = jlz.select_tokens(jnp.asarray(blk), m, jnp.asarray(nv), N=N,
                             SEG_SIZE=SEG, lazy=lazy, start=start)
    got = lz77.select_tokens(_t(blk), _t(np.asarray(m)), _t(nv), N=N,
                             SEG_SIZE=SEG, lazy=lazy, start=start)
    cnt = _same_tokens(got, want)
    assert cnt.size == BP * BS // SEG and (cnt == 0).any() and cnt.max() > 50


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("SEG,start", [(4096, 0), (1024, 2048)])
def test_select_tokens_plain_matches_reference_on_random_matches(SEG, start,
                                                                 lazy):
    """Random packed matches, long and far ones included: the segment-end
    clamp and the lazy defer, with no far cap."""
    rng = np.random.default_rng(SEG + start)
    blk, nv = _rows(_mixed_data(BS + 777, seed=5), prefix=start)
    N = start + BS
    ml = rng.integers(0, C.MAX_MATCH + 1, (BP, N))
    ml = np.where(rng.random((BP, N)) < 0.4, 0, ml)
    dist = rng.integers(1, C.WINDOW_SIZE + 1, (BP, N))
    matches = ((ml << 16) | dist).astype(np.int32)
    want = jlz.select_tokens(jnp.asarray(blk), jnp.asarray(matches),
                             jnp.asarray(nv), N=N, SEG_SIZE=SEG, lazy=lazy,
                             start=start)
    got = lz77.select_tokens(_t(blk), _t(matches), _t(nv), N=N, SEG_SIZE=SEG,
                             lazy=lazy, start=start)
    _same_tokens(got, want)
    jtv, jtd, _ = (np.asarray(x) for x in want)
    assert ((jtv > 130) & (jtd >= 2049)).any()


# ---------------------------------------------------------------------------
# token_symbols at the general shapes, and pack_payload

def _general_tokens(seed=4, far=False):
    """One dispatch's JAX tokens and symbols (two blocks of 8 KiB in lanes
    of 4,096, the second block short); with ``far`` random matches at
    distances up to 32,768."""
    blk, nv = _rows(_mixed_data(BS + 3000, seed=seed))
    if far:
        rng = np.random.default_rng(seed)
        ml = np.where(rng.random((BP, BS)) < 0.6, 0,
                      rng.integers(3, C.MAX_MATCH + 1, (BP, BS)))
        dist = rng.integers(1, C.WINDOW_SIZE + 1, (BP, BS))
        ml[0, 0], dist[0, 0] = 100, C.WINDOW_SIZE
        m = jnp.asarray(((ml << 16) | dist).astype(np.int32))
    else:
        m = jlz.find_matches(jnp.asarray(blk), jnp.asarray(nv), N=BS, S=4, J=6)
    tv, td, cnt = jlz.select_tokens(jnp.asarray(blk), m, jnp.asarray(nv),
                                    N=BS, SEG_SIZE=4096)
    sym = jdk.token_symbols(tv, td, cnt, nseg=BS // 4096)
    return (tv, td, cnt), sym


@pytest.mark.parametrize("far", [False, True])
def test_token_symbols_matches_reference_at_wide_shapes(far):
    """T = 4096 slots a lane, distance symbols up to 29."""
    (tv, td, cnt), sym = _general_tokens(far=far)
    jl, jd, jv, jll, jdf = (np.asarray(x) for x in sym)
    lsym, dsym, valid, ll_freq, d_freq = dk.token_symbols(
        *(_t(np.asarray(x)) for x in (tv, td, cnt)), nseg=BS // 4096)
    assert np.array_equal(valid.numpy(), jv)
    assert np.array_equal(lsym.numpy()[jv], jl[jv])
    assert np.array_equal(dsym.numpy()[jv], jd[jv])
    assert np.array_equal(ll_freq.numpy(), jll)
    assert np.array_equal(d_freq.numpy(), jdf)
    if far:
        assert jdf[:, 29].all() and np.asarray(td).max() == C.WINDOW_SIZE


@pytest.mark.parametrize("far", [False, True])
def test_pack_payload_matches_reference(far):
    """Per-block tables (one dynamic, one fixed), a disabled padded block
    would pack nothing; fields of up to 48 bits with ``far``."""
    nseg = BS // 4096
    (tv, td, cnt), sym = _general_tokens(far=far)
    lsym, dsym, valid, llf, dfq = sym
    llf = np.asarray(llf).astype(np.int64)
    llf[:, C.END_OF_BLOCK] += 1
    ll_len = np.stack([bt.package_merge_np(llf[0], 15), bt._FIXED_LL_LEN])
    d_len = np.stack([bt.package_merge_np(np.asarray(dfq)[0], 15),
                      bt._FIXED_D_LEN])
    codes = [bt._encode_tables(ll_len[i], d_len[i]) for i in range(BP)]
    ll_code = np.stack([c[0] for c in codes])
    d_code = np.stack([c[1] for c in codes])
    hdr_bits = np.array([417, 3], np.int32)
    enabled = np.array([True, True])
    W = (15 * BS + 4096) // 32
    want = [np.asarray(x) for x in jdk.pack_payload(
        tv, td, lsym, dsym, valid, jnp.asarray(ll_code),
        jnp.asarray(ll_len.astype(np.int32)), jnp.asarray(d_code),
        jnp.asarray(d_len.astype(np.int32)), jnp.asarray(hdr_bits),
        jnp.asarray(enabled), nseg=nseg, W=W, sub_every=128)]
    got = dk.pack_payload(
        *(_t(np.asarray(x)) for x in (tv, td, lsym, dsym, valid)),
        _t(ll_code.astype(np.int64)), _t(ll_len.astype(np.int64)),
        _t(d_code.astype(np.int64)), _t(d_len.astype(np.int64)),
        _t(hdr_bits), _t(enabled), nseg=nseg, W=W, sub_every=128)
    words, payload_end, lane_bit0, sub_bit, sub_out = (x.numpy() for x in got)
    jwords, jpe, jlb, jsb, jso = want
    assert np.array_equal(payload_end, jpe) and np.array_equal(lane_bit0, jlb)
    assert np.array_equal(sub_bit, jsb) and np.array_equal(sub_out, jso)
    assert (jsb == 1 << 30).any() and (jsb < 1 << 30).any()
    used = (jpe.astype(np.int64) + 31) // 32 + 1
    for b in range(BP):
        assert np.array_equal(words[b, :used[b]],
                              jwords[b, :used[b]].astype(np.int64))
    assert not words[:, used.max():].any()
    dense = dk.gather_compressed(got[0].reshape(-1),
                                 torch.arange(int(used[0])))
    assert dense.dtype == torch.int32
    assert np.array_equal(dense.numpy().view(np.uint32), jwords[0, :used[0]])
    if far:
        # 13 extra bits behind the longest distance code
        assert np.asarray(td).max() == C.WINDOW_SIZE and d_len[0].max() >= 5
    # without sub_every: the first three results alone
    assert len(dk.pack_payload(
        *(_t(np.asarray(x)) for x in (tv, td, lsym, dsym, valid)),
        _t(ll_code.astype(np.int64)), _t(ll_len.astype(np.int64)),
        _t(d_code.astype(np.int64)), _t(d_len.astype(np.int64)),
        _t(hdr_bits), _t(enabled), nseg=nseg, W=W)) == 3


# ---------------------------------------------------------------------------
# the whole encoder

EBS = 16384     # block size of the whole-encoder tests
DICT = b"the quick brown fox jumps over the lazy dog " * 40
LONG_DICT = _mixed_data(40000, seed=8)      # cut to its last 32 KiB

# name -> (data, JAX config or level, dictionary)
STREAMS = {
    "level1": (_mixed_data(), 1, None),
    "level5": (_mixed_data(), 5, None),
    "level6": (_mixed_data(), 6, None),
    "level9": (_mixed_data(seed=2), 9, None),
    "default_config": (_mixed_data(seed=3), None, None),
    "level0": (_mixed_data(70000), 0, None),
    # a stored block inside a coded stream: random bytes, then text
    "incompressible": (np.random.default_rng(7).integers(
        0, 256, EBS, dtype=np.uint8).tobytes() + _mixed_data(EBS), 6, None),
    # a stored block longer than 65,535 bytes (two stored chunks)
    "incompressible_long": (np.random.default_rng(8).integers(
        0, 256, 70000, dtype=np.uint8).tobytes(), 6, None),
    "fixed_wins": (b"This is zlib.es", 6, None),
    "empty": (b"", 6, None),
    "one_byte": (b"Q", 6, None),
    "exactly_N": (_mixed_data(EBS, seed=2), 6, None),
    "rle": (b"a" * 30000 + b"0123456789" * 100, 6, None),
    "seg_1024": (_mixed_data(seed=4), JaxCodecConfig(seg_size=1024), None),
    "reset_4096": (_mixed_data(seed=5), JaxCodecConfig(chunk_reset=4096),
                   None),
    # no candidates: literals only, no matcher
    "literals_only": (_mixed_data(20000, seed=9),
                      JaxCodecConfig(candidates=0), None),
    "dict_short": (b"a lazy dog jumps; the quick brown fox naps " * 30, 6,
                   DICT),
    "dict_long": (LONG_DICT[20000:35000] + _mixed_data(20000, seed=6), 6,
                  LONG_DICT),
    "dict_zero_run": (b"\x00\x00\x00\x00" + b"short dict 123 tail" * 4, 6,
                      b"short dict 123"),
    "dict_turbo_config": (_mixed_data(20000, seed=7),
                          JaxCodecConfig.turbo(candidates=4, probe_words=4),
                          DICT),
}


def _jax_config(spec):
    if spec is None:
        return JaxCodecConfig(blocks_per_dispatch=BP)
    if isinstance(spec, int):
        spec = JaxCodecConfig.from_level(spec)
    return dataclasses.replace(spec, blocks_per_dispatch=BP)


def _same_index(a, b) -> bool:
    """The port's index ``a`` against the reference's ``b``, field by
    field."""
    b = index_from_reference(b)
    return (a.blocks == b.blocks and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("anchor_bit", "anchor_out", "anchor_block"))
        and (a.turbo, a.chunk_reset, a.max_tokens, a.wide, a.self_contained)
        == (b.turbo, b.chunk_reset, b.max_tokens, b.wide, b.self_contained))


@pytest.fixture(scope="module", params=sorted(STREAMS))
def encoded(request):
    data, spec, dictionary = STREAMS[request.param]
    jcfg = _jax_config(spec)
    jcomp, jindex = jdp.deflate(data, with_index=True, config=jcfg,
                                block_size=EBS, dictionary=dictionary)
    return request.param, data, config_from_reference(jcfg), dictionary, \
        jcomp, jindex


def test_deflate_matches_reference(encoded):
    name, data, cfg, dictionary, jcomp, jindex = encoded
    stats = CodecStats()
    comp, index = tdp.deflate(data, with_index=True, config=cfg,
                              block_size=EBS, dictionary=dictionary,
                              stats=stats, device="cpu")
    assert comp == jcomp
    assert _same_index(index, jindex)
    assert stats.bytes_in == len(data) and stats.bytes_out == len(comp)
    assert index.wide == (dictionary is None and bool(data)
                          and not cfg.force_stored)
    kinds = {b.btype for b in index.blocks}
    want_kind = {"incompressible": C.BTYPE_STORED, "fixed_wins": C.BTYPE_FIXED,
                 "level6": C.BTYPE_DYNAMIC}.get(name)
    assert want_kind is None or want_kind in kinds
    if name == "incompressible":
        assert C.BTYPE_DYNAMIC in kinds
    if name == "incompressible_long":
        assert sum(b.out_len > 0 for b in index.blocks) == \
            sum(-(-n // 65535) for n in (EBS,) * 4 + (70000 - 4 * EBS,))


def test_cpython_and_the_port_decode_it(encoded):
    _, data, cfg, dictionary, jcomp, jindex = encoded
    comp, index = tdp.deflate(data, with_index=True, config=cfg,
                              block_size=EBS, dictionary=dictionary,
                              device="cpu")
    if dictionary is None:
        assert comp[:2] == b"\x78\x9c"
        assert zlib.decompress(comp) == data
    else:
        assert comp[0] == 0x78 and comp[1] & 0x20
        assert comp[2:6] == zlib.adler32(dictionary).to_bytes(4, "big")
        assert zlib.decompressobj(zdict=dictionary).decompress(comp) == data
    assert int.from_bytes(comp[-4:], "big") == zlib.adler32(data)
    # with its index: the wide lanes on the device path, or (FDICT, level 0,
    # the empty input) the host decode through the native runtime
    assert zlibes_tpu_torch.inflate(comp, index=index, dictionary=dictionary,
                                    device="cpu") == data
    assert zlibes_tpu_torch.inflate(comp, dictionary=dictionary,
                                    device="cpu") == data
    if index.wide and len(data) >= 300:
        lo = len(data) // 2 - 10
        assert zlibes_tpu_torch.inflate_range(
            comp, index, lo, 300, device="cpu") == data[lo:lo + 300]


@pytest.mark.parametrize("level", [0, 1, 5, 6, 9])
def test_public_deflate_takes_a_level(level):
    """``level=`` through the public entry point gives the JAX encoder's
    bytes; ``config`` overrides ``level``."""
    data = _mixed_data(30000, seed=level)
    jcfg = _jax_config(level)
    want = jdp.deflate(data, config=jcfg, block_size=EBS)
    cfg = config_from_reference(jcfg)
    assert zlibes_tpu_torch.deflate(data, level=3, config=cfg,
                                    block_size=EBS, device="cpu") == want
    if level in (0, 1):
        # the preset itself (16 blocks a dispatch): the same bytes
        assert zlibes_tpu_torch.deflate(data, level=level, block_size=EBS,
                                        device="cpu") == want
    assert zlib.decompress(want) == data


def test_public_deflate_rejects_a_bad_level_and_a_foreign_config():
    with pytest.raises(ValueError, match="level must be 0..9"):
        zlibes_tpu_torch.deflate(b"abc", level=10, device="cpu")
    with pytest.raises(TypeError, match="config_from_reference"):
        zlibes_tpu_torch.deflate(b"abc", config=JaxCodecConfig(),
                                 device="cpu")
    with pytest.raises(ValueError, match="multiple of config.seg_size"):
        zlibes_tpu_torch.deflate(b"abc" * 100, block_size=5000, device="cpu")


def test_shared_tables_outside_turbo_names_what_is_missing():
    """A shared-tables config outside the turbo profile (15-bit codes)
    encodes: the stream round-trips through CPython and the port, under a
    non-turbo index."""
    cfg = dataclasses.replace(zlibes_tpu_torch.CodecConfig.turbo(),
                              max_code_bits=15)
    data = b"some bytes, and some more bytes, and some bytes"
    comp, index = tdp.deflate(data, with_index=True, config=cfg,
                              device="cpu")
    assert zlib.decompress(comp) == data
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
    assert not index.turbo and index.chunk_reset == 4096


def test_shared_tables_outside_turbo_is_refused_where_reference_is_wrong():
    """A shared-tables config outside the turbo profile on data whose coded
    tokens pass 32 bits: the reference packs them with its 32-bit field and
    writes a stream CPython rejects; the port keeps the whole field and its
    stream round-trips, as does the turbo profile's on the same bytes."""
    import zlibes_tpu

    data = _skewed_data()
    cfg = dict(seg_size=512, shared_tables=True)
    out = zlibes_tpu_torch.deflate(data, config=zlibes_tpu_torch.CodecConfig(
        **cfg), block_size=32768, device="cpu")
    assert zlib.decompress(out) == data
    assert zlibes_tpu_torch.inflate(out, device="cpu") == data
    wrong = zlibes_tpu.deflate(data, config=JaxCodecConfig(**cfg),
                               block_size=32768)
    with pytest.raises(zlib.error, match="incorrect data check"):
        zlib.decompress(wrong)
    out = zlibes_tpu_torch.deflate(data, config=zlibes_tpu_torch.CodecConfig
                                   .turbo(), block_size=32768, device="cpu")
    assert zlib.decompress(out) == data


def test_dispatches_do_not_change_the_bytes():
    """Two, three and sixteen blocks a dispatch (the last dispatch ragged or
    padded) give one stream and one index."""
    data = _mixed_data(5 * EBS + 123, seed=4)
    outs = []
    for bp in (2, 3, 16):
        cfg = dataclasses.replace(
            zlibes_tpu_torch.CodecConfig.from_level(5),
            blocks_per_dispatch=bp)
        stats = CodecStats()
        comp, index = tdp.deflate(data, with_index=True, config=cfg,
                                  block_size=EBS, stats=stats, device="cpu")
        assert stats.dispatches == -(-6 // bp)
        assert {"match", "select", "symbols", "tables", "pack", "readback",
                "splice"} <= set(stats.stage_s)
        outs.append((comp, index.blocks, index.anchor_bit.tolist()))
    assert outs[0] == outs[1] == outs[2]
    assert zlib.decompress(outs[0][0]) == data


def test_general_index_feeds_the_wide_lanes():
    """The encoder's own index drives the port's wide decode: one anchor
    every 128 output bytes of every coded block, none for a stored one."""
    data = np.random.default_rng(3).integers(
        0, 256, EBS, dtype=np.uint8).tobytes() + _mixed_data(2 * EBS + 700)
    comp, index = tdp.deflate(data, with_index=True, level=6, block_size=EBS,
                              device="cpu")
    assert index.wide and not index.turbo
    coded = [b for b in index.blocks if b.btype != C.BTYPE_STORED]
    assert index.anchor_bit.size == sum(-(-b.out_len // 128) for b in coded)
    assert index.blocks[0].btype == C.BTYPE_STORED
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(
        comp, index, device="cpu")[-1:]
    assert out[:n].numpy().tobytes() == data[off:off + n]
