"""The port's shared-table encoder outside the turbo profile, against the
JAX package and CPython.

Three configs (``tests/shared_tables_cases.py``) each drive another kernel
variant: ``shared_full`` (``select_tokens``, 15-bit codes, no window
reset), ``shared_turbo15`` (``select_turbo`` with ``split_far`` off) and
``shared_seg1024`` (``select_tokens`` with ``split_far`` on).  Where every
coded token fits 32 bits, the port's bytes and index equal the JAX
package's (its Pallas kernels in interpret mode on the CPU); where one does
not, the reference's 32-bit field loses bits and CPython rejects its
stream, and the port's, which keeps the whole field, is held against
CPython and the port's own decoders.  Kernel contracts: ``select_turbo``
and ``select_tokens`` with the ``split_far`` setting each is new in,
``encode_fields`` against the JAX kernel and against fields written with
the port's ``refmodel`` bit writer, and the pack of tokens that span three
words.  Small shapes: two blocks a dispatch, 8-32 KiB blocks.
"""
import dataclasses
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as jdp
from zlibes_tpu.config import CodecConfig as JaxCodecConfig
from zlibes_tpu.ops import encode_kernel as jek
from zlibes_tpu.ops import lz77 as jlz

import zlibes_tpu_torch
from zlibes_tpu_torch import config_from_reference
from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.ops import deflate_kernel as dk
from zlibes_tpu_torch.ops import encode_kernel as ek
from zlibes_tpu_torch.ops import lz77
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec import refmodel

from shared_tables_cases import (SHARED_CONFIGS, deep_tables, far_copy_data,
                                 skewed_data, widest_token)
from test_torch_contract_cases import select_tokens_model
from test_torch_deflate import _same_index

torch.set_num_threads(2)

RAW = (Path(__file__).resolve().parent / "golden" / "raw.bin").read_bytes()
BS = 32768
# three blocks of 32 KiB: two dispatches of two, the second padded
SLICE = RAW[:2 * BS + 777]
BUFFERS = {"skewed": skewed_data, "far_copies": far_copy_data}
_MASK32 = (1 << 32) - 1


def _configs(name: str, **kw):
    """The port's config ``name`` at two blocks a dispatch, with ``kw``,
    and the JAX package's config of the same fields."""
    cfg = dataclasses.replace(SHARED_CONFIGS[name], blocks_per_dispatch=2,
                              **kw)
    jcfg = JaxCodecConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    assert config_from_reference(jcfg) == cfg
    return cfg, jcfg


def _port(data: bytes, cfg, bs: int = BS):
    """The port's stream and index on the CPU, and its widest coded
    token's bits."""
    with widest_token() as widest:
        comp, index = tdp.deflate(data, with_index=True, config=cfg,
                                  block_size=bs, device="cpu")
    return comp, index, widest[0]


# ---------------------------------------------------------------------------
# the encoder against the JAX package where every token fits 32 bits

VARIANTS = {
    "32k": (BS, {}),
    "16k": (16384, {}),
    "8k": (8192, {}),
    "greedy": (BS, dict(lazy=False)),
    "recompute": (BS, dict(phase1_cache_blocks=1)),
}
RAW_CASES = ([("shared_full", v) for v in ("32k", "greedy", "recompute",
                                           "16k")]
             + [("shared_turbo15", v) for v in ("32k", "greedy", "16k")]
             + [("shared_seg1024", v) for v in ("32k", "recompute", "8k")])


@pytest.mark.parametrize("name,variant", RAW_CASES)
def test_shared_config_equals_reference_on_raw(name, variant):
    """On a raw.bin slice every coded token fits 32 bits (so the
    comparison is not vacuous), and the stream and every index array are
    the JAX package's."""
    bs, kw = VARIANTS[variant]
    cfg, jcfg = _configs(name, **kw)
    comp, index, widest = _port(SLICE, cfg, bs)
    assert 0 < widest <= 32
    jcomp, jindex = jdp.deflate(SLICE, with_index=True, config=jcfg,
                                block_size=bs)
    assert comp == jcomp
    assert _same_index(index, jindex)
    assert not index.turbo and not index.wide
    assert zlib.decompress(comp) == SLICE


@pytest.mark.parametrize("data", [b"", b"x"], ids=["empty", "one_byte"])
@pytest.mark.parametrize("name", SHARED_CONFIGS)
def test_shared_config_small_inputs_equal_reference(name, data):
    cfg, jcfg = _configs(name)
    comp, index, _ = _port(data, cfg)
    jcomp, jindex = jdp.deflate(data, with_index=True, config=jcfg,
                                block_size=BS)
    assert comp == jcomp and _same_index(index, jindex)
    assert zlib.decompress(comp) == data
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data


@pytest.mark.parametrize("name", SHARED_CONFIGS)
def test_shared_config_checks_the_block_size(name):
    """Every shared-tables config, as the reference's: a multiple of the
    segment, and of 2,048 (the fused Adler-32 tiling)."""
    cfg, _ = _configs(name)
    with pytest.raises(ValueError, match="multiple of 2048"):
        zlibes_tpu_torch.deflate(RAW[:4096], config=cfg, block_size=3072,
                                 device="cpu")
    with pytest.raises(ValueError, match="multiple of config.seg_size"):
        zlibes_tpu_torch.deflate(RAW[:4096], config=cfg, block_size=4000,
                                 device="cpu")


# ---------------------------------------------------------------------------
# wide tokens: the port's streams round-trip, the reference's do not

@pytest.mark.parametrize("buffer", BUFFERS)
@pytest.mark.parametrize("name", SHARED_CONFIGS)
def test_shared_stream_round_trips(name, buffer):
    """Through CPython, the host decode with and without the index, the
    seek across a block boundary and the group decode into device
    memory."""
    data = BUFFERS[buffer]()
    cfg, _ = _configs(name)
    comp, index, _ = _port(data, cfg)
    assert zlib.decompress(comp) == data
    assert int.from_bytes(comp[-4:], "big") == zlib.adler32(data)
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
    assert zlibes_tpu_torch.inflate(comp, device="cpu") == data
    lo = BS - 2500
    assert zlibes_tpu_torch.inflate_range(comp, index, lo, 5000,
                                          device="cpu") == data[lo:lo + 5000]
    spans = zlibes_tpu_torch.inflate_to_device(comp, index, device="cpu")
    out = bytearray(len(data))
    for t, off, n in spans:
        out[off:off + n] = t[:n].numpy().tobytes()
    assert bytes(out) == data and sum(n for _, _, n in spans) == len(data)


@pytest.mark.parametrize("name,buffer", [("shared_full", "skewed"),
                                         ("shared_turbo15", "far_copies")])
def test_port_keeps_the_bits_the_reference_drops(name, buffer):
    """A coded token over 32 bits: the reference's stream has the right
    length and wrong bits, which CPython rejects; the port's is right."""
    data = BUFFERS[buffer]()
    cfg, jcfg = _configs(name)
    comp, _, widest = _port(data, cfg)
    assert 32 < widest <= 48
    assert zlib.decompress(comp) == data
    wrong = jdp.deflate(data, config=jcfg, block_size=BS)
    with pytest.raises(zlib.error):
        zlib.decompress(wrong)
    assert len(wrong) == len(comp) and wrong != comp


@pytest.mark.parametrize("buffer", BUFFERS)
def test_seg1024_tokens_fit_32_bits_and_equal_reference(buffer):
    """9-bit codes, the far cap and the 4 KiB reset keep every token of
    ``shared_seg1024`` within 32 bits, on the buffers that take the other
    two configs past it: the reference's stream is right, and the port's
    equals it."""
    data = BUFFERS[buffer]()
    cfg, jcfg = _configs("shared_seg1024")
    comp, index, widest = _port(data, cfg)
    assert widest <= 32
    jcomp, jindex = jdp.deflate(data, with_index=True, config=jcfg,
                                block_size=BS)
    assert comp == jcomp and _same_index(index, jindex)


# ---------------------------------------------------------------------------
# the kernels' new variants against the JAX package

def _random_matches(rng, B: int, N: int, max_dist: int):
    ml = rng.integers(0, C.MAX_MATCH + 1, (B, N))
    ml = np.where(rng.random((B, N)) < 0.4, 0, ml)
    dist = rng.integers(1, max_dist + 1, (B, N))
    return ((ml << 16) | dist).astype(np.int32)


def _rows(data: bytes, N: int, B: int = 2):
    arr = np.frombuffer(data, np.uint8)
    blk = np.zeros((B, N + 8), np.uint8)
    nv = np.zeros(B, np.int32)
    for i in range(B):
        c = arr[i * N:(i + 1) * N]
        blk[i, :c.size] = c
        nv[i] = c.size
    return blk, nv


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("lazy", [True, False])
def test_select_turbo_split_far_off_matches_reference(lazy):
    """Random packed matches under 4 KiB: far long matches stay whole,
    as in the Pallas kernel with ``split_far=False``."""
    N = 16384
    rng = np.random.default_rng(11)
    blk, nv = _rows(RAW[:N + 5000], N)
    matches = _random_matches(rng, 2, N, 4095)
    jtv, jtd, jcnt = (np.asarray(x) for x in jdp._select_turbo_glue(
        jnp.asarray(blk), jnp.asarray(matches), jnp.asarray(nv), N=N,
        SEG_SIZE=512, lazy=lazy, split_far=False))
    tv, td, cnt = tdp.select_glue(_t(blk), _t(matches), _t(nv), N, lazy,
                                  split_far=False)
    assert np.array_equal(cnt.numpy(), jcnt)
    v = np.arange(512)[None, :] < jcnt[:, None]
    assert np.array_equal(tv.numpy()[v], jtv[v])
    assert np.array_equal(td.numpy()[v], jtd[v])
    assert (jtv[v & (jtd >= 2049)] > 130).any()


@pytest.mark.parametrize("lazy", [True, False])
def test_select_tokens_split_far_matches_reference(lazy):
    """Random packed matches to 32 KiB back on 1,024-byte lanes, with far
    matches of 131-258 bytes placed at distances above 2048: each is cut to
    130, as in the JAX program with ``split_far=True``; the kernel's
    procedure (``select_tokens_model``) gives the same tokens."""
    N, SEG = 8192, 1024
    rng = np.random.default_rng(12)
    blk, nv = _rows(RAW[:N + 3000], N)
    matches = _random_matches(rng, 2, N, C.WINDOW_SIZE)
    far = rng.choice(N, 200, replace=False)
    matches[0, far] = ((rng.integers(131, 259, far.size) << 16)
                       | rng.integers(2049, C.WINDOW_SIZE + 1, far.size))
    kw = dict(N=N, SEG_SIZE=SEG, lazy=lazy, split_far=True)
    jtv, jtd, jcnt = (np.asarray(x) for x in jlz.select_tokens(
        jnp.asarray(blk), jnp.asarray(matches), jnp.asarray(nv), **kw))
    tv, td, cnt = (x.numpy() for x in lz77.select_tokens(
        _t(blk), _t(matches), _t(nv), **kw))
    assert np.array_equal(cnt, jcnt)
    v = np.arange(SEG)[None, :] < jcnt[:, None]
    assert np.array_equal(tv[v], jtv[v]) and np.array_equal(td[v], jtd[v])
    assert not tv[~v].any() and not td[~v].any()
    assert ((tv == 130) & (td > 2048)).sum() > 10
    assert not (v & (tv > 130) & (td > 2048)).any()
    model = select_tokens_model(blk, matches, nv, **kw)
    for a, b in zip(model[:3], (tv, td, cnt)):
        assert np.array_equal(a, b)


def _tables(max_bits: int, seed: int):
    """A canonical table pair of ``max_bits`` codes: a skewed histogram
    gives the rare symbols the longest codes."""
    rng = np.random.default_rng(seed)
    llf = (rng.pareto(0.7, C.NUM_LITLEN_SYMBOLS) * 50).astype(np.int64) + 1
    df = (rng.pareto(0.7, C.NUM_DIST_SYMBOLS) * 50).astype(np.int64) + 1
    llf[284], df[28], df[29] = 1, 1, 1
    ll_len = refmodel.package_merge_lengths(llf, max_bits)
    d_len = refmodel.package_merge_lengths(df, max_bits)
    return ll_len, d_len


def _field(ll_len, d_len, tv: int, td: int) -> tuple[int, int]:
    """One token's coded field and bit count from the port's ``refmodel``
    bit writer (canonical codes written MSB first)."""
    ll_code = refmodel.canonical_codes(ll_len)
    d_code = refmodel.canonical_codes(d_len)
    bw = refmodel.BitWriter()
    if td == 0:
        bw.write_code(int(ll_code[tv]), int(ll_len[tv]))
    else:
        i = int(np.searchsorted(C.LENGTH_BASE, tv, "right")) - 1
        bw.write_code(int(ll_code[257 + i]), int(ll_len[257 + i]))
        bw.write_bits(tv - int(C.LENGTH_BASE[i]),
                      int(C.LENGTH_EXTRA_BITS[i]))
        j = int(np.searchsorted(C.DIST_BASE, td, "right")) - 1
        bw.write_code(int(d_code[j]), int(d_len[j]))
        bw.write_bits(td - int(C.DIST_BASE[j]), int(C.DIST_EXTRA_BITS[j]))
    nbits = bw.bit_length
    return int.from_bytes(bytes(bw.out) + bytes([bw.bitbuf]), "little"), nbits


def _packed(ll_len, d_len):
    ll_code, d_code = bt._encode_tables(ll_len, d_len)
    return ek.pack_tables(ll_code, ll_len, d_code, d_len)


def test_encode_fields_equals_reference_within_32_bits():
    """Every length at the ends of its class at the ends of every distance
    class, every literal, disabled slots of garbage: where a field fits 32
    bits ``val`` is the JAX kernel's; on every token its low 32 bits
    are."""
    ll_len, d_len = _tables(15, 1)
    ll_code, d_code = bt._encode_tables(ll_len, d_len)
    lt, dt = ek.pack_tables(ll_code, ll_len, d_code, d_len)
    lt_j, dt_j = jek.pack_tables(*(jnp.asarray(x[None]) for x in
                                   (ll_code, ll_len, d_code, d_len)))
    ends = np.r_[C.DIST_BASE[:30], C.DIST_BASE[:30]
                 + (1 << C.DIST_EXTRA_BITS[:30]) - 1]
    lens, dists = np.meshgrid(np.arange(3, 259), ends, indexing="ij")
    n = 256 * 128
    rng = np.random.default_rng(13)
    tv = rng.integers(-50, 600, n)
    td = rng.integers(-5, 40000, n)
    en = rng.integers(0, 2, n)
    k = lens.size
    tv[:k], td[:k], en[:k] = lens.ravel(), dists.ravel(), 1
    tv[k:k + 256], td[k:k + 256], en[k:k + 256] = np.arange(256), 0, 1
    tv, td, en = (x.astype(np.int32) for x in (tv, td, en))
    jv, jn = jek.encode_fields(*(jnp.asarray(x.reshape(-1, 128))
                                 for x in (tv, td, en)), lt_j, dt_j)
    jv = np.asarray(jv).ravel().astype(np.uint32).astype(np.int64)
    jn = np.asarray(jn).ravel()
    val, nb = (x.numpy() for x in ek.encode_fields(_t(tv), _t(td), _t(en),
                                                   lt, dt))
    assert val.dtype == np.int64 and np.array_equal(nb, jn)
    on = en > 0
    fits = on & (nb <= 32)
    assert np.array_equal(val[fits], jv[fits])
    assert np.array_equal(val & _MASK32, jv)
    assert fits[:k].sum() > k // 2 and (nb[:k] > 32).any()
    assert not (val[on] >> nb[on]).any()


def test_encode_fields_keeps_fields_of_33_to_48_bits():
    """15-bit codes on the longest lengths (227-257, 5 extra bits) at the
    farthest distances (16,385-32,768, 13 extra bits): each field equals
    the one the port's ``refmodel`` bit writer writes, bit count and
    all."""
    ll_len, d_len = deep_tables()
    assert ll_len[284] == 15 and d_len[28] == d_len[29] == 15
    rng = np.random.default_rng(14)
    n = 4096
    tv = rng.integers(227, 258, n).astype(np.int32)
    td = rng.integers(16385, 32769, n).astype(np.int32)
    tv[:4], td[:4] = [227, 257, 257, 258], [16385, 32768, 24577, 32768]
    lt, dt = _packed(ll_len, d_len)
    val, nb = ek.encode_fields(_t(tv), _t(td), torch.ones(n, dtype=torch.int32),
                               lt, dt)
    want = [_field(ll_len, d_len, a, b) for a, b in zip(tv.tolist(),
                                                        td.tolist())]
    assert val.numpy().tolist() == [w[0] for w in want]
    assert nb.numpy().tolist() == [w[1] for w in want]
    assert nb[:3].tolist() == [48, 48, 48] and nb.min() > 32


def test_pack_rows_turbo_places_tokens_over_three_words():
    """Lanes of 48-bit matches between literals, behind a 17-bit header:
    the tokens starting late in a word span three, some words hold no
    token's start, and the packed block equals the bits the ``refmodel``
    bit writer writes, through ``pack_payload_turbo`` (the rows added at
    their words) and ``pack_payload_turbo_dense``."""
    ll_len, d_len = deep_tables()
    lt, dt = _packed(ll_len, d_len)
    rng = np.random.default_rng(15)
    L, T, nseg, hdr = 4, 40, 2, 17
    is_m = rng.random((L, T)) < 0.6
    tv = np.where(is_m, rng.integers(227, 258, (L, T)),
                  rng.integers(0, 256, (L, T))).astype(np.int32)
    td = np.where(is_m, rng.integers(16385, 32769, (L, T)), 0).astype(np.int32)
    cnt = np.array([40, 23, 31, 0])
    valid = np.arange(T)[None, :] < cnt[:, None]
    tv, td = np.where(valid, tv, 0), np.where(valid, td, 0)
    hdr_bits = torch.full((L // nseg,), hdr, dtype=torch.int32)
    R = 2 + (hdr + 48 * T + 31) // 32
    args = (_t(tv), _t(td), _t(valid), lt, dt, hdr_bits)
    rows, lane_tot, lane_bit0, payload_end, _, _ = dk.pack_rows_turbo(
        *args, nseg=nseg, R=R)
    W = 2 * R
    words, pe, lb0, _, _ = dk.pack_payload_turbo(*args, nseg=nseg, W=W, R=R)
    assert torch.equal(pe, payload_end) and torch.equal(lb0, lane_bit0)
    for b in range(L // nseg):
        bw = refmodel.BitWriter()
        bw.write_bits(0, hdr)
        starts = []
        for lane in range(b * nseg, (b + 1) * nseg):
            for j in range(int(cnt[lane])):
                v, nbits = _field(ll_len, d_len, int(tv[lane, j]),
                                  int(td[lane, j]))
                starts.append((bw.bit_length, nbits))
                bw.write_bits(v, nbits)
        assert int(payload_end[b]) == bw.bit_length
        blob = bytes(bw.out) + bytes([bw.bitbuf]) + bytes(4 * W)
        want = np.frombuffer(blob[:4 * W], "<u4").astype(np.int64)
        assert np.array_equal(words[b].numpy(), want)
        # a token that covers parts of three words, and a word in which no
        # token starts
        assert any((s & 31) + n > 64 for s, n in starts)
        first = {s >> 5 for s, _ in starts}
        assert set(range(hdr >> 5, bw.bit_length >> 5)) - first
    eob = 7
    dense, pe2, _, _, _ = dk.pack_payload_turbo_dense(*args, eob_len=eob,
                                                      nseg=nseg, R=R)
    used = (payload_end + eob + 31) // 32 + 1
    off = 0
    for b in range(L // nseg):
        n = int(used[b])
        got = dense[off:off + n].numpy().astype(np.int64) & _MASK32
        assert np.array_equal(got, words[b, :n].numpy())
        off += n
    assert torch.equal(pe2, payload_end)
