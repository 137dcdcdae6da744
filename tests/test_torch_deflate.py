"""The PyTorch port's turbo encoder, stage by stage, against the JAX package.

The same seeded inputs go through each JAX stage (Pallas kernels in
interpret mode on the CPU) and through the port's counterpart (plain
PyTorch versions on the CPU), at the shapes of one dispatch of
``CodecConfig.turbo(candidates=4, probe_words=4)`` with 16 KiB blocks.
Every array is an integer array or bytes, so every comparison is exact.
The JAX package is the reference only: the JAX encoder gets its own config,
the port the copy made by ``config_from_reference``.
"""
import dataclasses
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.config import CodecConfig as JaxCodecConfig
from zlibes_tpu.ops import deflate_kernel as jdk
from zlibes_tpu.ops import encode_kernel as jek
from zlibes_tpu.ops import entropy as jen
from zlibes_tpu.ops import lz77 as jlz

import zlibes_tpu_torch
from zlibes_tpu_torch import (
    CodecConfig,
    CodecStats,
    config_from_reference,
    index_from_reference,
)
from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.ops import deflate_kernel as dk
from zlibes_tpu_torch.ops import encode_kernel as ek
from zlibes_tpu_torch.ops import entropy as en
from zlibes_tpu_torch.ops import lz77
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.spec import constants as C

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# the reference's config for the JAX encoder, and the port's own copy of it
JCFG = JaxCodecConfig.turbo(candidates=4, probe_words=4)
CFG = config_from_reference(JCFG)
BS = 16384  # small blocks keep CPU compiles fast
BP = CFG.blocks_per_dispatch
NSEG = BS // CFG.seg_size
R = CFG.pack_row_width()


def _mixed_data(n=40000, seed=0):
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)
    rnd = rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()
    rle = b"A" * 1200 + b"ab" * 700 + bytes(range(256)) * 4
    out = (text + rnd + rle) * 3
    return out[:n]


# inputs of one dispatch: zero runs (the round-2 two-phase fault), dist-1
# runs past the probe cap, incompressible bytes, and a short last block
DISPATCH = {
    "mixed": lambda: _mixed_data(3 * BS + 5000),
    "zero_runs": lambda: bytes([4, 255, 255, 255]) + bytes(64)
    + _mixed_data(2 * BS) + bytes(3000) + b"\x00\x01" * 500,
    "rle": lambda: b"x" * 5000 + b"yz" * 3000 + b"x" * 300,
    "incompressible": lambda: np.random.default_rng(7).integers(
        0, 256, 12000, dtype=np.uint8).tobytes(),
}


def _rows(data: bytes):
    """(Bp, N + 8) block rows and (Bp,) valid counts of one dispatch."""
    arr = np.frombuffer(data, np.uint8)
    blk = np.zeros((BP, BS + 8), np.uint8)
    nv = np.zeros(BP, np.int32)
    for i in range(min(BP, -(-arr.size // BS))):
        c = arr[i * BS:(i + 1) * BS]
        blk[i, :c.size] = c
        nv[i] = c.size
    return blk, nv


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class Dispatch:
    """One dispatch through the JAX stages, as numpy."""

    def __init__(self, data: bytes):
        self.blk, self.nv = _rows(data)
        jb, jn = jnp.asarray(self.blk), jnp.asarray(self.nv)
        m = jlz.find_matches(jb, jn, N=BS, S=CFG.probe_words,
                             J=CFG.candidates, reset=CFG.chunk_reset,
                             two_phase=True)
        self.matches = np.asarray(m)
        self.sel = {}
        for lazy in (True, False):
            tv, td, cnt = dp._select_turbo_glue(jb, m, jn, N=BS,
                                                SEG_SIZE=CFG.seg_size,
                                                lazy=lazy, split_far=True)
            self.sel[lazy] = (np.asarray(tv), np.asarray(td), np.asarray(cnt))
        tv, td, cnt = self.sel[True]
        out = jdk.token_symbols(jnp.asarray(tv), jnp.asarray(td),
                                jnp.asarray(cnt), nseg=NSEG)
        self.symbols = [np.asarray(x) for x in out]


@pytest.fixture(scope="module", params=sorted(DISPATCH))
def disp(request):
    return Dispatch(DISPATCH[request.param]())


def _valid(cnt, T=CFG.seg_size):
    return np.arange(T)[None, :] < cnt[:, None]


def test_find_matches_matches_reference(disp):
    got = lz77.find_matches(_t(disp.blk), _t(disp.nv), N=BS,
                            S=CFG.probe_words, J=CFG.candidates,
                            reset=CFG.chunk_reset, two_phase=True)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), disp.matches)


def test_find_matches_takes_dist1_runs_past_probe_cap():
    disp = Dispatch(DISPATCH["rle"]())
    got = lz77.find_matches(_t(disp.blk), _t(disp.nv), N=BS,
                            S=CFG.probe_words, J=CFG.candidates,
                            reset=CFG.chunk_reset, two_phase=True).numpy()
    assert np.array_equal(got, disp.matches)
    ml, dist = got >> 16, got & 0xFFFF
    cap = 4 * CFG.probe_words + 3
    assert ((ml > cap) & (dist == 1)).any() and (ml == C.MAX_MATCH).any()
    # nothing reaches across a 4 KiB window reset
    pos = np.broadcast_to(np.arange(BS), ml.shape)
    m = ml >= 3
    assert (pos[m] % CFG.chunk_reset >= dist[m]).all()


@pytest.mark.parametrize("lazy", [True, False])
def test_select_turbo_plain_matches_reference(disp, lazy):
    tv, td, cnt = tdp.select_glue(_t(disp.blk), _t(disp.matches),
                                  _t(disp.nv), BS, lazy)
    jtv, jtd, jcnt = disp.sel[lazy]
    assert np.array_equal(cnt.numpy(), jcnt)
    v = _valid(jcnt)
    assert np.array_equal(tv.numpy()[v], jtv[v])
    assert np.array_equal(td.numpy()[v], jtd[v])
    assert not tv.numpy()[~v].any() and not td.numpy()[~v].any()


@pytest.mark.parametrize("lazy", [True, False])
def test_select_turbo_plain_matches_reference_on_random_matches(lazy):
    """Random packed matches (long and far ones included): the split_far
    cap, the segment-end clamp and the lazy defer, against the Pallas
    kernel."""
    rng = np.random.default_rng(5)
    blk, nv = _rows(_mixed_data(5 * BS + 777, seed=5))
    ml = rng.integers(0, C.MAX_MATCH + 1, (BP, BS))
    ml = np.where(rng.random((BP, BS)) < 0.4, 0, ml)
    dist = rng.integers(1, 4096, (BP, BS))
    matches = ((ml << 16) | dist).astype(np.int32)
    jtv, jtd, jcnt = (np.asarray(x) for x in dp._select_turbo_glue(
        jnp.asarray(blk), jnp.asarray(matches), jnp.asarray(nv), N=BS,
        SEG_SIZE=CFG.seg_size, lazy=lazy, split_far=True))
    tv, td, cnt = tdp.select_glue(_t(blk), _t(matches), _t(nv), BS, lazy)
    assert np.array_equal(cnt.numpy(), jcnt)
    v = _valid(jcnt)
    assert np.array_equal(tv.numpy()[v], jtv[v])
    assert np.array_equal(td.numpy()[v], jtd[v])
    assert (jtv[v & (jtd >= 2049)] <= 130).all()
    assert (jtv[v & (jtd > 0)] == 130).any()


def test_select_turbo_wrapper_checks_its_inputs():
    pv = torch.zeros((4, tk.SEL_SEG), dtype=torch.int32)
    slen = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tk.select_turbo(pv[:, :100].contiguous(), slen)
    with pytest.raises(ValueError, match="dtype"):
        tk.select_turbo(pv, slen.long())
    with pytest.raises(ValueError, match="contiguous"):
        tk.select_turbo(pv.t().contiguous().t(), slen)


def test_token_symbols_matches_reference(disp):
    tv, td, cnt = (_t(x) for x in disp.sel[True])
    lsym, dsym, valid, ll_freq, d_freq = dk.token_symbols(tv, td, cnt,
                                                          nseg=NSEG)
    jl, jd, jv, jll, jdf = disp.symbols
    assert np.array_equal(valid.numpy(), jv)
    assert np.array_equal(lsym.numpy()[jv], jl[jv])
    assert np.array_equal(dsym.numpy()[jv], jd[jv])
    assert np.array_equal(ll_freq.numpy(), jll)
    assert np.array_equal(d_freq.numpy(), jdf)
    assert ll_freq.sum() == int(cnt.sum())


def _entropy_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    ll = rng.integers(0, 5000, C.NUM_LITLEN_SYMBOLS)
    ll[rng.random(ll.size) < 0.3] = 0
    d = rng.integers(0, 800, C.NUM_DIST_SYMBOLS)
    d[30:] = 0
    if name == "single":
        ll = np.zeros_like(ll)
        ll[97] = 12
        d = np.zeros_like(d)
        d[5] = 3
    elif name == "no_dist":
        d = np.zeros_like(d)
    elif name == "clipped":     # above 2^29 / 4S: clipped before merging
        ll[:40] = rng.integers(1 << 20, 1 << 28, 40)
        d[:6] = [1 << 28, 1 << 27, 3 << 25, 9, 1, 700000]
    elif name == "skewed":      # geometric counts force the 9-bit limit
        ll = np.zeros_like(ll)
        ll[:40] = (1.6 ** np.arange(40)).astype(np.int64) + 1
        d[:30] = (2 ** np.arange(30)).clip(max=1 << 28)
    ll[C.END_OF_BLOCK] += 1
    return ll.astype(np.int32), d.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "single", "no_dist", "clipped",
                                  "skewed"])
def test_limited_lengths_pair_matches_reference(case):
    ll, d = _entropy_case(case)
    jll, jd = jen.limited_lengths_pair(jnp.asarray(ll), jnp.asarray(d), 9)
    got_ll, got_d = en.limited_lengths_pair(_t(ll), _t(d), 9)
    assert np.array_equal(got_ll.numpy(), np.asarray(jll))
    assert np.array_equal(got_d.numpy(), np.asarray(jd))
    assert got_ll.max() <= 9 and got_d.max() >= 1
    if case == "no_dist":
        assert got_d.tolist() == [1] + [0] * 31


def _tables(seed=3):
    rng = np.random.default_rng(seed)
    ll_len = dp.package_merge_np(rng.integers(1, 1000, C.NUM_LITLEN_SYMBOLS),
                                 9)
    d_len = dp.package_merge_np(np.r_[rng.integers(1, 300, 30), 0, 0], 9)
    ll_code, d_code = dp._encode_tables(ll_len, d_len)
    return ll_code, ll_len, d_code, d_len


def test_encode_fields_plain_matches_reference():
    """Every length 3..258 at the first and last distance of every distance
    class, every literal, and disabled slots holding garbage."""
    ll_code, ll_len, d_code, d_len = _tables()
    lt_j, dt_j = jek.pack_tables(*(jnp.asarray(x[None]) for x in
                                   (ll_code, ll_len, d_code, d_len)))
    lt, dt = ek.pack_tables(ll_code, ll_len, d_code, d_len)
    assert np.array_equal(lt.numpy(), np.asarray(lt_j)[0, :288])
    assert np.array_equal(dt.numpy(), np.asarray(dt_j)[0, :32])
    ends = np.r_[C.DIST_BASE[:30], C.DIST_BASE[:30]
                 + (1 << C.DIST_EXTRA_BITS[:30]) - 1]
    lens, dists = np.meshgrid(np.arange(3, 259), ends, indexing="ij")
    n = 256 * 128
    rng = np.random.default_rng(9)
    tv = rng.integers(-50, 600, n)
    td = rng.integers(-5, 40000, n)
    ena = rng.integers(0, 2, n)
    k = lens.size
    tv[:k], td[:k], ena[:k] = lens.ravel(), dists.ravel(), 1
    tv[k:k + 256], td[k:k + 256], ena[k:k + 256] = np.arange(256), 0, 1
    tv, td, ena = (x.astype(np.int32) for x in (tv, td, ena))
    jv, jn = jek.encode_fields(*(jnp.asarray(x.reshape(-1, 128))
                                 for x in (tv, td, ena)), lt_j, dt_j)
    val, nb = ek.encode_fields(_t(tv), _t(td), _t(ena), lt, dt)
    jv, jn = np.asarray(jv).ravel(), np.asarray(jn).ravel()
    on = ena > 0
    assert np.array_equal(nb.numpy(), jn)
    # the port keeps the whole field (up to 48 bits); the reference's is
    # its low 32 bits
    assert np.array_equal(val.numpy()[on] & 0xFFFFFFFF,
                          jv[on].astype(np.uint32))
    assert not nb.numpy()[~on].any()
    assert nb.numpy()[:k].max() > 32 >= nb.numpy()[:k].min()


def _pack_reference(disp, hdr_bits):
    """The JAX dense pack of a dispatch's tokens under its own tables."""
    tv, td, cnt = disp.sel[True]
    _jl, _jd, valid, llf, dfq = disp.symbols
    llt = llf.astype(np.int64).sum(0)
    llt[C.END_OF_BLOCK] += 1
    ll_len = dp.package_merge_np(llt, 9)
    d_len = dp.package_merge_np(dfq.astype(np.int64).sum(0), 9)
    if d_len.max(initial=0) == 0:
        d_len[0] = 1
    ll_code, d_code = dp._encode_tables(ll_len, d_len)
    eob = int(ll_len[C.END_OF_BLOCK])
    tabs = [jnp.asarray(np.broadcast_to(x, (BP, x.size)))
            for x in (ll_code, ll_len, d_code, d_len)]
    out = jdk.pack_payload_turbo_dense(
        jnp.asarray(tv), jnp.asarray(td), jnp.asarray(valid), *tabs,
        jnp.asarray(hdr_bits), jnp.ones(BP, bool), jnp.int32(eob),
        nseg=NSEG, R=R, F=80)
    lt, dt = ek.pack_tables(ll_code, ll_len, d_code, d_len)
    return [np.asarray(x) for x in out], (lt, dt, eob, valid)


def test_pack_payload_turbo_dense_matches_reference(disp):
    """Padded blocks (n_valid 0) and a short last block included."""
    hdr_bits = np.full(BP, 611, np.int32)
    hdr_bits[-(-int(disp.nv.sum()) // BS) - 1] = 613
    (jdense, jpe, jlb, jsb, jso), (lt, dt, eob, valid) = \
        _pack_reference(disp, hdr_bits)
    tv, td, _cnt = (_t(x) for x in disp.sel[True])
    dense, pe, lb, sb, so = dk.pack_payload_turbo_dense(
        tv, td, _t(valid), lt, dt, _t(hdr_bits), eob, nseg=NSEG, R=R,
        F=80)
    assert np.array_equal(pe.numpy(), jpe)
    assert np.array_equal(lb.numpy(), jlb)
    assert np.array_equal(sb.numpy(), jsb)
    assert np.array_equal(so.numpy(), jso)
    assert (disp.nv == 0).any() and (jsb == 1 << 30).any()
    used = int(((jpe.astype(np.int64) + eob + 31) // 32 + 1).sum())
    assert dense.dtype == torch.int32 and dense.numel() == jdense.size
    assert np.array_equal(dense.numpy()[:used],
                          jdense[:used].view(np.int32))


# ---------------------------------------------------------------------------
# the whole encoder

STREAMS = {
    "mixed": lambda: _mixed_data(),
    "rle": lambda: b"x" * 5000 + b"yz" * 3000 + b"x" * 300,
    "incompressible": lambda: np.random.default_rng(7).integers(
        0, 256, 12000, dtype=np.uint8).tobytes(),
    "empty": lambda: b"",
    "one_byte": lambda: b"Q",
    "exactly_N": lambda: _mixed_data(BS, seed=2),
    "N_plus_1": lambda: _mixed_data(BS + 1, seed=2),
}


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
    data = STREAMS[request.param]()
    jcomp, jindex = dp.deflate(data, with_index=True, config=JCFG,
                               block_size=BS)
    return data, jcomp, jindex


def test_deflate_matches_reference(encoded):
    data, jcomp, jindex = encoded
    comp, index = tdp.deflate(data, with_index=True, config=CFG,
                              block_size=BS, device="cpu")
    assert comp == jcomp
    assert _same_index(index, jindex)
    assert zlib.decompress(comp) == data
    if index.turbo:
        assert zlibes_tpu_torch.inflate(comp, index=index,
                                        device="cpu") == data
    else:
        # the empty input is one stored block, indexed as the reference
        # indexes it (no anchors), so it decodes without its index
        assert data == b"" and not index.anchor_bit.size
        assert zlibes_tpu_torch.inflate(comp, device="cpu") == data


def test_public_deflate_matches_pipeline(encoded):
    data, jcomp, _ = encoded
    stats = CodecStats()
    out = zlibes_tpu_torch.deflate(data, config=CFG, block_size=BS,
                                   stats=stats, device="cpu")
    assert out == jcomp
    assert stats.bytes_in == len(data) and stats.bytes_out == len(out)
    if data:
        assert stats.dispatches == 1
        assert {"match", "select", "symbols", "entropy", "pack",
                "readback"} <= set(stats.stage_s)


def test_trailer_is_adler32(encoded):
    data, jcomp, _ = encoded
    out = zlibes_tpu_torch.deflate(data, config=CFG, block_size=BS,
                                   device="cpu")
    assert int.from_bytes(out[-4:], "big") == zlib.adler32(data)


def test_recompute_path_is_byte_identical():
    """Beyond phase1_cache_blocks, phase 2 runs match and select again; with
    two blocks a dispatch the Adler-32 partial sums and histograms also
    combine across dispatches."""
    data = _mixed_data(5 * BS + 123, seed=4)
    jcomp, jindex = dp.deflate(data, with_index=True, config=JCFG,
                               block_size=BS)
    for cfg in (dataclasses.replace(CFG, phase1_cache_blocks=2),
                dataclasses.replace(CFG, phase1_cache_blocks=2,
                                    blocks_per_dispatch=2)):
        stats = CodecStats()
        comp, index = tdp.deflate(data, with_index=True, config=cfg,
                                  block_size=BS, stats=stats, device="cpu")
        assert comp == jcomp and _same_index(index, jindex)
        assert stats.dispatches == -(-6 // cfg.blocks_per_dispatch)
    assert int.from_bytes(comp[-4:], "big") == zlib.adler32(data)


@pytest.mark.parametrize("kwargs", [
    dict(level=6), dict(level=1, config=CFG), dict(), dict(config=None),
    dict(config=CodecConfig()), dict(config=CodecConfig.from_level(9)),
    dict(config=dataclasses.replace(CFG, max_code_bits=15)),
    dict(config=CFG, dictionary=b"a preset dictionary")])
def test_not_ported_raises_not_implemented(kwargs):
    """What the port once refused now encodes: a level, the default config,
    a dictionary (the general encoder), and a shared-tables config outside
    the turbo profile (the shared-table encoder, fields of up to 48
    bits)."""
    data = b"some bytes, and some bytes, and some more bytes"
    cfg = kwargs.get("config")
    out = zlibes_tpu_torch.deflate(data, device="cpu", block_size=4096,
                                   **kwargs)
    zdict = kwargs.get("dictionary")
    d = zlib.decompressobj(zdict=zdict) if zdict else zlib.decompressobj()
    assert d.decompress(out) == data
    assert zlibes_tpu_torch.inflate(out, dictionary=zdict,
                                    device="cpu") == data
    # the turbo profile where the config asks for it and no dictionary
    # forbids it, per-block tables elsewhere
    _, index = tdp.deflate(data, with_index=True, device="cpu",
                           block_size=4096, **kwargs)
    assert index.turbo == (cfg is CFG and zdict is None)


def test_deflate_modules_leave_jax_out():
    code = ("import sys, zlibes_tpu_torch\n"
            "from zlibes_tpu_torch import deflate, CodecConfig, CodecStats\n"
            "import zlibes_tpu_torch.codec.deflate_pipeline, "
            "zlibes_tpu_torch.ops.lz77, zlibes_tpu_torch.ops.entropy, "
            "zlibes_tpu_torch.ops.encode_kernel, "
            "zlibes_tpu_torch.ops.deflate_kernel\n"
            "out = deflate(b'abc' * 100, config=CodecConfig.turbo(), "
            "device='cpu')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'zlibes_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
