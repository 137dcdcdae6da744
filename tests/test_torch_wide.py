"""The PyTorch port's wide (default-profile) inflate, stage by stage, against
the JAX package.

The same default-profile streams (made by the JAX encoder at test time)
go through each JAX stage (Pallas kernels in interpret mode on the CPU)
and through the port's counterpart (plain PyTorch versions on the CPU).
Every array is an integer array or bytes, so every comparison is exact.
Hand-assembled fixed-Huffman streams (``test_torch_fixed_streams.py``)
check the port's repairs of the reference, against CPython zlib and the
refmodel.  The JAX package is the reference only: an index it made is
carried across with ``index_from_reference`` before the port sees it, and
every error expected from a port call is the port's own class.
"""
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from zlibes_tpu.codec import inflate_pipeline as jip
from zlibes_tpu.codec import wide as jwd
from zlibes_tpu.codec.deflate_pipeline import deflate_raw_tpu
from zlibes_tpu.codec.turbo import _from_grid, _to_planes
from zlibes_tpu.config import CodecConfig
from zlibes_tpu.ops import wide_kernel as jwk

import zlibes_tpu_torch
from zlibes_tpu_torch import ChecksumError, CorruptError, index_from_reference
from zlibes_tpu_torch.bench_corpus import bench_data
from zlibes_tpu_torch.codec import wide as wd
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.ops import wide_kernel as wk
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec import refmodel
from zlibes_tpu_torch.spec.refmodel import block_from_reference
from test_torch_fixed_streams import expand, fixed_lane, fixed_stream

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "golden"
CFG = CodecConfig.from_level(4)
BS = 16384  # small blocks keep the interpret-mode reference fast


def _rle(seed=7):
    # 258-byte matches skip whole 128-B sub-spans: empty decode lanes and
    # boundary-covering tokens found several lanes back
    rng = np.random.default_rng(seed)
    return (b"A" * 5000 + b"xyz" + b"B" * 9000
            + rng.integers(0, 256, 100, dtype=np.uint8).tobytes()) * 3


def _mixed(seed=5):
    # stored and coded blocks: the output is spliced, not flattened
    rng = np.random.default_rng(seed)
    return ((b"the quick brown fox jumps " * 800)
            + rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
            + (b"lorem ipsum dolor " * 900))


STREAMS = {
    "text": lambda: b"It was the best of times, it was the worst of times. "
                    * 1500,
    "rle": _rle,
    "mixed": _mixed,
    # low-ratio coded data maximizes per-lane stream words (SW bucket)
    "literal": lambda: np.random.default_rng(11).integers(
        0, 16, 60000, dtype=np.uint8).tobytes(),
    "tiny": lambda: b"This is zlib.es",
}


def _container(body: bytes, index, data: bytes):
    """The zlib container around a raw stream, and its index."""
    return (C.ZLIB_HEADER + body + zlib.adler32(data).to_bytes(4, "big"),
            index.shifted(16))


def wide_plan_from_reference(jp) -> wd.WidePlan:
    """The port's CPU plan from a JAX ``WidePlan``: undoes the TPU lane grid
    (1024-lane grid steps), folds the grouped fetch's 128-word block index
    and residue into one start word per lane, and takes table row ``cb``
    from grid step ``cb*LPB // 1024``, sublane ``(cb*LPB % 1024) // 128``.
    Keeps the reference's padded row count."""
    def t(x):
        return torch.from_numpy(np.array(x, np.int32))

    LB = jp.LB
    p = wd.WidePlan()
    p.coded = [block_from_reference(b) for b in jp.coded]
    p.stored = [block_from_reference(b) for b in jp.stored]
    p.contiguous, p.total_out = jp.contiguous, jp.total_out
    p.Cb, p.LPB, p.SW, p.T = jp.Cb, jp.LPB, jp.SW, jp.T
    L = p.Cb * p.LPB
    p.words = t(np.asarray(jp.words).reshape(-1))
    lane = np.arange(L)
    grp, j = lane // jp.GF, lane % jp.GF
    ridx = np.asarray(jp.shift_idx)
    p.start_w = t(np.asarray(jp.starts_w)[grp] * 128 + ridx[grp, j * jp.SW])
    for name, src in (("bit0", jp.bit0), ("endb", jp.endb),
                      ("base", jp.base_g)):
        setattr(p, name, t(np.asarray(_from_grid(src, LB=LB))))
    step, sub = (lane[::p.LPB] // LB), (lane[::p.LPB] % LB) // 128
    p.lt = t(np.asarray(jp.lt)[step, sub])
    p.dt = t(np.asarray(jp.dt)[step, sub])
    return p


class Ref:
    """One stream with the JAX package's stage outputs, in lane order."""

    def __init__(self, data: bytes):
        self.data = data
        self.body, self.index = deflate_raw_tpu(data, block_size=BS,
                                                config=CFG)
        assert self.index.wide
        self.comp, self.cindex = _container(self.body, self.index, data)
        # the port's own copies of both indexes
        self.pindex = index_from_reference(self.index)
        self.pcindex = index_from_reference(self.cindex)
        jp = jwd.WidePlan.build(self.body, self.index)
        self.jplan = jp
        assert jp.coded
        LB = jp.LB
        lanes = jwd.wide_lanes(jp.words, jp.starts_w, jp.shift_idx,
                               GF=jp.GF, SW=jp.SW)
        self.windows = np.asarray(lanes)
        tg, sg, mg = jwk.decode_wide(_to_planes(lanes, LB=LB), jp.bit0,
                                     jp.endb, jp.base_g, jp.lt, jp.dt,
                                     T=jp.T, LB=LB)
        self.tokens = np.asarray(_from_grid(tg, LB=LB))
        self.starts = np.asarray(_from_grid(sg, LB=LB))
        self.meta = np.asarray(_from_grid(mg, LB=LB))
        toks, starts = jwd._glue_wide(tg, sg, mg[0], mg[4], mg[5], T=jp.T,
                                      Cb=jp.Cb, LPB=jp.LPB, LB=LB)
        self.toks = np.asarray(toks)
        self.gstarts = np.asarray(starts)
        self.rows = np.asarray(jwk.resolve_wide(toks, starts, NSUBB=jp.LPB))
        self.plan = wide_plan_from_reference(jp)
        # lanes that decode a sub-span of some block's output
        self.real = np.zeros(jp.Cb * jp.LPB, bool)
        for cb, b in enumerate(jp.coded):
            self.real[cb * jp.LPB : cb * jp.LPB + -(-b.out_len // 128)] = True


@pytest.fixture(scope="module", params=sorted(STREAMS))
def ref(request):
    return Ref(STREAMS[request.param]())


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# tables and plan

def test_constants_match_reference():
    for name in ("SUB", "MAX_TOKENS", "TOKENS_PAD", "LL_ROOT_BITS", "LL_ROOT",
                 "LL_SUB", "LL_W", "D_ROOT_BITS", "D_ROOT", "D_SUB_OFF",
                 "D_SUB", "D_W", "TOK_VAL_MASK", "TOK_DIST_SHIFT",
                 "TOK_DIST_MASK", "TOK_MATCH_BIT", "_KIND_LIT", "_KIND_EOB",
                 "_KIND_LEN", "_KIND_INVALID", "_SUB_FLAG", "START_PAD"):
        assert getattr(wk, name) == getattr(jwk, name), name


def test_decode_tables_match_reference(ref):
    for b in ref.index.blocks:
        if b.btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            ll, dl = jip._block_code_lengths(ref.body, b)
            for got, want in zip(wk.wide_decode_tables(ll, dl),
                                 jwk.wide_decode_tables(ll, dl)):
                assert np.array_equal(got, want)


def _long_code_lengths():
    # a complete canonical code: short codes + a deep tail of >9-bit codes
    ll = np.zeros(288, np.int64)
    ll[:9] = np.arange(1, 10)
    ll[9:12] = [11, 12, 13]
    ll[12:16] = 15
    ll[256:260] = 15
    d = np.zeros(32, np.int64)
    d[:2] = 1
    return ll, d


def test_decode_tables_two_level_long_codes():
    ll, d = _long_code_lengths()
    lt, dt = wk.wide_decode_tables(ll, d)
    jlt, jdt = jwk.wide_decode_tables(ll, d)
    assert np.array_equal(lt, jlt) and np.array_equal(dt, jdt)
    assert (lt[: wk.LL_ROOT] & wk._SUB_FLAG).any()
    # every defined symbol decodes back through the table pair
    codes = refmodel.canonical_codes(ll)
    for sym in np.nonzero(ll)[0]:
        l = int(ll[sym])
        rev = int(f"{int(codes[sym]):0{l}b}"[::-1], 2)
        e = int(lt[rev & (wk.LL_ROOT - 1)])
        if e & wk._SUB_FLAG:
            e = int(lt[wk.LL_ROOT + ((e >> 9) & 511)
                       + ((rev >> 9) & ((1 << (e & 15)) - 1))])
        assert (e & 15) == l, sym


def test_decode_tables_reject_long_codes():
    ll, d = _long_code_lengths()
    ll[0] = 16
    with pytest.raises(CorruptError, match="15-bit"):
        wk.wide_decode_tables(ll, d)


def test_plan_matches_reference(ref):
    jp = ref.jplan
    built = wd.WidePlan.build(ref.body, ref.pindex, "cpu")
    assert (built.total_out, built.contiguous) == (jp.total_out,
                                                   jp.contiguous)
    assert built.coded == [block_from_reference(b) for b in jp.coded]
    assert built.stored == [block_from_reference(b) for b in jp.stored]
    want = ref.plan
    assert (built.LPB, built.SW, built.T) == (want.LPB, want.SW, want.T)
    # the port keeps one row per coded block; the reference pads to 8
    assert built.Cb == len(jp.coded) <= want.Cb
    L = built.Cb * built.LPB
    real = ref.real[:L]
    assert torch.equal(built.start_w[real], want.start_w[: L][real])
    assert not built.start_w[~real].any()
    for name in ("bit0", "endb", "base"):
        got, exp = getattr(built, name), getattr(want, name)
        assert torch.equal(got, exp[:L]), name
        assert not exp[L:].any(), name
    # the lane ends the reference checks the decode against
    assert np.array_equal(built.endb.numpy(),
                          np.asarray(jp.lane_end_check, np.int32)[:L])
    for name in ("lt", "dt"):
        got, exp = getattr(built, name), getattr(want, name)
        assert torch.equal(got, exp[: built.Cb]), name
        assert not exp[built.Cb :].any(), name
    n = built.words.numel()
    assert torch.equal(built.words, want.words[:n])
    assert not want.words[n:].any()


def test_plan_rejects_bad_indexes(ref):
    idx = ref.pindex
    short = refmodel.StreamIndex(idx.blocks, idx.anchor_bit[:-1],
                                 idx.anchor_out[:-1], idx.anchor_block[:-1],
                                 wide=True)
    with pytest.raises(CorruptError, match="one anchor per 128 B"):
        wd.WidePlan.build(ref.body, short, "cpu")
    not_wide = refmodel.StreamIndex(idx.blocks, idx.anchor_bit,
                                    idx.anchor_out, idx.anchor_block)
    with pytest.raises(CorruptError, match="wide anchors"):
        wd.WidePlan.build(ref.body, not_wide, "cpu")


# ---------------------------------------------------------------------------
# device stages, each on the reference's own inputs

def test_lane_windows_match_reference(ref):
    p = wd.WidePlan.build(ref.body, ref.pindex, "cpu")
    win = tk.lane_windows(p.words, p.start_w, width=p.SW)
    assert win.shape == (p.Cb * p.LPB, p.SW)
    real = ref.real[: p.Cb * p.LPB]
    # the reference's padded lanes read from other offsets, by design
    assert np.array_equal(win.numpy()[real], ref.windows[: p.Cb * p.LPB][real])


def test_decode_matches_reference(ref):
    p = ref.plan
    tokens, starts, meta = wk.decode_wide(_t(ref.windows), p.bit0, p.endb,
                                          p.base, p.lt, p.dt, LPB=p.LPB,
                                          T=p.T)
    assert np.array_equal(meta.numpy(), ref.meta)
    emitted = np.arange(p.T)[:, None] < ref.meta[0][None, :]
    assert np.array_equal(tokens.numpy()[emitted], ref.tokens[emitted])
    assert np.array_equal(starts.numpy()[emitted], ref.starts[emitted])
    assert ref.meta[0].sum() > 0
    p.check_meta(meta.numpy())


def test_decode_from_stream_words_matches_window_form_and_reference(ref):
    """``decode_wide((words, start_w), ..., SW=)``, the form the pipeline
    calls, equals the form that is given the windows, and the JAX decode."""
    p = ref.plan
    tk.LAUNCHES.clear()
    tokens, starts, meta = wk.decode_wide((p.words, p.start_w), p.bit0,
                                          p.endb, p.base, p.lt, p.dt,
                                          LPB=p.LPB, T=p.T, SW=p.SW)
    tokens_w, starts_w, meta_w = wk.decode_wide(_t(ref.windows), p.bit0,
                                                p.endb, p.base, p.lt, p.dt,
                                                LPB=p.LPB, T=p.T)
    assert not tk.LAUNCHES
    assert torch.equal(meta, meta_w)
    assert torch.equal(tokens, tokens_w) and torch.equal(starts, starts_w)
    assert np.array_equal(meta.numpy(), ref.meta)
    emitted = np.arange(p.T)[:, None] < ref.meta[0][None, :]
    assert np.array_equal(tokens.numpy()[emitted], ref.tokens[emitted])
    assert np.array_equal(starts.numpy()[emitted], ref.starts[emitted])


def test_decode_wrapper_rejects_bad_sources(ref):
    p = ref.plan
    args = (p.bit0, p.endb, p.base, p.lt, p.dt)
    with pytest.raises(ValueError, match="needs the window width"):
        wk.decode_wide((p.words, p.start_w), *args, LPB=p.LPB)
    with pytest.raises(ValueError, match="window width"):
        wk.decode_wide((p.words, p.start_w), *args, LPB=p.LPB,
                       SW=wk.MAX_WINDOW_WORDS + 1)
    with pytest.raises(ValueError, match="do not split into rows"):
        wk.decode_wide((p.words, p.start_w[:-1].contiguous()), *args,
                       LPB=p.LPB, SW=p.SW)
    with pytest.raises(ValueError, match="pass 2\\*\\*31"):
        wk.decode_wide((p.words, p.start_w), *args, LPB=p.LPB, SW=p.SW,
                       T=1 << 30)


def test_glue_matches_reference(ref):
    p = ref.plan
    toks, starts = wd._glue_wide(_t(ref.tokens), _t(ref.starts),
                                 _t(ref.meta), p.Cb, p.LPB)
    assert np.array_equal(toks.numpy(), ref.toks)
    assert np.array_equal(starts.numpy(), ref.gstarts)


def test_resolve_matches_reference(ref):
    rows = wk.resolve_wide(_t(ref.toks), _t(ref.gstarts)).numpy()
    assert rows.shape == ref.rows.shape
    for cb, b in enumerate(ref.jplan.coded):
        n = b.out_len
        assert np.array_equal(rows[cb, :n], ref.rows[cb, :n])
        assert rows[cb, :n].tobytes() == ref.data[b.out_start :
                                                  b.out_start + n]


def test_run_wide_on_reference_plan(ref):
    rows = wd.run_wide(ref.plan).numpy()
    for cb, b in enumerate(ref.jplan.coded):
        assert rows[cb, : b.out_len].tobytes() == \
            ref.data[b.out_start : b.out_start + b.out_len]


def test_run_wide_pads_sub_spans_with_zeros(ref):
    """The port's own plan has one row per coded block, and a row's
    sub-spans past its block's output resolve to zeros."""
    plan = wd.WidePlan.build(ref.body, ref.pindex, "cpu")
    rows = wd.run_wide(plan).numpy()
    assert rows.shape == (len(ref.jplan.coded), plan.LPB * 128)
    for cb, b in enumerate(ref.jplan.coded):
        assert rows[cb, : b.out_len].tobytes() == \
            ref.data[b.out_start : b.out_start + b.out_len]
        assert not rows[cb, -(-b.out_len // 128) * 128 :].any()


# ---------------------------------------------------------------------------
# entry points

def test_inflate_matches_reference(ref):
    out = zlibes_tpu_torch.inflate(ref.comp, index=ref.pcindex, device="cpu")
    assert out == ref.data
    assert out == zlib.decompress(ref.comp)
    assert out == jip.inflate(ref.comp, index=ref.cindex)


def test_inflate_to_device_matches_reference(ref):
    spans = zlibes_tpu_torch.inflate_to_device(ref.comp, ref.pcindex,
                                               device="cpu")
    assert len(spans) == 1
    t, off, n = spans[0]
    assert (t.device.type, t.dtype, off, n) == ("cpu", torch.uint8, 0,
                                                len(ref.data))
    assert t[:n].numpy().tobytes() == ref.data
    if ref.jplan.contiguous:
        (jt, joff, jn), = jip.inflate_to_device(ref.comp, ref.cindex)
        assert (joff, jn) == (off, n)
        assert np.array_equal(np.asarray(jt)[:jn], t[:n].numpy())


def test_wide_launches_nothing_on_cpu(ref):
    tk.LAUNCHES.clear()
    zlibes_tpu_torch.inflate(ref.comp, index=ref.pcindex, device="cpu")
    assert sum(tk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("where", ["head", "across", "tail"])
def test_inflate_range_matches_reference(ref, where):
    n = len(ref.data)
    start, length = {"head": (0, min(n, 100)),
                     "across": (min(BS - 70, max(0, n - 300)), min(n, 300)),
                     "tail": (n - min(n, 5), min(n, 5))}[where]
    length = min(length, n - start)
    got = zlibes_tpu_torch.inflate_range(ref.comp, ref.pcindex, start, length,
                                         device="cpu")
    assert got == ref.data[start : start + length]
    assert got == jip.inflate_range(ref.comp, ref.cindex, start, length)


@pytest.fixture(scope="module")
def fixture_stream():
    comp = (GOLDEN / "wide_bench.zz").read_bytes()
    index = refmodel.StreamIndex.load(GOLDEN / "wide_bench.idx.npz")
    return comp, index, bench_data()


@pytest.mark.parametrize("start,length", [(0, 100), (131070, 300),
                                          (400000, 80000), (262144, 1)])
def test_inflate_range_at_reference_seeks(fixture_stream, start, length):
    """The seeks of tests/test_wide.py, on the committed 128 KiB-block
    fixture, against CPython zlib's output."""
    comp, index, corpus = fixture_stream
    got = zlibes_tpu_torch.inflate_range(comp, index, start, length,
                                         device="cpu")
    assert got == corpus[start : start + length]


def test_inflate_range_rides_wide_path(fixture_stream, monkeypatch):
    comp, index, corpus = fixture_stream
    calls = []
    real = wd.inflate_raw_wide

    def spy(data, idx, device, check=True, stats=None):
        calls.append(idx.total_out)
        return real(data, idx, device, check, stats)

    monkeypatch.setattr(wd, "inflate_raw_wide", spy)
    assert zlibes_tpu_torch.inflate_range(comp, index, 262100, 100,
                                          device="cpu") == corpus[262100:262200]
    assert calls == [262144]  # two 128 KiB blocks, nothing more
    assert zlibes_tpu_torch.inflate_range(comp, index, 5, 0,
                                          device="cpu") == b""
    with pytest.raises(ValueError, match="outside output"):
        zlibes_tpu_torch.inflate_range(comp, index, len(corpus) - 1, 2,
                                       device="cpu")


def test_committed_fixture_decodes_on_cpu(fixture_stream):
    comp, index, corpus = fixture_stream
    assert index.wide and not index.turbo
    plan = wd.WidePlan.build(comp, index, "cpu")
    assert (plan.Cb, plan.LPB, plan.SW, plan.contiguous) == (30, 1024, 32,
                                                             True)
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == corpus


# ---------------------------------------------------------------------------
# corruption: each test names the exact error it expects

def test_checksum_error(ref):
    bad = ref.comp[:-1] + bytes([ref.comp[-1] ^ 1])
    with pytest.raises(ChecksumError):
        zlibes_tpu_torch.inflate(bad, index=ref.pcindex, device="cpu")
    assert zlibes_tpu_torch.inflate(bad, index=ref.pcindex, device="cpu",
                                    verify_checksum=False) == ref.data


def test_corrupt_lanes_raise_corrupt_error():
    """A flipped byte inside every decode lane makes lanes fail their meta
    checks (invalid codes, bad distances or a missed anchor), before any
    Adler-32; CPython zlib rejects the stream too."""
    data = b"some repetitive data " * 3000
    body, index = deflate_raw_tpu(data, block_size=BS,
                                  config=CodecConfig.from_level(2))
    comp, cindex = _container(body, index_from_reference(index), data)
    rng = np.random.default_rng(5)
    bad = bytearray(comp)
    bits = cindex.anchor_bit
    for lo, hi in zip(bits[:-1] // 8 + 1, bits[1:] // 8):
        if hi > lo:
            bad[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
    bad = bytes(bad)
    with pytest.raises(CorruptError):
        zlibes_tpu_torch.inflate(bad, index=cindex, device="cpu")
    with pytest.raises(zlib.error):
        zlib.decompress(bad)


# ---------------------------------------------------------------------------
# repairs of the reference's faults

_FIXED_TABLES = wk.wide_decode_tables(C.fixed_litlen_code_lengths(),
                                      C.fixed_dist_code_lengths())


def _one_lane(tokens, m: int, base: int = 0):
    """decode_wide's meta for lane ``m`` of a 128-lane block row holding
    ``tokens`` (every other lane empty)."""
    win, endb = fixed_lane(tokens, m)
    base_v = np.zeros(win.shape[0], np.int32)
    base_v[m] = base
    lt, dt = (torch.from_numpy(x[None]) for x in _FIXED_TABLES)
    _, _, meta = wk.decode_wide(_t(win), torch.zeros(win.shape[0],
                                                     dtype=torch.int32),
                                _t(endb), _t(base_v), lt, dt, LPB=128)
    return meta[:, m].tolist()


@pytest.mark.parametrize("tokens,m,base,ok", [
    ([(3, 1)], 0, 0, False),             # a match at the block's first byte
    ([97, (3, 2)], 0, 0, False),         # one byte back, distance two
    ([97, (3, 1)], 0, 0, True),
    ([(3, 129)], 1, 0, False),           # sub-span 1 starts at byte 128
    ([(3, 128)], 1, 0, True),
    ([(3, 131)], 1, 2, False),
    ([(3, 130)], 1, 2, True),
])
def test_decode_flags_distance_before_block_start(tokens, m, base, ok):
    count, _, err, active, _, _ = _one_lane(tokens, m, base)
    assert (err, active) == (0 if ok else 1, 0)
    assert count == (len(tokens) if ok else len(tokens) - 1)


def test_distance_before_block_start_raises_corrupt_error():
    """A stream whose first token copies from before the start: zlib and
    the refmodel reject it.  Its trailer is the Adler-32 of the bytes a
    resolve that clips the source to byte 0 produces, so without the
    distance check the port would return those bytes silently."""
    tokens = [(3, 1), 97, 98, 99]
    comp, index = fixed_stream([tokens], trailer=zlib.adler32(
        expand(tokens, clip=True)).to_bytes(4, "big"))
    with pytest.raises(zlib.error):
        zlib.decompress(comp)
    with pytest.raises(CorruptError):
        refmodel.inflate(comp)
    with pytest.raises(CorruptError, match="invalid Huffman data"):
        zlibes_tpu_torch.inflate(comp, index=index, device="cpu")


def test_fixed_block_tables_built_once(monkeypatch):
    blocks = [[104, 105, (4, 2)], [120] * 5,
              [97, 98, 99, (10, 3)], [33]]
    comp, index = fixed_stream(blocks)
    data = b"".join(expand(t) for t in blocks)
    assert zlib.decompress(comp) == data
    built = []
    real = wk.wide_decode_tables

    def spy(ll, dl):
        built.append(1)
        return real(ll, dl)

    monkeypatch.setattr(wk, "wide_decode_tables", spy)
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
    assert len(built) == 1
    assert zlibes_tpu_torch.inflate_range(comp, index, 2, 9,
                                          device="cpu") == data[2:11]


def test_non_self_contained_index_is_refused():
    """The seek and the wide plan refuse a chained index;
    ``inflate_to_device`` takes it through the group decode instead."""
    comp, index = fixed_stream([[97, 98, 99]])
    index.self_contained = False
    with pytest.raises(CorruptError, match="self-contained"):
        zlibes_tpu_torch.inflate_range(comp, index, 0, 1, device="cpu")
    with pytest.raises(CorruptError, match="self-contained"):
        wd.WidePlan.build(comp, index, "cpu")
    tk.LAUNCHES.clear()
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                        device="cpu")
    assert (off, n) == (0, 3) and out.numpy().tobytes() == b"abc"
    assert not tk.LAUNCHES
