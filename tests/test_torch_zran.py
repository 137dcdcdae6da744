"""Random reads of stock-zlib streams from access points, as zlib's
``examples/zran.c`` makes them: ``build_index(..., point_every=)`` keeps a
point at block 0 and at the first block boundary at or past every
``point_every`` bytes of output, each with the 32 KiB before it, and
``inflate_range`` of such a chained index decodes from the last point at or
before the read's start, behind that point's window, through the block that
holds its last byte, on the CPU here (plain versions of ``decode_tables``,
``decode_tokens`` and ``resolve_global``).

Streams of about 1 MB from CPython's ``zlib`` at levels 1, 6 and 9, and one
at level 6 with a stretch of random bytes that zlib stores, with a point
every 64 KiB.  Every read is held against ``zlib.decompress(stream)`` and
against the benchmark's plain reference (``benchmark/reference/zran.py``),
which reads the same range with CPython's ``zlib`` alone.  Imports the port
alone, but for one test that loads an index in the JAX package too.
"""
import importlib.util
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlibes_tpu_torch
from zlibes_tpu_torch import CodecStats, CorruptError, StreamIndex
from zlibes_tpu_torch.codec import inflate_pipeline as ip
from zlibes_tpu_torch.runtime import native
from zlibes_tpu_torch.spec import constants as C

_ZRAN = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
         / "zran.py")
_spec = importlib.util.spec_from_file_location("bench_zran", _ZRAN)
zran = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(zran)

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "golden"
RAW = (GOLDEN / "raw.bin").read_bytes()
P = 1 << 16             # output bytes between two access points
ANCHOR_EVERY = 1024     # short lanes keep the plain decode quick
W = C.WINDOW_SIZE


def _slices(n: int, seed: int) -> bytes:
    """``n`` bytes of seeded 16-64 KiB slices of raw.bin, as the
    benchmark's files are made."""
    ring = RAW + RAW[:1 << 16]
    rng = np.random.default_rng(seed)
    parts, have = [], 0
    while have < n:
        k = min(int(rng.integers(1 << 14, (1 << 16) + 1)), n - have)
        off = int(rng.integers(0, len(RAW)))
        parts.append(ring[off : off + k])
        have += k
    return b"".join(parts)


def _stored() -> bytes:
    """Text, 120,000 random bytes (stored by zlib), text."""
    rnd = np.random.default_rng(7).integers(0, 256, 120000, np.uint8)
    return _slices(450000, 8) + rnd.tobytes() + _slices(450000, 9)


def _stock(data: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8)
    return c.compress(data) + c.flush()


# name -> (data, zlib level)
STREAMS = {
    "level1": (lambda: _slices(1_000_000, 1), 1),
    "level6": (lambda: _slices(1_000_000, 6), 6),
    "level9": (lambda: _slices(1_000_000, 9), 9),
    "stored": (_stored, 6),
}


@pytest.fixture(scope="module")
def streams():
    out = {}
    for name, (make, level) in STREAMS.items():
        data = make()
        comp = _stock(data, level)
        out[name] = (data, comp, zlibes_tpu_torch.build_index(
            comp, anchor_every=ANCHOR_EVERY, point_every=P))
    return out


def _points(index):
    """The output offset of each access point."""
    return [index.blocks[b].out_start for b in index.point_block]


def _ref_points(index):
    """The index's points as the plain reference takes them."""
    return [(index.blocks[b].start_bit, index.blocks[b].out_start, w)
            for b, w in zip(index.point_block.tolist(), index.point_window)]


def test_the_streams_hold_their_features(streams):
    for name, (data, comp, index) in streams.items():
        assert zlib.decompress(comp) == data and len(data) >= 1_000_000
        assert not index.self_contained and not index.wide
        kinds = {b.btype for b in index.blocks}
        assert (C.BTYPE_STORED in kinds) == (name == "stored"), name
        assert len(index.point_block) >= 10, name


@pytest.mark.parametrize("name", list(STREAMS))
def test_points_fall_where_zran_puts_them(streams, name):
    """Block 0, then the first block boundary at or past every ``P`` bytes
    of output after the last point; each window the 32 KiB before its
    point; the blocks and anchors those of the scan without points."""
    data, comp, index = streams[name]
    starts = [b.out_start for b in index.blocks]
    want, last = [0], 0
    for b, o in enumerate(starts):
        if o - starts[last] >= P and o < len(data):
            want.append(b)
            last = b
    assert index.point_block.tolist() == want
    assert index.point_window[0] == b""
    for b, w in zip(want, index.point_window):
        o = starts[b]
        assert w == data[max(0, o - W) : o]
        assert len(w) == min(o, W)
    plain = zlibes_tpu_torch.build_index(comp, anchor_every=ANCHOR_EVERY)
    assert plain.point_block is None and plain.point_window is None
    assert plain.blocks == index.blocks
    for field in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(plain, field), getattr(index, field))


def _case(index, total: int, case: str, seed: int):
    """(start, length) of a read of the named kind."""
    pts = _points(index)
    mid = pts[len(pts) // 2]
    rng = np.random.default_rng(seed)
    if case == "at_zero":
        return 0, 3000
    if case == "last_byte":
        return total - 1, 1
    if case == "at_a_point":
        return mid, 20000
    if case == "in_the_window_after_a_point":
        return mid + 1000, 5000
    if case == "across_points":
        # from before one point to past the second after it
        k = len(pts) // 2
        return pts[k] - 500, pts[k + 2] - pts[k] + 1000
    if case == "empty":
        return mid + 7, 0
    start = int(rng.integers(0, total))
    return start, int(min(total - start, rng.integers(1024, 1 << 17)))


CASES = ["at_zero", "last_byte", "at_a_point", "in_the_window_after_a_point",
         "across_points", "empty", "seeded_a", "seeded_b", "seeded_c"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(STREAMS))
def test_a_read_equals_zlib_and_the_reference(streams, name, case,
                                              monkeypatch):
    """The read's bytes, what it decoded and what it uploaded: from the
    last point at or before the start through the block that holds the
    last byte, and those blocks' bytes of the stream alone."""
    data, comp, index = streams[name]
    start, length = _case(index, len(data), case,
                          seed=CASES.index(case) * 31 + len(name))
    uploads, spans = [], []
    real_upload, real_lanes = ip._to_device, ip._index_lanes

    def upload(arrays, device):
        uploads.append([np.array(a) for a in arrays])
        return real_upload(arrays, device)

    def lanes(index, b0=0, b1=None):
        if b1 is not None:
            spans.append((b0, b1))
        return real_lanes(index, b0, b1)

    monkeypatch.setattr(ip, "_to_device", upload)
    monkeypatch.setattr(ip, "_index_lanes", lanes)
    stats = CodecStats()
    got = zlibes_tpu_torch.inflate_range(comp, index, start, length,
                                         device="cpu", stats=stats)
    want = data[start : start + length]
    assert got == want == zlib.decompress(comp)[start : start + length]
    assert got == zran.read(comp, _ref_points(index), start, length)
    assert stats.bytes_out == length
    if length == 0:
        assert (stats.point_reads, stats.lead_bytes, uploads) == (0, 0, [])
        return
    pts = _points(index)
    k = int(np.searchsorted(pts, start, side="right")) - 1
    b0 = int(index.point_block[k])
    b1 = next(b for b, blk in enumerate(index.blocks)
              if blk.out_start + blk.out_len >= start + length)
    lead = start - pts[k]
    widest = max(b.out_len for b in index.blocks)
    assert (stats.point_reads, stats.lead_bytes) == (1, lead)
    assert 0 <= lead < P + widest
    # a read that lies in stored blocks alone is spliced, with no group
    coded = any(b.btype != C.BTYPE_STORED for b in index.blocks[b0 : b1 + 1])
    assert (stats.dispatches >= 1) == coded
    # the cut and the window go up first; the lanes are those of blocks
    # b0..b1; a span of one group then uploads its headers, each block
    # keeping its bit within a byte
    (cut, window), *rest = uploads
    byte0 = index.blocks[b0].start_bit >> 3
    assert cut.tobytes() == comp[byte0 : (index.blocks[b1].end_bit + 7) >> 3]
    assert window.tobytes() == index.point_window[k]
    assert spans == [(b0, b1)]
    if rest:
        ((hdr, *_),) = rest
        assert hdr[:, 0].tolist() == [
            b.start_bit - 8 * byte0 for b in index.blocks[b0 : b1 + 1]]


def test_a_coded_span_is_one_group_a_stored_one_the_group_decode(
        streams, monkeypatch):
    """A read whose blocks are all coded decodes as one group without the
    group decode's per-group readbacks; one whose span holds a stored block
    takes ``inflate_raw_indexed`` (its groups split at the stored block)
    with the same cut, words and window.  Both return zlib's bytes."""
    calls = []
    real = ip.inflate_raw_indexed

    def spy(cut, sub, device, **kwargs):
        calls.append((len(cut), kwargs["words"].numel(), kwargs["history"]))
        return real(cut, sub, device, **kwargs)

    monkeypatch.setattr(ip, "inflate_raw_indexed", spy)
    data, comp, index = streams["level6"]
    s = _points(index)[5] + 777
    stats = CodecStats()
    got = zlibes_tpu_torch.inflate_range(comp, index, s, 50000, device="cpu",
                                         stats=stats)
    assert got == data[s : s + 50000]
    assert (calls, stats.dispatches) == ([], 1)

    data, comp, index = streams["stored"]
    stored = [b for b in index.blocks if b.btype == C.BTYPE_STORED]
    s = stored[0].out_start - 3000
    e = stored[-1].out_start + stored[-1].out_len + 3000
    stats = CodecStats()
    got = zlibes_tpu_torch.inflate_range(comp, index, s, e - s, device="cpu",
                                         stats=stats)
    assert got == data[s:e]
    (n, nw, history), = calls
    assert nw == -(-n // 4) and history.numel() == W
    assert stats.dispatches >= 2


def test_the_counters_add_up_over_reads(streams):
    """One ``CodecStats`` over seeded reads: ``point_reads`` the reads,
    ``lead_bytes`` the leads worked out from the index."""
    data, comp, index = streams["level6"]
    pts = _points(index)
    rng = np.random.default_rng(3)
    stats, leads = CodecStats(), 0
    reads = [(int(s), int(rng.integers(1, 40000)))
             for s in rng.integers(0, len(data) - 40000, 4)]
    for s, n in reads:
        assert zlibes_tpu_torch.inflate_range(
            comp, index, s, n, device="cpu", stats=stats) == data[s : s + n]
        leads += s - pts[int(np.searchsorted(pts, s, side="right")) - 1]
    assert (stats.point_reads, stats.lead_bytes) == (len(reads), leads)
    assert stats.bytes_out == sum(n for _, n in reads)


def test_a_chained_index_without_points_still_raises(streams):
    data, comp, index = streams["level6"]
    plain = zlibes_tpu_torch.build_index(comp, anchor_every=ANCHOR_EVERY)
    with pytest.raises(CorruptError, match=r"point_every="):
        zlibes_tpu_torch.inflate_range(comp, plain, 100, 10, device="cpu")
    # a zero-length read is refused alike
    with pytest.raises(CorruptError, match=r"point_every="):
        zlibes_tpu_torch.inflate_range(comp, plain, 100, 0, device="cpu")


def _with_windows(index, windows):
    return StreamIndex(index.blocks, index.anchor_bit, index.anchor_out,
                       index.anchor_block, index.self_contained,
                       point_block=index.point_block, point_window=windows)


@pytest.mark.parametrize("name", ["level6", "stored"])
def test_a_corrupted_window_never_passes(streams, name):
    """Every window's bytes flipped: a read of the 32 KiB after a point
    gives other bytes or raises; every window cut to its last 100 bytes: a
    copy from past them escapes the history and raises.  (The third point
    lies in text, before the stored stretch.)"""
    data, comp, index = streams[name]
    mid = _points(index)[2]
    flipped = _with_windows(index, [bytes(x ^ 0x5A for x in w)
                                    for w in index.point_window])
    try:
        got = zlibes_tpu_torch.inflate_range(comp, flipped, mid, W,
                                             device="cpu")
    except CorruptError:
        got = None
    assert got != data[mid : mid + W]
    short = _with_windows(index, [w[-100:] for w in index.point_window])
    with pytest.raises(CorruptError):
        zlibes_tpu_torch.inflate_range(comp, short, mid, W, device="cpu")


def test_a_read_before_every_point_raises(streams):
    """An index whose first point is not at block 0 (not one that
    ``build_index`` makes) has no point for a read before it."""
    data, comp, index = streams["level6"]
    late = StreamIndex(index.blocks, index.anchor_bit, index.anchor_out,
                       index.anchor_block, index.self_contained,
                       point_block=index.point_block[1:],
                       point_window=index.point_window[1:])
    with pytest.raises(CorruptError, match="no access point"):
        zlibes_tpu_torch.inflate_range(comp, late, 10, 100, device="cpu")
    s = _points(index)[1]
    assert zlibes_tpu_torch.inflate_range(
        comp, late, s, 100, device="cpu") == data[s : s + 100]


def test_save_and_load_keep_the_points(streams, tmp_path):
    data, comp, index = streams["stored"]
    index.save(tmp_path / "zran.idx.npz")
    back = StreamIndex.load(tmp_path / "zran.idx.npz")
    assert back.point_block.tolist() == index.point_block.tolist()
    assert back.point_window == index.point_window
    assert back.blocks == index.blocks and not back.self_contained
    s = _points(index)[3] + 100
    assert zlibes_tpu_torch.inflate_range(
        comp, back, s, 9000, device="cpu") == data[s : s + 9000]
    # an index without points saves and loads without them
    plain = zlibes_tpu_torch.build_index(comp, anchor_every=ANCHOR_EVERY)
    plain.save(tmp_path / "plain.idx.npz")
    again = StreamIndex.load(tmp_path / "plain.idx.npz")
    assert again.point_block is None and again.point_window is None


@pytest.mark.parametrize("name", ["turbo_bench", "wide_bench"])
def test_the_goldens_load_as_before_in_both_packages(name):
    from zlibes_tpu.spec import refmodel as jrefmodel

    path = GOLDEN / f"{name}.idx.npz"
    ours, theirs = StreamIndex.load(path), jrefmodel.StreamIndex.load(path)
    assert ours.point_block is None and ours.point_window is None
    assert [b.out_start for b in ours.blocks] == [
        b.out_start for b in theirs.blocks]
    assert np.array_equal(ours.anchor_bit, theirs.anchor_bit)
    comp = (GOLDEN / f"{name}.zz").read_bytes()
    assert zlibes_tpu_torch.inflate_range(
        comp, ours, 131070, 300, device="cpu") == zlib.decompress(
            comp)[131070:131370]


def test_an_index_with_points_loads_in_the_jax_package(streams, tmp_path):
    """The JAX package reads the points' npz as an index without them."""
    from zlibes_tpu.spec import refmodel as jrefmodel

    _, _, index = streams["level1"]
    index.save(tmp_path / "zran.idx.npz")
    theirs = jrefmodel.StreamIndex.load(tmp_path / "zran.idx.npz")
    assert len(theirs.blocks) == len(index.blocks)
    assert np.array_equal(theirs.anchor_out, index.anchor_out)


def test_points_change_no_other_route(streams):
    """A self-contained stream keeps its route (no point span, no point
    counters); a chained one with points decodes whole as before."""
    from test_torch_contract_cases import zlib_flushed

    data = RAW[:200000]
    flushed = zlib_flushed(data, 32768)
    index = zlibes_tpu_torch.build_index(flushed, anchor_every=ANCHOR_EVERY,
                                         point_every=P)
    assert index.self_contained and index.point_block is not None
    stats = CodecStats()
    _, spans = _profiled(lambda: zlibes_tpu_torch.inflate_range(
        flushed, index, 70000, 5000, device="cpu", stats=stats))
    assert "zlibes.point" not in {n for n, _, _ in spans}
    assert (stats.point_reads, stats.lead_bytes, stats.bytes_out) == (
        0, 0, 5000)
    data6, comp6, index6 = streams["level6"]
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp6, index6,
                                                        device="cpu")
    assert (off, n) == (0, len(data6))
    assert out.numpy().tobytes() == data6


def test_build_index_decodes_once_with_points(monkeypatch):
    """With points, one host decode gives the blocks, anchors and windows;
    without them the scan alone runs, as before."""
    comp = _stock(RAW[:300000], 6)
    calls = []
    for fn in ("scan", "decode"):
        real = getattr(native, fn)
        monkeypatch.setattr(native, fn, lambda *a, _f=fn, _r=real, **k: (
            calls.append(_f), _r(*a, **k))[1])
    zlibes_tpu_torch.build_index(comp)
    zlibes_tpu_torch.build_index(comp, point_every=P)
    assert calls == ["scan", "decode"]


def _profiled(fn):
    """(what ``fn()`` returned, [(name, start ns, end ns)] of the
    ``zlibes.*`` spans of a CPU ``torch.profiler`` trace of it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("zlibes.")]
    return out, spans


def test_a_point_read_enters_its_spans(streams):
    """One root ``zlibes.inflate_range``; inside it one ``zlibes.point``
    holding the window's upload, then the sub-index, the plan (with its
    headers), the decode, the resolve and the readback of the range."""
    data, comp, index = streams["level9"]
    s = _points(index)[4] + 2000
    got, spans = _profiled(lambda: zlibes_tpu_torch.inflate_range(
        comp, index, s, 10000, device="cpu"))
    assert got == data[s : s + 10000]

    def of(name):
        return [(a, b) for n, a, b in spans if n == name]

    (root,) = of("zlibes.inflate_range")
    assert all(root[0] <= a <= b <= root[1] for _, a, b in spans)
    (point,) = of("zlibes.point")
    (sub,) = of("zlibes.subindex")
    assert point[1] <= sub[0]
    inside = [u for u in of("zlibes.upload")
              if point[0] <= u[0] <= u[1] <= point[1]]
    assert len(inside) == 1
    for name in ("zlibes.plan", "zlibes.headers", "zlibes.decode",
                 "zlibes.resolve"):
        assert len(of(name)) == 1, name
        assert of(name)[0][0] >= sub[1], name
    assert len(of("zlibes.readback")) >= 1
