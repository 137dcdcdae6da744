"""The ``zran`` configuration and its cell ``zran.range``: random reads of
stock-zlib streams from access points, as zlib's ``examples/zran.c`` makes
them.  The ``zran_index`` encoder entry, the plain reference
``reference/zran.py`` (CPython's ``zlib`` alone) against ``zlib`` and
against the port, the two readers of the cell's own metrics without a
device trace, and tiny runs of the cell on the CPU: sound, traced, and
under the ``grain`` control and the ``flip``, ``half`` and ``stale``
faults."""
import json
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import zlibes_tpu_torch as zt
from harness import spec
from reference import zran

from benchlib import BENCH, ROOT, run_cpu, tiny_copy
from test_bench_imports import top_imports

torch.set_num_threads(2)

CELL = "zran.range"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
RAW = (ROOT / "benchmark" / "data" / "raw.bin").read_bytes()


def _encoder(settings=None):
    cfg = spec.load_cell(ROOT / "BENCHMARK.json", CELL).config
    settings = settings or cfg["encoder"]
    return settings, spec.plugin(BENCH, "apis", "zran_index").make(
        settings, torch.device("cpu"), None)


def _mixed() -> bytes:
    """Text, 60,000 random bytes (which zlib stores), text."""
    rnd = np.random.default_rng(5).integers(0, 256, 60000, np.uint8)
    return RAW[:200000] + rnd.tobytes() + RAW[200000:400000]


def test_the_configuration_is_zrans():
    """zran.c's widths (1 MiB spacing, 32 KiB windows), stock zlib's
    defaults, the file equal to its entry, and the traffic of
    ``zlib6.range``, so that the two range cells differ in the index and
    the decoder alone."""
    entry = next(c for c in SPEC["configs"] if c["name"] == "zran")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert (cfg["source"], cfg["reduced"]) == (entry["source"],
                                               entry["reduced"])
    assert entry["reduced"] == ["read_files"]
    enc = cfg["encoder"]
    assert enc["api"] == "zran_index"
    assert (enc["level"], enc["window_bits"], enc["mem_level"]) == (6, 15, 8)
    assert enc["point_every"] == cfg["span"] == 1 << 20
    assert cfg["window_size"] == 1 << 15
    foreign = json.loads((BENCH / "configs" / "foreign.json").read_text())
    assert cfg["files"] == foreign["files"]
    assert cfg["read_files"] == ["nci", "samba", "dickens", "xml"]
    ours = spec.load_cell(ROOT / "BENCHMARK.json", CELL)
    theirs = spec.load_cell(ROOT / "BENCHMARK.json", "zlib6.range")
    assert ours.traffic == theirs.traffic and ours.chips == 1
    assert {m.name for m in ours.end_to_end} == {"range_p95_ms", "setup_s"}
    assert {m.name for m in theirs.per_layer} < {m.name
                                                 for m in ours.per_layer}


def test_zran_index_writes_stock_streams_with_points():
    settings, encode = _encoder(dict(_encoder()[0], point_every=65536))
    data = _mixed()
    stream, index = encode(data)
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8)
    assert stream == c.compress(data) + c.flush()
    assert zlib.decompress(stream) == data
    assert not index.self_contained
    starts = [index.blocks[b].out_start for b in index.point_block]
    assert starts[0] == 0 and index.point_window[0] == b""
    assert all(b - a >= 65536 for a, b in zip(starts, starts[1:]))
    assert all(w == data[o - 32768 : o] for o, w in
               zip(starts[1:], index.point_window[1:]))


def test_an_index_without_points_fails_at_once(monkeypatch):
    """A program whose ``build_index`` takes no ``point_every`` fails when
    the entry is made, before any stream is written."""
    from harness import codec

    def old_build_index(data, anchor_every=4096):
        raise AssertionError("never reached")

    monkeypatch.setattr(codec.zt, "build_index", old_build_index)
    with pytest.raises(TypeError, match="point_every"):
        _encoder()


def test_the_reference_imports_zlib_alone():
    assert top_imports(BENCH / "reference" / "zran.py") <= {"__future__",
                                                            "zlib"}


def test_the_empty_block_is_3_bits_over_a_byte():
    """The padding block that keeps a point's bit within its byte: 99 bits,
    accepted by inflate as a block that writes nothing."""
    bits = zran._EMPTY
    assert len(bits) == 99 and len(bits) % 8 == 3
    final = [1] + bits[1:]          # the same block, marked the last
    value = sum(b << i for i, b in enumerate(final))
    assert zlib.decompressobj(-15).decompress(value.to_bytes(13, "little")) \
        == b""


@pytest.mark.parametrize("every", [16384, 65536])
def test_the_reference_reads_what_zlib_wrote(every):
    """Seeded reads, reads at each point and across the stored stretch:
    the reference equals ``zlib.decompress`` and the port's read."""
    data = _mixed()
    stream = zlib.compress(data, 6)
    index = zt.build_index(stream, point_every=every)
    points = [(index.blocks[b].start_bit, index.blocks[b].out_start, w)
              for b, w in zip(index.point_block.tolist(), index.point_window)]
    assert {p[0] % 8 for p in points} != {0}
    rng = np.random.default_rng(every)
    reads = [(p[1], 3000) for p in points] + [(190000, 80000)]
    reads += [(int(s), int(rng.integers(0, 1 << 17)))
              for s in rng.integers(0, len(data) - (1 << 17), 12)]
    for s, n in reads:
        assert zran.read(stream, points, s, n) == data[s : s + n], (s, n)
    s, n = reads[-1]
    assert zt.inflate_range(stream, index, s, n, device="cpu") == \
        zran.read(stream, points, s, n)


def test_the_readers_read_nothing_without_a_device_trace():
    op = SimpleNamespace(work=lambda: {"reads": 10})
    for name in ("point_ms.zran", "decode_ms.zran"):
        read = spec.reader(BENCH, name)
        assert read(SimpleNamespace(op=op, trace=None)) is None, name
    read = spec.reader(BENCH, "decode_ms.zran")
    for trace in (SimpleNamespace(ops=[]),
                  SimpleNamespace(ops=[1], time_s=lambda pattern: 0.0)):
        assert read(SimpleNamespace(op=op, trace=trace)) is None
    kernels = SimpleNamespace(ops=[1], time_s=lambda pattern: 0.002)
    assert read(SimpleNamespace(op=op, trace=kernels)) == pytest.approx(0.4)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The benchmark at the tests' size, but for read files of several
    blocks each (a stream of one block is self-contained, and its reads
    take no point), with a point every 16 KiB so that they hold several."""
    out = tiny_copy(tmp_path_factory.mktemp("bench"))
    f = out.parent / "benchmark" / "configs" / "zran.json"
    cfg = json.loads(f.read_text())
    cfg["files"].update(a=300000, c=260000)
    cfg["encoder"]["point_every"] = 16384
    f.write_text(json.dumps(cfg))
    return out


def test_a_sound_run_is_correct(tiny):
    res = run_cpu(tiny, CELL)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"range_p95_ms", "setup_s"}
    assert res["checks"]["bad_reads"]["value"] == 0
    assert res["checks"]["bad_streams"]["value"] == 0


def test_a_traced_tiny_run_is_correct(tiny):
    res = run_cpu(tiny, CELL, trace=True)
    assert res["correct"], res["checks"]
    for name in ("point_ms.zran", "subindex_ms.range", "plan_ms.range",
                 "upload_ms.range"):
        assert res["metrics"][name]["value"] > 0, name
    assert res["metrics"]["range_p50_ms"]["value"] > 0
    # the CPU holds no device record: no device metric is written
    for name in ("decode_ms.zran", "device_ms.range", "idle_share.range"):
        assert name not in res["metrics"], name


@pytest.mark.parametrize("fault", ["flip", "half", "stale", "control"])
def test_faults_and_the_grain_control_are_caught(tiny, fault):
    kw = {"control": True} if fault == "control" else {"fault": fault}
    # the warm-up's answer is the first stale one
    res = run_cpu(tiny, CELL, seconds=3.0 if fault == "stale" else 1.0, **kw)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_reads"]["value"] > 0
