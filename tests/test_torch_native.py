"""The port's native runtime (``zlibes_tpu_torch/runtime/native.py`` and its
own ``zscan.cc``): the structure scan, the resolver, the speculative-parallel
scan against the serial one, foreign-stream indexes through the public
calls, and a long run of zero-length stored blocks.

The run of empty stored blocks.

``plausible_header`` in ``zlibes_tpu_torch/runtime/zscan.cc`` is the
candidate filter of the speculative-parallel scan: ``spec_worker`` calls it
at every bit of a span until a block chain decodes.  A zero-length stored
block carries no signal, so the filter's answer is that of the header after
it, and a span that starts inside a run of such blocks walks the whole rest
of the run: one loop turn a block (it was one stack frame a block).

How the scan is reached.  ``zlibes_tpu_torch.inflate(stream, device="cpu")``
without an index (the device only names where an indexed stream would
decode; such a stream decodes on the host either way) goes ``codec.inflate_pipeline._decode_native`` -> ``native.decode``
-> ``zdecode_parallel`` -> ``scan_parallel_impl``.  ``native.decode`` gives
the scan one thread less than the host has cores and spans of
``max(256 KiB, len // (2 * threads))`` bytes (at most 8 MiB);
``scan_parallel_impl`` speculates (``spec_worker`` -> ``plausible_header``)
when it has at least 2 threads and 2 spans, so on a host of 3 or more cores
a stream of 1.5 MB takes it through the public call.  On a smaller host the
public call scans serially; the direct ``native.decode`` and ``native.scan``
calls below name their threads and spans, so they speculate on any host,
with span starts placed exactly on block headers of the run.

Imports the port only.
"""
import zlib
from pathlib import Path

import numpy as np
import pytest

import zlibes_tpu_torch
from zlibes_tpu_torch import StreamIndex, errors
from zlibes_tpu_torch.runtime import native
from zlibes_tpu_torch.spec import refmodel as rm

RAW = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()

EMPTY_STORED = b"\x00\x00\x00\xff\xff"    # BFINAL 0, BTYPE 00, LEN 0, NLEN ~0
N_EMPTY = 300_000
# a multiple of the 5-byte block: span k starts at stream byte 2 + k * SPAN,
# a block header of the run, with 250,000 more empty blocks behind it
SPAN = 250_000


@pytest.fixture(scope="module")
def run_stream():
    """(zlib stream, its data): the zlib header, N_EMPTY zero-length stored
    blocks, then a level-6 deflate body of seeded text-like data."""
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
             for n in rng.integers(2, 9, 400)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 400, 60_000))
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = co.compress(data) + co.flush()
    stream = (b"\x78\x9c" + EMPTY_STORED * N_EMPTY + body
              + zlib.adler32(data).to_bytes(4, "big"))
    assert zlib.decompress(stream) == data
    return stream, data


def test_inflate_decodes_a_long_run_of_empty_stored_blocks(run_stream):
    stream, data = run_stream
    assert len(stream) > 2 * (1 << 18)        # at least two spans
    assert zlibes_tpu_torch.inflate(stream, device="cpu") == data


@pytest.mark.parametrize("threads", [2, 4])
def test_native_decode_speculates_inside_the_run(run_stream, threads):
    """Spans that start on a header inside the run: ``plausible_header``
    walks 250,000 empty blocks from the first of them."""
    stream, data = run_stream
    assert SPAN % len(EMPTY_STORED) == 0
    assert (N_EMPTY * len(EMPTY_STORED) - SPAN) // len(EMPTY_STORED) >= 200_000
    out, index, end_bit, adler = native.decode(
        stream, bit_offset=16, threads=threads, span_bytes=SPAN)
    assert out.tobytes() == data
    assert adler == zlib.adler32(data)
    assert -(-end_bit // 8) == len(stream) - 4   # the trailer follows
    empty = [b for b in index.blocks if b.out_len == 0]
    assert len(empty) >= N_EMPTY


def test_native_scan_parallel_equals_serial_on_the_run(run_stream):
    stream, data = run_stream
    tv1, td1, idx1, end1, n1 = native.scan(stream, bit_offset=16, threads=1)
    tv4, td4, idx4, end4, n4 = native.scan(stream, bit_offset=16, threads=4,
                                           span_bytes=SPAN)
    assert (end1, n1) == (end4, n4)
    assert (-(-end1 // 8), n1) == (len(stream) - 4, len(data))
    assert np.array_equal(tv1, tv4) and np.array_equal(td1, td4)
    assert len(idx1.blocks) == len(idx4.blocks) >= N_EMPTY
    assert np.array_equal(idx1.anchor_bit, idx4.anchor_bit)
    assert native.resolve(tv4, td4, n4).tobytes() == data


# ---------------------------------------------------------------------------
# scan, resolve and the indexes they make

def test_native_runtime_builds_here():
    assert native.available()


def test_scan_resolve_roundtrip():
    comp = zlib.compress(RAW, 6)
    tv, td, index, end_bit, out_len = native.scan(comp, bit_offset=16)
    assert out_len == len(RAW) == index.total_out
    assert bytes(native.resolve(tv, td, out_len)) == RAW
    assert (end_bit + 7) // 8 + 4 == len(comp)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_scan_all_levels_and_block_types(level):
    data = RAW[:120000]
    comp = zlib.compress(data, level)
    tv, td, _, _, out_len = native.scan(comp, 16)
    assert bytes(native.resolve(tv, td, out_len)) == data


def test_scan_detects_cross_block_refs():
    comp = zlib.compress(RAW, 6)          # several blocks, one shared window
    _, _, index, _, _ = native.scan(comp, 16)
    assert len(index.blocks) > 1 and not index.self_contained
    ours = rm.deflate(RAW[:200000])
    _, _, scanned, _, _ = native.scan(ours, 16)
    assert scanned.self_contained        # the encoder's blocks are independent


def test_scan_error_taxonomy():
    with pytest.raises(errors.TruncatedError):
        native.scan(zlib.compress(RAW[:5000])[:40], 16)
    bad = bytearray(zlib.compress(RAW[:5000], 9))
    bad[30] ^= 0x7F
    with pytest.raises((errors.CorruptError, errors.TruncatedError,
                        errors.BlockTypeError, errors.StoredBlockError)):
        tv, td, _, _, out_len = native.scan(bytes(bad), 16)
        native.resolve(tv, td, out_len)


def test_native_adler():
    assert native.adler32(RAW) == zlib.adler32(RAW)


def test_foreign_indexed_chained_decode():
    """``build_index`` on a foreign stream, then the indexed public call:
    chained blocks, so the stream decodes on the host and the index is held
    against what was decoded."""
    data = RAW * 4
    comp = zlib.compress(data, 6)
    index = zlibes_tpu_torch.build_index(comp)
    assert not index.self_contained
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data


def test_index_save_load(tmp_path):
    data = RAW[:100000]
    comp, index = zlibes_tpu_torch.deflate_indexed(data, backend="refmodel")
    assert (comp, index.blocks) == (lambda c, i: (c, i.blocks))(
        *rm.deflate(data, with_index=True))
    path = tmp_path / "stream.idx.npz"
    index.save(path)
    loaded = StreamIndex.load(path)
    assert loaded.blocks == index.blocks
    assert zlibes_tpu_torch.inflate(comp, index=loaded, device="cpu") == data


def _scan_tuple(comp, **kw):
    tv, td, idx, end_bit, out_len = native.scan(comp, **kw)
    blocks = [(b.btype, b.bfinal, b.start_bit, b.payload_start_bit,
               b.end_bit, b.out_start, b.out_len) for b in idx.blocks]
    return (tv.tobytes(), td.tobytes(), blocks, idx.anchor_bit.tobytes(),
            idx.anchor_out.tobytes(), idx.anchor_block.tobytes(), end_bit,
            out_len)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_parallel_scan_bit_identical(level):
    """The speculative-parallel scan splices spans bit-identically to the
    serial scan."""
    comp = zlib.compress(RAW * 6, level)[2:-4]
    assert _scan_tuple(comp, threads=1) == \
        _scan_tuple(comp, threads=2, span_bytes=1 << 17)


def test_parallel_scan_misspeculation_fallback():
    """Spans that land inside one giant block find no (or a wrong) block
    boundary: the merge rescans those spans serially and still gives the
    serial result."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 220000, dtype=np.uint8).tobytes()
    comp = rm.deflate(data, block_size=1 << 20)[2:-4]
    assert len(comp) > (1 << 16) * 2
    assert _scan_tuple(comp, threads=1) == \
        _scan_tuple(comp, threads=2, span_bytes=1 << 16)
    tv, td, _, _, out_len = native.scan(comp, threads=2, span_bytes=1 << 16)
    assert native.resolve(tv, td, out_len).tobytes() == data


def test_parallel_scan_stored_spans():
    """Streams of stored blocks (incompressible input) splice through the
    LEN/NLEN candidate filter."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 1 << 21, dtype=np.uint8).tobytes()
    comp = zlib.compress(data, 6)[2:-4]
    assert _scan_tuple(comp, threads=1) == \
        _scan_tuple(comp, threads=0, span_bytes=1 << 17)


def test_parallel_scan_fixed_block_stream_fallback():
    """A Z_FIXED stream holds fixed-Huffman blocks only, which the candidate
    filter never matches (every bit pattern parses as one): the whole scan
    falls back to the serial one and is still exact."""
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    comp = (co.compress(RAW * 4) + co.flush())[2:-4]
    assert len(comp) > (1 << 18)
    assert _scan_tuple(comp, threads=1) == \
        _scan_tuple(comp, threads=2, span_bytes=1 << 18)
