"""The port's native runtime on a long run of zero-length stored blocks.

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

import numpy as np
import pytest

import zlibes_tpu_torch
from zlibes_tpu_torch.runtime import native

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
