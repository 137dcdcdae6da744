"""Adversarial inputs and determinism of the PyTorch port, on the CPU.

Malformed input must always surface as one of the port's typed errors (or,
where the corruption yields a stream canonical zlib itself accepts, produce
the identical bytes): never wrong output, never a hang.  Three decoders are
held to that: the port's numpy spec model (``spec/refmodel.py``), the
public ``zlibes_tpu_torch.inflate(..., device="cpu")`` without an index
(the native runtime), and the same call with a turbo or a wide index (the
lane decode and resolve in their plain PyTorch versions).

Imports the port only; CPython ``zlib`` is the oracle.
"""
import zlib

import numpy as np
import pytest
import torch

import zlibes_tpu_torch
from zlibes_tpu_torch import ChecksumError, CodecConfig, CorruptError
from zlibes_tpu_torch import ZlibError as CodecError
from zlibes_tpu_torch.codec import deflate_pipeline as dp
from zlibes_tpu_torch.ops import huffman
from zlibes_tpu_torch.spec import refmodel as rm
from zlibes_tpu_torch.spec.refmodel import BitWriter
from test_torch_contract_cases import zlib_flushed
from test_torch_fixed_streams import expand, fixed_stream

torch.set_num_threads(2)

CODELEN_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
                 14, 1, 15]


def _native(stream: bytes) -> bytes:
    return zlibes_tpu_torch.inflate(stream, device="cpu")


DECODERS = {"refmodel": rm.inflate, "native": _native}


def _dyn_header(hlit, hdist, hclen, clc_lens, body_bits=()):
    """Hand-build a dynamic block header (possibly malformed)."""
    bw = BitWriter()
    bw.write_bits(1, 1)   # BFINAL
    bw.write_bits(2, 2)   # BTYPE dynamic
    bw.write_bits(hlit - 257, 5)
    bw.write_bits(hdist - 1, 5)
    bw.write_bits(hclen - 4, 4)
    for i in range(hclen):
        bw.write_bits(clc_lens.get(CODELEN_ORDER[i], 0), 3)
    for val, n in body_bits:
        bw.write_bits(val, n)
    return b"\x78\x9c" + bw.getvalue() + b"\x00" * 8


def _reserved_symbol_stream():
    """A fixed-Huffman block whose first code is symbol 286 (reserved):
    symbols 280-287 are the 8-bit codes 11000000..11000111."""
    bw = BitWriter()
    bw.write_bits(1, 1)
    bw.write_bits(1, 2)
    bw.write_code(0b11000110, 8)
    return b"\x78\x9c" + bw.getvalue() + b"\x00" * 8


MALFORMED = {
    # three 1-bit code-length codes (symbols 0, 8, 7): Kraft sum > 1
    "oversubscribed_code": lambda: _dyn_header(257, 1, 6,
                                               {0: 1, 8: 1, 7: 1}),
    # a single 2-bit code: decoding any other bit pattern dies
    "incomplete_code": lambda: _dyn_header(257, 1, 5, {0: 2, 8: 1},
                                           body_bits=[(0b1, 2)] * 4),
    # HLIT = 287 > 286: forbidden by RFC 1951
    "hlit_out_of_range": lambda: _dyn_header(287, 1, 4, {0: 1, 8: 1}),
    "reserved_litlen_symbol": _reserved_symbol_stream,
}


@pytest.mark.parametrize("decoder", sorted(DECODERS))
@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_stream_rejected(case, decoder):
    with pytest.raises(CodecError):
        DECODERS[decoder](MALFORMED[case]())


def test_oversubscribed_code_rejected_by_table_builders():
    lengths = np.zeros((1, 19), np.int64)
    lengths[0, :3] = 1
    with pytest.raises(CorruptError):
        huffman.canonical_codes_batch(lengths)
    with pytest.raises(CorruptError):
        huffman.build_litlen_tables(
            np.pad(lengths, ((0, 0), (0, 288 - 19))), 15)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_distance_32768_at_boundary(decoder):
    """A valid back-reference at the full 32 KiB window must decode."""
    rng = np.random.default_rng(0)
    head = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    data = head + head[:300]      # canonical zlib emits distance 32768
    assert DECODERS[decoder](zlib.compress(data, 9)) == data


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_truncation_sweep(decoder):
    """Every proper prefix of a small stream raises a typed error."""
    comp = zlib.compress(b"truncation sweep target " * 8, 9)
    for cut in range(len(comp)):
        with pytest.raises(CodecError):
            DECODERS[decoder](comp[:cut])


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_corruption_fuzz_vs_oracle(decoder):
    """1000 random corruptions: wherever canonical zlib accepts, the decoder
    gives identical bytes or a typed error; wherever it rejects, a typed
    error: never wrong output, never a crash of any other kind."""
    rng = np.random.default_rng(7)
    data = (b"fuzz corpus: " * 50
            + rng.integers(0, 256, 400, dtype=np.uint8).tobytes()) * 2
    comp = bytearray(zlib.compress(data, 6))
    agree = 0
    for trial in range(1000):
        bad = bytearray(comp)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            expect = zlib.decompress(bytes(bad))
        except zlib.error:
            expect = None
        try:
            got = DECODERS[decoder](bytes(bad))
        except CodecError:
            continue    # stricter rejection than zlib is fine
        assert got == expect, f"trial {trial}: wrong bytes"
        agree += 1
    assert agree < 1000     # the fuzz is not vacuous


def _fuzz_data():
    rng = np.random.default_rng(9)
    return (b"device fuzz " * 900
            + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
            + b"ab" * 2000)


def _turbo_stream():
    cfg = CodecConfig.turbo(candidates=4, probe_words=4)
    data = _fuzz_data()
    comp, index = dp.deflate(data, with_index=True, config=cfg,
                             block_size=16384, device="cpu")
    assert index.turbo
    return data, comp, index


def _wide_stream():
    """Eight hand-assembled fixed-Huffman blocks with a wide index."""
    rng = np.random.default_rng(11)
    blocks = []
    for _ in range(8):
        lits = [int(x) for x in rng.integers(0, 256, 40)]
        blocks.append(lits + [(60, 7), (20, 33)] + lits[:8])
    comp, index = fixed_stream(blocks)
    assert index.wide
    return b"".join(expand(t) for t in blocks), comp, index


INDEXED = {"turbo": _turbo_stream, "wide": _wide_stream}


@pytest.fixture(scope="module", params=sorted(INDEXED))
def indexed_stream(request):
    return INDEXED[request.param]()


def test_corruption_fuzz_device_pipeline(indexed_stream):
    """A sweep of single-byte corruptions through the indexed decode (lane
    decode, glue, resolve, Adler-32): a typed error, or, where the flip
    lands in bits the decode never reads, the original bytes."""
    data, comp, index = indexed_stream
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
    rng = np.random.default_rng(9)
    raised = 0
    for _ in range(25):
        bad = bytearray(comp)
        bad[int(rng.integers(2, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            got = zlibes_tpu_torch.inflate(bytes(bad), index=index,
                                           device="cpu")
        except CodecError:
            raised += 1
        else:
            assert got == data
    assert raised >= 15


def test_corruption_fuzz_device_pipeline_without_index():
    """The same sweep through the public call without an index."""
    rng = np.random.default_rng(9)
    data = b"device fuzz " * 200
    comp = zlib.compress(data, 6)
    for _ in range(25):
        bad = bytearray(comp)
        bad[int(rng.integers(2, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            expect = zlib.decompress(bytes(bad))
        except zlib.error:
            expect = None
        try:
            got = _native(bytes(bad))
        except CodecError:
            continue
        assert got == expect


def test_determinism_repeat_runs():
    """Same input, identical bytes across runs: the default-config and the
    turbo encoder, and the indexed and un-indexed inflate."""
    rng = np.random.default_rng(3)
    data = (b"determinism " * 400
            + rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())
    for cfg in (CodecConfig(blocks_per_dispatch=2),
                CodecConfig.turbo(candidates=4, probe_words=4)):
        runs = [dp.deflate(data, with_index=True, config=cfg,
                           block_size=16384, device="cpu") for _ in range(2)]
        assert runs[0][0] == runs[1][0]
        assert np.array_equal(runs[0][1].anchor_bit, runs[1][1].anchor_bit)
        assert runs[0][1].wide != runs[0][1].turbo
    comp, index = runs[0]
    assert zlib.decompress(comp) == data
    assert {zlibes_tpu_torch.inflate(comp, index=index, device="cpu")
            for _ in range(3)} == {data}
    assert {_native(comp) for _ in range(3)} == {data}


def test_indexed_fuzz_batched_lanes():
    """One corruption inside every decode lane a round, 1000 and more in
    all, through the turbo lane decode: the public call raises every round,
    and without the checksum the decode either refuses or gives wrong bytes
    only inside corrupted lanes' spans, nearly all of which show it."""
    data, comp, index = _turbo_stream()
    barr = np.frombuffer(data, np.uint8)
    rng = np.random.default_rng(21)
    spans = index.anchor_bit // 8
    total = detected = 0
    while total < 1000:
        bad = bytearray(comp)
        corrupted = []
        for k in range(len(spans)):
            lo = int(spans[k]) + 1
            hi = int(spans[k + 1]) if k + 1 < len(spans) else len(bad) - 8
            if hi <= lo:
                continue
            bad[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
            corrupted.append(k)
        total += len(corrupted)
        with pytest.raises((CorruptError, ChecksumError)):
            zlibes_tpu_torch.inflate(bytes(bad), index=index, device="cpu")
        spans_out, = zlibes_tpu_torch.inflate_to_device(bytes(bad), index,
                                                        device="cpu")
        out = spans_out[0][: spans_out[2]].numpy()
        diff = out != barr
        for k in corrupted:
            o0 = int(index.anchor_out[k])
            o1 = (int(index.anchor_out[k + 1])
                  if k + 1 < len(index.anchor_out) else barr.size)
            detected += int(bool(diff[o0:o1].any()))
    assert total >= 1000
    assert detected >= 0.9 * total, (detected, total)


@pytest.fixture
def device_path(monkeypatch):
    """The public inflate with the native runtime unavailable: a stream
    without a turbo or wide index takes the device decodes (the scan, or
    the group decode of a generic index) in their plain versions."""
    from zlibes_tpu_torch.runtime import native

    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture(scope="module")
def generic_fuzz_stream():
    """About 100 KB of CPython zlib output with a full flush every 16 KiB,
    indexed by ``build_index`` with an anchor every 1 KiB: self-contained,
    neither turbo nor wide."""
    rng = np.random.default_rng(21)
    data = (b"indexed fuzz corpus with repeated structure " * 1500
            + rng.integers(0, 256, 30000, dtype=np.uint8).tobytes())
    comp = zlib_flushed(data, 16384)
    index = zlibes_tpu_torch.build_index(comp, anchor_every=1024)
    assert index.self_contained and not index.turbo and not index.wide
    return data, comp, index


def test_indexed_fuzz_batched_lanes_generic_index(generic_fuzz_stream,
                                                  device_path):
    """The twin of the reference's batched-lanes fuzz on a generic index:
    one corruption inside every decode lane a round, 1000 and more in all,
    through the group decode; the public call raises every round, and the
    device output either holds wrong bytes inside nearly every corrupted
    lane's span."""
    data, comp, index = generic_fuzz_stream
    barr = np.frombuffer(data, np.uint8)
    rng = np.random.default_rng(21)
    # each lane's bytes inside its block's payload (block headers stay
    # intact, so every corruption reaches a lane decode)
    blk = index.anchor_block
    ends = np.where(np.append(blk[1:] == blk[:-1], False),
                    np.roll(index.anchor_bit, -1),
                    [index.blocks[b].end_bit for b in blk])
    total = detected = 0
    while total < 1000:
        bad = bytearray(comp)
        corrupted = []
        for k in range(len(blk)):
            lo, hi = int(index.anchor_bit[k]) // 8 + 1, int(ends[k]) // 8 - 1
            if hi <= lo:
                continue
            bad[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
            corrupted.append(k)
        total += len(corrupted)
        with pytest.raises((CorruptError, ChecksumError)):
            zlibes_tpu_torch.inflate(bytes(bad), index=index, device="cpu")
        (out, _, n), = zlibes_tpu_torch.inflate_to_device(bytes(bad), index,
                                                          device="cpu")
        diff = out[:n].numpy() != barr
        for k in corrupted:
            o0 = int(index.anchor_out[k])
            o1 = (int(index.anchor_out[k + 1])
                  if k + 1 < len(index.anchor_out) else barr.size)
            detected += int(bool(diff[o0:o1].any()))
    assert total >= 1000
    assert detected >= 0.9 * total, (detected, total)


def test_corruption_fuzz_device_pipeline_without_index_on_device(
        device_path):
    """The twin of the reference's fuzz of its un-indexed device scan: the
    same sweep through the port's scan (the native runtime unavailable):
    CPython's bytes, or a typed error."""
    rng = np.random.default_rng(9)
    data = b"device fuzz " * 200
    comp = zlib.compress(data, 6)
    assert _native(comp) == data
    typed = 0
    for _ in range(25):
        bad = bytearray(comp)
        bad[int(rng.integers(2, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            expect = zlib.decompress(bytes(bad))
        except zlib.error:
            expect = None
        try:
            got = _native(bytes(bad))
        except CodecError:
            typed += 1
            continue
        assert got == expect
    assert typed >= 15
