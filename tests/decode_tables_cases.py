"""Streams for ``decode_tables`` (``zlibes_tpu_torch.ops.decode_tables``)
and what the host parse makes of their blocks.

Each case is (stream, blocks): a zlib stream and the coded blocks whose
rows a plan asks for (BlockInfo: start bit, payload start bit, btype).
``CASES`` hold good headers: CPython's ``zlib`` at levels 1, 6 and 9, at
memLevel 9 and under ``Z_HUFFMAN_ONLY``, ``Z_RLE`` and ``Z_FIXED``, the
port's own level-6 fixture, and hand-made headers (15-bit codes, one
distance code, none, HLIT and HDIST at their most, empty tables, random
lengths).  ``ERRORS`` hold one bad block each and the error the host
raises for it.  ``expected`` runs the host path itself,
``_block_code_lengths`` and ``wide_decode_tables`` a block; the CPU test
holds the plain route to it, the card test the kernel to both.
"""
import zlib
from pathlib import Path

import numpy as np
import torch

import zlibes_tpu_torch
from zlibes_tpu_torch import CorruptError, StreamIndex, TruncatedError
from zlibes_tpu_torch.codec.inflate_pipeline import _block_code_lengths
from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.ops import decode_tables as dtab
from zlibes_tpu_torch.ops import huffman
from zlibes_tpu_torch.ops import wide_kernel as wk
from zlibes_tpu_torch.ops.inflate_kernel import stream_words
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec.refmodel import BitWriter, BlockInfo

GOLDEN = Path(__file__).resolve().parent / "golden"
RAW = (GOLDEN / "raw.bin").read_bytes()
ZLIB_HEADER = b"\x78\x9c"
# the payload start of a hand-made header's block: after the zlib header
START = 8 * len(ZLIB_HEADER)


def _cpython(level=6, mem_level=8, strategy=zlib.Z_DEFAULT_STRATEGY,
             size=160_000):
    c = zlib.compressobj(level, zlib.DEFLATED, 15, mem_level, strategy)
    comp = c.compress(RAW[:size]) + c.flush()
    blocks = zlibes_tpu_torch.build_index(comp).blocks
    return comp, [b for b in blocks
                  if b.btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC)]


def _port_level6():
    comp = (GOLDEN / "wide_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "wide_bench.idx.npz")
    return comp, [b for b in index.blocks if b.btype != C.BTYPE_STORED]


def header_stream(ll_len, d_len, tail: bytes = bytes(8)):
    """A zlib header, one final dynamic block's header for these lengths
    (``_dynamic_header``: HLIT and HDIST from the last used symbol), and
    ``tail``; (stream, its block, the header's bits)."""
    hdr, nbits = bt._dynamic_header(np.asarray(ll_len, np.int64),
                                    np.asarray(d_len, np.int64), 1)
    blk = BlockInfo(C.BTYPE_DYNAMIC, True, START, START + nbits,
                    START + nbits, 0, 100)
    return ZLIB_HEADER + hdr + tail, blk, nbits


def _hand(ll_len, d_len):
    comp, blk, _ = header_stream(ll_len, d_len)
    return comp, [blk]


def _chain(n: int) -> np.ndarray:
    """Lengths 1, 2, ..., n - 1, n - 1: a complete code of n symbols."""
    return np.array(list(range(1, n)) + [n - 1], np.int64)


def _deep15():
    """Complete litlen and distance codes down to 15 bits, symbols spread
    over the alphabets: every root prefix of a long code a sub-table of
    its own depth."""
    ll = np.zeros(C.NUM_LITLEN_SYMBOLS, np.int64)
    ll[np.arange(16) * 17 + 3] = _chain(16)
    d = np.zeros(C.NUM_DIST_SYMBOLS, np.int64)
    d[np.arange(16) * 2] = _chain(16)
    return _hand(ll, d)


def _fixed_lengths_with(d):
    return _hand(C.fixed_litlen_code_lengths()[:286], d)


def _single_dist():
    d = np.zeros(C.NUM_DIST_SYMBOLS, np.int64)
    d[0] = 1
    return _fixed_lengths_with(d)


def _no_dist():
    return _fixed_lengths_with(np.zeros(1, np.int64))


def _hlit_288():
    """HLIT 288 and HDIST 32: lengths for the reserved 286/287 and 30/31
    (invalid entries in the rows)."""
    return _hand(C.fixed_litlen_code_lengths(), C.fixed_dist_code_lengths())


def _empty_tables():
    return _hand(np.zeros(257, np.int64), np.zeros(1, np.int64))


def _random_lengths(seed: int):
    rng = np.random.default_rng(seed)
    llf = rng.integers(0, 5000, C.NUM_LITLEN_SYMBOLS) ** 3 \
        * (rng.random(C.NUM_LITLEN_SYMBOLS) < 0.7)
    df = rng.integers(0, 5000, C.NUM_DIST_SYMBOLS) ** 3 \
        * (rng.random(C.NUM_DIST_SYMBOLS) < 0.8)
    return _hand(bt.package_merge_np(llf, 15), bt.package_merge_np(df, 15))


CASES = {
    "zlib_level1": lambda: _cpython(level=1),
    "zlib_level6": lambda: _cpython(level=6),
    "zlib_level9": lambda: _cpython(level=9),
    "zlib_memlevel9": lambda: _cpython(mem_level=9),
    "zlib_huffman_only": lambda: _cpython(strategy=zlib.Z_HUFFMAN_ONLY),
    "zlib_rle": lambda: _cpython(strategy=zlib.Z_RLE),
    "zlib_fixed": lambda: _cpython(strategy=zlib.Z_FIXED, size=40_000),
    "port_level6": _port_level6,
    "deep_15_bits": _deep15,
    "single_distance_code": _single_dist,
    "no_distance_codes": _no_dist,
    "hlit_288_hdist_32": _hlit_288,
    "empty_tables": _empty_tables,
    "random_lengths_0": lambda: _random_lengths(0),
    "random_lengths_1": lambda: _random_lengths(1),
}


# ---------------------------------------------------------------------------
# bad headers: one block each

def _raw_header(hlit: int, hdist: int, clc: dict, syms: list, tail=b""):
    """A final dynamic block's header written bit by bit: HLIT - 257,
    HDIST - 1, the code-length code's lengths ``clc`` {symbol: length},
    then ``syms``: (code-length symbol, extra bits' value) coded by it."""
    bw = BitWriter()
    bw.write_bits(1, 1)
    bw.write_bits(C.BTYPE_DYNAMIC, 2)
    bw.write_bits(hlit - 257, 5)
    bw.write_bits(hdist - 1, 5)
    order = [int(s) for s in C.CODELEN_ORDER]
    hclen = max(4, max(order.index(s) for s in clc) + 1)
    bw.write_bits(hclen - 4, 4)
    for s in order[:hclen]:
        bw.write_bits(clc.get(s, 0), 3)
    lens = np.zeros(C.NUM_CODELEN_SYMBOLS, np.int64)
    for s, l in clc.items():
        lens[s] = l
    codes = huffman.canonical_codes_batch(lens[None])[0]
    extra = {16: 2, 17: 3, 18: 7}
    for s, v in syms:
        bw.write_code(int(codes[s]), int(lens[s]))
        if s in extra:
            bw.write_bits(v, extra[s])
    nbits = bw.bit_length
    body = bytes(bw.out) + (bytes([bw.bitbuf]) if bw.bitcnt else b"")
    blk = BlockInfo(C.BTYPE_DYNAMIC, True, START, START + nbits,
                    START + nbits, 0, 100)
    return ZLIB_HEADER + body + tail, [blk]


def _cut(comp: bytes, blocks, want_msg: str):
    """The stream cut to the first length at which the host parse raises
    ``want_msg``."""
    for n in range(len(ZLIB_HEADER) + 1, len(comp)):
        try:
            _block_code_lengths(comp[:n], blocks[0])
        except TruncatedError as e:
            if str(e) == want_msg:
                return comp[:n], blocks
    raise AssertionError(f"no cut raises {want_msg!r}")


def _good_header():
    return _fixed_lengths_with(np.full(30, 5, np.int64))


def _mismatch():
    comp, (blk,) = _good_header()
    blk.payload_start_bit += 1
    return comp, [blk]


def _oversubscribed():
    ll = np.zeros(C.NUM_LITLEN_SYMBOLS, np.int64)
    ll[[65, 66, 256]] = 1
    return _hand(ll, np.ones(1, np.int64))


def _sub_overflow():
    """An incomplete distance code (no over-subscription) whose 15-bit
    codes fall under two root prefixes: 1,024 sub-table entries, more than
    the 576 there are."""
    d = np.zeros(C.NUM_DIST_SYMBOLS, np.int64)
    d[:11] = [7, 8, 9, 10, 11, 12, 13, 14, 15, 15, 15]
    return _fixed_lengths_with(d)


# name -> (stream and blocks, the error the host raises)
ERRORS = {
    "no_previous_length": (lambda: _raw_header(
        257, 1, {0: 1, 16: 1}, [(16, 0)]),
        (CorruptError, "RLE repeat with no previous length")),
    "rle_overran": (lambda: _raw_header(
        257, 1, {0: 1, 18: 1}, [(18, 127), (18, 127)]),
        (CorruptError, "code length RLE overran table size")),
    "invalid_code": (lambda: _raw_header(257, 1, {0: 1}, [(0, 0)] * 3,
                                         tail=b"\xff"),
                     (CorruptError, "invalid Huffman code")),
    "index_mismatch": (_mismatch,
                       (CorruptError, "index does not match stream")),
    "oversubscribed": (_oversubscribed,
                       (CorruptError, "over-subscribed Huffman code")),
    "sub_table_overflow": (_sub_overflow, (
        CorruptError,
        "two-level sub-table overflow (non-canonical code lengths)")),
    "truncated_read": (lambda: _cut(*_good_header(), "bit stream overrun"),
                       (TruncatedError, "bit stream overrun")),
    "truncated_code": (lambda: _cut(*_good_header(),
                                    "bit stream overrun in Huffman code"),
                       (TruncatedError,
                        "bit stream overrun in Huffman code")),
}


def stream(name: str):
    """(stream, blocks) of a case of ``CASES`` or ``ERRORS``."""
    if name in CASES:
        return CASES[name]()
    return ERRORS[name][0]()


def inputs(comp: bytes, blocks, device="cpu"):
    """``decode_tables``' arguments: (words, hdr, total_bits)."""
    return (torch.from_numpy(stream_words(comp)).to(device),
            torch.from_numpy(dtab.headers(blocks)).to(device),
            len(comp) * 8)


def expected(comp: bytes, blocks):
    """The host path a block: (lt (NB, LL_W), dt (NB, D_W), status (NB,))
    int32 numpy, a bad block's rows zeros and its status the code of
    ``dtab.STATUS`` of what it raised."""
    NB = len(blocks)
    lt = np.zeros((NB, wk.LL_W), np.int32)
    dt = np.zeros((NB, wk.D_W), np.int32)
    status = np.zeros(NB, np.int32)
    for r, b in enumerate(blocks):
        try:
            lt[r], dt[r] = wk.wide_decode_tables(*_block_code_lengths(comp,
                                                                      b))
        except (CorruptError, TruncatedError) as e:
            status[r] = dtab.STATUS.index((type(e), str(e))) + 1
    return lt, dt, status


def indexes(comp: bytes, blocks):
    """A wide and a generic (self-contained) index of a one-block error
    stream: the block's 100 bytes of output, one anchor at its payload."""
    (blk,) = blocks
    out = []
    for wide in (True, False):
        out.append(StreamIndex(
            [blk], np.array([blk.payload_start_bit], np.int64),
            np.zeros(1, np.int64), np.zeros(1, np.int32), True, 0, False, 0,
            wide))
    return out
