"""Hand-assembled fixed-Huffman DEFLATE streams with a wide index, and
tests of the assembler against CPython zlib and the refmodel.

Imports the port's ``spec`` only (no JAX, nothing of ``zlibes_tpu``), so
the card tests and ``chip_smoke.py`` use it too.  A block is a list of
tokens: an int is a literal byte, a pair (length, distance) a match.  Every
block here produces at most 128 output bytes, so its one wide anchor sits
at its payload start.
"""
from __future__ import annotations

import zlib

import numpy as np
import pytest

from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec import refmodel
from zlibes_tpu_torch.spec.errors import CorruptError
from zlibes_tpu_torch.spec.refmodel import (
    BitWriter,
    BlockInfo,
    StreamIndex,
    canonical_codes,
)

_LL_LEN = C.fixed_litlen_code_lengths()
_LL_CODE = canonical_codes(_LL_LEN)
_D_LEN = C.fixed_dist_code_lengths()
_D_CODE = canonical_codes(_D_LEN)


def _sym(bw: BitWriter, sym: int, ll_len=_LL_LEN, ll_code=_LL_CODE) -> None:
    assert ll_len[sym], f"litlen symbol {sym} has no code"
    bw.write_code(int(ll_code[sym]), int(ll_len[sym]))


def write_tokens(bw: BitWriter, tokens, lengths=None) -> None:
    """Huffman codes of ``tokens`` (no block header, no EOB unless the
    tokens hold the symbol 256): the fixed codes, or the canonical codes of
    ``lengths`` = (litlen code lengths, distance code lengths)."""
    ll_len, d_len = lengths if lengths is not None else (_LL_LEN, _D_LEN)
    ll_code, d_code = ((canonical_codes(ll_len), canonical_codes(d_len))
                       if lengths is not None else (_LL_CODE, _D_CODE))
    for tok in tokens:
        if isinstance(tok, int):
            _sym(bw, tok, ll_len, ll_code)
            continue
        length, dist = tok
        _sym(bw, int(C.LENGTH_TO_SYMBOL[length]), ll_len, ll_code)
        i = int(C.LENGTH_TO_SYMBOL[length]) - 257
        bw.write_bits(int(C.LENGTH_TO_EXTRA[length]),
                      int(C.LENGTH_EXTRA_BITS[i]))
        d = int(C.DIST_TO_SYMBOL[dist])
        assert d_len[d], f"distance symbol {d} has no code"
        bw.write_code(int(d_code[d]), int(d_len[d]))
        bw.write_bits(int(C.DIST_TO_EXTRA[dist]), int(C.DIST_EXTRA_BITS[d]))


def fixed_lane(tokens, m: int, lanes: int = 128, sw: int = 8, lengths=None):
    """Lane windows (lanes, sw) int32 and end bits (lanes,) int32 where lane
    ``m`` holds ``tokens`` and an end-of-block from bit 0 (in the fixed
    codes, or those of ``lengths``), and every other lane is empty."""
    bw = BitWriter()
    write_tokens(bw, list(tokens) + [C.END_OF_BLOCK], lengths)
    nbits = bw.bit_length
    raw = bw.getvalue()
    words = np.frombuffer(raw + bytes(-len(raw) % 4), "<i4")
    assert words.size <= sw
    win = np.zeros((lanes, sw), np.int32)
    win[m, : words.size] = words
    endb = np.zeros(lanes, np.int32)
    endb[m] = nbits
    return win, endb


def expand(tokens, clip: bool = False) -> bytes:
    """The bytes ``tokens`` decode to.  With ``clip``, a source before the
    start reads byte 0's value, as a resolve that clips sources would."""
    out = bytearray()
    for tok in tokens:
        if isinstance(tok, int):
            out.append(tok)
            continue
        length, dist = tok
        for _ in range(length):
            src = len(out) - dist
            if src < 0:
                assert clip, "distance before the start of the output"
                out.append(out[0] if out else 0)
            else:
                out.append(out[src])
    return bytes(out)


def fixed_stream(blocks, trailer: bytes | None = None):
    """zlib stream of one fixed-Huffman block per entry of ``blocks``, and
    its wide index.  The Adler-32 trailer is that of the expanded blocks
    unless ``trailer`` is given."""
    bw = BitWriter()
    bw.write_bits(C.ZLIB_HEADER[0] | (C.ZLIB_HEADER[1] << 8), 16)
    infos, out_start = [], 0
    for i, tokens in enumerate(blocks):
        start = bw.bit_length
        bw.write_bits(int(i == len(blocks) - 1), 1)
        bw.write_bits(C.BTYPE_FIXED, 2)
        payload = bw.bit_length
        write_tokens(bw, tokens)
        _sym(bw, C.END_OF_BLOCK)
        n = len(expand(tokens, clip=True))
        assert 0 < n <= 128
        infos.append(BlockInfo(C.BTYPE_FIXED, i == len(blocks) - 1, start,
                               payload, bw.bit_length, out_start, n))
        out_start += n
    body = bw.getvalue()
    if trailer is None:
        trailer = zlib.adler32(b"".join(expand(t) for t in blocks)
                               ).to_bytes(4, "big")
    index = StreamIndex(
        infos,
        np.array([b.payload_start_bit for b in infos], np.int64),
        np.array([b.out_start for b in infos], np.int64),
        np.arange(len(infos), dtype=np.int32),
        wide=True)
    return body + trailer, index


@pytest.mark.parametrize("blocks", [
    [[97]],
    [[104, 105, (4, 2)], [120] * 5, [97, 98, 99, (10, 3)], [33]],
    [[7, 7, 7, (100, 3)], [0, 255, (125, 1)]],
])
def test_fixed_stream_decodes_in_zlib_and_refmodel(blocks):
    comp, index = fixed_stream(blocks)
    data = b"".join(expand(t) for t in blocks)
    assert zlib.decompress(comp) == data
    assert refmodel.inflate(comp) == data
    assert index.wide and index.total_out == len(data)
    assert [b.out_len for b in index.blocks] == [len(expand(t))
                                                 for t in blocks]


def test_fixed_stream_with_distance_before_start():
    comp, _ = fixed_stream([[(3, 1), 97]], trailer=bytes(4))
    with pytest.raises(CorruptError, match="before start"):
        refmodel.inflate(comp)
    assert expand([(3, 1), 97], clip=True) == bytes(3) + b"a"


def test_fixed_lane_holds_tokens_and_eob():
    win, endb = fixed_lane([97, (3, 1)], 5)
    assert win.shape == (128, 8) and endb.shape == (128,)
    assert not np.delete(win, 5, axis=0).any() and not np.delete(endb, 5).any()
    # 8 + (7 + 5) + 7 bits: a literal, a length-3 match, end-of-block
    assert endb[5] == 27
