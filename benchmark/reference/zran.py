"""Random reads of a zlib stream that someone else wrote, as zlib's
``examples/zran.c`` makes them, with the standard library's ``zlib`` alone.

An access point is (the bit of the stream at which a block starts, the
output offset of that block's first byte, the up to 32 KiB of output
before it).  A read of ``[start, start + length)`` inflates raw from the
last point at or before ``start``, with that point's window as the history
(``decompressobj(-15, zdict=window)``), and slices the output.

zran.c hands the inflater the bits of the point's first byte that belong to
the block (``inflatePrime``); CPython's ``zlib`` has no such call.  So the
bits before the block in that byte are replaced by empty blocks of as many
bits, modulo 8: the block then starts where it did within its byte, every
later stored block stays aligned on a byte, and the stream's bytes after the
first go to the inflater as they are.
"""
from __future__ import annotations

import zlib

# compressed bytes fed to the inflater at a time
CHUNK = 1 << 14

# code length codes in the order a dynamic header lists them (RFC 1951)
_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


def _bits(value: int, n: int) -> list[int]:
    """``n`` bits of ``value``, least significant first (a header field)."""
    return [(value >> i) & 1 for i in range(n)]


def _code(code: int, n: int) -> list[int]:
    """A Huffman code of ``n`` bits, most significant first."""
    return [(code >> (n - 1 - i)) & 1 for i in range(n)]


def _empty_dynamic_block() -> list[int]:
    """The bits of a dynamic block (BFINAL 0) that codes the end-of-block
    alone: 99 bits, 3 modulo 8.  The literal/length code is the end-of-block
    symbol's one code of length 1 and the distance code has no symbol,
    both of which inflate accepts."""
    # code length code: 18 -> 0, 17 -> 10, 0 -> 110, 1 -> 111
    lens = {18: 1, 17: 2, 0: 3, 1: 3}
    codes = {18: (0, 1), 17: (2, 2), 0: (6, 3), 1: (7, 3)}
    out = [0] + _bits(2, 2) + _bits(0, 5) + _bits(0, 5) + _bits(14, 4)
    for sym in _ORDER[:18]:
        out += _bits(lens.get(sym, 0), 3)
    # 256 zero lengths (138 + 115 + 3), the end-of-block's 1, one distance 0
    out += _code(*codes[18]) + _bits(138 - 11, 7)
    out += _code(*codes[18]) + _bits(115 - 11, 7)
    out += _code(*codes[17]) + _bits(3 - 3, 3)
    out += _code(*codes[1]) + _code(*codes[0])
    return out + [0]          # the end-of-block, code 0 of length 1


_EMPTY = _empty_dynamic_block()


def primed(stream: bytes, bit: int):
    """The raw DEFLATE data that starts at bit ``bit`` of ``stream``, as
    chunks of bytes: empty blocks in place of the ``bit % 8`` bits before it
    in its byte (99 bits each, so ``3 * (bit % 8) % 8`` of them), then the
    stream's bytes as they are."""
    byte, r = divmod(bit, 8)
    bits = _EMPTY * (3 * r % 8)
    value = sum(b << i for i, b in enumerate(bits))
    q = len(bits) // 8                    # len(bits) % 8 == r
    head = value.to_bytes(q + 1, "little")
    yield head[:q] + bytes([head[q] | (stream[byte] & (0xFF << r) & 0xFF)])
    view = memoryview(stream)
    for at in range(byte + 1, len(stream), CHUNK):
        yield bytes(view[at : at + CHUNK])


def read_from(stream: bytes, bit: int, out: int, window: bytes, start: int,
              length: int) -> bytes:
    """Output ``[start, start + length)`` of the raw DEFLATE data that
    begins at bit ``bit`` of ``stream`` with a block whose first output
    byte is byte ``out`` of the whole output, behind ``window``."""
    if start < out:
        raise ValueError(f"read at {start} before its point at {out}")
    need = start - out + length
    if need == 0:
        return b""
    d = zlib.decompressobj(-15, zdict=window) if window else \
        zlib.decompressobj(-15)
    got = bytearray()
    for part in primed(stream, bit):
        got += d.decompress(part, need - len(got))
        # the inflater keeps what it had no room for
        while d.unconsumed_tail and len(got) < need:
            got += d.decompress(d.unconsumed_tail, need - len(got))
        if len(got) >= need or d.eof:
            break
    if len(got) < need:
        raise ValueError(f"the stream ends {need - len(got)} B before the "
                         f"read's end")
    return bytes(got[start - out : need])


def read(stream: bytes, points, start: int, length: int) -> bytes:
    """Output ``[start, start + length)`` of ``stream`` read from the last
    of ``points`` (``(bit, out, window)`` each, in output order) at or
    before ``start``."""
    bit, out, window = [p for p in points if p[1] <= start][-1]
    return read_from(stream, bit, out, window, start, length)
