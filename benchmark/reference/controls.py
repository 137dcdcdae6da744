"""The controls: the plain reference put in the program's place, each with
one guarantee of the configuration broken, so that the comparison is shown
to fail.  The codec states no precision, so a control breaks a guarantee:

  ``wide_index``  (a compress cell with a wide index) CPython's level 6 with
                  a full flush every block, whose index holds one anchor a
                  block, not one every 128 output bytes;
  ``adler_share`` (a block-parallel compress cell) CPython's level 6 with a
                  full flush every block, whose Adler-32 is that of the
                  first rank's share of the input alone: the checksums of
                  the ranks not combined;
  ``row_pad``     (a decode to the card) CPython's inflate, uploaded, with
                  the output left at whole 4 KiB rows, not cut at the
                  stream's length;
  ``grain``       (range reads) CPython's inflate of the whole stream,
                  returning the 128-byte grains that hold the range, not
                  the range itself.
"""
from __future__ import annotations

import zlib

import numpy as np

from . import inflater as inf

WIDE_GRAIN = 128


def flushed_stream(data: bytes, block: int):
    """CPython's level 6 (windowBits 15, memLevel 8), ``Z_FULL_FLUSH`` every
    ``block`` bytes: (stream, flush segments as (start byte, end byte,
    output start, output length))."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
    parts, segs, at = [b"\x78\x9c"], [], 2
    for o in range(0, len(data), block):
        last = o + block >= len(data)
        p = c.compress(data[o:o + block]) + c.flush(
            zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)
        segs.append((at, at + len(p), o, min(block, len(data) - o)))
        parts.append(p)
        at += len(p)
    return b"".join(parts), segs


def wide_index(data: bytes, block: int = 131072):
    """``wide_index`` control: (stream, plain index arrays)."""
    body, segs = flushed_stream(data, block)
    comp = body + zlib.adler32(data).to_bytes(4, "big")
    bits = inf.Bits(comp)
    rows, a_bit, a_out = [], [], []
    for k, (s, e, o, n) in enumerate(segs):
        _, btype, _, _, pay = inf.read_header(bits, 8 * s)
        rows.append([btype, int(k == len(segs) - 1), 8 * s, pay, 8 * e, o, n])
        a_bit.append(pay)
        a_out.append(o)
    ix = {"blocks": np.array(rows, np.int64).reshape(-1, 7),
          "bit": np.array(a_bit, np.int64), "out": np.array(a_out, np.int64),
          "block": np.arange(len(segs), dtype=np.int64), "turbo": False,
          "wide": True}
    return comp, ix


def adler_share(data: bytes, world: int = 4, block: int = 32768) -> bytes:
    """``adler_share`` control: the stream, trailer from rank 0's share."""
    body, _ = flushed_stream(data, block)
    blocks = -(-len(data) // block)
    share = -(-blocks // world) * block
    return body + zlib.adler32(data[:share]).to_bytes(4, "big")


def row_pad(comp: bytes) -> bytes:
    """``row_pad`` control: the output, zero-padded to whole 4 KiB rows."""
    out = zlib.decompress(comp)
    return out + bytes(-len(out) % 4096)


def grain(out: bytes, start: int, length: int) -> bytes:
    """``grain`` control: the 128-byte grains of ``out`` that hold
    [start, start + length)."""
    lo = start - start % WIDE_GRAIN
    hi = -(-(start + length) // WIDE_GRAIN) * WIDE_GRAIN
    return out[lo:hi]
