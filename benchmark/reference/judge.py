"""The comparisons that decide ``correct``: what the port returned, held
against the seeded input by the standard library's ``zlib`` and the plain
reader of ``inflater.py``.  Each function returns a count of faults; the
limit of every count is 0.

An index is judged as plain arrays (``index_arrays`` of the harness):
``blocks`` (n, 7) int64 rows of btype, bfinal, start bit, payload bit, end
bit, output start and output length, and the anchors' ``bit``, ``out`` and
``block``."""
from __future__ import annotations

import zlib

import numpy as np

from . import inflater as inf

ZLIB_HEADER = b"\x78\x9c"     # deflate, 32 KiB window, default level
WIDE_GRAIN = 128              # a wide index: an anchor every 128 output B


def stream_faults(comp: bytes, data: bytes) -> int:
    """1 unless ``comp`` is one zlib member with the default header whose
    payload inflates to ``data`` and whose Adler-32 matches, else 0."""
    if comp[:2] != ZLIB_HEADER:
        return 1
    d = zlib.decompressobj()
    try:
        out = d.decompress(comp)
    except zlib.error:
        return 1
    return int(not d.eof or d.unused_data != b"" or out != data)


def block_faults(comp: bytes, data: bytes, ix: dict) -> int:
    """Block entries that do not tile the stream and its output, or whose
    bits, read alone from their first byte, do not give their bytes."""
    blocks = ix["blocks"]
    bad = 0
    bits = inf.Bits(comp)
    want_bit, want_out = 16, 0
    for i, (btype, bfinal, start, pay, end, out0, n) in enumerate(
            blocks.tolist()):
        last = i == len(blocks) - 1
        if (start != want_bit or out0 != want_out or end < pay or pay < start
                or bool(bfinal) != last):
            bad += 1
        want_bit, want_out = end, out0 + n
        try:
            _, bt, _, _, p = inf.read_header(bits, start)
        except inf.Corrupt:
            bad += 1
            continue
        if bt != btype or (bt != 0 and p != pay):
            bad += 1
            continue
        if n == 0:
            continue
        if start % 8:
            bad += 1
            continue
        raw = zlib.decompressobj(-15)
        try:
            got = raw.decompress(comp[start // 8:(end + 7) // 8])
        except zlib.error:
            got = None
        if got != data[out0:out0 + n]:
            bad += 1
    if want_out != len(data) or (want_bit + 7) // 8 != len(comp) - 4:
        bad += 1
    return bad


def _lane_fault(bits, data: bytes, ltab, dtab, bit: int, out: int,
                out0: int, n: int, stop: int) -> tuple[int, int] | None:
    """Walk the tokens from (bit, out) until the first one that starts at
    or past output ``stop`` (block-relative) or the end of the block, each
    checked against ``data``; the (bit, out) where it stopped, or None if a
    token breaks the data."""
    limit = n + 1
    for step in range(limit):
        if out >= n:
            if step == 0:
                # an anchor of an empty last grain stands at the block's
                # end, past its end-of-block code
                return bit, out
            s, _, _, nxt = inf.read_token(bits, bit, ltab, dtab)
            return (nxt, out) if s == inf.EOB else None
        if out >= stop:
            return bit, out
        s, ln, dist, nxt = inf.read_token(bits, bit, ltab, dtab)
        if s == inf.EOB:
            return None
        a = out0 + out
        if a >= len(data):
            return None
        if ln == 0:
            if out >= n or data[a] != s:
                return None
            out += 1
        else:
            if dist > out or out + ln > n or (
                    data[a:a + ln] != data[a - dist:a - dist + ln]):
                return None
            out += ln
        bit = nxt
    return None


def anchor_faults(comp: bytes, data: bytes, ix: dict, rng,
                  samples: int = 48) -> int:
    """Faults of a wide index's anchors.  All of them: each coded block
    holds one anchor for every 128 output bytes, in order, the first at its
    payload, the k-th at or past byte 128 k.  A seeded sample of them, and
    the last: walking the tokens from an anchor, checked against the data,
    reaches the first token at or past the next 128-byte boundary exactly at
    the next anchor (or the block's end exactly at its end bit)."""
    blocks = ix["blocks"]
    a_bit, a_out, a_blk = ix["bit"], ix["out"], ix["block"]
    bad = 0
    first = np.searchsorted(a_blk, np.arange(len(blocks)), side="left")
    last = np.searchsorted(a_blk, np.arange(len(blocks)), side="right")
    if (np.diff(a_blk) < 0).any():
        return a_blk.size or 1
    coded = []
    for b, (btype, _, start, pay, end, out0, n) in enumerate(blocks.tolist()):
        k = last[b] - first[b]
        if btype == 0 or n == 0:
            bad += k
            continue
        want = -(-n // WIDE_GRAIN)
        if k != want:
            bad += abs(k - want) or 1
            continue
        rel = a_out[first[b]:last[b]] - out0
        bb = a_bit[first[b]:last[b]]
        grid = np.arange(k) * WIDE_GRAIN
        bad += int(((rel < grid) | (rel > n) | (bb < pay) | (bb > end)).sum())
        bad += int((np.diff(rel) < 0).sum() + (np.diff(bb) < 0).sum())
        bad += int(rel[0] != 0 or bb[0] != pay)
        coded.append(b)
    if bad or not coded:
        return bad
    bits = inf.Bits(comp)
    if samples >= a_bit.size:
        picks = set(range(a_bit.size))
    else:
        picks = set(rng.integers(0, a_bit.size, size=samples).tolist())
    picks.add(a_bit.size - 1)
    tables = {}
    for i in sorted(picks):
        b = int(a_blk[i])
        btype, _, start, pay, end, out0, n = blocks[b].tolist()
        if b not in tables:
            _, _, ll, dl, _ = inf.read_header(bits, start)
            tables[b] = (inf.table(ll), inf.table(dl))
        ltab, dtab = tables[b]
        k = i - first[b]
        try:
            got = _lane_fault(bits, data, ltab, dtab, int(a_bit[i]),
                              int(a_out[i]) - out0, out0, n,
                              (k + 1) * WIDE_GRAIN)
        except inf.Corrupt:
            got = None
        if i + 1 < last[b]:
            want = (int(a_bit[i + 1]), int(a_out[i + 1]) - out0)
        else:
            want = (end, n)
        bad += int(got != want)
    return bad


def range_faults(got: bytes, data: bytes, start: int, length: int) -> int:
    return int(got != data[start:start + length])
