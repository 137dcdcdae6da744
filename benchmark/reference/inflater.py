"""A plain DEFLATE reader (RFC 1951): block headers, Huffman tables, and
token walks from any bit position, in Python; a lock-step token count over
many lanes in NumPy.  Slow, short and independent of the program."""
from __future__ import annotations

import numpy as np

LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
LEN_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
             4, 4, 4, 5, 5, 5, 5, 0]
DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577]
DIST_EXTRA = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
              9, 10, 10, 11, 11, 12, 12, 13, 13]
CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
EOB = 256


class Corrupt(ValueError):
    """The bits do not decode."""


class Bits:
    """A byte string read as a little-endian bit stream."""

    def __init__(self, buf: bytes):
        self.buf = bytes(buf) + bytes(8)
        self.nbits = 8 * len(buf)

    def peek(self, pos: int, n: int) -> int:
        i = pos >> 3
        v = int.from_bytes(self.buf[i:i + 8], "little") >> (pos & 7)
        return v & ((1 << n) - 1)


def table(lengths) -> tuple[np.ndarray, np.ndarray, int]:
    """Canonical Huffman decode table: (symbol, code length) for every value
    of the next ``maxbits`` stream bits (first bit lowest)."""
    lengths = np.asarray(lengths, np.int64)
    maxbits = int(lengths.max(initial=0))
    if maxbits == 0:
        return np.zeros(1, np.int32), np.zeros(1, np.int32), 0
    sym = np.full(1 << maxbits, -1, np.int32)
    ln = np.zeros(1 << maxbits, np.int32)
    code = 0
    for bits in range(1, maxbits + 1):
        for s in np.flatnonzero(lengths == bits):
            rev = int(f"{code:0{bits}b}"[::-1], 2)
            sym[rev::1 << bits] = s
            ln[rev::1 << bits] = bits
            code += 1
        code <<= 1
    return sym, ln, maxbits


def fixed_lengths() -> tuple[list[int], list[int]]:
    ll = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
    return ll, [5] * 30


def _read_sym(bits: Bits, pos: int, tab) -> tuple[int, int]:
    sym, ln, maxbits = tab
    v = bits.peek(pos, maxbits)
    n = int(ln[v])
    if n == 0:
        raise Corrupt(f"no code at bit {pos}")
    return int(sym[v]), pos + n


def read_header(bits: Bits, pos: int):
    """The block header at ``pos``: (bfinal, btype, litlen lengths,
    distance lengths, first payload bit); the lengths are None for a stored
    block, whose payload bit is that of its LEN field."""
    bfinal = bits.peek(pos, 1)
    btype = bits.peek(pos + 1, 2)
    pos += 3
    if btype == 0:
        return bfinal, 0, None, None, (pos + 7) & ~7
    if btype == 1:
        ll, dl = fixed_lengths()
        return bfinal, 1, ll, dl, pos
    if btype != 2:
        raise Corrupt(f"reserved block type at bit {pos - 3}")
    hlit = bits.peek(pos, 5) + 257
    hdist = bits.peek(pos + 5, 5) + 1
    hclen = bits.peek(pos + 10, 4) + 4
    pos += 14
    cl = [0] * 19
    for i in range(hclen):
        cl[CL_ORDER[i]] = bits.peek(pos, 3)
        pos += 3
    ctab = table(cl)
    lens: list[int] = []
    while len(lens) < hlit + hdist:
        s, pos = _read_sym(bits, pos, ctab)
        if s < 16:
            lens.append(s)
        elif s == 16:
            if not lens:
                raise Corrupt("repeat with no previous length")
            lens += [lens[-1]] * (3 + bits.peek(pos, 2))
            pos += 2
        elif s == 17:
            lens += [0] * (3 + bits.peek(pos, 3))
            pos += 3
        else:
            lens += [0] * (11 + bits.peek(pos, 7))
            pos += 7
    if len(lens) != hlit + hdist:
        raise Corrupt("code lengths overrun")
    return bfinal, 2, lens[:hlit], lens[hlit:], pos


def read_token(bits: Bits, pos: int, ltab, dtab):
    """The token at ``pos``: (symbol, length, distance, next bit); length 0
    for a literal (the symbol is the byte) and for the end of block."""
    s, pos = _read_sym(bits, pos, ltab)
    if s < EOB:
        return s, 0, 0, pos
    if s == EOB:
        return s, 0, 0, pos
    k = s - 257
    if k >= 29:
        raise Corrupt(f"length symbol {s}")
    n = LEN_BASE[k] + bits.peek(pos, LEN_EXTRA[k])
    pos += LEN_EXTRA[k]
    d, pos = _read_sym(bits, pos, dtab)
    if d >= 30:
        raise Corrupt(f"distance symbol {d}")
    dist = DIST_BASE[d] + bits.peek(pos, DIST_EXTRA[d])
    return s, n, dist, pos + DIST_EXTRA[d]


# ---------------------------------------------------------------------------
# lock-step token count over many lanes (NumPy)

def _peek_many(buf: np.ndarray, pos: np.ndarray, n) -> np.ndarray:
    i = pos >> 3
    v = (buf[i].astype(np.uint64) | (buf[i + 1].astype(np.uint64) << 8)
         | (buf[i + 2].astype(np.uint64) << 16)
         | (buf[i + 3].astype(np.uint64) << 24))
    v = v >> (pos & 7).astype(np.uint64)
    return (v & ((np.uint64(1) << np.asarray(n).astype(np.uint64))
                 - np.uint64(1))).astype(np.int64)


def count_tokens(comp: bytes, bit0: np.ndarray, end: np.ndarray,
                 ll_len, d_len) -> int:
    """Tokens (literals and matches, not end-of-block codes) in the lanes
    [bit0, end) of ``comp``, all coded under one table pair.  A lane that
    does not end exactly at its end bit raises Corrupt."""
    buf = np.frombuffer(bytes(comp) + bytes(8), np.uint8)
    lsym, lln, lmax = table(ll_len)
    dsym, dln, dmax = table(d_len)
    lbase = np.array(LEN_BASE + [0, 0], np.int64)
    lext = np.array(LEN_EXTRA + [0, 0], np.int64)
    dbase = np.array(DIST_BASE + [0, 0], np.int64)
    dext = np.array(DIST_EXTRA + [0, 0], np.int64)
    pos = np.asarray(bit0, np.int64).copy()
    end = np.asarray(end, np.int64)
    live = np.flatnonzero(pos < end)
    total = 0
    while live.size:
        p = pos[live]
        v = _peek_many(buf, p, lmax)
        s = lsym[v].astype(np.int64)
        n = lln[v].astype(np.int64)
        if (n == 0).any():
            raise Corrupt("no litlen code in a lane")
        p = p + n
        total += int((s != EOB).sum())
        m = s > EOB
        if m.any():
            k = s[m] - 257
            q = p[m] + lext[k]
            dv = _peek_many(buf, q, dmax)
            d = dsym[dv].astype(np.int64)
            dn = dln[dv].astype(np.int64)
            if (dn == 0).any() or (d >= 30).any() or (k >= 29).any():
                raise Corrupt("bad match in a lane")
            p[m] = q + dn + dext[d]
        pos[live] = p
        done = (pos[live] >= end[live]) | (s == EOB)
        live = live[~done]
    if (pos != np.maximum(end, np.asarray(bit0, np.int64))).any():
        raise Corrupt("a lane did not end at its end bit")
    return total
