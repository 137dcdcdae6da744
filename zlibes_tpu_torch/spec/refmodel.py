"""Pure-Python/NumPy reference model of the RFC 1950/1951 codec.

This is the *semantic spec* for the device kernels: a slow, readable,
sequential implementation of full inflate and deflate whose behavior is
validated against CPython's ``zlib`` and against the reference project's
golden fixtures.  The port's own copy of ``zlibes_tpu/spec/refmodel.py``;
``StreamIndex`` keeps the same ``.save``/``.load`` npz layout, and
``index_from_reference`` rebuilds one from any object with the same fields.

Capability parity notes (reference = zprodev/zlib.es):
  * ``inflate`` decodes stored / fixed / dynamic blocks (src/inflate.ts:22-37)
    and — unlike the reference — verifies the Adler-32 trailer.
  * ``deflate`` splits input into ≤131072-byte blocks (src/deflate.ts:20-34),
    uses greedy LZ77 over a 32 KiB window (src/lz77.ts) and per-block dynamic
    Huffman tables (src/deflate.ts:56-227).  We additionally handle 0/1-byte
    inputs correctly (the reference corrupts them, src/lz77.ts:116-117) and
    may emit stored blocks for incompressible data.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .errors import (
    BlockTypeError,
    ChecksumError,
    CorruptError,
    HeaderError,
    StoredBlockError,
    TruncatedError,
)

# ---------------------------------------------------------------------------
# Adler-32
# ---------------------------------------------------------------------------


def adler32(data: bytes | np.ndarray) -> int:
    """Adler-32 checksum (RFC 1950 §8; reference analog src/adler32.ts)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int64)
    n = arr.size
    if n == 0:
        return 1
    s1 = (1 + int(arr.sum())) % C.ADLER_MOD
    # s2 = n*1 + sum_{i} (n - i) * d_i   (mod m), i zero-based
    weights = np.arange(n, 0, -1, dtype=np.int64)
    s2 = (n + int((weights * arr % C.ADLER_MOD).sum())) % C.ADLER_MOD
    return (s2 << 16) | s1


# ---------------------------------------------------------------------------
# Bit I/O
# ---------------------------------------------------------------------------


class BitReader:
    """LSB-first bit reader over a byte buffer (RFC 1951 §3.1.1).

    Reference analog: src/utils/BitReadStream.ts.  Unlike the reference,
    reading past the end raises TruncatedError instead of yielding NaN.
    """

    def __init__(self, data: bytes, byte_offset: int = 0):
        self.data = data
        self.bitpos = byte_offset * 8
        self.nbits = len(data) * 8

    def read_bits(self, n: int) -> int:
        """Read n bits, LSB-first (headers, extra bits)."""
        if self.bitpos + n > self.nbits:
            raise TruncatedError("bit stream overrun")
        v = 0
        p = self.bitpos
        d = self.data
        for i in range(n):
            v |= ((d[(p + i) >> 3] >> ((p + i) & 7)) & 1) << i
        self.bitpos = p + n
        return v

    def peek_bits(self, n: int) -> int:
        """Peek up to n bits LSB-first; missing bits beyond the end are 0."""
        v = 0
        p = self.bitpos
        d = self.data
        avail = min(n, self.nbits - p)
        for i in range(avail):
            v |= ((d[(p + i) >> 3] >> ((p + i) & 7)) & 1) << i
        return v

    def align_to_byte(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7


class BitWriter:
    """LSB-first bit writer (reference analog: src/utils/BitWriteStream.ts)."""

    def __init__(self):
        self.out = bytearray()
        self.bitbuf = 0
        self.bitcnt = 0

    def write_bits(self, value: int, n: int) -> None:
        """Write n bits of value, LSB-first (headers, extra bits)."""
        self.bitbuf |= (value & ((1 << n) - 1)) << self.bitcnt
        self.bitcnt += n
        while self.bitcnt >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcnt -= 8

    def write_code(self, code: int, n: int) -> None:
        """Write an n-bit Huffman code, MSB of the code first (§3.1.1)."""
        rev = int(f"{code:0{n}b}"[::-1], 2) if n else 0
        self.write_bits(rev, n)

    def align_to_byte(self) -> None:
        if self.bitcnt:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf = 0
            self.bitcnt = 0

    @property
    def bit_length(self) -> int:
        return len(self.out) * 8 + self.bitcnt

    def getvalue(self) -> bytes:
        self.align_to_byte()
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Canonical Huffman
# ---------------------------------------------------------------------------


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes from code lengths (RFC 1951 §3.2.2).

    Returns codes[sym] (MSB-first integers); symbols with length 0 get 0.
    Reference analog: src/huffman.ts:8-39 / 135-151.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    max_len = int(lengths.max(initial=0))
    codes = np.zeros(lengths.size, dtype=np.int64)
    code = 0
    for bits in range(1, max_len + 1):
        code <<= 1
        for sym in range(lengths.size):
            if lengths[sym] == bits:
                codes[sym] = code
                code += 1
    return codes


def _bit_reverse(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


@dataclass
class DecodeTable:
    """Flat 2^max_bits lookup table: peeked LSB-first bits → (symbol, len)."""

    max_bits: int
    symbol: np.ndarray  # int32[2^max_bits], -1 = invalid
    length: np.ndarray  # int32[2^max_bits]


def build_decode_table(lengths: np.ndarray, max_bits: int | None = None) -> DecodeTable:
    """Build a one-shot flat decode table from code lengths.

    Indexing: ``peek_bits(max_bits)`` (LSB-first) → table entry.  For a code
    of length L with canonical (MSB-first) value c, all indices whose low L
    bits equal bit_reverse(c, L) map to that symbol.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    if max_bits is None:
        max_bits = int(lengths.max(initial=1))
    max_bits = max(max_bits, 1)
    size = 1 << max_bits
    symbol = np.full(size, -1, dtype=np.int32)
    length = np.zeros(size, dtype=np.int32)
    codes = canonical_codes(lengths)
    for sym in range(lengths.size):
        L = int(lengths[sym])
        if L == 0:
            continue
        base = _bit_reverse(int(codes[sym]), L)
        step = 1 << L
        for idx in range(base, size, step):
            symbol[idx] = sym
            length[idx] = L
    return DecodeTable(max_bits=max_bits, symbol=symbol, length=length)


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Length-limited Huffman code lengths via package-merge.

    Reference analog: src/huffman.ts:55-153 (its merge-round variant).  This
    is the textbook Larmore–Hirschberg coin-collector formulation: L-1
    rounds of "package adjacent pairs, merge with singletons"; a symbol's
    code length is the number of selected items containing it.
    Produces an optimal length-limited prefix code (Kraft-tight).
    """
    freqs = np.asarray(freqs)
    lengths = np.zeros(freqs.size, dtype=np.int32)
    active = [int(s) for s in np.nonzero(freqs)[0]]
    if not active:
        return lengths
    if len(active) == 1:
        lengths[active[0]] = 1
        return lengths
    singles = sorted(((int(freqs[s]), (s,)) for s in active), key=lambda x: x[0])
    merged = list(singles)
    for _ in range(max_len - 1):
        packages = [
            (merged[i][0] + merged[i + 1][0], merged[i][1] + merged[i + 1][1])
            for i in range(0, len(merged) - 1, 2)
        ]
        merged = sorted(singles + packages, key=lambda x: x[0])
    for _w, syms in merged[: 2 * len(active) - 2]:
        for s in syms:
            lengths[s] += 1
    if int(lengths.max()) > max_len:
        raise AssertionError("package-merge exceeded length limit")
    return lengths


# ---------------------------------------------------------------------------
# Inflate (raw DEFLATE)
# ---------------------------------------------------------------------------

_FIXED_LITLEN_TABLE = build_decode_table(C.fixed_litlen_code_lengths())
_FIXED_DIST_TABLE = build_decode_table(C.fixed_dist_code_lengths())


def _decode_symbol(br: BitReader, table: DecodeTable) -> int:
    idx = br.peek_bits(table.max_bits)
    sym = int(table.symbol[idx])
    if sym < 0:
        raise CorruptError("invalid Huffman code")
    L = int(table.length[idx])
    if br.bitpos + L > br.nbits:
        raise TruncatedError("bit stream overrun in Huffman code")
    br.bitpos += L
    return sym


def read_dynamic_code_lengths(br: BitReader) -> tuple[np.ndarray, np.ndarray]:
    """Parse a dynamic block header (RFC 1951 §3.2.7) → code-length arrays.

    Shared by the reference model and the device pipeline's host-side header
    parser (headers are tiny; payload decode is the device's job).
    """
    hlit = br.read_bits(5) + 257
    hdist = br.read_bits(5) + 1
    hclen = br.read_bits(4) + 4
    clc_lengths = np.zeros(C.NUM_CODELEN_SYMBOLS, dtype=np.int64)
    for i in range(hclen):
        clc_lengths[int(C.CODELEN_ORDER[i])] = br.read_bits(3)
    clc_table = build_decode_table(clc_lengths, C.MAX_CLC_BITS)

    lengths = np.zeros(hlit + hdist, dtype=np.int64)
    i = 0
    while i < hlit + hdist:
        sym = _decode_symbol(br, clc_table)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise CorruptError("RLE repeat with no previous length")
            rep = 3 + br.read_bits(2)
            lengths[i : i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:
            rep = 3 + br.read_bits(3)
            i += rep
        else:  # 18
            rep = 11 + br.read_bits(7)
            i += rep
    if i != hlit + hdist:
        raise CorruptError("code length RLE overran table size")
    return lengths[:hlit], lengths[hlit:]


def _read_dynamic_tables(br: BitReader) -> tuple[DecodeTable, DecodeTable]:
    litlen_lengths, dist_lengths = read_dynamic_code_lengths(br)
    return build_decode_table(litlen_lengths), build_decode_table(dist_lengths)


@dataclass
class BlockInfo:
    """Structure record for one DEFLATE block (powers the seek index)."""

    btype: int
    bfinal: bool
    start_bit: int       # bit offset of the block header in the stream
    payload_start_bit: int  # first bit after the header (symbols / raw bytes)
    end_bit: int         # bit offset just past the block
    out_start: int       # offset of this block's first output byte
    out_len: int         # decompressed bytes produced by this block


@dataclass
class InflateResult:
    data: bytes
    blocks: list[BlockInfo] = field(default_factory=list)
    end_bit: int = 0


@dataclass
class StreamIndex:
    """Seek/parallelism index for a DEFLATE stream (new capability; the
    reference has no analog).

    Anchors are (bit offset, output offset) pairs recorded at token
    boundaries roughly every ``anchor_every`` output bytes; they are the
    decode lanes of the device inflate path.  The first anchor of every
    compressed block sits at its payload start.
    """

    blocks: list[BlockInfo]
    anchor_bit: np.ndarray    # int64[NA] absolute bit offsets
    anchor_out: np.ndarray    # int64[NA] absolute output offsets
    anchor_block: np.ndarray  # int32[NA] owning block id
    self_contained: bool = True  # no back-references across block boundaries
    chunk_reset: int = 0  # >0: no back-reference crosses a ``chunk_reset``-
    # byte output boundary (encoder window resets) — every anchor chunk is
    # independently resolvable, enabling the turbo inflate path
    turbo: bool = False  # stream carries the full turbo profile: shared
    # stream-wide tables, code lengths ≤ 9 bits, anchors every 512 B,
    # window reset every 4 KiB — decodable by the turbo kernels
    max_tokens: int = 0  # max tokens in any anchor span (encoder-recorded;
    # sizes the decode kernel's token buffer / iteration bound)
    wide: bool = False  # DEFAULT-profile device-decode anchors: one anchor
    # per 128 B of output inside every coded block (uniform; an anchor
    # repeats when no token starts in its 128-B sub-span).  Fuel for the
    # two-level-table decoder (ops/wide_kernel.py) — the wire
    # format is untouched, anchors are pure sidecar metadata
    point_block: np.ndarray | None = None  # int64[NP] access points for
    # random reads of a chained stream, as zlib's examples/zran.c keeps
    # them: the block at which each point starts (block 0 first), or None
    point_window: list[bytes] | None = None  # each point's history: the
    # up to 32 KiB of output before it (empty at block 0)

    @property
    def total_out(self) -> int:
        return sum(b.out_len for b in self.blocks)

    def shifted(self, bits: int) -> "StreamIndex":
        """Same index with all bit offsets moved by ``bits`` (container header)."""
        blocks = [
            BlockInfo(
                btype=b.btype, bfinal=b.bfinal, start_bit=b.start_bit + bits,
                payload_start_bit=b.payload_start_bit + bits,
                end_bit=b.end_bit + bits, out_start=b.out_start,
                out_len=b.out_len,
            )
            for b in self.blocks
        ]
        return StreamIndex(blocks, self.anchor_bit + bits, self.anchor_out,
                           self.anchor_block, self.self_contained,
                           self.chunk_reset, self.turbo, self.max_tokens,
                           self.wide, self.point_block, self.point_window)

    # sidecar format version.  v2: turbo anchors come in PAIRS per 512 B
    # segment (segment start + mid-segment split).  v3: default-profile indexes carry uniform 128-B "wide" anchors for
    # the two-level-table decoder.  Older sidecars cannot drive
    # the current decode lanes and are rejected at load with an explicit
    # versioning error.
    FORMAT_VERSION = 3

    def save(self, path) -> None:
        """Persist the sidecar index (reload with StreamIndex.load)."""
        blk = np.array(
            [[b.btype, int(b.bfinal), b.start_bit, b.payload_start_bit,
              b.end_bit, b.out_start, b.out_len] for b in self.blocks],
            dtype=np.int64,
        )
        points = {}
        if self.point_block is not None:
            # the windows one after another, and each one's length
            points = dict(
                point_block=np.asarray(self.point_block, np.int64),
                point_window=np.frombuffer(b"".join(self.point_window),
                                           np.uint8),
                point_window_len=np.array(
                    [len(w) for w in self.point_window], np.int64))
        np.savez(path, blocks=blk, anchor_bit=self.anchor_bit,
                 anchor_out=self.anchor_out, anchor_block=self.anchor_block,
                 self_contained=np.array([self.self_contained]),
                 chunk_reset=np.array([self.chunk_reset]),
                 turbo=np.array([self.turbo]),
                 max_tokens=np.array([self.max_tokens]),
                 wide=np.array([self.wide]),
                 version=np.array([StreamIndex.FORMAT_VERSION]), **points)

    @staticmethod
    def load(path) -> "StreamIndex":
        z = np.load(path)
        version = int(z["version"][0]) if "version" in z else 1
        if version != StreamIndex.FORMAT_VERSION:
            raise ValueError(
                f"index sidecar is format v{version}; this build reads "
                f"v{StreamIndex.FORMAT_VERSION} (v3 adds uniform 128-B "
                f"wide anchors) — regenerate the index with "
                f"deflate_indexed() or ZScanner")
        blocks = [
            BlockInfo(int(r[0]), bool(r[1]), int(r[2]), int(r[3]), int(r[4]),
                      int(r[5]), int(r[6]))
            for r in z["blocks"]
        ]
        point_block = point_window = None
        if "point_block" in z:
            point_block = z["point_block"].astype(np.int64)
            ends = np.cumsum(z["point_window_len"])
            flat = z["point_window"].tobytes()
            point_window = [flat[e - n : e] for e, n in
                            zip(ends.tolist(), z["point_window_len"].tolist())]
        return StreamIndex(blocks, z["anchor_bit"], z["anchor_out"],
                           z["anchor_block"], bool(z["self_contained"][0]),
                           int(z["chunk_reset"][0]) if "chunk_reset" in z else 0,
                           bool(z["turbo"][0]) if "turbo" in z else False,
                           int(z["max_tokens"][0]) if "max_tokens" in z else 0,
                           bool(z["wide"][0]) if "wide" in z else False,
                           point_block, point_window)


def block_from_reference(obj) -> BlockInfo:
    """The port's ``BlockInfo`` from any object with the same fields."""
    if isinstance(obj, BlockInfo):
        return obj
    return BlockInfo(int(obj.btype), bool(obj.bfinal), int(obj.start_bit),
                     int(obj.payload_start_bit), int(obj.end_bit),
                     int(obj.out_start), int(obj.out_len))


def index_from_reference(obj) -> StreamIndex:
    """Rebuild the port's ``StreamIndex`` (and its ``BlockInfo`` records)
    from any object that carries the same fields, for example an index made
    by the JAX package's encoder: attributes and numpy arrays are read and
    copied, nothing of the other package is imported or type-checked.  A
    missing field raises AttributeError."""
    if isinstance(obj, StreamIndex):
        return obj
    return StreamIndex(
        [block_from_reference(b) for b in obj.blocks],
        np.array(obj.anchor_bit, dtype=np.int64),
        np.array(obj.anchor_out, dtype=np.int64),
        np.array(obj.anchor_block, dtype=np.int32),
        bool(obj.self_contained), int(obj.chunk_reset), bool(obj.turbo),
        int(obj.max_tokens), bool(obj.wide))


def inflate_raw(data: bytes, byte_offset: int = 0,
                dictionary: bytes | None = None) -> InflateResult:
    """Decode a raw DEFLATE stream (reference analog src/inflate.ts:16-292).

    ``dictionary``: preset window contents (RFC 1950 FDICT) — back-references
    may reach into it; it is not part of the output.
    """
    br = BitReader(data, byte_offset)
    dict_len = 0
    out = bytearray()
    if dictionary:
        out += dictionary[-C.WINDOW_SIZE:]
        dict_len = len(out)
    blocks: list[BlockInfo] = []
    while True:
        start_bit = br.bitpos
        bfinal = br.read_bits(1)
        btype = br.read_bits(2)
        out_start = len(out) - dict_len
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            payload_start = br.bitpos
            pos = br.bitpos >> 3
            if pos + 4 > len(data):
                raise TruncatedError("stored block header truncated")
            length = data[pos] | (data[pos + 1] << 8)
            nlen = data[pos + 2] | (data[pos + 3] << 8)
            if length != (~nlen & 0xFFFF):
                raise StoredBlockError("LEN/NLEN mismatch")
            pos += 4
            if pos + length > len(data):
                raise TruncatedError("stored block data truncated")
            out += data[pos : pos + length]
            br.bitpos = (pos + length) * 8
        elif btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            if btype == C.BTYPE_FIXED:
                litlen_table, dist_table = _FIXED_LITLEN_TABLE, _FIXED_DIST_TABLE
            else:
                litlen_table, dist_table = _read_dynamic_tables(br)
            payload_start = br.bitpos
            while True:
                sym = _decode_symbol(br, litlen_table)
                if sym < 256:
                    out.append(sym)
                elif sym == C.END_OF_BLOCK:
                    break
                else:
                    if sym > 285:
                        raise CorruptError("invalid length symbol")
                    li = sym - 257
                    length = int(C.LENGTH_BASE[li]) + br.read_bits(int(C.LENGTH_EXTRA_BITS[li]))
                    dsym = _decode_symbol(br, dist_table)
                    if dsym > 29:
                        raise CorruptError("invalid distance symbol")
                    dist = int(C.DIST_BASE[dsym]) + br.read_bits(int(C.DIST_EXTRA_BITS[dsym]))
                    if dist > len(out):
                        raise CorruptError("back-reference before start of output")
                    src = len(out) - dist
                    for k in range(length):  # may overlap (dist < length)
                        out.append(out[src + k])
        else:
            raise BlockTypeError("reserved BTYPE 3")
        blocks.append(
            BlockInfo(
                btype=btype,
                bfinal=bool(bfinal),
                start_bit=start_bit,
                payload_start_bit=payload_start,
                end_bit=br.bitpos,
                out_start=out_start,
                out_len=len(out) - dict_len - out_start,
            )
        )
        if bfinal:
            break
    return InflateResult(data=bytes(out[dict_len:]), blocks=blocks,
                         end_bit=br.bitpos)


def inflate(data: bytes, verify_checksum: bool = True,
            dictionary: bytes | None = None) -> bytes:
    """zlib-container inflate (RFC 1950; reference analog src/zlib.ts:11-23).

    Unlike the reference we validate FCHECK, verify the Adler-32 trailer
    (the reference skips both), and support preset
    dictionaries (FDICT) — the reference rejects none and supports none.
    """
    if len(data) < 6:
        raise TruncatedError("zlib stream shorter than minimal frame")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != C.ZLIB_CM_DEFLATE:
        raise HeaderError("not compressed by deflate")
    if (cmf >> 4) > 7:
        raise HeaderError("invalid CINFO (window > 32 KiB)")
    if (cmf * 256 + flg) % 31 != 0:
        raise HeaderError("FCHECK failed")
    offset = 2
    if flg & 0x20:
        if dictionary is None:
            raise HeaderError("stream requires a preset dictionary (FDICT)")
        if len(data) < 10:
            raise TruncatedError("missing DICTID")
        dictid = int.from_bytes(data[2:6], "big")
        if dictid != adler32(dictionary):
            raise HeaderError("DICTID does not match supplied dictionary")
        offset = 6
    elif dictionary is not None:
        dictionary = None  # stream does not use it
    res = inflate_raw(data, byte_offset=offset, dictionary=dictionary)
    if verify_checksum:
        trailer_pos = (res.end_bit + 7) >> 3
        if trailer_pos + 4 > len(data):
            raise TruncatedError("missing Adler-32 trailer")
        expect = int.from_bytes(data[trailer_pos : trailer_pos + 4], "big")
        actual = adler32(res.data)
        if expect != actual:
            raise ChecksumError(f"Adler-32 mismatch: {expect:#x} != {actual:#x}")
    return res.data


# ---------------------------------------------------------------------------
# Deflate
# ---------------------------------------------------------------------------


def lz77_greedy(block: np.ndarray, max_candidates: int = 128,
                lazy: bool = True, start: int = 0) -> list[tuple]:
    """LZ77 tokenization of one block (reference analog src/lz77.ts).

    Matches are intra-block only (the reference indexes only the block's own
    range, src/lz77.ts:14-20, so its blocks are self-contained too — this is
    what makes blocks independently decodable units).  Tokens are
    ``(byte,)`` literals or ``(length, dist)`` pairs.

    Uses a classic head/prev hash chain over exact 3-byte keys with a
    candidate cap, choosing the longest match (nearest wins ties), plus
    optional one-step lazy matching (defer a match when the next position
    has a longer one) — strictly stronger than the reference's capped
    newest-first greedy scan, which config[3] "size ≤ reference" requires.

    ``start``: tokenize only ``block[start:]`` — earlier bytes are context
    (a preset dictionary) that matches may reference but never cover.
    """
    n = block.size
    tokens: list[tuple] = []
    if n - start < C.MIN_MATCH:
        for b in block[start:]:
            tokens.append((int(b),))
        return tokens
    data = block.astype(np.int64)
    keys = (data[:-2] << 16) | (data[1:-1] << 8) | data[2:]
    head: dict[int, int] = {}
    prev = np.full(n, -1, dtype=np.int64)
    # insert positions lazily as the cursor advances
    inserted = 0

    def insert_upto(limit: int) -> None:
        nonlocal inserted
        while inserted < limit and inserted < n - 2:
            k = int(keys[inserted])
            prev[inserted] = head.get(k, -1)
            head[k] = inserted
            inserted += 1

    def best_match(i: int) -> tuple[int, int]:
        insert_upto(i)
        cand = head.get(int(keys[i]), -1)
        best_len = 0
        best_dist = 0
        tries = max_candidates
        limit = min(n - i, C.MAX_MATCH)
        lo = i - C.WINDOW_SIZE
        while cand >= 0 and cand >= lo and tries > 0:
            m = 0
            while m < limit and block[cand + m] == block[i + m]:
                m += 1
            if m > best_len:
                best_len = m
                best_dist = i - cand
                if m >= limit:
                    break
            cand = int(prev[cand])
            tries -= 1
        return best_len, best_dist

    i = start
    while i < n:
        if i >= n - 2:
            tokens.append((int(block[i]),))
            i += 1
            continue
        cur_len, cur_dist = best_match(i)
        if lazy and C.MIN_MATCH <= cur_len < C.MAX_MATCH and i + 1 < n - 2:
            nxt_len, _ = best_match(i + 1)
            if nxt_len > cur_len:
                tokens.append((int(block[i]),))
                i += 1
                continue
        if cur_len >= C.MIN_MATCH:
            tokens.append((cur_len, cur_dist))
            i += cur_len
        else:
            tokens.append((int(block[i]),))
            i += 1
    return tokens


def _rle_code_lengths(lengths: np.ndarray) -> list[tuple[int, int]]:
    """RLE a code-length sequence with codes 16/17/18 (RFC 1951 §3.2.7).

    Returns [(symbol, extra_value), ...].  Reference analog:
    src/deflate.ts:99-139.
    """
    out: list[tuple[int, int]] = []
    n = lengths.size
    i = 0
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == v:
            run += 1
        if v == 0:
            r = run
            while r >= 3:
                if r >= 11:
                    rep = min(r, 138)
                    out.append((18, rep - 11))
                else:
                    rep = r
                    out.append((17, rep - 3))
                r -= rep
            out.extend((0, 0) for _ in range(r))
        else:
            out.append((v, 0))
            r = run - 1
            while r >= 3:
                rep = min(r, 6)
                out.append((16, rep - 3))
                r -= rep
            out.extend((v, 0) for _ in range(r))
        i += run
    return out


_RLE_EXTRA_BITS = {16: 2, 17: 3, 18: 7}


def _write_dynamic_block(
    bw: BitWriter,
    tokens: list[tuple],
    anchor_every: int | None = None,
    out_start: int = 0,
) -> list[tuple[int, int]]:
    """Emit one dynamic-Huffman block body (header + coded payload).

    Reference analog: src/deflate.ts:56-227 (deflateDynamicBlock).
    When ``anchor_every`` is set, returns (bit_offset, out_offset) anchors
    sampled at token boundaries each time the output crosses a multiple of
    ``anchor_every`` bytes (the first anchor is the payload start).
    """
    # --- symbol streams + histograms
    litlen_freq = np.zeros(C.NUM_LITLEN_SYMBOLS, dtype=np.int64)
    dist_freq = np.zeros(C.NUM_DIST_SYMBOLS, dtype=np.int64)
    for t in tokens:
        if len(t) == 1:
            litlen_freq[t[0]] += 1
        else:
            length, dist = t
            litlen_freq[int(C.LENGTH_TO_SYMBOL[length])] += 1
            dist_freq[int(C.DIST_TO_SYMBOL[dist])] += 1
    litlen_freq[C.END_OF_BLOCK] += 1

    litlen_lengths = package_merge_lengths(litlen_freq, C.MAX_CODELEN_BITS)
    dist_lengths = package_merge_lengths(dist_freq, C.MAX_CODELEN_BITS)
    if dist_lengths.max(initial=0) == 0:
        dist_lengths[0] = 1  # always transmit at least one distance code

    hlit = max(257, int(np.nonzero(litlen_lengths)[0].max()) + 1)
    hdist = max(1, int(np.nonzero(dist_lengths)[0].max()) + 1)

    all_lengths = np.concatenate([litlen_lengths[:hlit], dist_lengths[:hdist]])
    rle = _rle_code_lengths(all_lengths)

    clc_freq = np.zeros(C.NUM_CODELEN_SYMBOLS, dtype=np.int64)
    for sym, _ in rle:
        clc_freq[sym] += 1
    clc_lengths = package_merge_lengths(clc_freq, C.MAX_CLC_BITS)

    hclen = 19
    while hclen > 4 and clc_lengths[int(C.CODELEN_ORDER[hclen - 1])] == 0:
        hclen -= 1

    litlen_codes = canonical_codes(litlen_lengths)
    dist_codes = canonical_codes(dist_lengths)
    clc_codes = canonical_codes(clc_lengths)

    # --- header
    bw.write_bits(hlit - 257, 5)
    bw.write_bits(hdist - 1, 5)
    bw.write_bits(hclen - 4, 4)
    for i in range(hclen):
        bw.write_bits(int(clc_lengths[int(C.CODELEN_ORDER[i])]), 3)
    for sym, extra in rle:
        bw.write_code(int(clc_codes[sym]), int(clc_lengths[sym]))
        if sym in _RLE_EXTRA_BITS:
            bw.write_bits(extra, _RLE_EXTRA_BITS[sym])

    # --- payload
    anchors: list[tuple[int, int]] = [(bw.bit_length, out_start)]
    out_off = out_start
    next_anchor = out_start + anchor_every if anchor_every else None
    for t in tokens:
        if anchor_every and out_off >= next_anchor:
            anchors.append((bw.bit_length, out_off))
            next_anchor = out_off + anchor_every
        if len(t) == 1:
            sym = t[0]
            bw.write_code(int(litlen_codes[sym]), int(litlen_lengths[sym]))
            out_off += 1
        else:
            length, dist = t
            lsym = int(C.LENGTH_TO_SYMBOL[length])
            bw.write_code(int(litlen_codes[lsym]), int(litlen_lengths[lsym]))
            bw.write_bits(int(C.LENGTH_TO_EXTRA[length]), int(C.LENGTH_EXTRA_BITS[lsym - 257]))
            dsym = int(C.DIST_TO_SYMBOL[dist])
            bw.write_code(int(dist_codes[dsym]), int(dist_lengths[dsym]))
            bw.write_bits(int(C.DIST_TO_EXTRA[dist]), int(C.DIST_EXTRA_BITS[dsym]))
            out_off += length
    bw.write_code(int(litlen_codes[C.END_OF_BLOCK]), int(litlen_lengths[C.END_OF_BLOCK]))
    return anchors


def deflate_raw(
    data: bytes,
    block_size: int = C.BLOCK_MAX_BUFFER_LEN,
    with_index: bool = False,
    anchor_every: int = 4096,
    dictionary: bytes | None = None,
):
    """Encode a raw DEFLATE stream of dynamic blocks (analog src/deflate.ts).

    With ``with_index`` also returns the StreamIndex (block layout + decode
    anchors) that powers block-parallel inflate.
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    bw = BitWriter()
    nblocks = max(1, -(-arr.size // block_size))
    blocks: list[BlockInfo] = []
    anchors: list[tuple[int, int, int]] = []
    for bi in range(nblocks):
        block = arr[bi * block_size : (bi + 1) * block_size]
        bfinal = 1 if bi == nblocks - 1 else 0
        start_bit = bw.bit_length
        out_start = bi * block_size
        bw.write_bits(bfinal, 1)
        if block.size == 0:
            # empty input: emit an empty stored block
            bw.write_bits(C.BTYPE_STORED, 2)
            bw.align_to_byte()
            payload_start = bw.bit_length
            bw.out += b"\x00\x00\xff\xff"
            blocks.append(BlockInfo(C.BTYPE_STORED, bool(bfinal), start_bit,
                                    payload_start, bw.bit_length, out_start, 0))
            continue
        bw.write_bits(C.BTYPE_DYNAMIC, 2)
        if bi == 0 and dictionary:
            ctx = np.frombuffer(dictionary[-C.WINDOW_SIZE:], dtype=np.uint8)
            tokens = lz77_greedy(np.concatenate([ctx, block]), start=ctx.size)
        else:
            tokens = lz77_greedy(block)
        blk_anchors = _write_dynamic_block(
            bw, tokens,
            anchor_every=anchor_every if with_index else None,
            out_start=out_start,
        )
        blocks.append(BlockInfo(C.BTYPE_DYNAMIC, bool(bfinal), start_bit,
                                blk_anchors[0][0], bw.bit_length, out_start,
                                block.size))
        anchors.extend((ab, ao, bi) for ab, ao in blk_anchors)
    body = bw.getvalue()
    if not with_index:
        return body
    index = StreamIndex(
        blocks=blocks,
        anchor_bit=np.array([a[0] for a in anchors], dtype=np.int64),
        anchor_out=np.array([a[1] for a in anchors], dtype=np.int64),
        anchor_block=np.array([a[2] for a in anchors], dtype=np.int32),
    )
    return body, index


def deflate(
    data: bytes,
    block_size: int = C.BLOCK_MAX_BUFFER_LEN,
    with_index: bool = False,
    anchor_every: int = 4096,
    dictionary: bytes | None = None,
):
    """zlib-container deflate (reference analog src/zlib.ts:25-49).

    ``dictionary`` sets FDICT and emits the DICTID; the first block's
    matches may reference the dictionary (RFC 1950 §2.2).
    """
    trailer = adler32(data).to_bytes(4, "big")
    if dictionary:
        flg_base = 0x78 * 256 + 0x20 + (2 << 6)
        flg = 0x20 + (2 << 6) + (31 - flg_base % 31) % 31
        header = bytes([0x78, flg]) + adler32(dictionary).to_bytes(4, "big")
    else:
        header = C.ZLIB_HEADER
    if with_index:
        body, index = deflate_raw(data, block_size, True, anchor_every,
                                  dictionary=dictionary)
        return header + body + trailer, index.shifted(len(header) * 8)
    body = deflate_raw(data, block_size, dictionary=dictionary)
    return header + body + trailer
