"""Host framing of the port's four encoders (the single-card turbo and
general encoders, ``parallel_deflate``, ``compress_batch``): how their
input becomes block rows, and how a coded block goes into the stream and
its index.

``stage_rows`` stages a dispatch's block rows.  After the readback,
``frame_blocks`` takes the coded words as one flat int32 image and each
block's metadata: it ORs in the header and end-of-block code, sets BFINAL
on a stream's last block, appends the empty stored sync block after every
other coded block (so that the next one starts on a byte), writes stored
blocks from the input, and returns the bytes with a block table of
``TABLE_FIELDS`` int64 columns, the fields of a ``BlockInfo``.  The index
anchors are built as arrays from the blocks' start bits and the readback
arrays: ``lane_anchors`` (segment starts, or the turbo index's pairs) and
``sub_anchors`` (the wide index's 128-byte anchors).
"""
from __future__ import annotations

import numpy as np

from ..ops.deflate_kernel import _BIGS
from ..spec import constants as C
from ..spec.refmodel import BlockInfo, StreamIndex, adler32

# a block table's columns: btype, bfinal, start, payload start and end
# bits, first output byte, output bytes (a BlockInfo's fields)
TABLE_FIELDS = 7
_STORED_MAX = 65535


def stage_rows(src, lo: int, hi: int, N: int, B: int | None = None,
               prefix: int = 0):
    """Chunks [lo, hi) of ``src`` as block rows -> (rows (B, prefix + N + 8)
    uint8, n_valid (B,) int32): chunk i in row i - lo from column
    ``prefix``, zeros elsewhere; B is hi - lo when None.  ``src`` is a
    contiguous uint8 array (chunk i its bytes [i*N, (i+1)*N)) or a callable
    i -> bytes-like of at most N bytes (a block provider, a payload list's
    ``__getitem__``)."""
    k = hi - lo
    rows = np.zeros((k if B is None else B, prefix + N + 8), np.uint8)
    n_valid = np.zeros(rows.shape[0], np.int32)
    if callable(src):
        for r in range(k):
            chunk = np.frombuffer(bytes(src(lo + r)), np.uint8)
            rows[r, prefix : prefix + chunk.size] = chunk
            n_valid[r] = chunk.size
        return rows, n_valid
    part = src[lo * N : hi * N]
    padded = np.zeros(k * N, np.uint8)
    padded[: part.size] = part
    rows[:k, prefix : prefix + N] = padded.reshape(k, N)
    n_valid[:k] = np.clip(part.size - np.arange(k) * N, 0, N)
    return rows, n_valid


def _or_bits(buf: np.ndarray, bit_off, value, nbits) -> None:
    """OR LSB-first bit-strings of at most 56 bits into a byte buffer at the
    bit offsets ``bit_off``, whose bytes are disjoint (arrays)."""
    v = value << (bit_off & 7)
    nbytes = (nbits + (bit_off & 7) + 7) // 8
    for i in range(int(nbytes.max(initial=0))):
        m = i < nbytes
        buf[(bit_off >> 3)[m] + i] |= ((v >> (8 * i)) & 0xFF)[m].astype(
            np.uint8)


def stored_blocks(raw: np.ndarray, final: bool, bit: int = 0,
                  out_start: int = 0):
    """``raw`` as stored blocks of at most 65,535 bytes (one empty block for
    no bytes) from stream bit ``bit`` (on a byte) and output byte
    ``out_start``, BFINAL on the last when ``final`` -> (bytes, block
    table)."""
    parts, rows = [], []
    for pos in range(0, max(raw.size, 1), _STORED_MAX):
        chunk = raw[pos : pos + _STORED_MAX]
        bf = int(final and pos + _STORED_MAX >= raw.size)
        ln = chunk.size
        part = bytes([bf]) + ln.to_bytes(2, "little") \
            + (~ln & 0xFFFF).to_bytes(2, "little") + chunk.tobytes()
        rows.append((C.BTYPE_STORED, bf, bit, bit + 8, bit + 8 * len(part),
                     out_start + pos, ln))
        parts.append(part)
        bit += 8 * len(part)
    return b"".join(parts), np.array(rows, np.int64)


def stored_stream(raw: np.ndarray):
    """``raw``, the empty input too, as a raw DEFLATE stream of stored
    blocks -> (bytes, StreamIndex without anchors)."""
    body, table = stored_blocks(raw, True)
    return body, StreamIndex(block_infos(table), np.zeros(0, np.int64),
                             np.zeros(0, np.int64), np.zeros(0, np.int32))


def block_infos(table: np.ndarray, base_bit: int = 0) -> list[BlockInfo]:
    """A block table's rows as ``BlockInfo``s, their bits moved by
    ``base_bit``."""
    t = np.array(table, np.int64).reshape(-1, TABLE_FIELDS)
    t[:, 2:5] += base_bit
    return [BlockInfo(b, bool(f), s, p, e, o, n)
            for b, f, s, p, e, o, n in t.tolist()]


def zlib_header(dictionary: bytes | None = None) -> bytes:
    """The zlib member header (RFC 1950), with a preset dictionary an FDICT
    header carrying its Adler-32 as DICTID."""
    if dictionary is None:
        return C.ZLIB_HEADER
    flg = 0x20 + (2 << 6)
    flg += (31 - (0x78 * 256 + flg) % 31) % 31
    return bytes([0x78, flg]) + adler32(dictionary).to_bytes(4, "big")


def frame_blocks(image: np.ndarray, off, pe, hdr, hdr_bits, eob_code,
                 eob_len, btype, nb, out_start, final,
                 raw: np.ndarray | None = None):
    """Consecutive blocks as stream bytes and their block table.

    A coded block's words start at word ``off`` of the int32 ``image``; its
    first ``hdr_bits`` bits are left for its header, whose bytes are a row
    of ``hdr`` (k, H) or (H,) uint8, and its payload ends at bit ``pe``,
    where the end-of-block code (``eob_code``, bit-reversed, ``eob_len``
    bits) goes; the image's other bits up to the byte after it are zero.
    A stored block (``btype``) takes its bytes from ``raw``[out_start :
    out_start + nb].  A ``final`` block ends a stream: BFINAL is set and no
    sync block follows.  Each argument is one value a block or one for all.

    Returns (bytes, block table (rows, TABLE_FIELDS) int64 from bit 0,
    start (k,) each block's first bit, row (k,) its row in the table)."""
    off = np.atleast_1d(np.asarray(off, np.int64))
    k = off.size
    pe, hdr_bits, eob_code, eob_len, btype, nb, out_start = (
        np.broadcast_to(np.asarray(x, np.int64), (k,)) for x in
        (pe, hdr_bits, eob_code, eob_len, btype, nb, out_start))
    final = np.broadcast_to(np.asarray(final, bool), (k,))
    coded = btype != C.BTYPE_STORED
    sync = coded & ~final
    end = pe + eob_len
    # a sync block's 3 header bits follow the end-of-block code in its byte
    nby = (end + 7 + 3 * sync) // 8
    stored_n = np.maximum(1, -(-nb // _STORED_MAX))
    size = np.where(coded, nby + 4 * sync, nb + 5 * stored_n)
    first = np.cumsum(size) - size
    start = 8 * first
    nrow = np.where(coded, 1 + sync, stored_n)
    row = np.cumsum(nrow) - nrow
    out = np.zeros(int(size.sum()), np.uint8)
    table = np.zeros((int(nrow.sum()), TABLE_FIELDS), np.int64)

    img = image.view(np.uint8)
    for s, o, m in zip(first[coded].tolist(), (4 * off[coded]).tolist(),
                       nby[coded].tolist()):
        out[s : s + m] = img[o : o + m]
    hdr = np.atleast_2d(np.asarray(hdr, np.uint8))
    cols = np.arange(hdr.shape[1])
    m = coded[:, None] & (cols < ((hdr_bits + 7) // 8)[:, None])
    out[(first[:, None] + cols)[m]] |= np.broadcast_to(hdr, m.shape)[m]
    out[first[coded & final]] |= 1
    _or_bits(out, start[coded] + pe[coded], eob_code[coded], eob_len[coded])
    # the sync block's LEN 00 00 and NLEN ff ff
    out[(first + nby)[sync, None] + [2, 3]] = 0xFF
    z = np.zeros(k, np.int64)
    table[row[coded]] = np.stack([btype, final, start, start + hdr_bits,
                                  start + end, out_start, nb], 1)[coded]
    table[row[sync] + 1] = np.stack([z, z, start + end, 8 * (first + nby),
                                     8 * (first + size), out_start + nb,
                                     z], 1)[sync]
    for i in np.flatnonzero(~coded).tolist():
        o0, n0 = int(out_start[i]), int(nb[i])
        part, rows = stored_blocks(raw[o0 : o0 + n0], bool(final[i]),
                                   int(start[i]), o0)
        out[first[i] : first[i] + len(part)] = np.frombuffer(part, np.uint8)
        table[row[i] : row[i] + len(rows)] = rows
    return out.tobytes(), table, start, row


def lane_anchors(start, row, nb, out_start, lane_bit0, seg_size: int,
                 split=None):
    """The anchors of coded blocks' segment lanes -> (anchor_bit,
    anchor_out, anchor_block) int64, block by block.

    ``start``, ``row``, ``nb``, ``out_start`` (k,) are each block's first
    bit, table row, bytes and first output byte, ``lane_bit0`` (k, nseg)
    the bit of each lane's first token within its block.  Each lane that
    holds bytes gives its start; with ``split`` = (split_bit, split_out
    (k, nseg), pe (k,)), the turbo index's pairs: each lane's start, then
    its first token at or past the split, or where the lane has none
    (``_BIGS``) its end, an empty second half-lane."""
    start, row, nb, out_start = (np.asarray(x, np.int64)[:, None]
                                 for x in (start, row, nb, out_start))
    lane_bit0 = np.asarray(lane_bit0, np.int64)
    s0 = np.arange(lane_bit0.shape[1], dtype=np.int64) * seg_size
    bits = start + lane_bit0
    outs = out_start + s0
    used = s0 < nb
    if split is not None:
        sb, so, pe = (np.asarray(x, np.int64) for x in split)
        lane_end = np.concatenate([lane_bit0[:, 1:], pe[:, None]], 1)
        none = sb >= _BIGS
        sb = np.where(none, lane_end - lane_bit0, sb)
        so = np.where(none, np.minimum(nb - s0, seg_size), so)
        bits = np.stack([bits, bits + sb], 2)
        outs = np.stack([outs, outs + so], 2)
        used = np.repeat(used[:, :, None], 2, 2)
        row = row[:, None]
    return bits[used], outs[used], np.broadcast_to(row, used.shape)[used]


def sub_anchors(start, row, end, nb, out_start, sub_bit, sub_out,
                seg_size: int, sub: int):
    """The wide index's anchors of coded blocks, one every ``sub`` output
    bytes -> (anchor_bit, anchor_out, anchor_block) int64, block by block.

    ``start``, ``row``, ``nb``, ``out_start`` as ``lane_anchors``, ``end``
    (k,) each block's end bit within it; ``sub_bit``, ``sub_out`` (k,
    boundaries) for each boundary of each lane in turn the bit within the
    block and the output offset within the lane of the first token at or
    past it, or ``_BIGS``.  Such a boundary takes the next one's anchor: the valid
    (bit, out) pairs do not decrease in boundary order, so that is a suffix
    minimum over the block's boundaries, the block's end after them.
    Repeated anchors mark empty decode lanes."""
    start, row, end, nb, out_start = (np.asarray(x, np.int64)[:, None]
                                      for x in (start, row, end, nb,
                                                out_start))
    j = np.arange(sub_bit.shape[1])
    outs = sub_out + j // (seg_size // sub) * seg_size
    # boundaries past the block's bytes stand for its end
    past = j >= -(-nb // sub)
    bits = np.where(past, end, np.minimum(end, sub_bit))
    outs = np.where(past, nb, np.minimum(nb, outs))
    bits = np.minimum.accumulate(bits[:, ::-1], 1)[:, ::-1]
    outs = np.minimum.accumulate(outs[:, ::-1], 1)[:, ::-1]
    return ((start + bits)[~past], (out_start + outs)[~past],
            np.broadcast_to(row, past.shape)[~past])
