"""Canonical-Huffman decode-table construction, batched over blocks.

Reference analog: the per-block nested-map construction at src/huffman.ts:8-39
and the bit-serial canonical decoder at src/inflate.ts:239-252.  Device
redesign: each block gets a *flat* 2^M-entry lookup table indexed by the
next M stream bits (LSB-first), so the device decode loop is one gather per
symbol instead of one branch per bit.  Table construction is vectorized in
NumPy across all blocks of a batch (it is header-sized work, not
payload-sized).

Entry packing (int32):
  litlen: bits0-3 codelen | bits4-5 kind (0 lit, 1 EOB, 2 length, 3 invalid)
          | bits6-15 value (literal byte / length base) | bits16-18 extra#
  dist:   bits0-3 codelen | bits4-7 extra# | bits8-23 dist base | bit24 invalid
"""
from __future__ import annotations

import numpy as np

from ..spec import constants as C
from ..spec.errors import CorruptError

# kind codes in litlen entries
KIND_LITERAL = 0
KIND_EOB = 1
KIND_LENGTH = 2
KIND_INVALID = 3

# bit-reversal lookup for 16-bit values
_REV16 = np.zeros(1 << 16, dtype=np.uint32)
_v = np.arange(1 << 16, dtype=np.uint32)
for _i in range(16):
    _REV16 |= (((_v >> _i) & 1) << (15 - _i)).astype(np.uint32)
del _v, _i


def litlen_entry_meta() -> np.ndarray:
    """Per-symbol litlen metadata (kind/value/extra packed at bits 4+)."""
    meta = np.zeros(C.NUM_LITLEN_SYMBOLS, dtype=np.int64)
    sym = np.arange(C.NUM_LITLEN_SYMBOLS)
    # literals 0..255
    meta[:256] = (KIND_LITERAL << 4) | (sym[:256] << 6)
    meta[256] = KIND_EOB << 4
    for i in range(29):
        meta[257 + i] = (
            (KIND_LENGTH << 4)
            | (int(C.LENGTH_BASE[i]) << 6)
            | (int(C.LENGTH_EXTRA_BITS[i]) << 16)
        )
    meta[286:] = KIND_INVALID << 4
    return meta


def dist_entry_meta() -> np.ndarray:
    """Per-symbol distance metadata (extra/base packed at bits 4+)."""
    meta = np.zeros(C.NUM_DIST_SYMBOLS, dtype=np.int64)
    for i in range(30):
        meta[i] = (int(C.DIST_EXTRA_BITS[i]) << 4) | (int(C.DIST_BASE[i]) << 8)
    meta[30:] = 1 << 24  # reserved symbols → invalid bit
    return meta


_LITLEN_META = litlen_entry_meta()
_DIST_META = dist_entry_meta()


def canonical_codes_batch(lengths: np.ndarray) -> np.ndarray:
    """Canonical code assignment (RFC 1951 §3.2.2), vectorized over rows.

    lengths: (B, S) int array of code lengths (0 = unused).
    Returns codes (B, S) as MSB-first integers.  Raises CorruptError on an
    over-subscribed code (Kraft sum > 1).
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    B, S = lengths.shape
    max_bits = int(lengths.max(initial=1))
    # Kraft check
    kraft = np.zeros(B, dtype=np.int64)
    for l in range(1, max_bits + 1):
        kraft += (lengths == l).sum(axis=1) << (15 - l)
    if (kraft > (1 << 15)).any():
        raise CorruptError("over-subscribed Huffman code")
    bl_count = np.zeros((B, max_bits + 1), dtype=np.int64)
    for l in range(1, max_bits + 1):
        bl_count[:, l] = (lengths == l).sum(axis=1)
    next_code = np.zeros((B, max_bits + 2), dtype=np.int64)
    code = np.zeros(B, dtype=np.int64)
    for l in range(1, max_bits + 1):
        code = (code + bl_count[:, l - 1]) << 1
        next_code[:, l] = code
    codes = np.zeros((B, S), dtype=np.int64)
    for l in range(1, max_bits + 1):
        mask = lengths == l
        rank = np.cumsum(mask, axis=1) - mask  # count of same-length syms before
        codes[mask] = (next_code[:, l : l + 1] + rank)[mask]
    return codes


def build_decode_tables(
    lengths: np.ndarray, meta: np.ndarray, max_bits: int
) -> np.ndarray:
    """Flat decode tables for a batch of blocks.

    lengths: (B, S) code lengths; meta: (S,) packed per-symbol metadata.
    Returns (B, 2**max_bits) int32 where entry = codelen | meta[sym], and
    0 (codelen 0) marks an invalid/unassigned bit pattern.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    B, S = lengths.shape
    if int(lengths.max(initial=0)) > max_bits:
        raise CorruptError("code length exceeds table width")
    codes = canonical_codes_batch(lengths)
    size = 1 << max_bits
    table = np.zeros(B * size, dtype=np.int64)
    brow = np.arange(B, dtype=np.int64)[:, None] * size
    for l in range(1, max_bits + 1):
        bsel, ssel = np.nonzero(lengths == l)
        if bsel.size == 0:
            continue
        # LSB-first index base = bit_reverse(code, l)
        base = (_REV16[codes[bsel, ssel].astype(np.uint32)] >> (16 - l)).astype(np.int64)
        entry = l | _LITLEN_META_OR(meta, ssel)
        reps = np.arange(1 << (max_bits - l), dtype=np.int64) << l
        idx = (bsel * size + base)[:, None] + reps[None, :]
        table[idx] = entry[:, None]
    _ = brow
    return table.reshape(B, size).astype(np.int32)


def _LITLEN_META_OR(meta: np.ndarray, ssel: np.ndarray) -> np.ndarray:
    return meta[ssel]


def build_litlen_tables(lengths: np.ndarray, max_bits: int) -> np.ndarray:
    return build_decode_tables(lengths, _LITLEN_META, max_bits)


def build_dist_tables(lengths: np.ndarray, max_bits: int) -> np.ndarray:
    return build_decode_tables(lengths, _DIST_META, max_bits)
