"""RFC 1950/1951 format constants, as NumPy arrays.

This is the L1 "shared constants" layer of the framework (reference analog:
``src/const.ts:1-35`` — BTYPE enum, block size, length/distance extra-bit
tables, code-length order permutation). Values here are mandated by the
DEFLATE spec (RFC 1951 §3.2.5-3.2.7) and the zlib container spec (RFC 1950),
not copied from any implementation.
"""
from __future__ import annotations

import numpy as np

# --- Block types (RFC 1951 §3.2.3) -----------------------------------------
BTYPE_STORED = 0
BTYPE_FIXED = 1
BTYPE_DYNAMIC = 2

# Maximum bytes of raw input encoded per DEFLATE block by our encoder.
# The reference uses 131072 (src/const.ts:7); we keep the same default so
# compressed-size comparisons are at the same operating point.
BLOCK_MAX_BUFFER_LEN = 131072

# 32 KiB LZ77 window (RFC 1951 §2; reference src/lz77.ts:49).
WINDOW_SIZE = 32768

# Maximum match length / minimum match length (RFC 1951 §3.2.5).
MAX_MATCH = 258
MIN_MATCH = 3

# --- Length codes 257..285 (RFC 1951 §3.2.5) --------------------------------
# LENGTH_EXTRA_BITS[i] / LENGTH_BASE[i] describe litlen symbol 257+i.
LENGTH_EXTRA_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1,
     2, 2, 2, 2,
     3, 3, 3, 3,
     4, 4, 4, 4,
     5, 5, 5, 5,
     0],
    dtype=np.int32,
)
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10,
     11, 13, 15, 17,
     19, 23, 27, 31,
     35, 43, 51, 59,
     67, 83, 99, 115,
     131, 163, 195, 227,
     258],
    dtype=np.int32,
)

# --- Distance codes 0..29 (RFC 1951 §3.2.5) ---------------------------------
DIST_EXTRA_BITS = np.array(
    [0, 0, 0, 0,
     1, 1, 2, 2,
     3, 3, 4, 4,
     5, 5, 6, 6,
     7, 7, 8, 8,
     9, 9, 10, 10,
     11, 11, 12, 12,
     13, 13],
    dtype=np.int32,
)
DIST_BASE = np.array(
    [1, 2, 3, 4,
     5, 7, 9, 13,
     17, 25, 33, 49,
     65, 97, 129, 193,
     257, 385, 513, 769,
     1025, 1537, 2049, 3073,
     4097, 6145, 8193, 12289,
     16385, 24577],
    dtype=np.int32,
)

# Order in which code-length-alphabet code lengths are transmitted
# (RFC 1951 §3.2.7).
CODELEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# Alphabet sizes.
NUM_LITLEN_SYMBOLS = 288   # 0..287 (286/287 reserved, never coded)
NUM_DIST_SYMBOLS = 32      # 0..31 (30/31 reserved)
NUM_CODELEN_SYMBOLS = 19
END_OF_BLOCK = 256

# Code-length caps (RFC 1951 §3.2.7).
MAX_CODELEN_BITS = 15      # litlen / dist codes
MAX_CLC_BITS = 7           # code-length-alphabet codes

# --- Fixed Huffman code lengths (RFC 1951 §3.2.6) ---------------------------


def fixed_litlen_code_lengths() -> np.ndarray:
    """Static litlen code lengths: 0-143→8, 144-255→9, 256-279→7, 280-287→8."""
    lens = np.empty(NUM_LITLEN_SYMBOLS, dtype=np.int32)
    lens[0:144] = 8
    lens[144:256] = 9
    lens[256:280] = 7
    lens[280:288] = 8
    return lens


def fixed_dist_code_lengths() -> np.ndarray:
    """Static distance code lengths: all 32 symbols use 5 bits."""
    return np.full(NUM_DIST_SYMBOLS, 5, dtype=np.int32)


# --- zlib container (RFC 1950) ----------------------------------------------
ZLIB_CM_DEFLATE = 8
ZLIB_CINFO_32K = 7
# Header bytes our encoder emits: CMF=0x78 (CM=8, CINFO=7); FLG chosen with
# FLEVEL=2, FDICT=0 and FCHECK making (CMF*256+FLG) % 31 == 0 → 0x9C.
# (Same header the reference writes, src/zlib.ts:28-34.)
ZLIB_HEADER = bytes([0x78, 0x9C])

ADLER_MOD = 65521

# --- Reverse-symbol lookup tables (value → code), used by encoders ----------


def build_length_code_table() -> tuple[np.ndarray, np.ndarray]:
    """Map match length 3..258 → (litlen symbol, extra-bit value).

    Returns (symbol[259], extra[259]); indices 0..2 are unused.
    """
    sym = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    extra = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    for i in range(len(LENGTH_BASE)):
        base = int(LENGTH_BASE[i])
        nbits = int(LENGTH_EXTRA_BITS[i])
        hi = MAX_MATCH if i == len(LENGTH_BASE) - 1 else base + (1 << nbits) - 1
        hi = min(hi, MAX_MATCH)
        for length in range(base, hi + 1):
            sym[length] = 257 + i
            extra[length] = length - base
    # length 258 maps to code 285 with 0 extra bits (not 284's range end)
    sym[MAX_MATCH] = 285
    extra[MAX_MATCH] = 0
    return sym, extra


def build_dist_code_table() -> tuple[np.ndarray, np.ndarray]:
    """Map distance 1..32768 → (dist symbol, extra-bit value)."""
    sym = np.zeros(WINDOW_SIZE + 1, dtype=np.int32)
    extra = np.zeros(WINDOW_SIZE + 1, dtype=np.int32)
    for i in range(len(DIST_BASE)):
        base = int(DIST_BASE[i])
        nbits = int(DIST_EXTRA_BITS[i])
        hi = base + (1 << nbits) - 1
        hi = min(hi, WINDOW_SIZE)
        for dist in range(base, hi + 1):
            sym[dist] = i
            extra[dist] = dist - base
    return sym, extra


LENGTH_TO_SYMBOL, LENGTH_TO_EXTRA = build_length_code_table()
DIST_TO_SYMBOL, DIST_TO_EXTRA = build_dist_code_table()
