"""Typed error taxonomy for the codec.

Mirrors the failure modes of zlib.es: bad container header
("Not compressed by deflate", src/zlib.ts:15), unsupported BTYPE
(src/inflate.ts:32), truncated data (src/inflate.ts:35), stored-block
LEN/NLEN mismatch (src/inflate.ts:50), corrupt Huffman data
(src/inflate.ts:88,166,246,276), and bit-stream overrun
(src/utils/BitReadStream.ts:15).  We add ChecksumError: unlike the
reference (which never verifies Adler-32 on inflate), we do.
"""


class ZlibError(Exception):
    """Base class for all codec errors."""


class HeaderError(ZlibError):
    """Malformed zlib container header (bad CM/CINFO/FCHECK, or FDICT set)."""


class BlockTypeError(ZlibError):
    """Reserved/unsupported BTYPE (3) in a DEFLATE block header."""


class TruncatedError(ZlibError):
    """Input ended before the stream was complete."""


class StoredBlockError(ZlibError):
    """Stored block LEN/NLEN complement check failed."""


class CorruptError(ZlibError):
    """Invalid Huffman code, bad RLE state, or out-of-range back-reference."""


class ChecksumError(ZlibError):
    """Adler-32 of decompressed output does not match the stream trailer."""
