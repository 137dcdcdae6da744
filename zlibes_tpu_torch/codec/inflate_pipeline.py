"""zlib-container inflate for the PyTorch port.

Counterpart of ``zlibes_tpu/codec/inflate_pipeline.py``.  Container
framing and header parsing are host work; a turbo-indexed stream's payload
decode, LZ resolve and Adler-32 run on the requested device.  A stream
without an index decodes through the shared native runtime, as the JAX
package does when that runtime is available.
"""
from __future__ import annotations

import torch

from zlibes_tpu.spec import constants as C
from zlibes_tpu.spec.errors import (
    ChecksumError,
    CorruptError,
    HeaderError,
    TruncatedError,
)
from zlibes_tpu.spec.refmodel import (
    BitReader,
    BlockInfo,
    read_dynamic_code_lengths,
)

from ..ops.adler32 import adler32_device

_FIXED_LITLEN_LENGTHS = C.fixed_litlen_code_lengths()
_FIXED_DIST_LENGTHS = C.fixed_dist_code_lengths()


def _block_code_lengths(data: bytes, blk: BlockInfo):
    """Host-parse a compressed block's header → (litlen, dist) code lengths."""
    if blk.btype == C.BTYPE_FIXED:
        return _FIXED_LITLEN_LENGTHS, _FIXED_DIST_LENGTHS
    br = BitReader(data)
    br.bitpos = blk.start_bit + 3
    ll, dl = read_dynamic_code_lengths(br)
    if blk.payload_start_bit and br.bitpos != blk.payload_start_bit:
        raise CorruptError("index does not match stream")
    return ll, dl


def _decode_native(data: bytes, offset: int, dictionary: bytes | None):
    """Whole-stream host decode of a stream without an index."""
    from zlibes_tpu.runtime import native

    if not native.available():
        raise NotImplementedError(
            "decoding a stream without an index needs the native runtime; "
            "the device decode of such streams is ROADMAP queue 1 item 8")
    out, _index, end_bit, adler = native.decode(
        data, bit_offset=offset * 8, dictionary=dictionary)
    return torch.from_numpy(out), end_bit, adler


def inflate(data: bytes, *, device: torch.device | str,
            verify_checksum: bool = True, index=None,
            dictionary: bytes | None = None) -> bytes:
    """zlib-container inflate; a turbo-indexed stream decodes on ``device``."""
    data = bytes(data)
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
        from zlibes_tpu.spec.refmodel import adler32 as _adler_host

        if int.from_bytes(data[2:6], "big") != _adler_host(dictionary):
            raise HeaderError("DICTID does not match supplied dictionary")
        offset = 6
    else:
        dictionary = None
    known_adler = None
    if index is None:
        out, end_bit, known_adler = _decode_native(data, offset, dictionary)
    elif getattr(index, "turbo", False):
        if dictionary is not None:
            raise HeaderError("turbo streams never carry FDICT")
        from .turbo import inflate_raw_turbo

        out = inflate_raw_turbo(data, index, device)
        end_bit = index.blocks[-1].end_bit
    elif getattr(index, "wide", False):
        raise NotImplementedError(
            "default-profile (wide) indexed inflate is not ported yet "
            "(ROADMAP queue 1 item 4)")
    else:
        raise NotImplementedError(
            "generic indexed inflate is not ported yet "
            "(ROADMAP queue 1 item 8)")
    if verify_checksum:
        trailer_pos = (end_bit + 7) >> 3
        if trailer_pos + 4 > len(data):
            raise TruncatedError("missing Adler-32 trailer")
        expect = int.from_bytes(data[trailer_pos : trailer_pos + 4], "big")
        if known_adler is not None:
            # the native decode folded Adler-32 into its resolve pass
            actual = known_adler
        else:
            actual = int(adler32_device(out))
        if expect != actual:
            raise ChecksumError(f"Adler-32 mismatch: {expect:#x} != {actual:#x}")
    return out.cpu().numpy().tobytes()
