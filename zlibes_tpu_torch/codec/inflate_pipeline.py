"""zlib-container inflate for the PyTorch port.

Counterpart of ``zlibes_tpu/codec/inflate_pipeline.py``.  Container
framing and header parsing are host work; the payload decode, LZ resolve
and Adler-32 of a stream with a turbo or a wide (default-profile) index run
on the requested device, as do the seek (``inflate_range``) and the
device-resident output (``inflate_to_device``).  A stream without an index,
and a stream whose index the card cannot use (generic 4 KiB anchors, a
chained index of a foreign stream, any non-turbo index on a stream with a
preset dictionary), decodes on the host through the port's native runtime
(``runtime/native.py``), as the JAX package does when that runtime is
available; the index must still match what was decoded.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spec import constants as C
from ..spec.errors import (
    ChecksumError,
    CorruptError,
    HeaderError,
    TruncatedError,
)
from ..spec.refmodel import (
    BitReader,
    BlockInfo,
    StreamIndex,
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
    """Whole-stream host decode, for a stream without an index or with one
    the card cannot use: (bytes as a uint8 CPU tensor, end bit, Adler-32)."""
    from ..runtime import native

    if not native.available():
        raise NotImplementedError(
            "this stream has no turbo or self-contained wide index, so it "
            "decodes on the host, which needs the native runtime (g++); the "
            "device decode of generic and un-indexed streams is not ported "
            "yet")
    out, _index, end_bit, adler = native.decode(
        data, bit_offset=offset * 8, dictionary=dictionary)
    return torch.from_numpy(out), end_bit, adler


def _on_device(index: StreamIndex, dictionary: bytes | None = None) -> bool:
    """Whether the card decodes this index: a turbo index, or a wide,
    self-contained one on a stream without a preset dictionary."""
    return bool(getattr(index, "turbo", False)
                or (getattr(index, "wide", False) and dictionary is None
                    and getattr(index, "self_contained", True)))


def _inflate_indexed(data: bytes, index: StreamIndex,
                     device: torch.device | str,
                     check: bool = True) -> torch.Tensor:
    """Device decode of an indexed stream's payload: the turbo path for a
    turbo index, the wide path for a self-contained wide index.  Returns
    the output bytes as a uint8 tensor on ``device``."""
    if getattr(index, "turbo", False):
        from .turbo import inflate_raw_turbo

        return inflate_raw_turbo(data, index, device, check=check)
    if _on_device(index):
        from .wide import inflate_raw_wide

        return inflate_raw_wide(data, index, device, check=check)
    raise NotImplementedError(
        "the device decode of a generic index (4 KiB anchors, neither turbo "
        "nor wide) is not ported yet: inflate_range and inflate_to_device "
        "need a turbo or a wide index; inflate() decodes such a stream on "
        "the host")


def inflate_range(data: bytes, index: StreamIndex, start: int, length: int,
                  *, device: torch.device | str) -> bytes:
    """Random-access decode of output bytes [start, start+length).

    Only the self-contained blocks overlapping the range are decoded, on
    ``device``, through a sub-index that keeps the turbo and wide flags, so
    a seek runs the same kernels as a whole-stream decode.  Block
    out_starts are multiples of 128 KiB, so the sub-stream keeps the anchor
    geometry (512 B turbo segments, 128 B wide sub-spans).
    """
    total = index.total_out
    if start < 0 or length < 0 or start + length > total:
        raise ValueError(
            f"range [{start}, {start + length}) outside output [0, {total})")
    if not getattr(index, "self_contained", True):
        raise CorruptError(
            "inflate_range requires self-contained blocks (indexes from this "
            "framework's encoder); foreign chained streams must decode from "
            "the start")
    if length == 0:
        return b""
    end = start + length
    keep = [i for i, b in enumerate(index.blocks) if b.out_len
            and b.out_start < end and b.out_start + b.out_len > start]
    out_lo = index.blocks[keep[0]].out_start
    keep_arr = np.asarray(keep, np.int32)
    mask = np.isin(index.anchor_block, keep_arr)
    sub = StreamIndex(
        [BlockInfo(b.btype, b.bfinal, b.start_bit, b.payload_start_bit,
                   b.end_bit, b.out_start - out_lo, b.out_len)
         for b in (index.blocks[i] for i in keep)],
        index.anchor_bit[mask],
        index.anchor_out[mask] - out_lo,
        np.searchsorted(keep_arr, index.anchor_block[mask]).astype(np.int32),
        True,
        getattr(index, "chunk_reset", 0),
        getattr(index, "turbo", False),
        getattr(index, "max_tokens", 0),
        getattr(index, "wide", False),
    )
    out = _inflate_indexed(bytes(data), sub, device)
    return out[start - out_lo : end - out_lo].cpu().numpy().tobytes()


def inflate_to_device(data: bytes, index: StreamIndex, *,
                      device: torch.device | str):
    """Decompress into device memory, with no copy of the output to the
    host: returns [(uint8 tensor on ``device``, out_offset, nbytes)].

    One span covers the whole output: a turbo stream's chunk rows or a wide
    stream's block rows, flattened, or, for a wide stream with stored
    content, one spliced tensor.  As in the reference, the decode's meta
    checks are skipped; the caller verifies the bytes.
    """
    if not getattr(index, "self_contained", True):
        raise CorruptError(
            "inflate_to_device requires self-contained blocks (streams "
            "produced by this framework); use inflate() for foreign streams")
    out = _inflate_indexed(bytes(data), index, device, check=False)
    return [(out, 0, index.total_out)]


def inflate(data: bytes, *, device: torch.device | str,
            verify_checksum: bool = True, index=None,
            dictionary: bytes | None = None) -> bytes:
    """zlib-container inflate; a turbo- or wide-indexed stream decodes on
    ``device``, any other on the host through the native runtime."""
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
        from ..spec.refmodel import adler32 as _adler_host

        if int.from_bytes(data[2:6], "big") != _adler_host(dictionary):
            raise HeaderError("DICTID does not match supplied dictionary")
        offset = 6
    else:
        dictionary = None
    known_adler = None
    if index is not None and _on_device(index, dictionary):
        if dictionary is not None:
            raise HeaderError("turbo streams never carry FDICT")
        out = _inflate_indexed(data, index, device)
        end_bit = index.blocks[-1].end_bit
    else:
        out, end_bit, known_adler = _decode_native(data, offset, dictionary)
        # the decode did not need the index, but a caller who passes one
        # that belongs to another stream must get an error, not the bytes
        if index is not None and (index.blocks[-1].end_bit != end_bit
                                  or index.total_out != out.numel()):
            raise CorruptError("index does not match this stream (block "
                               "layout / output size disagree)")
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
