"""Public API of the PyTorch port (counterpart of ``zlibes_tpu/codec/api.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..spec import constants as C
from ..spec import refmodel as _rm
from ..spec.refmodel import StreamIndex

# "device": the pipelines on ``device=`` (CUDA kernels on a card, their plain
# PyTorch versions on the CPU); "refmodel": the numpy spec model on the host.
# There is no "auto": the port never gives way from the device to the host
# model by itself.
_BACKENDS = ("device", "refmodel")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {_BACKENDS}")


def _device(device: torch.device | str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is false")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def _own_index(index):
    """``index`` if it is the port's own ``StreamIndex`` (or None); an
    object of any other class, an index of the JAX package included, raises
    TypeError: convert it first with ``index_from_reference``."""
    if index is not None and not isinstance(index, StreamIndex):
        raise TypeError(
            f"index is a {type(index).__module__}.{type(index).__qualname__},"
            f" not zlibes_tpu_torch.StreamIndex; convert it with "
            f"zlibes_tpu_torch.spec.refmodel.index_from_reference")
    return index


def deflate(data: bytes, *, backend: str = "device",
            level: int | None = None, config=None,
            block_size: int | None = None, stats=None,
            dictionary: bytes | None = None,
            device: torch.device | str = "cuda") -> bytes:
    """Compress ``data`` into a zlib stream (header 0x78 0x9C, or the FDICT
    header with ``dictionary``, + Adler-32) on ``device`` (CUDA kernels on
    a card, their plain PyTorch versions on the CPU).

    ``level`` 0..9 selects a speed/ratio preset (zlib-style; 0 stores);
    ``config`` (a ``CodecConfig``) overrides it; with neither the default
    config (level 6) encodes.  ``CodecConfig.turbo(...)`` selects the turbo
    profile (shared tables, 512-byte segments, 4 KiB window resets, codes
    of at most 9 bits); every other shared-tables config encodes through
    the same shared-table encoder, with coded fields of up to 48 bits.  A
    config of another class raises TypeError.
    ``dictionary=`` supplies a preset dictionary (RFC 1950 §2.2).
    ``stats`` (a ``CodecStats``) collects per-call observability.

    ``backend="device"`` (the default) runs the pipeline on ``device``;
    ``backend="refmodel"`` runs the numpy spec model on the host with
    ``block_size`` and ``dictionary`` and ignores the other arguments.
    There is no "auto": the device path never gives way to the host model
    by itself, and a failure on the device raises.
    """
    _check_backend(backend)
    if backend == "refmodel":
        kw = {"block_size": block_size} if block_size else {}
        return _rm.deflate(bytes(data), dictionary=dictionary, **kw)
    from . import deflate_pipeline

    dev = _device(device)
    return deflate_pipeline.deflate(data, block_size=block_size,
                                    level=level, config=config, stats=stats,
                                    dictionary=dictionary, device=dev)


def deflate_indexed(data: bytes, *, backend: str = "device",
                    block_size: int | None = None,
                    device: torch.device | str = "cuda"):
    """Compress with the default config and return (zlib bytes,
    StreamIndex).

    The index (block layout and decode anchors) selects the lane-parallel
    ``inflate(..., index=)`` and the seekable ``inflate_range``; the stream
    itself is plain conformant zlib.  ``backend`` as for ``deflate``: the
    device pipeline's index is a wide one (an anchor every 128 output
    bytes), the host model's a generic one (about every 4 KiB).
    """
    _check_backend(backend)
    if backend == "refmodel":
        kw = {"block_size": block_size} if block_size else {}
        return _rm.deflate(bytes(data), with_index=True, **kw)
    from . import deflate_pipeline

    return deflate_pipeline.deflate(bytes(data), block_size=block_size,
                                    with_index=True, device=_device(device))


def inflate(data: bytes, *, backend: str = "device", index=None,
            verify_checksum: bool = True, dictionary: bytes | None = None,
            device: torch.device | str = "cuda") -> bytes:
    """Decompress a zlib stream, verifying the Adler-32 trailer.

    ``index=`` a turbo-profile or a wide (default-profile, levels 1-9)
    StreamIndex selects the lane-parallel decode on ``device`` (CUDA
    kernels on a card, their plain PyTorch versions on the CPU: one decode
    and one resolve kernel a call).  Without an index, and with any other
    index (generic 4 KiB anchors, a ``build_index`` index of a foreign
    stream, a non-turbo index on an FDICT stream), the stream decodes on
    the host through the port's native runtime when it is available, and
    an index that does not match what was decoded raises CorruptError;
    without that runtime it decodes on ``device``: through the index's
    anchor lanes (kernels ``decode_tokens`` + ``resolve_global``), or
    without an index block by block (the scan).  ``dictionary=`` supplies
    the preset dictionary for FDICT streams (RFC 1950 §2.2).

    ``backend="refmodel"`` decodes with the numpy spec model on the host
    (``verify_checksum`` and ``dictionary`` passed on, ``index`` unused);
    the default ``"device"`` never gives way to it by itself.
    """
    _check_backend(backend)
    if backend == "refmodel":
        return _rm.inflate(bytes(data), verify_checksum=verify_checksum,
                           dictionary=dictionary)
    from . import inflate_pipeline

    return inflate_pipeline.inflate(bytes(data), verify_checksum=verify_checksum,
                                    index=_own_index(index),
                                    dictionary=dictionary,
                                    device=_device(device))


def inflate_range(data: bytes, index, start: int, length: int, *,
                  device: torch.device | str = "cuda", stats=None) -> bytes:
    """Random-access decode: output bytes [start, start+length) only.

    Decodes, on ``device``, just the blocks covering the range, through
    any self-contained index (turbo, wide, or generic: the host model's,
    ``build_index`` of a stream written with full flushes), so the cost is
    O(length + block_size) whatever the stream's size.  A chained index (a
    stock-zlib stream's) needs access points, ``build_index(...,
    point_every=)``: the read decodes from the last point at or before
    ``start``, behind that point's window, through the block that holds
    the last byte, and uploads only those blocks' bytes, as zlib's
    examples/zran.c reads.  A chained index without points raises
    CorruptError, a stream with a preset dictionary HeaderError.
    ``stats`` (a ``CodecStats``) gets the bytes returned, the decode
    dispatches and, from a point, ``point_reads`` and ``lead_bytes`` (the
    output decoded before ``start``).
    """
    from . import inflate_pipeline

    return inflate_pipeline.inflate_range(bytes(data), _own_index(index),
                                          start, length,
                                          device=_device(device),
                                          stats=stats)


def inflate_to_device(data: bytes, index, *,
                      device: torch.device | str = "cuda", stats=None):
    """Decompress a stream with any index (turbo, wide, generic, or the
    chained ``build_index`` index of a stock-zlib stream) straight into
    ``device`` memory, with no device-to-host copy of the output.

    A chained index decodes through its anchor lanes in groups (kernels
    ``decode_tokens`` + ``resolve_global``), in stream order, each group
    behind the 32 KiB of output before it, with no host sync between
    groups.  Returns a list of (uint8 tensor, out_offset, nbytes) spans
    covering the output: bytes [out_offset, out_offset + nbytes) are the
    tensor's first nbytes (one span today).  A stream with a preset
    dictionary raises HeaderError.  ``stats`` (a ``CodecStats``) collects
    the bytes in and out, the blocks, the decode dispatches (groups on the
    group path) and ``chained_groups``, the groups resolved behind the
    previous group's output.
    """
    from . import inflate_pipeline

    return inflate_pipeline.inflate_to_device(bytes(data), _own_index(index),
                                              device=_device(device),
                                              stats=stats)


def build_index(data: bytes, anchor_every: int = 4096,
                point_every: int = 0) -> StreamIndex:
    """Scan any conformant zlib stream into a StreamIndex (block layout and
    one decode anchor about every ``anchor_every`` output bytes), for
    streams this framework did not write.  ``inflate(data, index=...)``
    accepts it (host decode, the index checked against the stream),
    ``inflate_to_device`` does whether its blocks are chained or not, and
    ``inflate_range`` does when they are self-contained (a stream written
    with full flushes) or when the index has access points.

    ``point_every`` > 0 adds access points, as zlib's examples/zran.c
    keeps them: one at block 0 and one at the first block boundary at or
    past every ``point_every`` bytes of output after the last, each with
    the up to 32 KiB of output before it, from one host decode of the
    stream (in place of the scan, which gives the same blocks and
    anchors).  0, the default, adds none.
    Requires the native runtime scanner; RuntimeError without it.
    """
    from ..runtime import native

    if not native.available():
        raise RuntimeError("native runtime unavailable")
    if point_every <= 0:
        _, _, index, _, _ = native.scan(bytes(data), bit_offset=16,
                                        anchor_every=anchor_every)
        return index
    out, index, _, _ = native.decode(bytes(data), bit_offset=16,
                                     anchor_every=anchor_every)
    starts = [b.out_start for b in index.blocks]
    points, last = [0], 0
    for b, o in enumerate(starts):
        if o - starts[last] >= point_every and o < out.size:
            points.append(b)
            last = b
    W = C.WINDOW_SIZE
    index.point_block = np.asarray(points, np.int64)
    index.point_window = [out[max(0, starts[b] - W) : starts[b]].tobytes()
                          for b in points]
    return index
