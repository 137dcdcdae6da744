"""Public API of the PyTorch port (counterpart of ``zlibes_tpu/codec/api.py``)."""
from __future__ import annotations

import torch

from ..spec.refmodel import StreamIndex


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


def deflate(data: bytes, *, level: int | None = None, config=None,
            block_size: int | None = None, stats=None,
            dictionary: bytes | None = None,
            device: torch.device | str = "cuda") -> bytes:
    """Compress ``data`` into a zlib stream (header 0x78 0x9C + Adler-32) on
    ``device`` (CUDA kernels on a card, their plain PyTorch versions on the
    CPU).

    The port encodes the turbo profile: ``config`` must be
    ``CodecConfig.turbo(...)`` (shared tables, 512-byte segments, 4 KiB
    window resets, codes of at most 9 bits).  ``level=``, the default
    config and ``dictionary=`` raise NotImplementedError (the general
    encoder, levels 1-9, is not ported yet); a config of another class
    raises TypeError.  ``stats`` (a CodecStats) collects
    per-call observability.  The pipeline's ``deflate(..., with_index=True)``
    also returns the stream's StreamIndex.
    """
    from . import deflate_pipeline

    dev = _device(device)
    return deflate_pipeline.deflate(data, block_size=block_size,
                                    level=level, config=config, stats=stats,
                                    dictionary=dictionary, device=dev)


def inflate(data: bytes, *, index=None, verify_checksum: bool = True,
            dictionary: bytes | None = None,
            device: torch.device | str = "cuda") -> bytes:
    """Decompress a zlib stream, verifying the Adler-32 trailer.

    ``index=`` a turbo-profile or a wide (default-profile, levels 1-9)
    StreamIndex selects the lane-parallel decode on ``device`` (CUDA
    kernels on a card, their plain PyTorch versions on the CPU: one decode
    and one resolve kernel a call).  Without an index, and with any other
    index (generic 4 KiB anchors, a ``build_index`` index of a foreign
    stream, a non-turbo index on an FDICT stream), the stream decodes on
    the host through the port's native runtime, and an index that does not
    match what was decoded raises CorruptError.  ``dictionary=`` supplies
    the preset dictionary for FDICT streams (RFC 1950 §2.2).
    """
    from . import inflate_pipeline

    return inflate_pipeline.inflate(bytes(data), verify_checksum=verify_checksum,
                                    index=_own_index(index),
                                    dictionary=dictionary,
                                    device=_device(device))


def inflate_range(data: bytes, index, start: int, length: int, *,
                  device: torch.device | str = "cuda") -> bytes:
    """Random-access decode: output bytes [start, start+length) only.

    Decodes, on ``device``, just the self-contained blocks covering the
    range of a stream with a turbo or a wide index, so the cost is
    O(length + block_size) whatever the stream's size.
    """
    from . import inflate_pipeline

    return inflate_pipeline.inflate_range(bytes(data), _own_index(index),
                                          start, length,
                                          device=_device(device))


def inflate_to_device(data: bytes, index, *,
                      device: torch.device | str = "cuda"):
    """Decompress a stream with a turbo or a wide index straight into
    ``device`` memory, with no device-to-host copy of the output.

    Returns a list of (uint8 tensor, out_offset, nbytes) spans covering the
    output: bytes [out_offset, out_offset + nbytes) are the tensor's first
    nbytes.
    """
    from . import inflate_pipeline

    return inflate_pipeline.inflate_to_device(bytes(data), _own_index(index),
                                              device=_device(device))


def build_index(data: bytes, anchor_every: int = 4096) -> StreamIndex:
    """Scan any conformant zlib stream into a StreamIndex (block layout and
    one decode anchor about every ``anchor_every`` output bytes), for
    streams this framework did not write.  ``inflate(data, index=...)``
    accepts it (host decode, the index checked against the stream).
    Requires the native runtime scanner; RuntimeError without it.
    """
    from ..runtime import native

    if not native.available():
        raise RuntimeError("native runtime unavailable")
    _, _, index, _, _ = native.scan(bytes(data), bit_offset=16,
                                    anchor_every=anchor_every)
    return index
