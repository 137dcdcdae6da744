"""Public API of the PyTorch port (counterpart of ``zlibes_tpu/codec/api.py``)."""
from __future__ import annotations

import torch


def _device(device: torch.device | str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is false")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def inflate(data: bytes, *, index=None, verify_checksum: bool = True,
            dictionary: bytes | None = None,
            device: torch.device | str = "cuda") -> bytes:
    """Decompress a zlib stream, verifying the Adler-32 trailer.

    ``index=`` a turbo-profile StreamIndex selects the lane-parallel decode
    on ``device`` (CUDA kernels on a card, their plain PyTorch versions on
    the CPU).  Without an index the stream decodes through the shared
    native runtime.  ``dictionary=`` supplies the preset dictionary for
    FDICT streams (RFC 1950 §2.2).
    """
    from . import inflate_pipeline

    return inflate_pipeline.inflate(bytes(data), verify_checksum=verify_checksum,
                                    index=index, dictionary=dictionary,
                                    device=_device(device))
