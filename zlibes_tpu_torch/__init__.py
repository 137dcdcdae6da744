"""zlibes_tpu_torch — the zlib/DEFLATE codec on PyTorch and CUDA (Hopper).

The port of ``zlibes_tpu``: the same streams, indexes and typed errors,
encoded (turbo profile, ``deflate(data, config=CodecConfig.turbo())``)
and decoded (turbo and wide indexed streams) by CUDA kernels written for
the H100 (``csrc/``) on a card and by their plain PyTorch versions on the
CPU.  Imports ``torch`` and never ``jax``.
"""
from zlibes_tpu.config import CodecConfig, CodecStats
from zlibes_tpu.spec import errors
from zlibes_tpu.spec.errors import (
    ChecksumError,
    CorruptError,
    HeaderError,
    TruncatedError,
    ZlibError,
)
from zlibes_tpu.spec.refmodel import StreamIndex

from .codec.api import deflate, inflate, inflate_range, inflate_to_device

__all__ = ["deflate", "inflate", "inflate_range", "inflate_to_device",
           "StreamIndex", "CodecConfig", "CodecStats",
           "errors", "ZlibError", "HeaderError", "TruncatedError",
           "CorruptError", "ChecksumError"]
