"""zlibes_tpu_torch — the zlib/DEFLATE codec on PyTorch and CUDA (Hopper).

The port of ``zlibes_tpu``: the same streams, indexes and typed errors,
decoded by CUDA kernels written for the H100 (``csrc/``) on a card and by
their plain PyTorch versions on the CPU.  Imports ``torch`` and never
``jax``.
"""
from zlibes_tpu.spec import errors
from zlibes_tpu.spec.errors import (
    ChecksumError,
    CorruptError,
    HeaderError,
    TruncatedError,
    ZlibError,
)
from zlibes_tpu.spec.refmodel import StreamIndex

from .codec.api import inflate

__all__ = ["inflate", "StreamIndex", "errors", "ZlibError", "HeaderError",
           "TruncatedError", "CorruptError", "ChecksumError"]
