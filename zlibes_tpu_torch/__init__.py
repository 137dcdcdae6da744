"""zlibes_tpu_torch — the zlib/DEFLATE codec on PyTorch and CUDA (Hopper).

The port of ``zlibes_tpu``: the same streams, index layout and error
taxonomy, in classes of its own (``spec/``, ``config.py``).  CUDA kernels
written for the H100 (``csrc/``) run it on a card, their plain PyTorch
versions on the CPU:

  * encode: levels 0-9, preset dictionaries, and the turbo profile of
    ``CodecConfig.turbo()``;
  * decode: turbo- and wide-indexed streams on ``device``; a stream with
    no index or with another index (a generic or chained one, such as
    ``build_index`` makes for a foreign stream) on the host through the
    native runtime (``runtime/``) when ``g++`` built it, else on ``device``
    (the group decode through the index, or the scan without one);
    ``inflate_range`` and ``inflate_to_device`` on any self-contained index;
  * ``parallel/``: block parallelism over a ``torch.distributed`` process
    group, one rank a device (``parallel_deflate``, ``parallel_inflate``,
    ``compress_batch``, ``multihost``).

Imports ``torch``, never ``jax`` and nothing of ``zlibes_tpu``: an index or
a config made by that package is carried across with
``index_from_reference`` / ``config_from_reference``.
"""
from .config import CodecConfig, CodecStats, config_from_reference
from .spec import constants, errors
from .spec.errors import (
    ChecksumError,
    CorruptError,
    HeaderError,
    TruncatedError,
    ZlibError,
)
from .spec.refmodel import StreamIndex, index_from_reference

from .codec.api import (
    build_index,
    deflate,
    deflate_indexed,
    inflate,
    inflate_range,
    inflate_to_device,
)

__all__ = ["deflate", "deflate_indexed", "inflate", "inflate_range",
           "inflate_to_device", "build_index", "StreamIndex", "CodecConfig",
           "CodecStats", "index_from_reference", "config_from_reference",
           "constants", "errors", "ZlibError", "HeaderError", "TruncatedError",
           "CorruptError", "ChecksumError"]
