"""zlibes_tpu_torch — the zlib/DEFLATE codec on PyTorch and CUDA (Hopper).

The port of ``zlibes_tpu``: the same streams, index layout and error
taxonomy, in classes of its own (``spec/``, ``config.py``), encoded
(levels 0-9, preset dictionaries, and the turbo profile of
``CodecConfig.turbo()``) and decoded (turbo and wide indexed streams) by
CUDA kernels written for the H100 (``csrc/``) on a card and by their plain
PyTorch versions on the CPU; streams without
an index, or with an index the card cannot use (``build_index`` makes one
for a foreign stream), decode on the host through the native runtime
(``runtime/``).  Imports
``torch``, never ``jax`` and nothing of ``zlibes_tpu``: an index or a config
made by that package is carried across with ``index_from_reference`` /
``config_from_reference``.
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
