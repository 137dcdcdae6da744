"""The ``cpython_zlib`` encoder entry: streams as stock zlib writes them,
through CPython's ``zlib`` module (which links the system's zlib), each
indexed once on ingest by the port's ``build_index``, the access points
that zlib's ``examples/zran.c`` keeps beside a stream it did not write.

Settings (the configuration's ``encoder``): ``level``, ``window_bits`` and
``mem_level`` of ``zlib.compressobj`` (one stream, no flush), and
``anchor_every``, the output bytes between two access points of the index.
Any other key (a ``codec_config``) is not the writer's and is ignored.
"""
import sys
import zlib

from harness.codec import zt    # the harness's one binding of the port


def make(settings, device, mesh):
    level = int(settings["level"])
    window_bits = int(settings["window_bits"])
    mem_level = int(settings["mem_level"])
    anchor_every = int(settings["anchor_every"])
    print(f"cpython_zlib: zlib {zlib.ZLIB_RUNTIME_VERSION} (CPython built "
          f"against {zlib.ZLIB_VERSION}), level {level}, windowBits "
          f"{window_bits}, memLevel {mem_level}; build_index every "
          f"{anchor_every} B", file=sys.stderr, flush=True)

    def encode(data: bytes):
        c = zlib.compressobj(level, zlib.DEFLATED, window_bits, mem_level)
        stream = c.compress(data) + c.flush()
        return stream, zt.build_index(stream, anchor_every=anchor_every)

    return encode
