"""The ``zran_index`` encoder entry: streams as stock zlib writes them,
through CPython's ``zlib`` module (which links the system's zlib), each
indexed once on ingest as zlib's ``examples/zran.c`` indexes a stream it
did not write: the port's ``build_index`` with access points, one at the
first block boundary at or past every ``point_every`` bytes of output, each
keeping the 32 KiB of output before it.

Settings (the configuration's ``encoder``): ``level``, ``window_bits`` and
``mem_level`` of ``zlib.compressobj`` (one stream, no flush),
``anchor_every``, the output bytes between two decode anchors, and
``point_every``, those between two access points.  Any other key (a
``codec_config``) is not the writer's and is ignored.
"""
import sys
import zlib

from harness.codec import zt    # the harness's one binding of the port


def make(settings, device, mesh):
    level = int(settings["level"])
    window_bits = int(settings["window_bits"])
    mem_level = int(settings["mem_level"])
    anchor_every = int(settings["anchor_every"])
    point_every = int(settings["point_every"])
    print(f"zran_index: zlib {zlib.ZLIB_RUNTIME_VERSION} (CPython built "
          f"against {zlib.ZLIB_VERSION}), level {level}, windowBits "
          f"{window_bits}, memLevel {mem_level}; build_index anchors every "
          f"{anchor_every} B, access points every {point_every} B",
          file=sys.stderr, flush=True)

    def encode(data: bytes):
        c = zlib.compressobj(level, zlib.DEFLATED, window_bits, mem_level)
        stream = c.compress(data) + c.flush()
        return stream, zt.build_index(stream, anchor_every=anchor_every,
                                      point_every=point_every)

    # a program whose build_index keeps no access points fails here, before
    # the set-up writes the files' streams
    encode(b"")
    return encode
