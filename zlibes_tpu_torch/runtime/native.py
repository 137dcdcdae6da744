"""ctypes bindings for the native runtime (zscan.cc).

The port's own copy of ``zlibes_tpu/runtime/native.py``.  The shared
library is built once with g++ from this package's ``zscan.cc`` into
``build/zlibes_tpu_torch/`` beside the package at first use, under a file
name of its own (``libzscan_torch-*.so``).  Without a toolchain
``available()`` is false and a decode of a stream without an index raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..spec.errors import (
    BlockTypeError,
    CorruptError,
    StoredBlockError,
    TruncatedError,
)
from ..spec.refmodel import BlockInfo, StreamIndex
from .kernels import BUILD_DIR

_SRC = Path(__file__).parent / "zscan.cc"
_lib = None
_tried = False


class _BlockRec(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in (
        "btype", "bfinal", "start_bit", "payload_start_bit", "end_bit",
        "out_start", "out_len", "tok_start", "tok_count")]


def _build() -> ctypes.CDLL | None:
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libzscan_torch-{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-pthread", str(_SRC),
                 "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
            tmp.rename(so)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.zscan.restype = ctypes.c_int
    lib.zscan_parallel.restype = ctypes.c_int
    lib.zdecode_parallel.restype = ctypes.c_int
    lib.zresolve.restype = ctypes.c_int
    lib.zadler32.restype = ctypes.c_uint32
    return lib


def _get() -> ctypes.CDLL | None:
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _build()
    return _lib


def available() -> bool:
    return _get() is not None


_ERRORS = {
    -1: (BlockTypeError, "reserved BTYPE 3"),
    -2: (TruncatedError, "stream ended mid-block"),
    -3: (StoredBlockError, "LEN/NLEN mismatch"),
    -4: (CorruptError, "invalid Huffman data"),
}


def scan(data: bytes, bit_offset: int = 0, anchor_every: int = 4096,
         dict_len: int = 0, threads: int = 0, span_bytes: int = 0):
    """Native structure scan of a raw DEFLATE stream.

    ``threads`` > 1 (or 0 = hardware concurrency) runs the rapidgzip-style
    speculative-parallel scan for streams spanning multiple ``span_bytes``
    spans: worker threads search each span start for a decodable block
    boundary and scan ahead, and spans whose candidate matches the
    authoritative chain splice in; mis-speculated spans fall back to a
    serial rescan, so output is bit-identical to the sequential scan.

    Returns (toks_val, toks_dist, StreamIndex, end_bit, out_len).  Raises
    the usual typed errors on malformed input, or RuntimeError if the
    native library is unavailable.
    """
    lib = _get()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    if span_bytes <= 0:
        # ~2 spans per thread balances the pool (the main thread scans
        # span 0 then drains) while keeping the per-span candidate-search
        # overhead amortized; 256 KiB floor.  The 8 MiB cap bounds the
        # speculative buffers (~24 B per compressed byte per in-flight
        # span; zscan_parallel additionally processes spans in waves and
        # frees each span's buffers at merge), so peak
        # speculation memory is O(threads * 8 MiB * 24) however large the
        # stream.
        import os as _os

        nt = threads if threads > 0 else (_os.cpu_count() or 1)
        span_bytes = min(8 << 20,
                         max(1 << 18, len(data) // max(1, 2 * nt)))
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    # zscan's bit reader does unaligned 64-bit loads: pad 8 readable
    # bytes past the logical end (nbytes stays the logical size)
    buf = np.concatenate([raw, np.zeros(8, np.uint8)])
    nbytes = raw.size
    # capacity: tokens ≤ output bytes; grow-and-retry on cap errors
    cap_toks = max(1 << 16, nbytes * 4)
    cap_blocks = 4096
    while True:
        toks_val = np.empty(cap_toks, np.int32)
        toks_dist = np.empty(cap_toks, np.int32)
        blocks = (_BlockRec * cap_blocks)()
        cap_anch = max(1024, cap_toks // max(anchor_every // 8, 1))
        a_bit = np.empty(cap_anch, np.int64)
        a_out = np.empty(cap_anch, np.int64)
        a_blk = np.empty(cap_anch, np.int32)
        n_toks = ctypes.c_int64()
        n_blocks = ctypes.c_int64()
        n_anch = ctypes.c_int64()
        end_bit = ctypes.c_int64()
        out_len = ctypes.c_int64()
        crossing = ctypes.c_int64()
        spliced = ctypes.c_int64()
        common = (
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(nbytes), ctypes.c_int64(bit_offset),
            toks_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            toks_dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap_toks),
            blocks, ctypes.c_int64(cap_blocks),
            a_bit.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            a_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            a_blk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap_anch), ctypes.c_int64(anchor_every),
            ctypes.c_int64(dict_len),
        )
        tail = (
            ctypes.byref(n_toks), ctypes.byref(n_blocks), ctypes.byref(n_anch),
            ctypes.byref(end_bit), ctypes.byref(out_len),
            ctypes.byref(crossing),
        )
        if threads != 1 and nbytes > span_bytes:
            rc = lib.zscan_parallel(
                *common, ctypes.c_int64(threads), ctypes.c_int64(span_bytes),
                *tail, ctypes.byref(spliced))
        else:
            rc = lib.zscan(*common, *tail)
        if rc == -5:
            cap_toks *= 4
            continue
        if rc == -6:
            cap_blocks *= 4
            continue
        if rc == -7:
            cap_toks *= 2  # grows anchor cap too
            continue
        if rc != 0:
            exc, msg = _ERRORS.get(rc, (CorruptError, f"native scan error {rc}"))
            raise exc(msg)
        break
    nb = n_blocks.value
    infos = [
        BlockInfo(
            btype=int(blocks[i].btype), bfinal=bool(blocks[i].bfinal),
            start_bit=int(blocks[i].start_bit),
            payload_start_bit=int(blocks[i].payload_start_bit),
            end_bit=int(blocks[i].end_bit),
            out_start=int(blocks[i].out_start),
            out_len=int(blocks[i].out_len),
        )
        for i in range(nb)
    ]
    index = StreamIndex(
        infos,
        a_bit[: n_anch.value].copy(),
        a_out[: n_anch.value].copy(),
        a_blk[: n_anch.value].copy(),
        self_contained=(crossing.value == 0),
    )
    return (toks_val[: n_toks.value], toks_dist[: n_toks.value], index,
            end_bit.value, out_len.value)


def decode(data: bytes, bit_offset: int = 0, anchor_every: int = 4096,
           dictionary: bytes | None = None, threads: int = 0,
           span_bytes: int = 0):
    """Fused pipelined foreign decode: wave scan + trailing resolver.

    One native call runs the speculative-parallel structure scan while a
    resolver thread trails the merge frontier, expanding tokens into the
    output buffer and folding the Adler-32 of the produced bytes into the
    same cache-hot pass.

    Returns (out uint8 ndarray, StreamIndex, end_bit, adler32).
    """
    lib = _get()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    import os as _os

    if threads <= 0:
        # one core is the resolver's: the scan gets cpu-1 so the fused
        # pipeline never oversubscribes (on a 2-core host the scan runs
        # single-threaded with progressive frontier publishes while the
        # other core resolves and checksums)
        threads = max(1, (_os.cpu_count() or 2) - 1)
    if span_bytes <= 0:
        span_bytes = min(8 << 20,
                         max(1 << 18, len(data) // max(1, 2 * threads)))
    dict_tail = bytes(dictionary[-32768:]) if dictionary else b""
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    buf = np.concatenate([raw, np.zeros(8, np.uint8)])
    nbytes = raw.size
    cap_toks = max(1 << 16, nbytes * 4)
    cap_blocks = 4096
    out_cap = max(1 << 20, nbytes * 8)
    prefix = len(dict_tail)
    while True:
        toks_val = np.empty(cap_toks, np.int32)
        toks_dist = np.empty(cap_toks, np.int32)
        blocks = (_BlockRec * cap_blocks)()
        cap_anch = max(1024, cap_toks // max(anchor_every // 8, 1))
        a_bit = np.empty(cap_anch, np.int64)
        a_out = np.empty(cap_anch, np.int64)
        a_blk = np.empty(cap_anch, np.int32)
        out = np.empty(out_cap + prefix, np.uint8)
        if prefix:
            out[:prefix] = np.frombuffer(dict_tail, np.uint8)
        n_toks = ctypes.c_int64()
        n_blocks = ctypes.c_int64()
        n_anch = ctypes.c_int64()
        end_bit = ctypes.c_int64()
        out_len = ctypes.c_int64()
        crossing = ctypes.c_int64()
        spliced = ctypes.c_int64()
        adler = ctypes.c_uint32()
        rc = lib.zdecode_parallel(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(nbytes), ctypes.c_int64(bit_offset),
            toks_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            toks_dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap_toks),
            blocks, ctypes.c_int64(cap_blocks),
            a_bit.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            a_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            a_blk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap_anch), ctypes.c_int64(anchor_every),
            ctypes.c_int64(prefix),
            ctypes.c_int64(threads), ctypes.c_int64(span_bytes),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(out_cap + prefix), ctypes.c_int64(prefix),
            ctypes.byref(n_toks), ctypes.byref(n_blocks),
            ctypes.byref(n_anch), ctypes.byref(end_bit),
            ctypes.byref(out_len), ctypes.byref(crossing),
            ctypes.byref(spliced), ctypes.byref(adler))
        if rc == -5:
            cap_toks *= 4
            continue
        if rc == -6:
            cap_blocks *= 4
            continue
        if rc == -7:
            cap_toks *= 2
            continue
        if rc == -9:
            out_cap *= 8
            continue
        if rc != 0:
            exc, msg = _ERRORS.get(rc, (CorruptError,
                                        f"native decode error {rc}"))
            raise exc(msg)
        break
    nb = n_blocks.value
    infos = [
        BlockInfo(
            btype=int(blocks[i].btype), bfinal=bool(blocks[i].bfinal),
            start_bit=int(blocks[i].start_bit),
            payload_start_bit=int(blocks[i].payload_start_bit),
            end_bit=int(blocks[i].end_bit),
            out_start=int(blocks[i].out_start),
            out_len=int(blocks[i].out_len),
        )
        for i in range(nb)
    ]
    index = StreamIndex(
        infos,
        a_bit[: n_anch.value].copy(),
        a_out[: n_anch.value].copy(),
        a_blk[: n_anch.value].copy(),
        self_contained=(crossing.value == 0),
    )
    return (out[prefix : prefix + out_len.value], index, end_bit.value,
            int(adler.value))


def resolve(toks_val: np.ndarray, toks_dist: np.ndarray, out_len: int,
            dictionary: bytes | None = None) -> np.ndarray:
    """Sequential host LZ resolve (fallback path)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    plen = len(dictionary) if dictionary else 0
    out = np.empty(plen + out_len, np.uint8)
    if plen:
        out[:plen] = np.frombuffer(dictionary, np.uint8)
    got = ctypes.c_int64()
    rc = lib.zresolve(
        np.ascontiguousarray(toks_val).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.ascontiguousarray(toks_dist).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(toks_val.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(plen + out_len), ctypes.byref(got),
        ctypes.c_int64(plen),
    )
    if rc != 0:
        raise CorruptError("native resolve failed")
    return out[plen : plen + got.value]


def adler32(data: bytes) -> int:
    lib = _get()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(lib.zadler32(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size)))
