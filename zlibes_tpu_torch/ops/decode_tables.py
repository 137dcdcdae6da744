"""Each coded block's decode-table row for the wide and the generic
decoders: the ``decode_tables`` kernel for NVIDIA Hopper, with its plain
version, the host parse.

For every block of a plan, from the stream's words and the block's start
bit, payload start bit and btype: the header's code lengths (the fixed
lengths for a fixed block, a dynamic header parsed as
``read_dynamic_code_lengths`` parses it, checked against the index's
payload start), then the two-level litlen and distance rows that
``wide_kernel.wide_decode_tables`` builds, which ``decode_wide`` and
``decode_tokens`` read.  Where the host would raise, the block's status
holds the error's code (``STATUS``); ``raise_status`` raises it after the
plan's one readback.

The JAX package parses every header on the host; there is no Pallas
kernel.  The plain version here is that parse (``_block_code_lengths`` of
``codec/inflate_pipeline.py`` and ``wk.wide_decode_tables``, called
through the module attributes), one block at a time; on the card one CTA
a block builds the same rows from the words already there
(``csrc/decode_tables.cu``), so neither the headers nor the rows cross
the bus.

The wrapper launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; any other device raises.  Launches count in
``turbo_kernel.LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import wide_kernel as wk
from ..spec import constants as C
from ..spec.errors import CorruptError, TruncatedError
from ..spec.refmodel import BlockInfo

from .turbo_kernel import _check, _launch, _ptr, _route

# status code k (1-based) -> the error the host raises: the parse's (1-6),
# then the tables' (7-8)
STATUS = (
    (TruncatedError, "bit stream overrun"),
    (TruncatedError, "bit stream overrun in Huffman code"),
    (CorruptError, "invalid Huffman code"),
    (CorruptError, "RLE repeat with no previous length"),
    (CorruptError, "code length RLE overran table size"),
    (CorruptError, "index does not match stream"),
    (CorruptError, "over-subscribed Huffman code"),
    (CorruptError, "two-level sub-table overflow (non-canonical code "
                   "lengths)"),
)
_PARSE = 6  # codes 1-6 come from the header's parse


def headers(blocks) -> np.ndarray:
    """The kernel's per-block input for BlockInfo-like ``blocks``: (NB, 3)
    int64 start bit, payload start bit (0 where the index has none) and
    btype."""
    return np.array([(b.start_bit, b.payload_start_bit or 0, b.btype)
                     for b in blocks], np.int64).reshape(-1, 3)


def _status_of(e: Exception) -> int:
    try:
        return STATUS.index((type(e), str(e))) + 1
    except ValueError:
        raise e from None


def decode_tables_plain(words: torch.Tensor, hdr: torch.Tensor,
                        total_bits: int):
    """The host parse and table build a block at a time, on CPU tensors;
    the arguments and results of ``decode_tables``.  Every fixed block
    shares one build, a dynamic one is keyed by its start bit."""
    from ..codec.inflate_pipeline import _block_code_lengths

    data = words.numpy().view(np.uint8)[: total_bits // 8].tobytes()
    NB = hdr.shape[0]
    lt = np.zeros((NB, wk.LL_W), np.int32)
    dt = np.zeros((NB, wk.D_W), np.int32)
    status = np.zeros(NB, np.int32)
    built: dict[object, tuple] = {}
    for r, (start, payload, btype) in enumerate(hdr.tolist()):
        key = btype if btype == C.BTYPE_FIXED else start
        if key not in built:
            blk = BlockInfo(btype, False, start, payload, 0, 0, 0)
            try:
                lengths = _block_code_lengths(data, blk)
                built[key] = (*wk.wide_decode_tables(*lengths), 0)
            except (TruncatedError, CorruptError) as e:
                built[key] = (0, 0, _status_of(e))
        lt[r], dt[r], status[r] = built[key]
    return tuple(torch.from_numpy(x) for x in (lt, dt, status))


def decode_tables(words: torch.Tensor, hdr: torch.Tensor, total_bits: int):
    """Each block's decode-table row.

    words (NW,) int32 the stream as ``stream_words`` lays it out; hdr (NB,
    3) int64 each block's start bit, payload start bit (0: not checked)
    and btype (1 fixed, any other a dynamic header); total_bits the
    stream's bits (a read past them is a truncation).  Returns (lt (NB,
    LL_W), dt (NB, D_W), status (NB,)) int32: the rows as
    ``wide_decode_tables`` builds them, and 0 or the ``STATUS`` code of the
    error the host raises first for the block (its rows then zeros)."""
    dev = words.device
    NB = hdr.shape[0]
    _check(words, "words", torch.int32, (words.shape[0],), dev)
    _check(hdr, "hdr", torch.int64, (NB, 3), dev)
    if not 0 <= total_bits <= 32 * words.shape[0]:
        raise ValueError(f"{total_bits} bits do not fit {words.shape[0]} "
                         f"words")
    if not _route(words):
        return decode_tables_plain(words, hdr, total_bits)
    lt = torch.empty((NB, wk.LL_W), dtype=torch.int32, device=dev)
    dt = torch.empty((NB, wk.D_W), dtype=torch.int32, device=dev)
    status = torch.empty(NB, dtype=torch.int32, device=dev)
    if NB:
        _launch("decode_tables", dev, _ptr(words),
                ctypes.c_int64(words.shape[0]), ctypes.c_int64(total_bits),
                _ptr(hdr), ctypes.c_int(NB), _ptr(lt), _ptr(dt),
                _ptr(status))
    return lt, dt, status


def raise_status(status: np.ndarray, bounds=None) -> None:
    """Raise the error the host parse would have raised first: the first
    bad row's; or, with ``bounds`` (row offsets of consecutive groups,
    from 0), the first bad group's first parse error, else its first table
    error (a group's headers are all parsed before its rows are built)."""
    bad = np.flatnonzero(status)
    if not bad.size:
        return
    code = int(status[bad[0]])
    if bounds is not None:
        g = int(np.searchsorted(bounds, bad[0], side="right"))
        rows = status[bounds[g - 1] : bounds[g]]
        parse = rows[(rows > 0) & (rows <= _PARSE)]
        if parse.size:
            code = int(parse[0])
    cls, msg = STATUS[code - 1]
    raise cls(msg)
