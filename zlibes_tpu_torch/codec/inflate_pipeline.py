"""zlib-container inflate for the PyTorch port.

Counterpart of ``zlibes_tpu/codec/inflate_pipeline.py``.  Container
framing, header parsing and table construction are host work; payload
decode, LZ resolve and Adler-32 run on the requested device.  Three device
decodes:

  * a turbo or a wide (default-profile) index: the turbo and wide pipelines
    (``codec/turbo.py``, ``codec/wide.py``);
  * any other index (generic ~4 KiB anchors, a ``build_index`` index of a
    foreign stream, chained or self-contained, the index of a stream with a
    preset dictionary): anchor lanes grouped into dispatches of
    ``decode_tokens`` + ``resolve_global`` (``plan_groups``, ``run_group``,
    ``inflate_raw_indexed``);
  * no index: the blocks one after another, each a single lane of
    ``decode_tokens``, then ``resolve_global`` over 4 MiB windows
    (``inflate_raw_scan``).

``inflate()`` sends a stream without a turbo or wide index to the port's
native runtime (``runtime/native.py``) when it is available, as the JAX
package does, and checks the index against what was decoded; without it
such a stream takes the device decodes above.  ``inflate_range`` takes
any self-contained index, and a chained one with access points
(``build_index(..., point_every=)``) from the last point before the read,
behind its window, as zlib's examples/zran.c reads; ``inflate_to_device``
takes any index, a chained one (a stock-zlib stream's ``build_index``)
through the group decode, its groups in stream order, each behind the
output before it on the device.
"""
from __future__ import annotations

import bisect
import itertools

import numpy as np
import torch

from ..config import CodecStats, span, trace
from ..spec import constants as C
from ..spec.errors import (
    BlockTypeError,
    ChecksumError,
    CorruptError,
    HeaderError,
    StoredBlockError,
    TruncatedError,
)
from ..spec.refmodel import (
    BitReader,
    BlockInfo,
    StreamIndex,
    read_dynamic_code_lengths,
)

from ..ops import decode_tables as dtab
from ..ops import wide_kernel as wk
from ..ops.adler32 import adler32_device
from ..ops.turbo_kernel import _launch
from ..ops.inflate_kernel import (
    FLAT_W,
    RESOLVE_TILE,
    decode_tokens,
    resolve_global,
    resolve_rounds,
    splice_stored,
    stream_words,
)

_FIXED_LITLEN_LENGTHS = C.fixed_litlen_code_lengths()
_FIXED_DIST_LENGTHS = C.fixed_dist_code_lengths()

# decode lanes a group dispatch, and the output bytes it may span
_LANES = 8192
_MAX_GROUP_SPAN = (1 << 23) - C.BLOCK_MAX_BUFFER_LEN
# tokens a scan-path decode call (a block resumes until its end)
_SCAN_CHUNK_TOKENS = 65536
# output bytes a resolve window of the scan path, behind a 32 KiB halo
_RESOLVE_WINDOW = 1 << 22


def _bucket(n: int, lo: int = 4096) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


class _Stream:
    """The compressed stream on the device: ``words`` (NW,) int32, the same
    memory as ``bytes`` (4·NW,) uint8; uploaded here unless the caller
    gives its ``words``."""

    def __init__(self, data: bytes, device: torch.device | str,
                 words: torch.Tensor | None = None):
        if words is None:
            with trace("zlibes.upload"):
                words = torch.from_numpy(stream_words(data)).to(device)
        self.words = words
        self.bytes = self.words.view(torch.uint8)
        self.total_bits = len(data) * 8


def _block_code_lengths(data: bytes, blk: BlockInfo):
    """Host-parse a compressed block's header → (litlen, dist) code lengths."""
    if blk.btype == C.BTYPE_FIXED:
        return _FIXED_LITLEN_LENGTHS, _FIXED_DIST_LENGTHS
    br = BitReader(data)
    br.bitpos = blk.start_bit + 3
    ll, dl = read_dynamic_code_lengths(br)
    if blk.payload_start_bit and br.bitpos != blk.payload_start_bit:
        raise CorruptError("index does not match stream")
    return ll, dl


def _tables(device, rows):
    """(lt (NB, LL_W), dt (NB, D_W)) int32 on ``device`` from a list of
    (litlen, dist) code lengths, one row each."""
    lt = np.zeros((len(rows), wk.LL_W), np.int32)
    dt = np.zeros((len(rows), wk.D_W), np.int32)
    for r, (ll, dl) in enumerate(rows):
        lt[r], dt[r] = wk.wide_decode_tables(ll, dl)
    with trace("zlibes.upload"):
        return (torch.from_numpy(lt).to(device),
                torch.from_numpy(dt).to(device))


# ---------------------------------------------------------------------------
# no index: the scan path

def _decode_one_block(stream: _Stream, bitpos: int, ll_len, d_len):
    """Decode one block's payload as a single lane, resumed every
    ``_SCAN_CHUNK_TOKENS`` tokens: (tokens (N,) int32 on the device, the
    bit after its end-of-block)."""
    dev = stream.words.device
    lt, dt = _tables(dev, [(ll_len, d_len)])
    bit = torch.tensor([bitpos], dtype=torch.int64, device=dev)
    end = torch.tensor([stream.total_bits], dtype=torch.int64, device=dev)
    row = torch.zeros(1, dtype=torch.int32, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    parts = []
    while True:
        toks, _, cnt, bit, active, err = decode_tokens(
            stream.words, lt, dt, row, bit, end, active, T=_SCAN_CHUNK_TOKENS)
        n, bad, more = torch.stack([cnt.long(), err.long(),
                                    active.long()]).cpu()[:, 0].tolist()
        if bad:
            raise CorruptError("invalid Huffman data in block payload")
        parts.append(toks[:n, 0])
        if not more:
            break
    return torch.cat(parts), int(bit[0])


def _resolve_tokens_device(tokens: torch.Tensor,
                           dictionary: bytes | None = None) -> torch.Tensor:
    """Resolve one stream's tokens (N,) int32 into its bytes on their
    device, in 4 MiB windows, each behind the 32 KiB before it (the first
    behind the preset dictionary's tail, or nothing: a copy from before the
    stream raises)."""
    dev = tokens.device
    ism = (tokens & wk.TOK_MATCH_BIT) != 0
    lens = torch.where(ism, tokens & wk.TOK_VAL_MASK, 1).long()
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    total = int(ends[-1]) if tokens.numel() else 0
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    P = C.WINDOW_SIZE
    tail = bytes(dictionary[-P:]) if dictionary else b""
    first = torch.from_numpy(np.frombuffer(tail, np.uint8).copy()).to(dev)
    bounds = torch.arange(0, total, _RESOLVE_WINDOW, device=dev)
    # each window's tokens: from the one covering its first byte to the
    # last starting before its end
    t0s = torch.searchsorted(ends, bounds, right=True).tolist()
    t1s = torch.searchsorted(starts, (bounds + _RESOLVE_WINDOW).clamp(
        max=total)).tolist()
    for a, t0, t1 in zip(range(0, total, _RESOLVE_WINDOW), t0s, t1s):
        b = min(total, a + _RESOLVE_WINDOW)
        prefix = first if a == 0 else out[a - P : a]
        halo = prefix.numel()
        n = t1 - t0
        res, err = resolve_global(
            tokens[t0:t1].reshape(n, 1).contiguous(),
            (starts[t0:t1] - starts[t0]).int().reshape(n, 1),
            torch.tensor([n], dtype=torch.int32, device=dev),
            (starts[t0 : t0 + 1] + (halo - a)).int(),
            halo + (b - a), prefix.contiguous())
        if bool(err):
            raise CorruptError("back-reference before start of output")
        out[a:b] = res[halo:]
    return out


def inflate_raw_scan(data: bytes, byte_offset: int = 0,
                     dictionary: bytes | None = None, *,
                     device: torch.device | str):
    """Inflate an arbitrary conformant deflate stream starting at
    ``byte_offset`` without an index, on ``device``: block headers parsed on
    the host, each block's payload one lane of ``decode_tokens``, the
    stream's tokens resolved together (copies cross blocks).  Returns
    (bytes as a uint8 tensor on ``device``, list[BlockInfo], end bit).

    The reference's scan takes its native runtime when it can; this is its
    device branch, which the port's ``inflate()`` reaches when the native
    runtime is not available."""
    stream = _Stream(data, device)
    br = BitReader(data, byte_offset)
    parts: list[torch.Tensor] = []
    blocks: list[BlockInfo] = []
    out_count = 0
    while True:
        start_bit = br.bitpos
        try:
            bfinal = br.read_bits(1)
            btype = br.read_bits(2)
        except TruncatedError:
            raise TruncatedError("stream ended before final block")
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            payload_start = br.bitpos
            pos = br.bitpos >> 3
            if pos + 4 > len(data):
                raise TruncatedError("stored block header truncated")
            length = data[pos] | (data[pos + 1] << 8)
            nlen = data[pos + 2] | (data[pos + 3] << 8)
            if length != (~nlen & 0xFFFF):
                raise StoredBlockError("LEN/NLEN mismatch")
            pos += 4
            if pos + length > len(data):
                raise TruncatedError("stored block data truncated")
            # stored bytes are literal tokens
            parts.append(stream.bytes[pos : pos + length].int())
            br.bitpos = (pos + length) * 8
            out_len = length
        elif btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            if btype == C.BTYPE_FIXED:
                ll_len, d_len = _FIXED_LITLEN_LENGTHS, _FIXED_DIST_LENGTHS
            else:
                ll_len, d_len = read_dynamic_code_lengths(br)
            payload_start = br.bitpos
            with trace("zlibes.decode"):
                toks, br.bitpos = _decode_one_block(stream, br.bitpos,
                                                    ll_len, d_len)
            parts.append(toks)
            out_len = int(torch.where((toks & wk.TOK_MATCH_BIT) != 0,
                                      toks & wk.TOK_VAL_MASK, 1).sum())
        else:
            raise BlockTypeError("reserved BTYPE 3")
        blocks.append(BlockInfo(
            btype=btype, bfinal=bool(bfinal), start_bit=start_bit,
            payload_start_bit=payload_start, end_bit=br.bitpos,
            out_start=out_count, out_len=out_len))
        out_count += out_len
        if bfinal:
            break
    tokens = torch.cat(parts) if parts else stream.words.new_zeros(0)
    with trace("zlibes.resolve"):
        out = _resolve_tokens_device(tokens, dictionary=dictionary)
    return out, blocks, br.bitpos


# ---------------------------------------------------------------------------
# an index: anchor lanes in groups

def _index_lanes(index: StreamIndex, b0: int = 0, b1: int | None = None):
    """Flatten a StreamIndex into per-lane (bit0, end_bit, out_base,
    out_len, block_id) int64 arrays: a lane runs to the next anchor of its
    block, or to the block's end.  With ``b1``, only the anchors of blocks
    ``b0..b1`` (the index's anchors in block order), their ids counted
    from ``b0``."""
    bit0 = np.asarray(index.anchor_bit, np.int64)
    out = np.asarray(index.anchor_out, np.int64)
    block = np.asarray(index.anchor_block, np.int64)
    blocks = index.blocks
    if b1 is not None:
        a0, a1 = np.searchsorted(block, [b0, b1 + 1]).tolist()
        bit0, out, blocks = bit0[a0:a1], out[a0:a1], blocks[b0 : b1 + 1]
        block = block[a0:a1] - b0
    ends = np.array([(b.end_bit, b.out_start + b.out_len) for b in blocks]
                    or [(0, 0)], np.int64)
    end, out_end = ends[block, 0], ends[block, 1]
    same = block[1:] == block[:-1]
    end[:-1] = np.where(same, bit0[1:], end[:-1])
    out_end[:-1] = np.where(same, out[1:], out_end[:-1])
    return bit0, end, out, out_end - out, block


class _GroupPlan:
    """Host-prepared device tensors for one indexed decode dispatch.

    lt, dt       (NB, LL_W), (NB, D_W) int32: one table row per block
    rows         (B,) int32 each lane's row
    bit0, endb   (B,) int64 each lane's absolute start / end bit
    active       (B,) bool, all true
    out_base     (B,) int32 each lane's first byte from the group's
    lane_end     (B,) int64 on the host, for the end check
    B lanes, T token slots a lane; the group's output is
    [d_base, d_base + d_total) of the stream's.
    """

    __slots__ = ("lt", "dt", "rows", "bit0", "endb", "active", "out_base",
                 "lane_end", "B", "T", "d_base", "d_total")


@span("zlibes.plan")
def plan_groups(data: bytes, index: StreamIndex,
                device: torch.device | str,
                words: torch.Tensor | None = None) -> list[_GroupPlan]:
    """Group anchor lanes into device dispatches (whole blocks per group,
    ≤ _LANES lanes, ≤ 2^23-byte output span).

    For non-self-contained (foreign) indexes, groups additionally split at
    stored blocks so back-references never point into an unresolved gap —
    stored content reaches later groups through the chained prefix.
    ``words``: the stream's words on ``device`` where the caller has
    uploaded them (else the plan does).  The call is the span
    ``zlibes.plan``, its uploads ``zlibes.upload``; every group's block
    headers and table rows are one ``decode_tables`` launch, in one span
    ``zlibes.headers`` inside it (the blocks' input going up its
    ``zlibes.upload`` child, the statuses coming back its
    ``zlibes.readback`` child, where a bad header raises).
    """
    lane_bit0, lane_end, lane_out, lane_outlen, lane_block = \
        _index_lanes(index)
    split_at_stored = not getattr(index, "self_contained", True)
    nlanes = lane_bit0.size
    if nlanes == 0:
        return []
    max_span = int(lane_outlen.max(initial=1))
    T = _bucket(max_span + 16, lo=512)
    groups: list[tuple[int, int]] = []
    gstart = 0
    i = 0
    while i < nlanes:
        j = i
        while j < nlanes and lane_block[j] == lane_block[i]:
            j += 1
        span = int(lane_out[j - 1] + lane_outlen[j - 1] - lane_out[gstart])
        gap = (split_at_stored and i > gstart
               and lane_block[i] != lane_block[i - 1] + 1)
        if (j - gstart > _LANES or span > _MAX_GROUP_SPAN or gap) \
                and i > gstart:
            groups.append((gstart, i))
            gstart = i
        i = j
    if gstart < nlanes:
        groups.append((gstart, nlanes))

    def on_dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    # a table row for each block of a group, in block order; every group's
    # rows in one decode_tables launch, a group's rows a contiguous slice
    uniq = [np.unique(lane_block[g0:g1], return_inverse=True)
            for g0, g1 in groups]
    bounds = np.cumsum([0] + [ids.size for ids, _ in uniq])
    if words is None:
        with trace("zlibes.upload"):
            words = torch.from_numpy(stream_words(data)).to(device)
    with trace("zlibes.headers"):
        with trace("zlibes.upload"):
            hdr = on_dev(dtab.headers([index.blocks[b] for ids, _ in uniq
                                       for b in ids]), np.int64)
        lt, dt, status = dtab.decode_tables(words, hdr, len(data) * 8)
        with trace("zlibes.readback"):
            status = status.cpu().numpy()
        dtab.raise_status(status, bounds)

    plans = []
    for (g0, g1), (_, rows), r0, r1 in zip(groups, uniq, bounds[:-1],
                                           bounds[1:]):
        p = _GroupPlan()
        p.lt, p.dt = lt[r0:r1], dt[r0:r1]
        p.B = g1 - g0
        p.T = T
        p.lane_end = lane_end[g0:g1]
        p.d_base = int(lane_out[g0])
        p.d_total = int(lane_out[g1 - 1] + lane_outlen[g1 - 1]) - p.d_base
        with trace("zlibes.upload"):
            p.rows = on_dev(rows, np.int32)
            p.bit0 = on_dev(lane_bit0[g0:g1], np.int64)
            p.endb = on_dev(lane_end[g0:g1], np.int64)
            p.active = torch.ones(p.B, dtype=torch.bool, device=device)
            p.out_base = on_dev(lane_out[g0:g1] - p.d_base, np.int32)
        plans.append(p)
    return plans


_ESCAPED = "back-reference escapes its resolve span"


def _check_lanes(err, still, endpos, lane_end) -> None:
    """Raise CorruptError for a decode that stopped a lane on a bad code or
    at its last token slot, or left one off its end bit (host arrays, a
    lane each)."""
    if err.any() or still.any():
        raise CorruptError("invalid Huffman data in indexed block")
    if not (endpos == lane_end).all():
        raise CorruptError("lane did not end at its anchor boundary")


def run_group(stream: _Stream, p: _GroupPlan, check: bool = True,
              prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Decode and resolve one planned group on the stream's device; returns
    its bytes with the prefix at [0, P) and the group's at [P, P + d_total).

    ``prefix``: the (up to 32 KiB of) output before the group, for streams
    whose blocks are not self-contained (groups then resolve in order, each
    behind the previous tail) and for the first groups of a stream with a
    preset dictionary.  ``check`` raises CorruptError on a lane that failed
    or did not end at its index's end bit, and on a copy from before the
    prefix."""
    with trace("zlibes.decode"):
        tokens, starts, count, endpos, still, err = decode_tokens(
            stream.words, p.lt, p.dt, p.rows, p.bit0, p.endb, p.active,
            T=p.T)
    if check:
        with trace("zlibes.readback"):
            meta = torch.stack([count.long(), err.long(), still.long(),
                                endpos]).cpu().numpy()
        _check_lanes(meta[1], meta[2], meta[3], p.lane_end)
        # the occupied token rows only (unchecked, the whole (T, B) arrays
        # go on: the counts stay on the device, and the resolve skips every
        # slot at or past its lane's count)
        Tc = int(meta[0].max(initial=0))
        tokens, starts = tokens[:Tc], starts[:Tc]
    if prefix is None:
        prefix = stream.bytes.new_zeros(0)
    P = prefix.numel()
    with trace("zlibes.resolve"):
        out, rerr = resolve_global(tokens, starts, count, p.out_base + P,
                                   P + p.d_total, prefix)
    if check:
        with trace("zlibes.readback"):
            escaped = bool(rerr)
        if escaped:
            raise CorruptError(_ESCAPED)
    return out


def inflate_raw_indexed(data: bytes, index: StreamIndex,
                        device: torch.device | str,
                        dictionary: bytes | None = None,
                        check: bool = True,
                        stats: CodecStats | None = None,
                        history: torch.Tensor | None = None,
                        words: torch.Tensor | None = None) -> torch.Tensor:
    """Anchor-parallel inflate through any index; returns the bytes as a
    uint8 tensor on ``device``.

    Self-contained blocks (no copy across a block boundary) resolve group
    by group; a chained index (a foreign stream) resolves its groups in
    order, each behind the 32 KiB before it.  ``dictionary`` (FDICT
    streams), or ``history`` (the up to 32 KiB of output before the
    stream's first byte, on ``device``: an access point's window): its
    tail is the prefix of every group that starts in the first 32 KiB of
    output.  Stored payloads are spliced in on the device: before
    the groups of a chained index (its groups split at stored blocks, and a
    group's prefix reads them), after those of a self-contained one (a group
    may span a stored block and writes its span whole).  With
    ``check=False`` nothing is read back between the groups: a group's
    prefix is a slice of the output on the device.  ``stats`` counts the
    groups in ``dispatches`` and, in ``chained_groups``, those resolved
    behind the previous group's output; on the card ``device_headers``
    counts the blocks whose header and table row ``decode_tables`` built.
    ``words``: the stream's words on ``device`` where the caller has
    uploaded them.
    """
    stream = _Stream(data, device, words)
    out = torch.empty(index.total_out, dtype=torch.uint8, device=device)
    chained = not getattr(index, "self_contained", True)
    W = C.WINDOW_SIZE
    dict_tail = history
    if dictionary:
        dict_tail = torch.from_numpy(np.frombuffer(
            bytes(dictionary[-W:]), np.uint8).copy()).to(device)
    if chained:
        splice_stored(out, stream.bytes, data, index.blocks)
    plans = plan_groups(data, index, device, stream.words)
    if stats is not None:
        stats.dispatches += len(plans)
        stats.chained_groups += sum(1 for p in plans if chained and p.d_base)
        if stream.words.is_cuda:
            stats.device_headers += sum(p.lt.shape[0] for p in plans)
    for p in plans:
        prefix = None
        if (chained and p.d_base) or (dict_tail is not None
                                      and p.d_base < W):
            prefix = out[max(0, p.d_base - W) : p.d_base]
            if dict_tail is not None and prefix.numel() < W:
                prefix = torch.cat([dict_tail, prefix])[-W:]
        dev_out = run_group(stream, p, check=check, prefix=prefix)
        P = 0 if prefix is None else prefix.numel()
        out[p.d_base : p.d_base + p.d_total] = dev_out[P : P + p.d_total]
    if not chained:
        splice_stored(out, stream.bytes, data, index.blocks)
    return out


# ---------------------------------------------------------------------------
# entry points

def _refuse_fdict(data: bytes, what: str) -> None:
    if len(data) > 1 and data[1] & 0x20:
        raise HeaderError(
            f"{what} does not take a stream with a preset dictionary "
            f"(FDICT): decode it with inflate(..., dictionary=)")


def _on_device(index: StreamIndex, dictionary: bytes | None = None) -> bool:
    """Whether the turbo or the wide pipeline decodes this index: a turbo
    index, or a wide, self-contained one on a stream without a preset
    dictionary."""
    return bool(getattr(index, "turbo", False)
                or (getattr(index, "wide", False) and dictionary is None
                    and getattr(index, "self_contained", True)))


def _inflate_indexed(data: bytes, index: StreamIndex,
                     device: torch.device | str, check: bool = True,
                     stats: CodecStats | None = None) -> torch.Tensor:
    """Device decode of an indexed stream's payload: the turbo path for a
    turbo index, the wide path for a self-contained wide index, the group
    path for any other.  Returns the output bytes as a uint8 tensor on
    ``device``; ``stats`` counts the decode dispatches (one on the turbo
    and wide paths, a group each on the group path) and, on the wide and
    group paths on the card, ``device_headers`` (and ``device_lanes`` on
    the wide path)."""
    if getattr(index, "turbo", False) or _on_device(index):
        if stats is not None:
            stats.dispatches += 1
        if getattr(index, "turbo", False):
            from .turbo import inflate_raw_turbo

            return inflate_raw_turbo(data, index, device, check=check)
        from .wide import inflate_raw_wide

        return inflate_raw_wide(data, index, device, check=check,
                                stats=stats)
    return inflate_raw_indexed(data, index, device, check=check, stats=stats)


def _host_buffer(nbytes: int, device: torch.device | str) -> torch.Tensor:
    """An uninitialised host byte buffer, page-locked when ``device`` is a
    card, so that a copy to or from it is one DMA the host does not wait
    for (a pageable one goes through the driver's own staging)."""
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")


def _layout(sizes, align: int = 8) -> list[int]:
    """The byte offsets of regions of ``sizes`` bytes one after another in
    one buffer, each at a multiple of ``align`` bytes, and the buffer's
    size last."""
    return list(itertools.accumulate((-(-n // align) * align for n in sizes),
                                     initial=0))


def _to_device(arrays: list[np.ndarray], device: torch.device | str):
    """Host arrays on ``device`` by one copy of one buffer, each one's bytes
    followed by zeros up to its next multiple of 8.  Returns (the buffer on
    ``device``, each array's byte offset in it)."""
    at = _layout([a.nbytes for a in arrays])
    host = _host_buffer(at[-1], device)
    flat = host.numpy()
    for a, o, o1 in zip(arrays, at, at[1:]):
        flat[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
        flat[o + a.nbytes : o1] = 0
    return host.to(device, non_blocking=True), at


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Tensors of one device on the host after one wait: on a card each is
    copied without a wait into one page-locked buffer, then the stream is
    synchronised once."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    at = _layout([t.nbytes for t in tensors])
    host = _host_buffer(at[-1], dev)
    views = [host[o : o + t.nbytes].view(t.dtype).view(t.shape)
             for t, o in zip(tensors, at)]
    for v, t in zip(views, tensors):
        v.copy_(t, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [v.numpy() for v in views]


class _Group:
    """One group of a point read behind its history: the uploaded lane
    arrays (``_to_device`` of headers, bit0, end bits, rows, out bases,
    active), then ``decode_tables``, ``decode_tokens`` and
    ``resolve_global`` through their wrappers, on any device, with
    nothing read back between them; ``readback`` returns output bytes
    [r0, r1) of the group (history included) and every status after one
    wait: (bytes, table statuses, end bits, stopped, errors, escaped)."""

    def __init__(self, words, n, on, at, arrays, T, P, total, history):
        self.words, self.n, self.T, self.P = words, n, T, P
        self.total, self.history = total, history
        self.hdr, self.bit0, self.endb, self.rows, self.base, self.active = (
            on[o : o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, at))

    def tables(self):
        self.lt, self.dt, self.status = dtab.decode_tables(
            self.words, self.hdr, self.n * 8)

    def decode(self):
        (self.tokens, self.starts, self.count, self.bitpos, self.still,
         self.err) = decode_tokens(self.words, self.lt, self.dt, self.rows,
                                   self.bit0, self.endb, self.active,
                                   T=self.T)

    def resolve(self):
        self.out, self.escaped = resolve_global(
            self.tokens, self.starts, self.count, self.base,
            self.P + self.total, self.history)

    def readback(self, r0, r1):
        return _to_host([self.out[r0:r1], self.status, self.bitpos,
                         self.still, self.err, self.escaped])


class _CardGroup(_Group):
    """``_Group`` on a card with the wrappers' host work left out: the
    three kernels' launchers get pointers into the uploaded arrays and
    into one workspace that holds every output and scratch buffer, the
    statuses last and side by side, so that the range and the statuses
    come back in two copies after one wait."""

    def __init__(self, words, n, on, at, arrays, T, P, total, history):
        self.words, self.n, self.T, self.P = words, n, T, P
        self.total, self.history = total, history
        NB, B = arrays[0].shape[0], arrays[1].size
        if T * B >= 1 << 31:
            raise ValueError(f"{T} token slots of {B} lanes: T * B must be "
                             f"below 2**31")
        self.NB, self.B = NB, B
        self.rounds = resolve_rounds(P + total)
        tiles = -(-(P + total) // RESOLVE_TILE)
        # lt, dt, flat, tokens, starts, count, state, tile_open, out; then
        # the statuses: a table status a block, a lane's end bit, stopped
        # and error flags, the resolve's error and open flags (zeroed)
        sizes = [NB * wk.LL_W * 4, NB * wk.D_W * 4, NB * FLAT_W * 4,
                 T * B * 4, T * B * 4, B * 4, (P + total) * 4, tiles * 4,
                 P + total, NB * 4, B * 8, B, B, 4 * (self.rounds + 2)]
        self.at = _layout(sizes, 256)
        self.ws = torch.empty(self.at[-1], dtype=torch.uint8,
                              device=words.device)
        self.ws[self.at[13] : self.at[14]].zero_()
        w = self.ws.data_ptr()
        self.p = [w + o for o in self.at]
        u = on.data_ptr()
        self.u = [u + o for o in at]

    def tables(self):
        p = self.p
        _launch("decode_tables", self.words.device, self.words.data_ptr(),
                self.words.numel(), self.n * 8, self.u[0], self.NB, p[0],
                p[1], p[9])

    def decode(self):
        p, u = self.p, self.u
        _launch("decode_tokens", self.words.device, self.words.data_ptr(),
                self.words.numel(), p[0], p[1], self.NB, p[2], u[3], u[1],
                u[2], u[5], self.B, self.T, p[3], p[4], p[5], p[10], p[11],
                p[12])

    def resolve(self):
        p = self.p
        _launch("resolve_global", self.words.device, p[3], p[4], p[5],
                self.u[4], self.T, self.B, self.history.data_ptr(), self.P,
                self.P + self.total, self.rounds, p[6], p[7], p[13] + 4,
                p[8], p[13])

    def readback(self, r0, r1):
        at = self.at
        got, st = _to_host([self.ws[at[8] + r0 : at[8] + r1],
                            self.ws[at[9] : at[13] + 4]])
        o = [x - at[9] for x in at[9:14]]
        NB, B = self.NB, self.B
        return (got, st[o[0] : o[0] + 4 * NB].view(np.int32),
                st[o[1] : o[1] + 8 * B].view(np.int64),
                st[o[2] : o[2] + B].view(bool), st[o[3] : o[3] + B].view(bool),
                st[o[4] : o[4] + 4].view(np.int32)[0])


def _point_read(data: bytes, index: StreamIndex, start: int, end: int,
                device: torch.device | str,
                stats: CodecStats | None) -> bytes:
    """Output [start, end) of a chained stream as zlib's examples/zran.c
    reads it: from the last access point at or before ``start``, behind
    that point's window, through the block that holds ``end - 1``.  Only
    those blocks' bytes are cut from the stream (bit offsets rebased by
    whole bytes, so each block keeps its bit within a byte) and decoded.

    A span whose blocks all have lanes (no stored block) is one group: its
    stream bytes and window go up in one copy, its lane arrays and headers
    in another, ``decode_tables``, ``decode_tokens`` and ``resolve_global``
    run behind the window with nothing read back between them, and the
    range and every status come back after one wait, then raise as
    ``run_group`` raises (on a card ``_CardGroup``, else ``_Group``).  Any
    other span takes the group decode (``inflate_raw_indexed``) of the
    same upload.  The point's lookup, the cut and its upload are the span
    ``zlibes.point``, the lanes of the point's blocks (the sub-index)
    ``zlibes.subindex``, the group's upload and table build
    ``zlibes.plan``."""
    blocks = index.blocks
    with trace("zlibes.point"):
        k = bisect.bisect_right([blocks[b].out_start
                                 for b in index.point_block.tolist()],
                                start) - 1
        if k < 0:
            raise CorruptError(f"no access point at or before {start}")
        b0 = int(index.point_block[k])
        lo = blocks[b0].out_start
        b1 = b0
        while blocks[b1].out_start + blocks[b1].out_len < end:
            b1 += 1
        byte0 = blocks[b0].start_bit >> 3
        n = ((blocks[b1].end_bit + 7) >> 3) - byte0
        window = np.frombuffer(index.point_window[k], np.uint8)
        P = window.size
        with trace("zlibes.upload"):
            on, at = _to_device(
                [np.frombuffer(data, np.uint8, n, byte0), window], device)
        words = on[: 4 * -(-n // 4)].view(torch.int32)
        history = on[at[1] : at[1] + P]
    with trace("zlibes.subindex"):
        shift = byte0 * 8
        bit0, endb, out, out_len, rows = _index_lanes(index, b0, b1)
        bit0, endb, out = bit0 - shift, endb - shift, out - lo
        one = (0 < rows.size <= _LANES
               and np.count_nonzero(rows[1:] != rows[:-1]) == b1 - b0
               and blocks[b1].out_start + blocks[b1].out_len - lo
               <= _MAX_GROUP_SPAN)
        if not one:
            sub = StreamIndex(
                [BlockInfo(b.btype, b.bfinal, b.start_bit - shift,
                           b.payload_start_bit - shift, b.end_bit - shift,
                           b.out_start - lo, b.out_len)
                 for b in blocks[b0 : b1 + 1]],
                bit0, out, rows.astype(np.int32), False)
    if stats is not None:
        stats.point_reads += 1
        stats.lead_bytes += start - lo
        stats.bytes_out += end - start
    if not one:
        out = inflate_raw_indexed(data[byte0 : byte0 + n], sub, device,
                                  stats=stats, history=history if P else None,
                                  words=words)
        with trace("zlibes.readback"):
            return out[start - lo : end - lo].cpu().numpy().tobytes()
    with trace("zlibes.plan"):
        T = _bucket(int(out_len.max()) + 16, lo=512)
        hdr = dtab.headers(blocks[b0 : b1 + 1])
        hdr[:, :2] -= shift
        arrays = [hdr, bit0, endb, rows.astype(np.int32),
                  (out + P).astype(np.int32), np.ones(rows.size, bool)]
        with trace("zlibes.upload"):
            on, at = _to_device(arrays, device)
        g = (_CardGroup if on.is_cuda else _Group)(
            words, n, on, at, arrays, T, P,
            blocks[b1].out_start + blocks[b1].out_len - lo, history)
        with trace("zlibes.headers"):
            g.tables()
    with trace("zlibes.decode"):
        g.decode()
    with trace("zlibes.resolve"):
        g.resolve()
    with trace("zlibes.readback"):
        got, status, bitpos, still, err, escaped = g.readback(
            P + start - lo, P + end - lo)
    dtab.raise_status(status, np.array([0, status.size]))
    _check_lanes(err, still, bitpos, endb)
    if escaped:
        raise CorruptError(_ESCAPED)
    if stats is not None:
        stats.dispatches += 1
        if words.is_cuda:
            stats.device_headers += status.size
    return got.tobytes()


@span("zlibes.inflate_range")
def inflate_range(data: bytes, index: StreamIndex, start: int, length: int,
                  *, device: torch.device | str,
                  stats: CodecStats | None = None) -> bytes:
    """Random-access decode of output bytes [start, start+length).

    Only the self-contained blocks overlapping the range are decoded, on
    ``device``, through a sub-index that keeps the turbo and wide flags, so
    a seek runs the same kernels as a whole-stream decode.  Block
    out_starts are multiples of 128 KiB in turbo and wide streams, so the
    sub-stream keeps their anchor geometry (512 B turbo segments, 128 B
    wide sub-spans); a generic index's lanes are its anchors wherever they
    lie.  A chained index with access points (``build_index(...,
    point_every=)``) reads from its last point at or before ``start``
    (``_point_read``); one without them raises CorruptError.  The call is
    the span ``zlibes.inflate_range``; the sub-index is
    ``zlibes.subindex``, a point's lookup and cut ``zlibes.point``, the
    copy of the range to the host ``zlibes.readback``.  ``stats`` gets the
    bytes returned, the decode dispatches and, on a point read,
    ``point_reads`` and ``lead_bytes``.
    """
    total = index.total_out
    if start < 0 or length < 0 or start + length > total:
        raise ValueError(f"range [{start}, {start + length}) outside "
                         f"output [0, {total})")
    data = bytes(data)
    _refuse_fdict(data, "inflate_range")
    chained = not getattr(index, "self_contained", True)
    if chained and getattr(index, "point_block", None) is None:
        raise CorruptError(
            "inflate_range requires self-contained blocks or access "
            "points: this index is chained (copies cross its block "
            "boundaries, as in stock zlib's streams) and has no points; "
            "build it with build_index(..., point_every=)")
    if length == 0:
        return b""
    end = start + length
    if chained:
        return _point_read(data, index, start, end, device, stats)
    with trace("zlibes.subindex"):
        keep = [i for i, b in enumerate(index.blocks) if b.out_len
                and b.out_start < end and b.out_start + b.out_len > start]
        out_lo = index.blocks[keep[0]].out_start
        keep_arr = np.asarray(keep, np.int32)
        mask = np.isin(index.anchor_block, keep_arr)
        sub = StreamIndex(
            [BlockInfo(b.btype, b.bfinal, b.start_bit,
                       b.payload_start_bit, b.end_bit,
                       b.out_start - out_lo, b.out_len)
             for b in (index.blocks[i] for i in keep)],
            index.anchor_bit[mask],
            index.anchor_out[mask] - out_lo,
            np.searchsorted(keep_arr,
                            index.anchor_block[mask]).astype(np.int32),
            True,
            getattr(index, "chunk_reset", 0),
            getattr(index, "turbo", False),
            getattr(index, "max_tokens", 0),
            getattr(index, "wide", False),
        )
    out = _inflate_indexed(data, sub, device, stats=stats)
    if stats is not None:
        stats.bytes_out += length
    with trace("zlibes.readback"):
        return out[start - out_lo : end - out_lo].cpu().numpy().tobytes()


@span("zlibes.inflate_to_device")
def inflate_to_device(data: bytes, index: StreamIndex, *,
                      device: torch.device | str,
                      stats: CodecStats | None = None):
    """Decompress into device memory, with no copy of the output to the
    host: returns [(uint8 tensor on ``device``, out_offset, nbytes)].

    One span covers the whole output: a turbo stream's chunk rows or a wide
    stream's block rows, flattened, or one tensor into which the coded
    rows, the groups of a generic index and the stored blocks' payloads
    were spliced.  A chained index (a foreign stream, whose copies cross
    every block boundary) decodes through the group path, its groups in
    stream order, each behind the up to 32 KiB of output before it, with
    nothing read back between them.  As in the reference, the decode's
    meta checks are skipped; the caller verifies the bytes.  ``stats`` (a
    ``CodecStats``) gets the stream's and the output's bytes, the blocks,
    the decode dispatches, ``chained_groups``, ``device_headers`` and
    ``device_lanes``.  The call is the span ``zlibes.inflate_to_device``.
    """
    data = bytes(data)
    _refuse_fdict(data, "inflate_to_device")
    out = _inflate_indexed(data, index, device, check=False, stats=stats)
    if stats is not None:
        stats.bytes_in += len(data)
        stats.bytes_out += index.total_out
        stats.blocks += len(index.blocks)
    return [(out, 0, index.total_out)]


def _decode_native(data: bytes, offset: int, dictionary: bytes | None):
    """Whole-stream host decode through the native runtime: (bytes as a
    uint8 CPU tensor, end bit, Adler-32)."""
    from ..runtime import native

    out, _index, end_bit, adler = native.decode(
        data, bit_offset=offset * 8, dictionary=dictionary)
    return torch.from_numpy(out), end_bit, adler


@span("zlibes.inflate")
def inflate(data: bytes, *, device: torch.device | str,
            verify_checksum: bool = True, index=None,
            dictionary: bytes | None = None) -> bytes:
    """zlib-container inflate.  A turbo- or wide-indexed stream decodes on
    ``device``; any other on the host through the native runtime when it is
    available, else on ``device`` (through its index, or by the scan).
    The call is the span ``zlibes.inflate``; the native decode is
    ``zlibes.decode``, the trailer's check ``zlibes.adler``, the copy of
    the output to the host ``zlibes.readback``."""
    from ..runtime import native

    data = bytes(data)

    if len(data) < 6:
        raise TruncatedError("zlib stream shorter than minimal frame")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != C.ZLIB_CM_DEFLATE:
        raise HeaderError("not compressed by deflate")
    if (cmf >> 4) > 7:
        raise HeaderError("invalid CINFO (window > 32 KiB)")
    if (cmf * 256 + flg) % 31 != 0:
        raise HeaderError("FCHECK failed")
    offset = 2
    if flg & 0x20:
        if dictionary is None:
            raise HeaderError("stream requires a preset dictionary (FDICT)")
        if len(data) < 10:
            raise TruncatedError("missing DICTID")
        from ..spec.refmodel import adler32 as _adler_host

        if int.from_bytes(data[2:6], "big") != _adler_host(dictionary):
            raise HeaderError("DICTID does not match supplied dictionary")
        offset = 6
    else:
        dictionary = None
    known_adler = None
    if index is not None and _on_device(index, dictionary):
        if dictionary is not None:
            raise HeaderError("turbo streams never carry FDICT")
        out = _inflate_indexed(data, index, device)
        end_bit = index.blocks[-1].end_bit
    elif native.available():
        with trace("zlibes.decode"):
            out, end_bit, known_adler = _decode_native(data, offset,
                                                       dictionary)
        # the decode did not need the index, but a caller who passes one
        # that belongs to another stream must get an error, not the bytes
        if index is not None and (index.blocks[-1].end_bit != end_bit
                                  or index.total_out != out.numel()):
            raise CorruptError("index does not match this stream (block "
                               "layout / output size disagree)")
    elif index is not None:
        out = inflate_raw_indexed(data, index, device, dictionary=dictionary)
        end_bit = index.blocks[-1].end_bit
    else:
        out, _blocks, end_bit = inflate_raw_scan(
            data, byte_offset=offset, dictionary=dictionary, device=device)
    if verify_checksum:
        trailer_pos = (end_bit + 7) >> 3
        if trailer_pos + 4 > len(data):
            raise TruncatedError("missing Adler-32 trailer")
        expect = int.from_bytes(data[trailer_pos : trailer_pos + 4], "big")
        if known_adler is not None:
            # the native decode folded Adler-32 into its resolve pass
            actual = known_adler
        else:
            with trace("zlibes.adler"):
                adler = adler32_device(out)
                with trace("zlibes.readback"):
                    actual = int(adler)
        if expect != actual:
            raise ChecksumError(f"Adler-32 mismatch: {expect:#x} != {actual:#x}")
    with trace("zlibes.readback"):
        return out.cpu().numpy().tobytes()
