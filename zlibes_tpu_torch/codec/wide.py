"""Wide inflate pipeline: the device decode of default-profile streams
(per-block 15-bit tables, full 32 KiB window), which is what levels 1-9 of
the encoder write.

Counterpart of ``zlibes_tpu/codec/wide.py``: per-lane two-level-table
decode (which stages its lane windows itself) + block-row LZ resolve.  Every per-lane array is in
lane order, and lane ``cb * LPB + m`` decodes the tokens that start in
output sub-span ``[m*128, (m+1)*128)`` of coded block ``cb``.  The TPU
pipeline's lane grid, word-planes, grouped 256-word fetch, per-grid-step
sublane table rows and 8-row padding are not carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import CodecStats, span, trace
from ..spec import constants as C
from ..spec.errors import CorruptError
from ..spec.refmodel import StreamIndex

from ..ops import decode_tables as dtab
from ..ops import wide_kernel as wk
from ..ops.inflate_kernel import splice_stored, stream_words

SUB = wk.SUB
# the largest lane window, in stream words, a valid wide index can need
MAX_SW = 80


def _glue_wide(tokens: torch.Tensor, starts: torch.Tensor,
               meta: torch.Tensor, Cb: int, LPB: int):
    """Token post-pass: block-row resolve layout + slot-0 cover tokens.

    tokens, starts (T, L) int32 from ``decode_wide``, valid in
    [0, meta[0]); meta (6, L).  Every 128-B sub-span's slot 0 receives its
    boundary-covering token (the token with start < boundary < end) with a
    negative start, found by a forward fill of each lane's last token over
    lane order: a long match can skip whole sub-spans, so the cover can
    come from several lanes back.  Block-start lanes never take a
    predecessor, so the fill needs no reset at block boundaries.

    Returns (toks, starts): (Cb, LPB, TOKENS_PAD) int32, invalid slots
    carrying start START_PAD.
    """
    T, L = tokens.shape
    dev = tokens.device
    counts = meta[0]
    valid = torch.arange(T, device=dev)[:, None] < counts[None, :]
    tokens = torch.where(valid, tokens, 0)
    starts = torch.where(valid, starts, wk.START_PAD)

    lane = torch.arange(L, device=dev)
    m_in_b = lane % LPB
    boundary = (m_in_b * SUB).int()
    # exclusive forward fill: the nearest lane before this one that emitted
    # a token
    filled = torch.cummax(torch.where(counts > 0, lane, -1), 0).values
    pred = torch.cat([filled.new_full((1,), -1), filled[:-1]])
    has_pred = pred >= 0
    pred = pred.clamp(min=0)
    pred_t = meta[4][pred]
    pred_s = meta[5][pred] + (pred % LPB * SUB).int()  # within the block
    plen = torch.where((pred_t & wk.TOK_MATCH_BIT) != 0,
                       pred_t & wk.TOK_VAL_MASK, 1)
    cross = has_pred & (m_in_b != 0) & (pred_s + plen > boundary)
    cross = cross.reshape(Cb, LPB, 1)

    def relayout(x, slot0, fill):
        rows = torch.full((Cb, LPB, wk.TOKENS_PAD), fill, dtype=torch.int32,
                          device=dev)
        rows[:, :, :T] = x.T.reshape(Cb, LPB, T)
        shifted = torch.cat([slot0.reshape(Cb, LPB, 1), rows[:, :, :-1]], 2)
        return torch.where(cross, shifted, rows)

    return (relayout(tokens, pred_t, 0),
            relayout(starts, pred_s - boundary, wk.START_PAD))


def anchor_rows(index: StreamIndex, ids):
    """``wide_lanes``' input for the blocks ``ids`` of ``index`` (indices
    into ``index.blocks``): the anchors' bits and output offsets (NA,)
    int64, sorted by block, in array order within a block (one stable
    argsort where the index does not come so), and (len(ids), 4) int64
    rows: each block's first anchor, anchor count, out_start, end_bit."""
    abit = np.asarray(index.anchor_bit, np.int64)
    aout = np.asarray(index.anchor_out, np.int64)
    ablk = np.asarray(index.anchor_block)
    if (ablk[1:] < ablk[:-1]).any():
        order = np.argsort(ablk, kind="stable")
        abit, aout, ablk = abit[order], aout[order], ablk[order]
    key = np.asarray(ids).astype(ablk.dtype)
    first = np.searchsorted(ablk, key, "left")
    count = np.searchsorted(ablk, key, "right") - first
    blocks = [index.blocks[i] for i in ids]
    rows = np.stack([first, count, [b.out_start for b in blocks],
                     [b.end_bit for b in blocks]], 1).astype(np.int64)
    return np.ascontiguousarray(abit), np.ascontiguousarray(aout), rows


class WidePlan:
    """Host-prepared device tensors for one wide-profile stream (reusable).

    words     (NW,) int32    the stream as little-endian words
    start_w   (L,) int32     first stream word of each lane's window
    bit0/endb (L,) int32     lane start / end bit within its window
    base      (L,) int32     first token's offset in the lane's sub-span
    lt        (Cb, LL_W) int32, dt (Cb, D_W) int32: one table row per
                             coded block
    L = Cb * LPB lanes; a block's lanes past its output are empty
    (bit0 == endb == 0).  ``build`` is the span ``zlibes.plan``; its
    uploads are ``zlibes.upload``; the lanes are one ``wide_lanes`` launch
    from the uploaded anchors, the blocks' headers and table rows (one
    ``decode_tables`` launch from the uploaded words) ``zlibes.headers``,
    which reads the blocks' statuses and the lanes' status back in one
    ``zlibes.readback``, after which a bad header, anchor count or anchor
    raises.
    """

    __slots__ = ("words", "start_w", "bit0", "endb", "base", "lt", "dt",
                 "coded", "stored", "contiguous", "total_out", "Cb", "LPB",
                 "SW", "T")

    @staticmethod
    @span("zlibes.plan")
    def build(data: bytes, index: StreamIndex,
              device: torch.device | str) -> "WidePlan":
        if not getattr(index, "wide", False):
            raise CorruptError("stream index does not carry wide anchors")
        if not getattr(index, "self_contained", True):
            raise CorruptError("wide decode requires self-contained blocks")
        p = WidePlan()
        ids = [i for i, b in enumerate(index.blocks)
               if b.btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC) and b.out_len]
        p.coded = [index.blocks[i] for i in ids]
        p.stored = [b for b in index.blocks
                    if b.btype == C.BTYPE_STORED and b.out_len]
        p.total_out = index.total_out
        p.T = wk.MAX_TOKENS
        with trace("zlibes.upload"):
            p.words = torch.from_numpy(stream_words(data)).to(device)
        if not p.coded:
            # all-stored stream (incompressible input): copies only
            p.Cb = p.LPB = p.SW = 0
            p.contiguous = False
            return p
        out_start = np.array([b.out_start for b in p.coded], np.int64)
        out_len = np.array([b.out_len for b in p.coded], np.int64)
        LPB = max(128, -(-int(out_len.max()) // (SUB * 128)) * 128)
        p.LPB = LPB
        p.Cb = Cb = len(p.coded)
        # rows flatten straight into the output iff the coded blocks tile
        # it back to back at LPB*SUB bytes each (no stored content, uniform
        # block size: the common case)
        p.contiguous = not p.stored and bool(
            (out_start == np.arange(Cb) * (LPB * SUB)).all())

        # per-lane anchor spans, built on the device from the anchors
        abit, aout, rows = anchor_rows(index, ids)
        with trace("zlibes.upload"):
            abit_d, aout_d, rows_d = (torch.from_numpy(x).to(device)
                                      for x in (abit, aout, rows))
        p.start_w, p.bit0, p.endb, p.base, lanes = wk.wide_lanes(
            abit_d, aout_d, rows_d, LPB)

        # per-block two-level tables, built from the words on the device;
        # the blocks' statuses come back with the lanes' status
        with trace("zlibes.headers"):
            with trace("zlibes.upload"):
                hdr = torch.from_numpy(dtab.headers(p.coded)).to(device)
            p.lt, p.dt, status = dtab.decode_tables(p.words, hdr,
                                                    len(data) * 8)
            with trace("zlibes.readback"):
                status = torch.cat([status, lanes]).cpu().numpy()
            dtab.raise_status(status[:Cb])
        na = -(-out_len // SUB)
        short = np.flatnonzero(rows[:, 1] != na)
        if short.size:
            cb = short[0]
            raise CorruptError(
                f"wide index must carry one anchor per {SUB} B of "
                f"block output ({na[cb]} expected, {rows[cb, 1]} found)")
        if status[Cb]:
            raise CorruptError("wide anchors are not monotone uniform")
        # a lane's 128-B sub-span codes at most ~128*15 + 48 bits (~66
        # words): the window covers the lane's span + 2 words of lookahead,
        # bucketed to multiples of 8 words
        wneed = -(-int(status[Cb + 1]) // 32) + 2
        p.SW = max(8, -(-wneed // 8) * 8)
        if p.SW > MAX_SW:
            raise CorruptError("anchor span exceeds the lane stream window")
        return p

    def check_meta(self, meta) -> None:
        """Validate decode metadata (>= 4 rows, L; a tensor on any device or
        an array): no lane flagged, every lane ended exactly at its anchor
        (empty lanes: 0 == 0).  Compared on the lanes' device; the verdict
        is one ``zlibes.readback`` of two flags."""
        meta = torch.as_tensor(meta, device=self.endb.device)
        flags = torch.stack([meta[2].any() | meta[3].any(),
                             (meta[1] != self.endb).any()])
        with trace("zlibes.readback"):
            failed, missed = flags.tolist()
        if failed:
            raise CorruptError("invalid Huffman data in wide lane")
        if missed:
            raise CorruptError("wide lane did not end at its anchor")


def run_wide(plan: WidePlan, check: bool = True) -> torch.Tensor:
    """Execute the device stages (decode, glue, resolve: two kernel
    launches; the spans ``zlibes.decode``, ``zlibes.glue`` and
    ``zlibes.resolve``, and ``zlibes.readback`` for the check); returns the
    (Cb, LPB*128) uint8 block rows on the plan's device (row cb holds coded
    block cb's output up to its out_len)."""
    with trace("zlibes.decode"):
        tokens, starts, meta = wk.decode_wide(
            (plan.words, plan.start_w), plan.bit0, plan.endb, plan.base,
            plan.lt, plan.dt, LPB=plan.LPB, T=plan.T, SW=plan.SW)
    if check:
        plan.check_meta(meta)
    with trace("zlibes.glue"):
        toks, sts = _glue_wide(tokens, starts, meta, plan.Cb, plan.LPB)
    with trace("zlibes.resolve"):
        return wk.resolve_wide(toks, sts)


def inflate_raw_wide(data: bytes, index: StreamIndex,
                     device: torch.device | str, check: bool = True,
                     stats: CodecStats | None = None) -> torch.Tensor:
    """Full wide-profile inflate; returns the decompressed bytes as a uint8
    tensor on ``device``.

    Contiguous streams are the rows flattened; otherwise the coded rows and
    the stored blocks' payloads (read from the plan's copy of the stream on
    the device) are spliced into one tensor.  On the card ``stats`` counts
    the coded blocks whose header and table rows ``decode_tables`` built
    (``device_headers``) and the lanes ``wide_lanes`` built
    (``device_lanes``).
    """
    plan = WidePlan.build(data, index, device)
    if stats is not None and plan.words.is_cuda:
        stats.device_headers += plan.Cb
        stats.device_lanes += plan.Cb * plan.LPB
    rows = run_wide(plan, check=check) if plan.coded else None
    return wide_output(plan, rows, data)


def wide_output(plan: WidePlan, rows: torch.Tensor | None,
                data: bytes) -> torch.Tensor:
    """The stream's output on the plan's device from the coded blocks' rows
    (``run_wide``'s, or None without coded blocks): the rows flattened when
    they tile the output, else the rows and the stored blocks' payloads
    spliced into one tensor."""
    if plan.contiguous:
        return rows.reshape(-1)[: plan.total_out]
    out = torch.empty(plan.total_out, dtype=torch.uint8,
                      device=plan.words.device)
    for i, b in enumerate(plan.coded):
        out[b.out_start : b.out_start + b.out_len] = rows[i, : b.out_len]
    splice_stored(out, plan.words.view(torch.uint8), data, plan.stored)
    return out
