"""Turbo inflate pipeline: lane windows + per-lane decode + chunk-row LZ
resolve, for streams carrying the turbo profile (shared 9-bit-capped
tables, 512 B anchor pairs, 4 KiB window reset).

Counterpart of ``zlibes_tpu/codec/turbo.py``.  Every per-lane array is in
lane order and the lanes keep the stream's order: the TPU pipeline's lane
grid, word-planes and chunk sort (which let whole TPU grid blocks exit
early) are not carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from zlibes_tpu.spec import constants as C
from zlibes_tpu.spec.errors import CorruptError
from zlibes_tpu.spec.refmodel import StreamIndex

from ..ops import turbo_kernel as tk

SUB = tk.SUB


def _glue_tokens(tokens: torch.Tensor, counts: torch.Tensor,
                 base: torch.Tensor, C_pad: int):
    """Token post-pass: start offsets + the resolve layout.

    tokens (T, L) int32 packed tokens, valid in [0, counts); base (L,) the
    sub-span offset of each lane's first token (0 for even lanes; the
    split - SUB for odd lanes).

    Decode lanes come in pairs covering one SEG_SPAN-byte segment, split
    at the first token starting at-or-after byte SUB.  Lane 2s feeds
    resolve sub-span 2s directly; lane 2s+1 feeds sub-span 2s+1, prefixed
    by the *crossing token* — the even lane's token that straddles SUB,
    re-emitted with a negative start so the resolve finds it for the odd
    sub-span's first bytes.  The slot is inserted only when a token
    crosses.

    Returns (toks16, starts16): (SUBS_PER_CHUNK, C_pad, TOKENS_PAD) int32,
    invalid slots carrying start 2048 (past any in-span position).
    """
    T, L = tokens.shape
    spc = tk.SUBS_PER_CHUNK
    dev = tokens.device
    valid = torch.arange(T, device=dev)[:, None] < counts[None, :]
    ism = (tokens & tk.TOK_MATCH_BIT) != 0
    val = tokens & tk.TOK_VAL_MASK
    lens = torch.where(valid, torch.where(ism, val, 1), 0)
    ends = torch.cumsum(lens, dim=0, dtype=torch.int32)
    starts = torch.where(valid, base[None, :] + ends - lens, tk.PAD_START)
    toks = torch.where(valid, tokens, 0)

    # crossing token per lane (at most one; only even lanes can have one:
    # odd lanes' rebased tokens end at <= SUB); sum = select
    cross = valid & (starts < SUB) & (starts + lens > SUB)
    has_cross = cross.any(dim=0)
    cross_t = torch.where(cross, toks, 0).sum(dim=0, dtype=torch.int32)
    cross_s = torch.where(cross, starts, 0).sum(dim=0, dtype=torch.int32) - SUB

    # odd lanes take the previous (even) lane's crossing token in slot 0
    odd = (torch.arange(L, device=dev) & 1) == 1
    use0 = odd & torch.roll(has_cross, 1)

    def relayout(x, slot0, fill):
        # (T, L) -> (spc, C_pad, TOKENS_PAD): lane l is chunk l // spc,
        # sub-span l % spc
        rows = x.T.reshape(C_pad, spc, T).permute(1, 0, 2)
        out = torch.full((spc, C_pad, tk.TOKENS_PAD), fill, dtype=torch.int32,
                         device=dev)
        out[:, :, :T] = rows
        shifted = torch.cat(
            [torch.roll(slot0, 1).reshape(C_pad, spc).T[:, :, None],
             out[:, :, :-1]], dim=2)
        return torch.where(use0.reshape(C_pad, spc).T[:, :, None], shifted,
                           out).contiguous()

    return (relayout(toks, cross_t, 0),
            relayout(starts, cross_s, tk.PAD_START))


def _lane_spans(index: StreamIndex):
    """Per-anchor (bit0, end_bit) absolute spans; turbo anchors come in
    pairs per SEG_SPAN bytes of output (segment start + mid-segment
    split)."""
    na = index.anchor_bit.size
    bit0 = index.anchor_bit.astype(np.int64)
    blk = index.anchor_block.astype(np.int64)
    end = np.empty(na, np.int64)
    end[:-1] = bit0[1:]
    blk_end = np.asarray([b.end_bit for b in index.blocks], np.int64)
    last_of_block = np.ones(na, bool)
    last_of_block[:-1] = blk[1:] != blk[:-1]
    end[last_of_block] = blk_end[blk[last_of_block]]
    return bit0, end


def _padded_lanes(L: int) -> int:
    """Lanes rounded up to whole 4 KiB chunks (SUBS_PER_CHUNK lanes)."""
    spc = tk.SUBS_PER_CHUNK
    return max(spc, -(-L // spc) * spc)


class TurboPlan:
    """Host-prepared device tensors for one turbo stream (reusable).

    words     (NW,) int32   the stream as little-endian words
    start_w   (L_pad,) int32 first stream word of each lane's window
    bit0/endb (L_pad,) int32 lane start / end bit within its window
    base      (L_pad,) int32 sub-span offset of each lane's first token
    lt/dt     (512,) int32   decode tables
    Padded lanes (>= L) are empty: bit0 == endb == 0.
    """

    __slots__ = ("words", "start_w", "bit0", "endb", "base", "lt", "dt",
                 "endb_host", "L", "L_pad", "C_pad", "T", "total_out")

    @staticmethod
    def build(data: bytes, index: StreamIndex,
              device: torch.device | str) -> "TurboPlan":
        from .inflate_pipeline import _block_code_lengths

        if not getattr(index, "turbo", False):
            raise CorruptError("stream index does not carry the turbo profile")
        for b in index.blocks:
            if b.btype == C.BTYPE_STORED and b.out_len:
                raise CorruptError("turbo streams contain no stored data")
        coded = [b for b in index.blocks if b.btype == C.BTYPE_DYNAMIC]
        if not coded:
            raise CorruptError("turbo stream has no coded blocks")
        ll_len, d_len = _block_code_lengths(data, coded[0])
        lt, dt = tk.turbo_decode_tables(ll_len, d_len)

        bit0_abs, end_abs = _lane_spans(index)
        L = bit0_abs.size
        spans = L // 2
        seg = tk.SEG_SPAN
        base_rel = index.anchor_out - (np.arange(L, dtype=np.int64) // 2) * seg
        if (L % 2 or not np.array_equal(base_rel[0::2],
                                        np.zeros(spans, np.int64))
                or (base_rel[1::2] < 0).any()
                or (base_rel[1::2] > seg).any()):
            raise CorruptError(
                f"turbo anchors must pair every {seg} B of output with a "
                f"mid-segment split anchor (split < {tk.SUB} only for a "
                f"short final segment, where the second lane is empty)")
        start_w = bit0_abs >> 5
        endb = end_abs - (start_w << 5)
        if int(endb.max(initial=0)) > (tk.STREAM_WORDS - 4) * 32:
            raise CorruptError("anchor span exceeds the lane stream window")
        # per-lane first-token offset in SUB-span coordinates (odd lanes'
        # within-segment split offset is rebased by -SUB, clipped at 0 for
        # a short final segment)
        base = base_rel.copy()
        base[1::2] = np.maximum(base[1::2] - tk.SUB, 0)

        p = TurboPlan()
        p.L = L
        p.L_pad = _padded_lanes(L)
        p.C_pad = p.L_pad // tk.SUBS_PER_CHUNK
        p.T = tk.MAX_TOKENS
        p.total_out = index.total_out

        raw = np.frombuffer(data, np.uint8)
        words = np.zeros(-(-raw.size // 4), "<u4")
        words.view(np.uint8)[: raw.size] = raw

        def lanes(vals):
            x = np.zeros(p.L_pad, np.int32)
            x[:L] = vals
            return torch.from_numpy(x).to(device)

        p.words = torch.from_numpy(words.view(np.int32)).to(device)
        p.start_w = lanes(start_w)
        p.bit0 = lanes(bit0_abs & 31)
        p.endb = lanes(endb)
        p.base = lanes(base)
        p.endb_host = p.endb.cpu().numpy()
        p.lt = torch.from_numpy(lt).to(device)
        p.dt = torch.from_numpy(dt).to(device)
        return p

    def check_meta(self, meta: np.ndarray) -> None:
        """Validate decode metadata (4, L_pad): no lane flagged, every lane
        ended exactly at its anchor (padded lanes: 0 == 0)."""
        if meta[2].any() or meta[3].any():
            raise CorruptError("invalid Huffman data in turbo lane")
        if not (meta[1] == self.endb_host).all():
            raise CorruptError("turbo lane did not end at its anchor")


def run_turbo(plan: TurboPlan, check: bool = True) -> torch.Tensor:
    """Execute the three device stages; returns the (C_pad, 4096) uint8
    chunk rows on the plan's device — output bytes are the rows flattened
    and cut at plan.total_out."""
    win = tk.lane_windows(plan.words, plan.start_w)
    tokens, meta = tk.decode_turbo(win, plan.bit0, plan.endb, plan.lt,
                                   plan.dt, T=plan.T)
    if check:
        plan.check_meta(meta.cpu().numpy())
    toks16, starts16 = _glue_tokens(tokens, meta[0], plan.base, plan.C_pad)
    return tk.resolve_turbo(toks16, starts16)


def inflate_raw_turbo(data: bytes, index: StreamIndex,
                      device: torch.device | str) -> torch.Tensor:
    """Full turbo inflate of a stream produced by CodecConfig.turbo().

    Returns the decompressed bytes as a uint8 tensor on ``device``.
    """
    plan = TurboPlan.build(data, index, device)
    rows = run_turbo(plan)
    return rows.reshape(-1)[: plan.total_out]
