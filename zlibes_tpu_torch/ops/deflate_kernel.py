"""Device-side encode stages of the turbo profile, as torch ops.

Counterpart of ``zlibes_tpu/ops/deflate_kernel.py``: symbols and per-block
histograms of the selected tokens (``token_symbols``), and the payload
pack straight into a compacted stream image (``pack_payload_turbo_dense``)
around the ``encode_fields`` kernel.

Every array is in lane order: lane ``l`` of a dispatch is row ``l`` of an
(L, T) array, segment ``l % nseg`` of block ``l // nseg``.  Coded words are
int64 holding 32-bit values until the image leaves as int32.

What replaces the reference's TPU choreography, exactly:

  * the histograms' row sort and boundary bisection -> one
    ``scatter_add`` of ones at ``block * S + symbol``;
  * the segmented OR scan of in-word contributions -> a segmented sum: a
    word's contributions are bit-disjoint, so adding them is OR-ing them;
  * the per-lane sort compacting run-end words, and the global sort
    splicing lane rows into the stream image -> scatters: word indices of
    run ends, and dense positions of lane words, are unique.
"""
from __future__ import annotations

import torch

from ..spec import constants as C

from .encode_kernel import encode_fields
from .symbol_math import dist_symbol, len_symbol
from .turbo_kernel import SUB

_MASK32 = (1 << 32) - 1
_BIGS = 1 << 30          # "no split token" sentinel
_BIGK = 0x3FFFFFFF       # inactive word slot / dense key


def token_symbols(tv: torch.Tensor, td: torch.Tensor, cnt: torch.Tensor,
                  nseg: int):
    """tv, td (L, T) token values and distances, cnt (L,) tokens per lane
    -> (lsym, dsym (-1 for literals), valid (L, T), ll_freq (B, 288),
    d_freq (B, 32)), frequencies int64."""
    L, T = tv.shape
    B = L // nseg
    dev = tv.device
    valid = torch.arange(T, device=dev)[None, :] < cnt[:, None]
    is_match = valid & (td > 0)
    lsym = torch.where(is_match, len_symbol(tv.clamp(0, C.MAX_MATCH)),
                       tv.long())
    lsym = torch.where(valid, lsym, 0)
    dsym = torch.where(is_match, dist_symbol(td.clamp(0, C.WINDOW_SIZE)), -1)
    blk = (torch.arange(L, device=dev) // nseg)[:, None]

    def hist(sym, mask, S):
        # masked tokens count in one spare bin past the last block's
        idx = torch.where(mask, blk * S + sym, B * S).reshape(-1)
        counts = torch.zeros(B * S + 1, dtype=torch.long, device=dev)
        counts.scatter_add_(0, idx, torch.ones_like(idx))
        return counts[:B * S].reshape(B, S)

    ll_freq = hist(lsym, valid, C.NUM_LITLEN_SYMBOLS)
    d_freq = hist(dsym, is_match, C.NUM_DIST_SYMBOLS)
    return lsym, dsym, valid, ll_freq, d_freq


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def _segmented_sum(v: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along axis 1 that restarts where ``first``."""
    cs = torch.cumsum(v, 1)
    col = torch.arange(v.shape[1], device=v.device).expand_as(v)
    start = torch.cummax(torch.where(first, col, 0), dim=1).values
    return cs - (cs - v).gather(1, start)


def pack_rows_turbo(tv, td, valid, lt, dt, hdr_bits, nseg: int, R: int):
    """Coded fields placed into per-lane word rows (``_pack_rows_turbo``,
    zlibes_tpu/ops/deflate_kernel.py:386).

    Returns (rows (L, R) int64: word j of lane l's coded bits, relative to
    the lane's first stream word lane_bit0 >> 5; lane_tot (L,) bits;
    lane_bit0 (L,); payload_end (B,); split_bit, split_out
    (L,): bit and output offsets, relative to the lane's first token, of
    the first token starting at or after output byte SUB of the lane, 2^30
    when none does)."""
    L, T = tv.shape
    B = L // nseg
    dev = tv.device
    val, nb = encode_fields(tv.reshape(-1), td.reshape(-1),
                            valid.int().reshape(-1), lt, dt)
    val = val.long().reshape(L, T) & _MASK32
    tb = torch.where(valid, nb.reshape(L, T), 0).long()

    lane_tot = tb.sum(1)
    blk1 = torch.arange(L, device=dev) // nseg
    lane_cum = _exclusive_cumsum(lane_tot, 0)
    lane_base = lane_cum - lane_cum[blk1 * nseg]
    within = _exclusive_cumsum(tb, 1)
    hdr = hdr_bits.long()
    lane_bit0 = lane_base + hdr[blk1]
    payload_end = lane_tot.reshape(B, nseg).sum(1) + hdr

    # mid-segment anchor split: first token whose output start is >= SUB
    adv = torch.where(valid, torch.where(td > 0, tv.long(), 1), 0)
    wout = _exclusive_cumsum(adv, 1)
    cond = wout >= SUB
    split_bit = torch.where(cond, within, _BIGS).min(1).values
    split_out = torch.where(cond, wout, _BIGS).min(1).values

    en = valid & (tb > 0)
    rel = within + (lane_bit0 & 31)[:, None]     # bit offset within lane row
    dw = torch.where(en, rel >> 5, _BIGK)        # word slot
    sh = rel & 31
    c0 = torch.where(en, (val << sh) & _MASK32, 0)
    c1 = torch.where(en, (val >> (31 - sh)) >> 1, 0)

    prev = torch.nn.functional.pad(dw, (1, 0), value=-1)[:, :T]
    acc = _segmented_sum(c0, dw > prev)
    nxt = torch.nn.functional.pad(dw, (0, 1), value=1 << 30)[:, 1:]
    is_end = (nxt > dw) & en
    # tokens' word slots advance by <= 1 (every coded token fits 32 bits),
    # so the run ends carry word slots 0..nwords-1, each once
    slot = torch.where(is_end, dw, R).clamp(max=R)
    main = torch.zeros((L, R + 1), dtype=torch.long, device=dev)
    main.scatter_(1, slot, torch.where(is_end, acc, 0))
    carry = torch.zeros((L, R + 1), dtype=torch.long, device=dev)
    carry.scatter_(1, slot, torch.where(is_end, c1, 0))
    rows = main[:, :R] | torch.nn.functional.pad(carry[:, :R - 1], (1, 0))
    return rows, lane_tot, lane_bit0, payload_end, split_bit, split_out


def pack_payload_turbo_dense(tv, td, valid, lt, dt, hdr_bits, eob_len: int,
                             nseg: int, R: int, F: int = 80):
    """Turbo pack straight to a compacted stream image
    (``pack_payload_turbo_dense``, zlibes_tpu/ops/deflate_kernel.py:542).

    tv, td (L, T) int32 tokens, valid (L, T) bool, lt (288,) / dt (32,)
    int32 packed tables, hdr_bits (B,) int32 header bits per block (a
    padded block has no tokens and packs to its header's span).  Lane l owns the dense words [blk_off[b] + W0[l], ... +
    W0[l+1]) of its block's span (the last content lane through the block's
    used_words = (payload_end + eob_len + 31) // 32 + 1, covering the EOB
    word the host fills), the word shared at a lane boundary pre-merged
    into the successor's word 0; filler zeros cover each block's header
    words, or the whole span of a block without content.

    Returns (dense (L*R + B*F,) int32: the first sum(used_words) words are
    the compacted stream image, zeros after; payload_end (B,), lane_bit0,
    split_bit, split_out (L,)), all int64 but the image."""
    L, T = tv.shape
    B = L // nseg
    dev = tv.device
    rows, lane_tot, lane_bit0, payload_end, split_bit, split_out = \
        pack_rows_turbo(tv, td, valid, lt, dt, hdr_bits, nseg, R)
    lane = torch.arange(L, device=dev)
    blk1 = lane // nseg
    used_words = (payload_end + eob_len + 31) // 32 + 1
    blk_off = _exclusive_cumsum(used_words, 0)
    W0 = lane_bit0 >> 5
    lane_in_blk = lane % nseg
    has_bits = lane_tot > 0
    W0_next = torch.nn.functional.pad(W0, (0, 1))[1:]
    succ_has = (torch.nn.functional.pad(has_bits, (0, 1))[1:]
                & (lane_in_blk != nseg - 1))
    # empty segment lanes only trail a block (every covered segment emits a
    # token), so a content lane with no content successor owns the block's
    # tail words through used_words
    n_l = torch.where(has_bits, torch.where(succ_has, W0_next - W0,
                                            used_words[blk1] - W0), 0)
    carry = rows.gather(1, n_l.clamp(0, R - 1)[:, None])[:, 0]
    carry_in = torch.nn.functional.pad(carry, (1, 0))[:L]
    carry_in = torch.where(lane_in_blk == 0, 0, carry_in)
    rows = torch.cat([rows[:, :1] | carry_in[:, None], rows[:, 1:]], 1)

    size = L * R + B * F
    jrel = torch.arange(R, device=dev)[None, :]
    gkey = torch.where(jrel < n_l[:, None],
                       (blk_off[blk1] + W0)[:, None] + jrel, size)
    dense = torch.zeros(size + 1, dtype=torch.long, device=dev)
    dense.scatter_(0, gkey.clamp(0, size).reshape(-1), rows.reshape(-1))
    # filler keys (header words; the whole span of a content-free block)
    # hold zeros: the zero-initialised image already has them
    dense = dense[:size]
    dense = torch.where(dense >= 1 << 31, dense - (1 << 32), dense).int()
    return dense, payload_end, lane_bit0, split_bit, split_out
