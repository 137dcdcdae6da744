"""Device-side encode stages, as torch ops.

Counterpart of ``zlibes_tpu/ops/deflate_kernel.py``: symbols and per-block
histograms of the selected tokens (``token_symbols``); the general
encoder's payload pack under per-block tables into per-block word buffers
(``pack_payload``) and the read of their used words
(``gather_compressed``); and the shared-table encoder's pack around the
``encode_fields`` kernel (any shared-tables config, fields of up to 48
bits), straight into a compacted stream image
(``pack_payload_turbo_dense``) or, for the block-parallel turbo encoder,
into per-block word buffers (``pack_payload_turbo``).

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
    run ends, and dense positions of lane words, are unique;
  * ``pack_payload``'s bf16 one-hot matmul table lookup -> a gather of
    the block's (code, length) row; its 32 masked minima of the sub-anchors
    -> one ``searchsorted`` a lane (output offsets do not decrease along a
    lane's tokens).
"""
from __future__ import annotations

import torch

from ..spec import constants as C

from .encode_kernel import encode_fields
from .symbol_math import dist_extra, dist_symbol, len_extra, len_symbol
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


def pack_payload(tv, td, lsym, dsym, valid, ll_code, ll_len, d_code, d_len,
                 hdr_bits, enabled, nseg: int, W: int, sub_every: int = 0):
    """Every token's coded field placed into per-block word buffers
    (``pack_payload``, zlibes_tpu/ops/deflate_kernel.py:80).

    tv, td, lsym, dsym (L, T) tokens and their symbols (dsym -1 for a
    literal), valid (L, T) bool; ll_code, ll_len (B, 288) and d_code, d_len
    (B, 32) each block's bit-reversed codes and lengths; hdr_bits (B,) bits
    of each block's header, left free at the front of its buffer; enabled
    (B,) bool, False for a block that is not coded (stored or padding).

    Returns (words (B, W) int64 holding 32-bit words; payload_end (B,) the
    bit offset just after the last token, the end-of-block code not
    included; lane_bit0 (L,) the bit offset of each lane's first token) and,
    with ``sub_every`` > 0, (sub_bit, sub_out (L, T // sub_every)): for each
    ``sub_every``-byte output boundary j of the lane, the bit offset within
    the block and the output offset within the lane of the first token
    starting at or after byte j * sub_every, 2^30 where the lane has none.

    A field has up to 48 bits (15 + 5 + 15 + 13) and lands in up to three
    words; contributions to a word are bit-disjoint, so they are added."""
    L, T = tv.shape
    B = L // nseg
    dev = tv.device
    blk1 = torch.arange(L, device=dev) // nseg
    blk2 = blk1[:, None]
    is_match = valid & (td > 0)
    vs = tv.clamp(0, C.MAX_MATCH)
    ds = td.clamp(0, C.WINDOW_SIZE)

    ls = lsym.long().clamp(0, C.NUM_LITLEN_SYMBOLS - 1)
    f1v = ll_code.long()[blk2, ls]
    f1n = torch.where(valid, ll_len.long()[blk2, ls], 0)
    dsy = torch.where(is_match, dsym.long(), 0).clamp(
        0, C.NUM_DIST_SYMBOLS - 1)
    f3v = torch.where(is_match, d_code.long()[blk2, dsy], 0)
    f3n = torch.where(is_match, d_len.long()[blk2, dsy], 0)
    le_n, le_v = len_extra(vs)
    f2v = torch.where(is_match, le_v, 0)
    f2n = torch.where(is_match, le_n, 0)
    de_n, de_v = dist_extra(ds)
    f4v = torch.where(is_match, de_v, 0)
    f4n = torch.where(is_match, de_n, 0)

    # the combined field, LSB-first, in one int64 (at most 48 bits)
    field = torch.zeros_like(f1v)
    tb = torch.zeros_like(f1n)
    for v, n in ((f1v, f1n), (f2v, f2n), (f3v, f3n), (f4v, f4n)):
        field |= (v & ((1 << n) - 1)) << tb
        tb = tb + n

    lane_tot = tb.sum(1)
    lane_cum = _exclusive_cumsum(lane_tot, 0)
    lane_base = lane_cum - lane_cum[blk1 * nseg]       # restarts per block
    within = _exclusive_cumsum(tb, 1)
    hdr = hdr_bits.long()
    lane_bit0 = lane_base + hdr[blk1]
    tok_off = lane_bit0[:, None] + within
    payload_end = lane_tot.reshape(B, nseg).sum(1) + hdr

    lo = field & _MASK32
    hi = field >> 32
    w = blk2 * W + (tok_off >> 5)
    sh = tok_off & 31
    w0v = (lo << sh) & _MASK32
    w1v = ((lo << sh) >> 32) | ((hi << sh) & _MASK32)
    w2v = (hi << sh) >> 32
    use = enabled[blk2] & valid & (tb > 0)
    OOB = B * W
    words = torch.zeros(OOB + 1, dtype=torch.long, device=dev)
    for k, (wv, on) in enumerate(((w0v, use), (w1v, use & (w1v > 0)),
                                  (w2v, use & (w2v > 0)))):
        idx = torch.where(on, w + k, OOB).clamp(max=OOB)
        words.index_add_(0, idx.reshape(-1), wv.reshape(-1))
    words = words[:OOB].reshape(B, W)
    if not sub_every:
        return words, payload_end, lane_bit0

    # sub-anchors: first token at or after every sub_every-byte output
    # boundary of the lane
    adv = torch.where(valid, torch.where(td > 0, vs.long(), 1), 0)
    wout = torch.where(valid, _exclusive_cumsum(adv, 1), _BIGS)
    bounds = (torch.arange(T // sub_every, device=dev) * sub_every).expand(
        L, T // sub_every).contiguous()
    first = torch.searchsorted(wout, bounds)
    found = first < T
    first = first.clamp(max=T - 1)
    sub_out = torch.where(found, wout.gather(1, first), _BIGS)
    sub_bit = torch.where(sub_out < _BIGS, tok_off.gather(1, first), _BIGS)
    return words, payload_end, lane_bit0, sub_bit, sub_out


def gather_compressed(words_flat: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """The used words of the per-block buffers, as one dense int32 array
    for the copy to the host (``gather_compressed``,
    zlibes_tpu/ops/deflate_kernel.py:634): words_flat int64 holding 32-bit
    words, idx their flat indices."""
    v = words_flat[idx]
    return torch.where(v >= 1 << 31, v - (1 << 32), v).int()


def pack_rows_turbo(tv, td, valid, lt, dt, hdr_bits, nseg: int, R: int):
    """Coded fields placed into per-lane word rows (``_pack_rows_turbo``,
    zlibes_tpu/ops/deflate_kernel.py:386), fields of up to 48 bits whole
    (the reference's pack takes the low 32 bits of each).

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
    val = val.reshape(L, T)
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

    # a field of up to 48 bits at bit sh (< 32) of its word slot dw spans up
    # to three words: c0 in dw, c1 in dw + 1, c2 in dw + 2
    en = valid & (tb > 0)
    rel = within + (lane_bit0 & 31)[:, None]     # bit offset within lane row
    dw = torch.where(en, rel >> 5, _BIGK)        # word slot
    sh = rel & 31
    lo = (val & _MASK32) << sh                   # < 2^63
    hi = (val >> 32) << sh                       # < 2^47
    c0 = torch.where(en, lo & _MASK32, 0)
    c1 = torch.where(en, (lo >> 32) | (hi & _MASK32), 0)
    c2 = torch.where(en, hi >> 32, 0)

    # the tokens starting in one word slot are a run; only the run's last
    # token reaches past the slot.  A wide token can leave the next slot
    # without a run of its own, so the run ends hold distinct, not
    # consecutive, slots: word j is the c0 sum of run j, the c1 of run j - 1
    # and the c2 of run j - 2, each 0 where there is no such run
    prev = torch.nn.functional.pad(dw, (1, 0), value=-1)[:, :T]
    acc = _segmented_sum(c0, dw > prev)
    nxt = torch.nn.functional.pad(dw, (0, 1), value=1 << 30)[:, 1:]
    is_end = (nxt > dw) & en
    slot = torch.where(is_end, dw, R).clamp(max=R)
    rows = torch.zeros((L, R), dtype=torch.long, device=dev)
    for k, part in enumerate((acc, c1, c2)):
        words = torch.zeros((L, R + 1), dtype=torch.long, device=dev)
        words.scatter_(1, slot, torch.where(is_end, part, 0))
        rows[:, k:] |= words[:, :R - k]
    return rows, lane_tot, lane_bit0, payload_end, split_bit, split_out


def pack_payload_turbo(tv, td, valid, lt, dt, hdr_bits, nseg: int, W: int,
                       R: int):
    """Turbo pack into per-block W-word buffers (``pack_payload_turbo``,
    zlibes_tpu/ops/deflate_kernel.py:487), the block-parallel encoder's:
    each lane's row of ``pack_rows_turbo`` added at its block's buffer from
    the lane's first stream word (the one word two lanes share holds
    disjoint bits of each, so adding is OR-ing), words past W dropped.

    tv, td (L, T) int32 tokens, valid (L, T) bool, lt (288,) / dt (32,)
    int32 packed tables, hdr_bits (B,) header bits per block, left free at
    the front of its buffer.  Returns (words (B, W) int64 holding 32-bit
    words, payload_end (B,), lane_bit0, split_bit, split_out (L,))."""
    L = tv.shape[0]
    B = L // nseg
    dev = tv.device
    rows, _tot, lane_bit0, payload_end, split_bit, split_out = \
        pack_rows_turbo(tv, td, valid, lt, dt, hdr_bits, nseg, R)
    blk1 = torch.arange(L, device=dev) // nseg
    OOB = B * W
    idx = (blk1 * W + (lane_bit0 >> 5))[:, None] \
        + torch.arange(R, device=dev)[None, :]
    idx = torch.where(idx < (blk1 * W + W)[:, None], idx, OOB)
    words = torch.zeros(OOB + 1, dtype=torch.long, device=dev)
    words.index_add_(0, idx.reshape(-1), rows.reshape(-1))
    return (words[:OOB].reshape(B, W), payload_end, lane_bit0, split_bit,
            split_out)


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
