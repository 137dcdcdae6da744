"""Generic indexed inflate kernels for NVIDIA Hopper, with their plain
versions.

Counterpart of ``zlibes_tpu/ops/inflate_kernel.py``: the device decode of a
stream whose index carries neither turbo nor wide anchors (a generic index
of about one anchor every 4 KiB of output, a ``build_index`` index of a
foreign stream, the index of a preset-dictionary stream) and of an
un-indexed stream, block by block.  Two stages:

  * ``decode_tokens``  per-lane Huffman decode of variable-length lanes
    into packed tokens and their output offsets;
  * ``resolve_global`` LZ expansion of any number of lanes into one output
    span behind an already-resolved prefix (32 KiB reach and more: a copy
    may reach any earlier byte of the span or of the prefix).

Each wrapper launches its CUDA kernel (``csrc/inflate_kernels.cu``) for a
CUDA tensor and runs its plain PyTorch version for a CPU tensor; any other
device raises.  Launches are counted in ``turbo_kernel.LAUNCHES``.  Both
reference functions are XLA programs (a ``while_loop`` of gathers, a
scatter / cummax / pointer-doubling pass), not ``pallas_call``s; their
plain versions are an eager step a token and a handful of passes a round.

Tokens use the wide profile's packing (``wide_kernel.TOK_*``): literal byte
or match length in bits 0-8, distance in bits 9-24, bit 25 for a match.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spec import constants as C
from ..spec.errors import CorruptError
from .turbo_kernel import _check, _launch, _ptr, _route
from .wide_kernel import (
    D_ROOT,
    D_ROOT_BITS,
    D_SUB_OFF,
    D_W,
    LL_ROOT,
    LL_ROOT_BITS,
    LL_SUB,
    LL_W,
    TOK_DIST_MASK,
    TOK_DIST_SHIFT,
    TOK_MATCH_BIT,
    TOK_VAL_MASK,
    _KIND_EOB,
    _KIND_INVALID,
    _KIND_LEN,
    _SUB_FLAG,
)

_MASK32 = (1 << 32) - 1

# entries of a row of one-level roots that the decode kernel flattens each
# table row into: 2^11 litlen, 2^8 distance (kFlatW of
# csrc/inflate_kernels.cu)
FLAT_W = (1 << 11) + (1 << 8)


def stream_words(data: bytes) -> np.ndarray:
    """The stream as little-endian int32 words, the last one zero-padded:
    what every decode kernel of the port reads its bits from."""
    raw = np.frombuffer(data, np.uint8)
    words = np.zeros(-(-raw.size // 4), "<u4")
    words.view(np.uint8)[: raw.size] = raw
    return words.view(np.int32)


def splice_stored(out: torch.Tensor, stream_bytes: torch.Tensor,
                  data: bytes, blocks) -> None:
    """Copy every stored block's payload into ``out``, on the device of
    ``stream_bytes`` (the stream as uint8): stored bytes never pass through
    a decode kernel."""
    for b in blocks:
        if b.btype == C.BTYPE_STORED and b.out_len:
            pos = (b.payload_start_bit >> 3) + 4   # past LEN / NLEN
            if pos + b.out_len > len(data):
                raise CorruptError(
                    "stored block runs past the end of the stream")
            out[b.out_start : b.out_start + b.out_len] = \
                stream_bytes[pos : pos + b.out_len]


# ---------------------------------------------------------------------------
# stage 1: per-lane token decode
#
# Replaces decode_tokens (zlibes_tpu/ops/inflate_kernel.py:62), an XLA
# while_loop that decodes one token of every lane an iteration through flat
# 2^15-entry tables, two gathers a window.  Here a lane reads its block's
# two-level tables (wide_kernel.wide_decode_tables: 7 KB a row where a flat
# row is 128 KiB + 128 KiB), which decode the same codes to the same
# symbols.  The kernel (csrc/inflate_kernels.cu) is bound by its longest
# lane's chain of tokens, one thread a lane: it first flattens every row
# into one-level roots of 11 litlen and 8 distance bits (FLAT_W entries, in
# a scratch array the wrapper allocates), then walks each lane as
# decode_wide does, two literals a step, with the stream's words in
# registers (a generic lane, up to ~1,900 words, is too long to stage),
# every rare case through the two-level row, and as few lanes a block as
# make two blocks an SM (a warp pays for each of its lanes' rare steps).
#
# Contract (the reference's, token for token): a token is bad when its
# litlen code is invalid (no code, symbol 286/287), when a length has an
# invalid distance code (no code, symbol 30/31), or when it ends past the
# lane's end bit.  A bad token sets the error flag and stops the lane
# without moving its bit position; end-of-block stops it after moving it;
# reaching the end bit stops it.  A lane still active after T tokens stops
# with its bit position, to be resumed by another call.  A lane whose
# ``active0`` is false emits nothing.  No check of a distance against the
# output (the resolve flags a reference before its span).  Token t of lane
# b lies at [t, b] of (T, B) ``tokens`` with its output offset from the
# lane's first byte at [t, b] of ``starts``; slots at or past the lane's
# count are not written by the kernel (zeros in the plain version).

def _stream_bits(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 63 stream bits from bit ``pos`` (int64, per lane), LSB-first, as
    int64; words past the end of the stream read as 0."""
    n = words.numel()
    wi = (pos >> 5)[:, None] + torch.arange(3, device=pos.device)
    got = words[wi.clamp(0, max(n - 1, 0))].long() & _MASK32
    got = torch.where((wi >= 0) & (wi < n), got, 0)
    s = pos & 31
    w0, w1, w2 = got[:, 0], got[:, 1], got[:, 2]
    low = (1 << s) - 1
    lo32 = (w0 >> s) | ((w1 & low) << (32 - s))
    hi32 = (w1 >> s) | ((w2 & low) << (32 - s))
    return lo32 | ((hi32 & 0x7FFFFFFF) << 32)


def decode_tokens_plain(words, lt, dt, table_row, bit0, end_bit, active0,
                        T: int):
    B = bit0.numel()
    dev = words.device
    tokens = torch.zeros((T, B), dtype=torch.int32, device=dev)
    starts = torch.zeros((T, B), dtype=torch.int32, device=dev)
    lt_flat = lt.long().reshape(-1)
    dt_flat = dt.long().reshape(-1)
    lt_off = table_row.long() * LL_W
    dt_off = table_row.long() * D_W
    pos = bit0.clone()
    end = end_bit
    outpos = torch.zeros(B, dtype=torch.long, device=dev)
    active = active0.clone()
    err = torch.zeros(B, dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.long, device=dev)
    for t in range(T):
        if not bool(active.any()):
            break
        x = _stream_bits(words, pos)
        e1 = lt_flat[lt_off + (x & (LL_ROOT - 1))]
        subw = (e1 & 15).clamp(max=6)
        sidx = ((e1 >> 9) & 511) + ((x >> LL_ROOT_BITS) & ((1 << subw) - 1))
        e2 = lt_flat[lt_off + LL_ROOT + sidx.clamp(0, LL_SUB - 1)]
        e = torch.where((e1 & _SUB_FLAG) != 0, e2, e1)
        ln = e & 15
        kind = (e >> 4) & 3
        eb = (e >> 6) & 7
        val = (e >> 9) & 511
        is_len = kind == _KIND_LEN
        val = torch.where(is_len, val + ((x >> ln) & ((1 << eb) - 1)), val)
        k1 = ln + eb
        y = x >> k1
        d1 = dt_flat[dt_off + (y & (D_ROOT - 1))]
        dsw = ((d1 >> 24) & 15).clamp(max=9)
        dsidx = ((d1 >> 8) & 1023) + ((y >> D_ROOT_BITS) & ((1 << dsw) - 1))
        d2 = dt_flat[dt_off + D_SUB_OFF + dsidx.clamp(0, 639)]
        de = torch.where((d1 & _SUB_FLAG) != 0, d2, d1)
        dln = de & 15
        deb = (de >> 4) & 15
        dist = ((de >> 8) & 0x7FFF) + ((y >> dln) & ((1 << deb) - 1))
        newpos = pos + k1 + torch.where(is_len, dln + deb, 0)
        bad = ((ln == 0) | (kind == _KIND_INVALID) | (is_len & (dln == 0))
               | (newpos > end))
        emit = active & ~bad & (kind != _KIND_EOB)
        tok = torch.where(
            is_len, val | (dist << TOK_DIST_SHIFT) | TOK_MATCH_BIT, val)
        tokens[t] = torch.where(emit, tok, 0).int()
        starts[t] = torch.where(emit, outpos, 0).int()
        count += emit.long()
        err |= active & bad
        pos = torch.where(active & ~bad, newpos, pos)
        outpos += torch.where(emit, torch.where(is_len, val, 1), 0)
        active = emit & (newpos < end)
    return tokens, starts, count.int(), pos, active, err


def decode_tokens(words: torch.Tensor, lt: torch.Tensor, dt: torch.Tensor,
                  table_row: torch.Tensor, bit0: torch.Tensor,
                  end_bit: torch.Tensor, active0: torch.Tensor, T: int):
    """words (NW,) int32 the stream (``stream_words``); lt (NB, LL_W), dt
    (NB, D_W) int32 two-level tables, one row per block as
    ``wide_decode_tables`` builds them; table_row (B,) int32 each lane's
    row; bit0, end_bit (B,) int64 absolute start / end bit of each lane;
    active0 (B,) bool the lanes to decode; T token slots a lane.

    Returns (tokens (T, B) int32 packed, starts (T, B) int32 offsets in the
    lane's output, both valid in [0, count); count (B,) int32; bitpos (B,)
    int64 the bit after the last consumed symbol; active (B,) bool lanes
    stopped by T; err (B,) bool)."""
    dev = words.device
    B = bit0.numel()
    _check(words, "words", torch.int32, (words.numel(),), dev)
    NB = lt.shape[0] if lt.dim() == 2 else -1
    _check(lt, "lt", torch.int32, (NB, LL_W), dev)
    _check(dt, "dt", torch.int32, (NB, D_W), dev)
    if B and NB < 1:
        raise ValueError("lanes without a table row")
    for name, t, dtype in (("table_row", table_row, torch.int32),
                           ("bit0", bit0, torch.int64),
                           ("end_bit", end_bit, torch.int64),
                           ("active0", active0, torch.bool)):
        _check(t, name, dtype, (B,), dev)
    if T <= 0 or T * B >= 1 << 31:
        raise ValueError(f"{T} token slots of {B} lanes: T must be positive "
                         f"and T * B below 2**31")
    if not _route(words):
        return decode_tokens_plain(words, lt, dt, table_row, bit0, end_bit,
                                   active0, T)
    tokens = torch.empty((T, B), dtype=torch.int32, device=dev)
    starts = torch.empty((T, B), dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    bitpos = torch.empty(B, dtype=torch.int64, device=dev)
    active = torch.empty(B, dtype=torch.bool, device=dev)
    err = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        flat = torch.empty((NB, FLAT_W), dtype=torch.int32, device=dev)
        _launch("decode_tokens", dev, _ptr(words),
                ctypes.c_int64(words.numel()), _ptr(lt), _ptr(dt),
                ctypes.c_int(NB), _ptr(flat), _ptr(table_row), _ptr(bit0),
                _ptr(end_bit), _ptr(active0), ctypes.c_int(B),
                ctypes.c_int(T), _ptr(tokens), _ptr(starts),
                _ptr(count), _ptr(bitpos), _ptr(active), _ptr(err))
    return tokens, starts, count, bitpos, active, err


# ---------------------------------------------------------------------------
# stage 2: LZ resolve of one output span
#
# Replaces resolve_global (zlibes_tpu/ops/inflate_kernel.py:152): one token
# scatter, a cummax forward fill of each byte's covering token, one gather
# of its metadata, then pointer-doubling rounds (full width while many
# bytes are open, then over a sort-compacted set).  Here the decoder hands
# over each token's offset, so no cumsum or fill is needed.  The kernel
# (csrc/inflate_kernels.cu) takes the output in 4 KiB tiles, a block each:
# an expand kernel finds the tokens that cover its tile by searches over
# out_base and the lanes' ascending starts (so it reads no slot past a
# count, and one lane of a million tokens spreads over all SMs as well as
# 940 lanes do), gives each byte its final value or its source by the
# reference's modular rule, and resolves the sources inside the tile in
# shared memory; then rounds, a launch each, jump the pointers that leave
# their tile (up to RESOLVE_HOPS a byte), skipping tiles with nothing open
# and every tile once a round left nothing open: a source lies in an
# earlier tile, so ``rounds`` of them finish any chain.
#
# Coordinates as in the reference: the prefix (P bytes, already resolved)
# is [0, P) of the output; lane b's bytes start at out_base[b] (>= P - 258:
# a token may start before P, and its bytes below P are the prefix's) and
# the lanes tile [P, total) in lane order.  ``err`` marks a copy from below
# 0; such a source reads byte 0.  A byte that no token covers (only a
# corrupt decode leaves one) is 0 here and the forward-filled token's in
# the plain version, as in the reference.  total < 2**31.

# output bytes a block of the kernel owns, and the pointers an open byte
# follows a round (kTile and kHops of csrc/inflate_kernels.cu)
RESOLVE_TILE = 4096
RESOLVE_HOPS = 16

_RESOLVED = 1 << 40   # plain version: a final byte carries this flag


def resolve_global_plain(tokens, starts, count, out_base, total: int,
                         prefix):
    T, B = tokens.shape
    P = prefix.numel()
    O = total
    dev = tokens.device
    valid = torch.arange(T, device=dev)[:, None] < count.long()[None, :]
    tok = tokens.long()
    ism = valid & ((tok & TOK_MATCH_BIT) != 0)
    val = tok & TOK_VAL_MASK
    dist = torch.where(ism, (tok >> TOK_DIST_SHIFT) & TOK_DIST_MASK, 0)
    tok_len = torch.where(valid, torch.where(ism, val, 1), 0)
    g_start = out_base.long()[None, :] + starts.long()
    g_end = g_start + tok_len
    # tokens overlapping [P, O) scatter at their first byte there
    in_win = valid & (g_end > P) & (g_start < O)
    posf = torch.where(in_win, g_start.clamp(min=P), O).reshape(-1)
    packed = ((val << 16) | dist).reshape(-1)
    svd = torch.zeros(O + 1, dtype=torch.long, device=dev).scatter_(
        0, posf, packed)[:O]
    sstart = torch.full((O + 1,), -1, dtype=torch.long, device=dev).scatter_(
        0, posf, g_start.reshape(-1))[:O]
    o_q = torch.cummax(sstart, 0).values
    q = torch.arange(O, device=dev)
    vd = svd[o_q.clamp(min=P).clamp(0, max(O - 1, 0))] if O else svd
    d_q = vd & 0xFFFF
    v_q = vd >> 16
    incopy = (d_q > 0) & (q >= P)
    src = torch.where(incopy, o_q - d_q + (q - o_q) % d_q.clamp(min=1), q)
    err = (incopy & (src < 0)).any()
    src = src.clamp(0, max(O - 1, 0))
    pref = torch.zeros(O, dtype=torch.long, device=dev)
    pref[:P] = prefix.long()
    literal = torch.where(q < P, pref, v_q & 0xFF)
    state = torch.where(incopy, src, literal | _RESOLVED)
    for _ in range(max(O - 1, 1).bit_length()):
        done = state >= _RESOLVED
        state = torch.where(done, state, state[torch.where(done, 0, state)])
    return (state & 255).to(torch.uint8), err


def resolve_global(tokens: torch.Tensor, starts: torch.Tensor,
                   count: torch.Tensor, out_base: torch.Tensor, total: int,
                   prefix: torch.Tensor):
    """tokens, starts (T, B) int32 as ``decode_tokens`` gives them, valid in
    [0, count); count, out_base (B,) int32; total the span's length in
    bytes, prefix included; prefix (P,) uint8 the resolved bytes before the
    lanes' output, P <= total.  Returns (out (total,) uint8 with the prefix
    at [0, P), err () bool: a copy reaches below 0)."""
    dev = tokens.device
    T, B = tokens.shape if tokens.dim() == 2 else (-1, -1)
    _check(tokens, "tokens", torch.int32, (T, B), dev)
    _check(starts, "starts", torch.int32, (T, B), dev)
    _check(count, "count", torch.int32, (B,), dev)
    _check(out_base, "out_base", torch.int32, (B,), dev)
    P = prefix.numel()
    _check(prefix, "prefix", torch.uint8, (P,), dev)
    if not P <= total < 1 << 31:
        raise ValueError(f"total {total} must lie in [{P}, 2**31)")
    if not _route(tokens):
        return resolve_global_plain(tokens, starts, count, out_base, total,
                                    prefix)
    out, err, _ = _resolve_global_cuda(tokens, starts, count, out_base,
                                       total, prefix)
    return out, err.bool()


def resolve_rounds(total: int) -> int:
    """The rounds ``resolve_global``'s kernel launches after its expand for
    a span of ``total`` bytes: each multiplies a pointer's reach by
    RESOLVE_HOPS + 1, and a chain has fewer hops than there are tiles."""
    tiles = -(-total // RESOLVE_TILE)
    rounds = 0
    while (RESOLVE_HOPS + 1) ** rounds < tiles:
        rounds += 1
    return rounds


def _resolve_global_cuda(tokens, starts, count, out_base, total: int,
                         prefix):
    """The kernel's launch, on checked CUDA tensors: (out, err () int32,
    open_ (rounds + 1,) int32, where open_[r] says that round r - 1, or the
    expand for r = 0, left a byte unresolved)."""
    dev = tokens.device
    T, B = tokens.shape
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    err = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = resolve_rounds(total)
    open_ = torch.zeros(rounds + 1, dtype=torch.int32, device=dev)
    if total:
        state = torch.empty(total, dtype=torch.int32, device=dev)
        tile_open = torch.empty(-(-total // RESOLVE_TILE), dtype=torch.int32,
                                device=dev)
        _launch("resolve_global", dev, _ptr(tokens), _ptr(starts),
                _ptr(count), _ptr(out_base), ctypes.c_int(T), ctypes.c_int(B),
                _ptr(prefix), ctypes.c_int(prefix.numel()),
                ctypes.c_int(total), ctypes.c_int(rounds), _ptr(state),
                _ptr(tile_open), _ptr(open_), _ptr(out), _ptr(err))
    return out, err, open_
