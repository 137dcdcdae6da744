"""Default-profile (wide) inflate kernels for NVIDIA Hopper, with their plain
versions.

Counterpart of ``zlibes_tpu/ops/wide_kernel.py``: the device decode of
streams with per-block RFC 1951 15-bit Huffman tables and the full 32 KiB
LZ window, which is what levels 1-9 emit.  Two stages:

  * ``decode_wide``  per-lane two-level-table Huffman decode into packed
    tokens, their start offsets and meta, from the stream's words and each
    lane's first word (the kernel stages the lane windows itself; the
    windows ``turbo_kernel.lane_windows`` gives at ``width=SW`` are taken
    too);
  * ``resolve_wide`` LZ expansion of whole block rows (32 KiB reach).

Before them, ``wide_lanes`` builds every decode lane's span (first window
word, start and end bit, first token's offset) from the index's anchors.

Each wrapper launches its CUDA kernel (``csrc/wide_kernels.cu``) for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor; any other
device raises.  Launches are counted in ``turbo_kernel.LAUNCHES``.

Decode lanes are the index's uniform 128-B "wide" anchors: lane ``m`` of a
coded block decodes the tokens that start in output sub-span
``[m*128, (m+1)*128)`` of its block.  Every coded block owns ``LPB``
consecutive lanes (a multiple of 128) and one row of each table.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import huffman
from ..spec import constants as C
from ..spec.errors import CorruptError

from .turbo_kernel import (
    _FLAG,
    _bits_at,
    _check,
    _covering_slot,
    _lane_source,
    _launch,
    _ptr,
    _route,
    lane_windows_plain,
)

# output bytes per decode lane / resolve sub-span
SUB = 128
# max tokens per decode lane: <= SUB starters + EOB + slack
MAX_TOKENS = 144
# token slots per resolve sub-span (> MAX_TOKENS + 1 cover slot)
TOKENS_PAD = 256

# litlen table: 9-bit root (512) + sub region (512; zlib's ENOUGH_LENS
# proves <= 852 entries in all for 286 symbols, root 9, 15-bit codes)
LL_ROOT_BITS = 9
LL_ROOT = 1 << LL_ROOT_BITS
LL_SUB = 512
LL_W = LL_ROOT + LL_SUB
# dist table: 6-bit root + sub region (zlib's ENOUGH_DISTS proves <= 592
# entries for 30 symbols, root 6, 15-bit codes -> sub <= 528); the root's
# 64 entries pad to 128, and sub indices clip to [0, 640)
D_ROOT_BITS = 6
D_ROOT = 1 << D_ROOT_BITS
D_SUB_OFF = 128
D_SUB = 576
D_W = D_SUB_OFF + 640

# token packing: val (literal byte / match length, 9b) | dist (16b @9)
# | is_match (bit 25)
TOK_VAL_MASK = 0x1FF
TOK_DIST_SHIFT = 9
TOK_DIST_MASK = 0xFFFF
TOK_MATCH_BIT = 1 << 25

_KIND_LIT, _KIND_EOB, _KIND_LEN, _KIND_INVALID = 0, 1, 2, 3
_SUB_FLAG = 1 << 30

# start offset of an empty token slot: past every in-span position
START_PAD = 2048
# longest row (bytes) that the resolve kernel keeps in shared memory: the
# 227 KB a block may use (kMaxDynamicSmem in csrc/wide_kernels.cu)
RESOLVE_SMEM_ROW = 227 * 1024


# ---------------------------------------------------------------------------
# two-level table construction (host, header-sized work per block)

def _fill_two_level(lengths: np.ndarray, root_bits: int, root_entries: int,
                    sub_off: int, sub_cap: int, width: int, entry_fn,
                    subptr_fn) -> np.ndarray:
    """Build one two-level LSB-first decode table row.

    Codes of length <= root_bits fill the root directly (replicated every
    2^len); longer codes group by their root-bit stream prefix, each
    prefix getting a 2^(maxlen-root) sub-span addressed by the NEXT
    stream bits, with the root entry holding a sub-pointer.
    """
    lengths = np.asarray(lengths, np.int64)
    tab = np.zeros(width, np.int32)
    if not lengths.any():
        return tab
    codes = huffman.canonical_codes_batch(lengths[None, :])[0]
    root_mask = (1 << root_bits) - 1
    # LSB-first index of each code
    rev = np.zeros(lengths.size, np.int64)
    nz = lengths > 0
    rev[nz] = huffman._REV16[codes[nz].astype(np.uint32)] >> (16 - lengths[nz])
    for sym in np.nonzero(nz)[0]:
        l = int(lengths[sym])
        if l > root_bits:
            continue
        e = entry_fn(int(sym), l)
        for idx in range(int(rev[sym]), root_entries, 1 << l):
            tab[idx] = e
    long_syms = np.nonzero(lengths > root_bits)[0]
    if long_syms.size == 0:
        return tab
    prefixes = rev[long_syms] & root_mask
    next_sub = 0
    for p in sorted(set(int(x) for x in prefixes)):
        members = long_syms[(rev[long_syms] & root_mask) == p]
        wmax = int(lengths[members].max()) - root_bits
        span = 1 << wmax
        if next_sub + span > sub_cap:
            raise CorruptError("two-level sub-table overflow "
                               "(non-canonical code lengths)")
        tab[p] = subptr_fn(wmax, next_sub)
        for sym in members:
            l = int(lengths[sym])
            hi = int(rev[sym]) >> root_bits  # (l - root) sub bits
            e = entry_fn(int(sym), l)
            for idx in range(hi, span, 1 << (l - root_bits)):
                tab[sub_off + next_sub + idx] = e
        next_sub += span
    return tab


def wide_decode_tables(ll_len: np.ndarray, d_len: np.ndarray):
    """Two-level decode tables for one block: (lt (LL_W,), dt (D_W,)) int32.

    litlen entry: codelen(4b) | kind(2b @4) | extra#(3b @6) | base(9b @9)
    litlen subptr (root only): subw(4b @0) | sub base(9b @9) | bit 30
    dist entry:   codelen(4b) | extra#(4b @4) | base(15b @8)
    dist subptr:  base(10b @8) | subw(4b @24) | bit 30
    codelen 0 marks an invalid bit pattern.
    """
    ll_len = np.asarray(ll_len, np.int64)
    d_len = np.asarray(d_len, np.int64)
    if int(ll_len.max(initial=0)) > 15 or int(d_len.max(initial=0)) > 15:
        raise CorruptError("code lengths exceed the RFC 1951 15-bit cap")

    def ll_entry(sym, l):
        if sym < 256:
            return l | (_KIND_LIT << 4) | (sym << 9)
        if sym == C.END_OF_BLOCK:
            return l | (_KIND_EOB << 4)
        if sym < 286:
            i = sym - 257
            return (l | (_KIND_LEN << 4) | (int(C.LENGTH_EXTRA_BITS[i]) << 6)
                    | (int(C.LENGTH_BASE[i]) << 9))
        return l | (_KIND_INVALID << 4)

    def ll_subptr(w, base):
        return _SUB_FLAG | w | (base << 9)

    def d_entry(sym, l):
        if sym < 30:
            return (l | (int(C.DIST_EXTRA_BITS[sym]) << 4)
                    | (int(C.DIST_BASE[sym]) << 8))
        return 0  # reserved distance symbols: invalid

    def d_subptr(w, base):
        return _SUB_FLAG | (base << 8) | (w << 24)

    lt = _fill_two_level(ll_len, LL_ROOT_BITS, LL_ROOT, LL_ROOT, LL_SUB,
                         LL_W, ll_entry, ll_subptr)
    dt = _fill_two_level(d_len, D_ROOT_BITS, D_ROOT, D_SUB_OFF, D_SUB,
                         D_W, d_entry, d_subptr)
    return lt, dt


# ---------------------------------------------------------------------------
# the plan's per-lane anchor spans
#
# Replaces no TPU kernel: the JAX package builds the lanes on the host, a
# loop over the coded blocks that selects each block's anchors from all of
# them (zlibes_tpu/codec/wide.py), O(blocks x anchors).  On the card one
# thread a lane (csrc/wide_kernels.cu): lane l = cb * LPB + m reads anchor
# j = first[cb] + m and the one after it, and writes its four int32 values;
# neighbouring threads read neighbouring anchors.  The kernel moves 16 B an
# anchor in and 16 B a lane out, so bytes bind it (a few microseconds for a
# 35 MB stream's 270,000 lanes).  The checks the host loop made become one
# status word, folded a block at a time into one atomic each: a flag where a
# lane's next anchor lies before its own (the block's end bit, for its last
# lane, is not checked) or its first token's offset falls outside
# [0, SUB + MAX_MATCH]; and the largest end bit, which sizes the lane window.
# The per-block anchor counts are the host's to check (``WidePlan.build``).

# a lane's first token starts at most a longest match before its sub-span
REL_LIMIT = SUB + C.MAX_MATCH + 1
_INT32_MAX = (1 << 31) - 1


def wide_lanes_plain(abit: torch.Tensor, aout: torch.Tensor,
                     rows: torch.Tensor, LPB: int):
    NA = abit.shape[0]
    L = rows.shape[0] * LPB
    lane = torch.arange(L, device=abit.device)
    m = lane % LPB
    first, count, out_start, end_bit = rows[lane // LPB].unbind(1)
    j = first + m
    live = (m < count) & (j < NA)
    last = (m == count - 1) | (j + 1 >= NA)
    # a zero past the last anchor, read by the lanes that read none
    ab = torch.cat([abit, abit.new_zeros(1)])
    ao = torch.cat([aout, aout.new_zeros(1)])
    j = torch.where(live, j, NA)
    a = ab[j]
    nxt = torch.where(last, end_bit, ab[(j + 1).clamp(max=NA)])
    rel = ao[j] - out_start - m * SUB
    start_w = a >> 5
    endb = nxt - (start_w << 5)
    bad = live & ((~last & (nxt < a)) | (rel < 0) | (rel >= REL_LIMIT))
    widest = torch.where(live, endb, 0).clamp(0, _INT32_MAX)
    status = torch.stack([bad.any().long(),
                          widest.amax() if L else widest.new_zeros(())])

    def lanes(x):
        return torch.where(live, x, 0).to(torch.int32)

    return (lanes(start_w), lanes(a & 31), lanes(endb), lanes(rel),
            status.to(torch.int32))


def wide_lanes(abit: torch.Tensor, aout: torch.Tensor, rows: torch.Tensor,
               LPB: int):
    """Every decode lane's span from the index's anchors.

    abit, aout (NA,) int64 the anchors' stream bits and output offsets;
    rows (Cb, 4) int64, a coded block each: its first anchor, its anchor
    count, out_start and end_bit (0 <= first, first + count <= NA); LPB
    lanes a block.  Lane ``cb * LPB + m`` with m < count takes anchor
    ``first + m``; the others are empty (every value 0).

    Returns start_w, bit0, endb, base (Cb * LPB,) int32: the lane's first
    window word, its start and end bit within the window (the end is the
    next anchor, or end_bit for the block's last lane) and its first
    token's offset in its sub-span; and status (2,) int32: 1 where a lane's
    next anchor lies before its own or its offset is outside [0,
    REL_LIMIT), and the largest end bit (0 at least, at most 2**31 - 1)."""
    dev = abit.device
    NA = abit.shape[0]
    Cb = rows.shape[0]
    L = Cb * LPB
    _check(abit, "abit", torch.int64, (NA,), dev)
    _check(aout, "aout", torch.int64, (NA,), dev)
    _check(rows, "rows", torch.int64, (Cb, 4), dev)
    if LPB <= 0 or L >= 1 << 31:
        raise ValueError(f"{Cb} rows of LPB={LPB} lanes: LPB must be "
                         f"positive and the lanes fewer than 2**31")
    if not _route(abit):
        return wide_lanes_plain(abit, aout, rows, LPB)
    out = [torch.empty(L, dtype=torch.int32, device=dev) for _ in range(4)]
    status = torch.zeros(2, dtype=torch.int32, device=dev)
    if L:
        _launch("wide_lanes", dev, _ptr(abit), _ptr(aout), ctypes.c_int64(NA),
                _ptr(rows), ctypes.c_int(L), ctypes.c_int(LPB),
                *map(_ptr, out), _ptr(status))
    return (*out, status)


# ---------------------------------------------------------------------------
# stage 2: per-lane token decode
#
# Replaces decode_wide (zlibes_tpu/ops/wide_kernel.py:365, kernel
# _decode_wide_kernel :217).  The TPU kernel runs 1024 lanes of one grid
# step in lock step, one <=48-bit token per iteration, from a 128-bit buffer
# with a paired 64-bit refill out of word-planes, and gathers each table
# entry through banked selects over per-sublane table rows.  On the card a
# lane is a serial chain and a warp that runs alone gets one instruction out
# in four to six cycles, so what bounds the kernel is the longest lane's
# steps times the instructions of a step, not its bytes (``chip_smoke.py``
# prints the longest and the mean lane and the cycles a step).  The design
# (csrc/wide_kernels.cu) is decode_turbo's walk carried over to two-level
# per-row tables.  A block is 32 lanes of one coded block (LPB is a multiple
# of 128), the walk in one warp.  All threads stage the 32 windows straight
# from the stream's words (the window stage, folded in) and the row's two
# tables, which they flatten into one-level roots of 11 litlen and 8
# distance bits with repacked entries (a root entry that holds a code is
# repacked once for all its indices; the few that point to a sub-table are
# listed and looked up side by side); a code longer than its root, like
# every other rare case (end of block, invalid code, a distance that may be
# bad, a token past the lane's end, 32 bits or more), leaves the fast step
# for one token through the two-level tables with the plain version's
# checks.  A lane
# keeps the 96 stream bits at its position in registers; a step has no
# branch but the loop's and the one that leaves it, takes two literals when
# it can, and sends the next step's lookup out before it is judged; the
# running output position stays off the lookup chain.  Tokens and starts are
# stored (T, L) so that a warp's stores land on neighbouring addresses.
#
# Contract (bit for bit with the TPU kernel on valid streams): a token is
# bad when its litlen code is invalid (codelen 0, symbol 286/287), when a
# length has an invalid distance code or a distance > 32768 or reaching
# before the start of its block, or when it ends past endb.  A bad token sets
# the error flag and stops the lane without moving its bit position;
# end-of-block stops it after moving it.  The before-the-block check is the
# port's own: the TPU kernel lets such a distance through and its resolve
# clips the source to byte 0.  meta rows: 0 token count, 1 end bit, 2 error
# flag, 3 still active after T tokens, 4 last emitted token, 5 its start.
# Token and start slots at or past the count are not written by the kernel.

def decode_wide_plain(win, bit0, endb, base, lt, dt, LPB: int,
                      T: int = MAX_TOKENS):
    L = win.shape[0]
    dev = win.device
    tokens = torch.zeros((T, L), dtype=torch.int32, device=dev)
    starts = torch.full((T, L), START_PAD, dtype=torch.int32, device=dev)
    lane = torch.arange(L, device=dev)
    row = lane // LPB
    # flat table index of each lane's rows
    lt_flat = lt.long().reshape(-1)
    dt_flat = dt.long().reshape(-1)
    lt_off = row * LL_W
    dt_off = row * D_W
    # the lane's sub-span offset within its block: a distance may reach
    # back at most to the block's first byte
    span0 = (lane % LPB) * SUB
    pos = bit0.long()
    end = endb.long()
    outpos = base.long()
    active = pos < end
    err = torch.zeros(L, dtype=torch.bool, device=dev)
    count = torch.zeros(L, dtype=torch.long, device=dev)
    last_tok = torch.zeros(L, dtype=torch.long, device=dev)
    last_start = torch.zeros(L, dtype=torch.long, device=dev)
    for t in range(T):
        if not bool(active.any()):
            break
        x = _bits_at(win, pos)
        # litlen symbol: 9-bit root, sub-table on long-code prefixes
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
        # distance symbol: 6-bit root + sub region
        d1 = dt_flat[dt_off + (y & (D_ROOT - 1))]
        dsw = ((d1 >> 24) & 15).clamp(max=9)
        dsidx = ((d1 >> 8) & 1023) + ((y >> D_ROOT_BITS) & ((1 << dsw) - 1))
        d2 = dt_flat[dt_off + D_SUB_OFF + dsidx.clamp(0, 639)]
        de = torch.where((d1 & _SUB_FLAG) != 0, d2, d1)
        dln = de & 15
        deb = (de >> 4) & 15
        dist = ((de >> 8) & 0x7FFF) + ((y >> dln) & ((1 << deb) - 1))
        k = k1 + torch.where(is_len, dln + deb, 0)
        newpos = pos + k
        bad = ((ln == 0) | (kind == _KIND_INVALID)
               | (is_len & ((dln == 0) | (dist > C.WINDOW_SIZE)
                            | (dist > span0 + outpos)))
               | (newpos > end))
        is_eob = kind == _KIND_EOB
        emit = active & ~bad & ~is_eob
        tok = torch.where(
            is_len, val | (dist << TOK_DIST_SHIFT) | TOK_MATCH_BIT, val)
        tokens[t] = torch.where(emit, tok, 0).int()
        starts[t] = torch.where(emit, outpos, START_PAD).int()
        count += emit.long()
        err |= active & bad
        pos = torch.where(active & ~bad, newpos, pos)
        last_tok = torch.where(emit, tok, last_tok)
        last_start = torch.where(emit, outpos, last_start)
        outpos = outpos + torch.where(emit, torch.where(is_len, val, 1), 0)
        active = emit & (newpos < end)
    meta = torch.stack([count, pos, err.long(), active.long(), last_tok,
                        last_start]).int()
    return tokens, starts, meta


# the widest lane window the kernel takes: its window area and tables stay
# under the 48 KB of shared memory a block has without opting in to more
MAX_WINDOW_WORDS = 255


def decode_wide(win, bit0: torch.Tensor, endb: torch.Tensor,
                base: torch.Tensor, lt: torch.Tensor, dt: torch.Tensor,
                LPB: int, T: int = MAX_TOKENS, SW: int | None = None):
    """win: the pair (words (NW,) int32 stream words, start_w (L,) int32
    first word of each lane's window) with the window width ``SW`` in
    words, from which the kernel stages the windows itself, or the (L, SW)
    int32 lane windows ``lane_windows`` gives; bit0, endb (L,) int32 start
    / end bit within the window; base (L,) int32 first token's offset in
    its 128-B sub-span; lt (Cb, LL_W), dt (Cb, D_W) int32 per-block tables
    as ``wide_decode_tables`` builds them (the kernel relies on a sub-table
    entry of code length n being repeated every 2^(n - root bits) slots);
    LPB lanes per block row (L = Cb * LPB, LPB a multiple of 128).

    Returns (tokens (T, L) int32 packed and starts (T, L) int32 sub-span
    offsets, both valid in [0, count); meta (6, L) int32: count, end bit,
    error flag, still-active flag, last emitted token, its start)."""
    if isinstance(win, torch.Tensor):
        SW = win.shape[1] if win.dim() == 2 else -1
    elif SW is None:
        raise ValueError("(words, start_w) needs the window width SW")
    if not 1 <= SW <= MAX_WINDOW_WORDS:
        raise ValueError(f"window width {SW} outside [1, {MAX_WINDOW_WORDS}]")
    words, start_w = _lane_source(win, SW)
    dev = words.device
    L = start_w.numel()
    if LPB <= 0 or LPB % 128 or L % LPB:
        raise ValueError(f"{L} lanes do not split into rows of LPB={LPB} "
                         f"(a positive multiple of 128)")
    if T * L >= 1 << 31:
        raise ValueError(f"{T} token slots of {L} lanes pass 2**31")
    Cb = L // LPB
    for name, t, shape in (("bit0", bit0, (L,)), ("endb", endb, (L,)),
                           ("base", base, (L,)), ("lt", lt, (Cb, LL_W)),
                           ("dt", dt, (Cb, D_W))):
        _check(t, name, torch.int32, shape, dev)
    if not _route(words):
        if not isinstance(win, torch.Tensor):
            win = lane_windows_plain(words, start_w, SW)
        return decode_wide_plain(win, bit0, endb, base, lt, dt, LPB, T)
    tokens = torch.empty((T, L), dtype=torch.int32, device=dev)
    starts = torch.empty((T, L), dtype=torch.int32, device=dev)
    meta = torch.empty((6, L), dtype=torch.int32, device=dev)
    if L:
        _launch("decode_wide", dev, _ptr(words),
                ctypes.c_int64(words.numel()), _ptr(start_w),
                ctypes.c_int(SW), _ptr(bit0), _ptr(endb), _ptr(base),
                _ptr(lt), _ptr(dt), ctypes.c_int(L), ctypes.c_int(LPB),
                ctypes.c_int(T), _ptr(tokens), _ptr(starts), _ptr(meta))
    return tokens, starts, meta


# ---------------------------------------------------------------------------
# stage 3: LZ resolve over block rows
#
# Replaces resolve_wide (zlibes_tpu/ops/wide_kernel.py:547, kernel
# _resolve_wide_kernel :421).  The TPU kernel walks each block row in
# 128-byte tiles, 16 per grid step: a bisection finds each byte's covering
# token, far sources come from a word-packed scratch of resolved bytes
# through a 64-bank gather sweep, and in-tile overlaps resolve by 7
# pointer-doubling rounds.  On the card the work is split in two kernels
# (csrc/wide_kernels.cu).  Everything that depends on no earlier tile is done
# for all 4 KiB tiles of all rows at once, on all SMs, by an expand kernel:
# a block per tile stages the tile's starts and tokens in shared memory,
# binary-searches each byte's covering token there, and resolves the chains
# that stay inside the tile by pointer jumping without barriers between
# rounds; it writes one int32 of state per byte, a final byte or the offset
# of a source in an earlier tile.  Only the copying from earlier tiles is
# serial: a walk kernel, one thread block per row, takes the row's tiles in
# order with the next two tiles' states in flight in registers, keeps the
# row's bytes in shared memory (dynamic, up to 224 KiB of row; a longer row
# keeps them in the output array and reads far sources from L2), pays one
# byte read a far source and one barrier a tile, and writes the row out
# once.  The expand kernel is bound by memory (all of toks and starts read
# once); the walk by the chain of tiles of one row, Cb blocks wide.
#
# Input contract: Cb rows x NSUBB sub-spans x 256 slots; starts are offsets
# within the sub-span, pad slots carry START_PAD, slot 0 may hold the
# boundary-covering token with a negative start.  A byte with no token
# starting at or before it takes slot 0.  A match copies from
# clip(q - dist, 0, NSUBB*128 - 1) within the row; a chain that ends on a
# byte copying itself leaves that byte's index (mod 256) as its value.

def resolve_wide_plain(toks: torch.Tensor,
                       starts: torch.Tensor) -> torch.Tensor:
    Cb, nsubb, _ = toks.shape
    n = nsubb * SUB
    dev = toks.device
    toks_flat = toks.reshape(Cb, -1)
    starts_flat = starts.reshape(Cb, -1)
    q = torch.arange(n, device=dev).expand(Cb, n)
    m = q >> 7
    slot = _covering_slot(starts_flat, m, q & (SUB - 1), TOKENS_PAD)
    tok = toks_flat.gather(1, m * TOKENS_PAD + slot)
    val = tok & TOK_VAL_MASK
    dist = (tok >> TOK_DIST_SHIFT) & TOK_DIST_MASK
    ism = (tok & TOK_MATCH_BIT) != 0
    src = (q - dist).clamp(0, max(n - 1, 0))
    state = torch.where(ism, src, (val & 255) | _FLAG)
    # chains run backwards and are shorter than the row: ceil(log2(n))
    # pointer-jumping rounds reach every chain's end
    for _ in range(max(n - 1, 1).bit_length()):
        done = state >= _FLAG
        nxt = state.gather(1, torch.where(done, 0, state))
        state = torch.where(done, state, nxt)
    return (state & 255).to(torch.uint8)


def resolve_wide(toks: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """toks, starts (Cb, NSUBB, 256) int32 -> (Cb, NSUBB*128) uint8 block
    rows; NSUBB*128 must be a multiple of the kernel's 4 KiB tile and less
    than 2**29."""
    dev = toks.device
    shape = tuple(toks.shape)
    if (len(shape) != 3 or shape[2] != TOKENS_PAD or (shape[1] * SUB) % 4096
            or shape[1] * SUB >= 1 << 29):
        raise ValueError(f"toks has shape {shape}, expected (Cb, NSUBB, "
                         f"{TOKENS_PAD}) with NSUBB a multiple of 32 below "
                         f"{(1 << 29) // SUB}")
    _check(toks, "toks", torch.int32, shape, dev)
    _check(starts, "starts", torch.int32, shape, dev)
    if not _route(toks):
        return resolve_wide_plain(toks, starts)
    Cb, nsubb, _ = shape
    out = torch.empty((Cb, nsubb * SUB), dtype=torch.uint8, device=dev)
    if out.numel():
        # the expand kernel's per-byte state, read by the walk kernel
        state = torch.empty((Cb, nsubb * SUB), dtype=torch.int32, device=dev)
        _launch("resolve_wide", dev, _ptr(toks), _ptr(starts),
                ctypes.c_int(Cb), ctypes.c_int(nsubb), _ptr(state),
                _ptr(out))
    return out
