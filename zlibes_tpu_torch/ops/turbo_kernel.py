"""Turbo-profile kernels for NVIDIA Hopper, with their plain versions.

Counterpart of ``zlibes_tpu/ops/turbo_kernel.py``.  Three inflate stages
and one encode stage:

  * ``lane_windows``  each decode lane's 96 stream words (one gather): the
    stage both decode kernels now do themselves, in shared memory, kept as
    the way to look at the windows they see;
  * ``decode_turbo``  per-lane Huffman decode into packed tokens + meta,
    from the stream's words and each lane's first word;
  * ``resolve_turbo`` LZ expansion of 4 KiB chunk rows;
  * ``select_turbo``  the encoder's greedy + lazy tokenisation of each
    512-byte segment lane.

Each wrapper launches its CUDA kernel (``csrc/turbo_kernels.cu``, and
``csrc/encode_kernels.cu`` for ``select_turbo``) for a CUDA tensor and runs
its plain PyTorch version for a CPU tensor; any other device raises.
``LAUNCHES`` counts kernel launches per wrapper, for every kernel of the
port.

All per-lane arrays are in lane order: lane ``l`` is row ``l`` of a
(L, ...) array or column ``l`` of a (..., L) array.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from . import huffman
from ..spec import constants as C
from ..spec.errors import CorruptError

# table width: turbo streams cap code lengths at 9 bits
M_BITS = 9
TABLE = 1 << M_BITS
# output bytes per selection segment (one anchor pair per SEG_SPAN: the
# encoder records a second anchor at the first token starting at-or-after
# byte SUB of the segment, so every decode lane covers roughly half a
# segment)
SEG_SPAN = 512
# output bytes per resolve sub-span; decode lane l feeds sub-span l (the
# token crossing the mid-segment boundary is duplicated into the odd
# sub-span's slot 0 with a negative start — see _glue_tokens in turbo.py)
SUB = 256
SUBS_PER_CHUNK = 4096 // SUB
# stream words per decode lane.  A lane's tokens all start within one
# SUB-byte half-segment, so <= SUB of them, and a (match, literal) mix
# maximizing coded bits yields <= 86*32 + slack ~ 2790 bits; + the <=31-bit
# sub-word start offset + 2 words of lookahead -> 91, padded to 96.
STREAM_WORDS = 96
# max tokens per decode lane: <= SUB+1 starters (+ the crossing token) + slack
MAX_TOKENS = 272
# token slots per resolve sub-span (>= MAX_TOKENS + 1 cross slot)
TOKENS_PAD = 384

# token packing: val (literal byte / match length) | dist<<9 | is_match<<21
TOK_VAL_MASK = 0x1FF
TOK_DIST_SHIFT = 9
TOK_DIST_MASK = 0xFFF
TOK_MATCH_BIT = 1 << 21

_KIND_LIT, _KIND_EOB, _KIND_LEN, _KIND_INVALID = 0, 1, 2, 3

# start offset of an empty resolve slot: past every in-span position
PAD_START = 2048
# resolve: a resolved byte carries this flag; an unresolved one a pointer
_FLAG = 1 << 30
# pointer-jumping rounds that resolve any back-reference chain in 4096 B
_JUMP_ROUNDS = 12

_MASK32 = (1 << 32) - 1

# kernel launches per wrapper name (plain-version calls are not counted)
LAUNCHES: Counter = Counter()


# ---------------------------------------------------------------------------
# table construction (host, header-sized work)

def turbo_decode_tables(ll_len: np.ndarray, d_len: np.ndarray):
    """Flat LSB-first decode tables as packed int32.

    Returns (lt (512,) int32, dt (512,) int32).
      litlen entry: codelen(4b) | kind(2b @4) | extra#(3b @6) | base(9b @9)
      dist entry:   codelen(4b) | extra#(4b @4) | base(15b @8)
    codelen 0 marks an invalid bit pattern.
    """
    ll_len = np.asarray(ll_len, np.int64)
    d_len = np.asarray(d_len, np.int64)
    if int(ll_len.max(initial=0)) > M_BITS or int(d_len.max(initial=0)) > M_BITS:
        raise CorruptError("turbo stream requires code lengths <= 9 bits")

    def flat(lengths, entry_fn):
        codes = huffman.canonical_codes_batch(lengths[None, :])[0]
        tab = np.zeros(TABLE, np.int32)
        for sym in range(lengths.size):
            l = int(lengths[sym])
            if l == 0:
                continue
            base = int(huffman._REV16[int(codes[sym])] >> (16 - l))
            e = entry_fn(sym, l)
            for idx in range(base, TABLE, 1 << l):
                tab[idx] = e
        return tab

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

    def d_entry(sym, l):
        if sym < 30:
            return (l | (int(C.DIST_EXTRA_BITS[sym]) << 4)
                    | (int(C.DIST_BASE[sym]) << 8))
        return 0  # reserved distance symbols: invalid

    return flat(ll_len, ll_entry), flat(d_len, d_entry)


# ---------------------------------------------------------------------------
# launch plumbing

def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _launch(name: str, device: torch.device, *args) -> None:
    from ..runtime import kernels

    fn = getattr(kernels.library(), f"zt_{name}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# stage 1: per-lane stream windows
#
# Replaces extract_lanes + shift_lanes (zlibes_tpu/ops/turbo_kernel.py:172,
# :227): on the TPU a scalar-prefetch DMA of two 128-word-aligned blocks per
# lane and a select pass dropping the alignment residue; both compute
#     out[l, w] = words[start_w[l] + w]   (0 past the end of the stream).
# The wide path's grouped 256-word fetch (zlibes_tpu/codec/wide.py:229-257,
# :292) computes the same at width SW.  On the card this is one gather, one
# thread per output word: bound by memory traffic (L*width*4 B written, the
# same read mostly from L2 because neighbouring lanes' windows overlap).
# The inflate pipelines do not launch it: decode_turbo and decode_wide take
# (words, start_w) and stage the same windows in shared memory
# (stage_windows, csrc/lane_decode.cuh), so the windows never reach device
# memory.  The kernel stays for whoever wants to see them.

def lane_windows_plain(words: torch.Tensor, start_w: torch.Tensor,
                       width: int = STREAM_WORDS) -> torch.Tensor:
    idx = start_w.long()[:, None] + torch.arange(width, device=words.device)
    n = words.numel()
    inside = (idx >= 0) & (idx < n)
    got = words[idx.clamp(0, max(n - 1, 0))]
    return torch.where(inside, got, torch.zeros((), dtype=words.dtype,
                                                device=words.device))


def lane_windows(words: torch.Tensor, start_w: torch.Tensor,
                 width: int = STREAM_WORDS) -> torch.Tensor:
    """words (NW,) int32 stream words (little-endian), start_w (L,) int32
    per-lane first word -> (L, width) int32 lane windows (96 words for a
    turbo lane, the plan's SW for a wide lane)."""
    dev = words.device
    _check(words, "words", torch.int32, (words.numel(),), dev)
    L = start_w.numel()
    _check(start_w, "start_w", torch.int32, (L,), dev)
    if width <= 0:
        raise ValueError(f"width must be positive, got {width}")
    if not _route(words):
        return lane_windows_plain(words, start_w, width)
    out = torch.empty((L, width), dtype=torch.int32, device=dev)
    if L:
        _launch("lane_windows", dev, _ptr(words), ctypes.c_int64(words.numel()),
                _ptr(start_w), ctypes.c_int64(L), ctypes.c_int(width),
                _ptr(out))
    return out


# ---------------------------------------------------------------------------
# stage 2: per-lane token decode
#
# Replaces decode_turbo (zlibes_tpu/ops/turbo_kernel.py:472, kernel
# _decode_kernel :332).  The TPU kernel runs all lanes in lock step, two
# tokens per iteration, from a 128-bit buffer with a paired 64-bit refill
# served by select trees over word-planes.  On the card a lane is a serial
# chain (a token's position follows from the token before it), there are
# only 470 warps of lanes for 132 SMs, and a warp that runs alone issues one
# instruction in four to six cycles: what bounds the kernel is not its bytes
# but the longest lane's steps times the instructions of one step
# (``chip_smoke.py`` prints the longest and the mean lane and the cycles a
# token).  The design (csrc/turbo_kernels.cu) cuts both.  A block of 32
# lanes brings its windows into shared memory once, straight from the
# stream's words at each lane's first word (the window stage, folded in), at
# an odd row pitch that keeps lanes on different banks; a lane holds the 96 stream
# bits at its position and the window's next words in registers, so the
# next lookup index is one funnel shift; the tables are repacked in the
# kernel so that the bits an entry consumes need no mask; a step has no
# branch but the loop's and one for the rare cases (last token, invalid
# code, a distance that can pass 4095, 32 bits or more), the distance
# lookup going out for every token and dropped by a clamped shift; and a
# step takes two tokens when both are literals, which halves the steps of
# the longest lanes, the ones made of literals.  Tokens are stored (T, L) so
# that a warp's stores land on neighbouring addresses.
#
# Contract (bit for bit with the TPU kernel on valid streams): a token is
# bad when its litlen code is invalid (codelen 0, symbol 286/287), when a
# length has an invalid distance code or a distance > 4095, or when it
# ends past endb.  A bad token sets the error flag and stops the lane
# without moving its bit position; end-of-block stops it after moving it.
# meta rows: 0 token count, 1 end bit, 2 error flag, 3 still active after
# T tokens.  Token slots at or past the count are not written.

def _bits_at(win: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 63 stream bits starting at bit ``pos`` of each lane's window
    (LSB-first), as int64; a turbo token uses at most 9 + 7 + 9 + 15 of
    them, a wide token 15 + 5 + 15 + 13.  Reads past the window's last word
    are clamped to it, as in the kernels."""
    sw = win.shape[1]
    wi = (pos >> 5)[:, None]
    s = pos & 31
    w = win.gather(1, torch.cat([wi, wi + 1, wi + 2], 1).clamp(max=sw - 1))
    w = w.long() & _MASK32
    w0, w1, w2 = w[:, 0], w[:, 1], w[:, 2]
    low = (1 << s) - 1
    lo32 = (w0 >> s) | ((w1 & low) << (32 - s))
    hi32 = (w1 >> s) | ((w2 & low) << (32 - s))
    return lo32 | ((hi32 & 0x7FFFFFFF) << 32)


def decode_turbo_plain(win, bit0, endb, lt, dt, T: int = MAX_TOKENS):
    L = win.shape[0]
    dev = win.device
    tokens = torch.zeros((T, L), dtype=torch.int32, device=dev)
    lt = lt.long()
    dt = dt.long()
    pos = bit0.long()
    end = endb.long()
    active = pos < end
    err = torch.zeros(L, dtype=torch.bool, device=dev)
    count = torch.zeros(L, dtype=torch.long, device=dev)
    for t in range(T):
        if not bool(active.any()):
            break
        x = _bits_at(win, pos)
        e = lt[x & (TABLE - 1)]
        ln = e & 15
        kind = (e >> 4) & 3
        eb = (e >> 6) & 7
        base = (e >> 9) & 511
        extra = (x >> ln) & ((1 << eb) - 1)
        is_len = kind == _KIND_LEN
        val = torch.where(is_len, base + extra, base)
        k1 = ln + eb
        y = x >> k1
        de = dt[y & (TABLE - 1)]
        dln = de & 15
        deb = (de >> 4) & 15
        dist = ((de >> 8) & 0x7FFF) + ((y >> dln) & ((1 << deb) - 1))
        k = k1 + torch.where(is_len, dln + deb, 0)
        newpos = pos + k
        bad = ((ln == 0) | (kind == _KIND_INVALID)
               | (is_len & ((dln == 0) | (dist > TOK_DIST_MASK)))
               | (newpos > end))
        is_eob = kind == _KIND_EOB
        emit = active & ~bad & ~is_eob
        tok = torch.where(
            is_len, val | (dist << TOK_DIST_SHIFT) | TOK_MATCH_BIT, val)
        tokens[t] = torch.where(emit, tok, 0).int()
        count += emit.long()
        err |= active & bad
        pos = torch.where(active & ~bad, newpos, pos)
        active = emit & (newpos < end)
    meta = torch.stack([count, pos, err.long(), active.long()]).int()
    return tokens, meta


def _lane_source(src, width: int):
    """The stream a decode kernel stages its lane windows from, as
    ``(words, start_w)``.  ``src`` is that pair already (the stream's int32
    words and each lane's first word), or the ``(L, width)`` lane windows
    themselves, which are their own stream: lane ``l``'s window starts at
    word ``l * width``."""
    if isinstance(src, torch.Tensor):
        L = src.shape[0] if src.dim() == 2 else -1
        _check(src, "win", torch.int32, (L, width), src.device)
        if L * width >= 1 << 31:
            raise ValueError(f"{L} windows of {width} words pass 2**31 words")
        return src.reshape(-1), torch.arange(0, L * width, width,
                                             dtype=torch.int32,
                                             device=src.device)
    words, start_w = src
    dev = words.device
    _check(words, "words", torch.int32, (words.numel(),), dev)
    _check(start_w, "start_w", torch.int32, (start_w.numel(),), dev)
    return words, start_w


def decode_turbo(win, bit0: torch.Tensor, endb: torch.Tensor,
                 lt: torch.Tensor, dt: torch.Tensor, T: int = MAX_TOKENS):
    """win: the pair (words (NW,) int32 stream words, start_w (L,) int32
    first word of each lane's window), from which the kernel stages the
    windows itself, or the (L, 96) int32 lane windows ``lane_windows``
    gives; bit0, endb (L,) int32 start / end bit within the window; lt, dt
    (512,) int32 tables.

    Returns (tokens (T, L) int32 packed, valid in [0, count); meta (4, L)
    int32: count, end bit, error flag, still-active flag)."""
    words, start_w = _lane_source(win, STREAM_WORDS)
    dev = words.device
    L = start_w.numel()
    for name, t, n in (("bit0", bit0, L), ("endb", endb, L),
                       ("lt", lt, TABLE), ("dt", dt, TABLE)):
        _check(t, name, torch.int32, (n,), dev)
    if not _route(words):
        if not isinstance(win, torch.Tensor):
            win = lane_windows_plain(words, start_w)
        return decode_turbo_plain(win, bit0, endb, lt, dt, T)
    tokens = torch.empty((T, L), dtype=torch.int32, device=dev)
    meta = torch.empty((4, L), dtype=torch.int32, device=dev)
    if L:
        _launch("decode_turbo", dev, _ptr(words),
                ctypes.c_int64(words.numel()), _ptr(start_w), _ptr(bit0),
                _ptr(endb), _ptr(lt), _ptr(dt), ctypes.c_int(L),
                ctypes.c_int(T), _ptr(tokens), _ptr(meta))
    return tokens, meta


# ---------------------------------------------------------------------------
# stage 3: LZ resolve over 4 KiB chunk rows
#
# Replaces resolve_turbo (zlibes_tpu/ops/turbo_kernel.py:601, kernel
# _resolve_kernel :536).  The TPU kernel walks each chunk in 128-byte
# tiles: a windowed bisection finds each byte's covering token, sources in
# resolved tiles come from banked VMEM gathers and in-tile overlaps from 7
# pointer-doubling rounds.  On the card one block of 256 threads owns one
# chunk row, thread t byte t of each of its 16 sub-spans.  The row's starts
# come into shared memory by 16-byte asynchronous copies, in four groups
# that are searched as they land; each byte runs the bisection below there
# (the same nine probes, so unsorted starts give the same slot) and reads
# its token once from global memory; the 4096 states then resolve in shared
# memory by pointer jumping with no barrier between rounds, each warp for as
# many rounds as its chains need: every pointer leads backwards, an entry
# is at any time a value-preserving stand-in for its byte, and a byte that
# copies itself (distance 0, or byte 0 as a match) is closed as q & 255
# when the state is built, which is where the fixed 12 rounds leave it and
# the only cycle there can be.  The row leaves in 16-byte stores.  What
# bounds it is shared-memory work (nine dependent lookups a byte, then the
# random reads of the jumps), not its bytes, which the card moves in a
# third of the kernel's time; neighbouring lanes hold neighbouring bytes so
# that a copy's reads fall on neighbouring banks.
#
# Input contract: 16 sub-spans x 384 slots per chunk; starts are offsets
# within the sub-span, pad slots carry start 2048, slot 0 of an odd
# sub-span may hold the crossing token with a negative start.  A byte with
# no token starting at or before it takes slot 0.  A match copies from
# clip(q - dist, 0, 4095) within the chunk.

def _covering_slot(starts_flat: torch.Tensor, m: torch.Tensor,
                   ql: torch.Tensor, pad: int = TOKENS_PAD) -> torch.Tensor:
    """Branch-free binary search, as in the kernels: per byte, the largest
    slot i < pad of its sub-span (``pad`` slots each) with start[i] <= ql
    (else 0)."""
    lo = torch.zeros_like(ql)
    step = 1 << ((pad - 1).bit_length() - 1)
    while step:
        mid = lo + step
        sv = starts_flat.gather(1, m * pad + mid.clamp(max=pad - 1))
        lo = torch.where((mid < pad) & (sv <= ql), mid, lo)
        step //= 2
    return lo


def resolve_turbo_plain(toks: torch.Tensor,
                        starts: torch.Tensor) -> torch.Tensor:
    C_rows = toks.shape[1]
    dev = toks.device
    toks_flat = toks.permute(1, 0, 2).reshape(C_rows, -1)
    starts_flat = starts.permute(1, 0, 2).reshape(C_rows, -1)
    q = torch.arange(4096, device=dev).expand(C_rows, 4096)
    m = q >> 8
    slot = _covering_slot(starts_flat, m, q & (SUB - 1))
    tok = toks_flat.gather(1, m * TOKENS_PAD + slot)
    val = tok & TOK_VAL_MASK
    dist = (tok >> TOK_DIST_SHIFT) & TOK_DIST_MASK
    ism = (tok & TOK_MATCH_BIT) != 0
    src = (q - dist).clamp(0, 4095)
    state = torch.where(ism, src, (val & 255) | _FLAG)
    for _ in range(_JUMP_ROUNDS):
        done = state >= _FLAG
        nxt = state.gather(1, torch.where(done, 0, state))
        state = torch.where(done, state, nxt)
    return (state & 255).to(torch.uint8)


def resolve_turbo(toks: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """toks, starts (16, C, 384) int32 -> (C, 4096) uint8 chunk rows."""
    dev = toks.device
    shape = (SUBS_PER_CHUNK, toks.shape[1] if toks.dim() == 3 else -1,
             TOKENS_PAD)
    _check(toks, "toks", torch.int32, shape, dev)
    _check(starts, "starts", torch.int32, shape, dev)
    if not _route(toks):
        return resolve_turbo_plain(toks, starts)
    C_rows = shape[1]
    out = torch.empty((C_rows, 4096), dtype=torch.uint8, device=dev)
    if C_rows:
        _launch("resolve_turbo", dev, _ptr(toks), _ptr(starts),
                ctypes.c_int(C_rows), _ptr(out))
    return out


# ---------------------------------------------------------------------------
# encode: greedy + lazy token selection per 512-byte segment lane
#
# Replaces select_turbo (zlibes_tpu/ops/turbo_kernel.py:696, kernel
# _select_kernel :646).  The TPU kernel walks all lanes in lock step from
# word-planes, one position or match per iteration, until the last lane
# ends.  On the card (csrc/encode_kernels.cu) a block of 128 threads owns 8
# lanes and keeps their 2 KB rows in shared memory: rows come in and tokens
# go out with 16-byte loads and stores on neighbouring addresses; the token
# at a position and the position after it depend on that position and the
# next alone, so all 512 of a row are computed at once and packed as
# token | next << 22; one thread a lane then follows the chain from position
# 0, one shared-memory load a step, writing token t in place at slot t (never
# above the cursor).  It is bound by the latency of the longest lane's chain;
# 4096 lanes of a dispatch make 512 blocks.
#
# Contract: pv (L, 512) int32 packs each position's best match and byte as
# dist (12 bits) | len << 12 (9 bits) | literal << 21; seg_len (L,) is the
# number of valid positions of each lane (at most 512; a larger value counts
# as 512).  Tokens are ``ml | dist << 9 |
# TOK_MATCH_BIT`` for a match and the literal byte otherwise; slots at or
# past a lane's count are 0.  ``split_far`` (the reference's, on for codes
# of at most 9 bits) caps a match of 131 bytes or more at a distance above
# 2048 at 130 bytes, after the clamp at the lane's end; the kernel is
# instantiated for both.

# packed per-position value: dist(12) | len(9 @12) | literal(8 @21)
SEL_LEN_SHIFT = 12
SEL_LIT_SHIFT = 21
SEL_SEG = SEG_SPAN


def select_turbo_plain(pv: torch.Tensor, seg_len: torch.Tensor,
                       lazy: bool = True, split_far: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    L, SEG = pv.shape
    dev = pv.device
    pv = pv.long()
    seg_end = seg_len.long().clamp(max=SEG)
    toks = torch.zeros((L, SEG), dtype=torch.int32, device=dev)
    c = torch.zeros(L, dtype=torch.long, device=dev)
    active = seg_end > 0
    count = torch.zeros(L, dtype=torch.long, device=dev)
    # exactly SEG steps, with no host sync: a lane advances >= 1 position a
    # step, so it ends within SEG steps
    for t in range(SEG):
        cs = c.clamp(max=SEG - 1)
        cur = pv.gather(1, cs[:, None])[:, 0]
        ml = (cur >> SEL_LEN_SHIFT) & 511
        dist = cur & 0xFFF
        lit = (cur >> SEL_LIT_SHIFT) & 0xFF
        ml = torch.minimum(ml, seg_end - c)
        if split_far:
            ml = torch.where((ml >= 131) & (dist >= 2049), 130, ml)
        use = ml >= C.MIN_MATCH
        if lazy:
            nxt = pv.gather(1, (cs + 1).clamp(max=SEG - 1)[:, None])[:, 0]
            ml1 = (nxt >> SEL_LEN_SHIFT) & 511
            defer = use & (ml < C.MAX_MATCH) & (ml1 > ml) & (c + 1 < seg_end)
            use = use & ~defer
        tok = torch.where(use, ml | (dist << TOK_DIST_SHIFT) | TOK_MATCH_BIT,
                          lit)
        toks[:, t] = torch.where(active, tok, 0).int()
        count += active.long()
        c = torch.where(active, c + torch.where(use, ml, 1), c)
        active = active & (c < seg_end)
    return toks, count.int()


def select_turbo(pv: torch.Tensor, seg_len: torch.Tensor,
                 lazy: bool = True, split_far: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """pv (L, 512) int32 packed positions, seg_len (L,) int32 valid
    positions per lane -> (tokens (L, 512) int32 in the turbo token
    packing, 0 past each count; counts (L,) int32).  Distances must fit 12
    bits (a 4 KiB window reset); with ``split_far`` (the default, as for
    the turbo profile's codes of at most 9 bits) matches farther than 2048
    bytes are capped at 130."""
    dev = pv.device
    L = pv.shape[0]
    _check(pv, "pv", torch.int32, (L, SEL_SEG), dev)
    _check(seg_len, "seg_len", torch.int32, (L,), dev)
    if not _route(pv):
        return select_turbo_plain(pv, seg_len, lazy, split_far)
    toks = torch.empty((L, SEL_SEG), dtype=torch.int32, device=dev)
    count = torch.empty(L, dtype=torch.int32, device=dev)
    if L:
        _launch("select_turbo", dev, _ptr(pv), _ptr(seg_len), ctypes.c_int(L),
                ctypes.c_int(int(lazy)), ctypes.c_int(int(split_far)),
                _ptr(toks), _ptr(count))
    return toks, count
