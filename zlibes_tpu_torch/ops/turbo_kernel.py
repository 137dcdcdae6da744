"""Turbo-profile inflate kernels for NVIDIA Hopper, with their plain versions.

Counterpart of ``zlibes_tpu/ops/turbo_kernel.py``.  Three stages:

  * ``lane_windows``  each decode lane's 96 stream words (one gather);
  * ``decode_turbo``  per-lane Huffman decode into packed tokens + meta;
  * ``resolve_turbo`` LZ expansion of 4 KiB chunk rows.

Each wrapper launches its CUDA kernel (``csrc/turbo_kernels.cu``) for a
CUDA tensor and runs its plain PyTorch version for a CPU tensor; any other
device raises.  ``LAUNCHES`` counts kernel launches per wrapper.

All per-lane arrays are in lane order: lane ``l`` is row ``l`` of a
(L, ...) array or column ``l`` of a (..., L) array.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from zlibes_tpu.ops import huffman
from zlibes_tpu.spec import constants as C
from zlibes_tpu.spec.errors import CorruptError

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
    raise ValueError(f"no turbo kernel for device {t.device}")


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
# On the card this is one gather, one thread per output word: bound by
# memory traffic (L*96*4 B written, the same read mostly from L2 because
# neighbouring lanes' windows overlap).

def lane_windows_plain(words: torch.Tensor,
                       start_w: torch.Tensor) -> torch.Tensor:
    idx = (start_w.long()[:, None]
           + torch.arange(STREAM_WORDS, device=words.device))
    n = words.numel()
    inside = (idx >= 0) & (idx < n)
    got = words[idx.clamp(0, max(n - 1, 0))]
    return torch.where(inside, got, torch.zeros((), dtype=words.dtype,
                                                device=words.device))


def lane_windows(words: torch.Tensor, start_w: torch.Tensor) -> torch.Tensor:
    """words (NW,) int32 stream words (little-endian), start_w (L,) int32
    per-lane first word -> (L, 96) int32 lane windows."""
    dev = words.device
    _check(words, "words", torch.int32, (words.numel(),), dev)
    L = start_w.numel()
    _check(start_w, "start_w", torch.int32, (L,), dev)
    if not _route(words):
        return lane_windows_plain(words, start_w)
    out = torch.empty((L, STREAM_WORDS), dtype=torch.int32, device=dev)
    if L:
        _launch("lane_windows", dev, _ptr(words), ctypes.c_int64(words.numel()),
                _ptr(start_w), ctypes.c_int64(L), _ptr(out))
    return out


# ---------------------------------------------------------------------------
# stage 2: per-lane token decode
#
# Replaces decode_turbo (zlibes_tpu/ops/turbo_kernel.py:472, kernel
# _decode_kernel :332).  The TPU kernel runs all lanes in lock step, two
# tokens per iteration, from a 128-bit buffer with a paired 64-bit refill
# served by select trees over word-planes.  On the card each thread owns one
# lane and runs until that lane ends: the 9-bit tables sit in shared memory,
# and every token reads the 64 bits at its bit position from the lane's
# window (three L1-resident loads).  It is bound by the serial dependency
# of one token on the previous token's length, so its speed comes from
# having many lanes in flight; tokens are stored (T, L) so that a warp's
# stores land on neighbouring addresses.
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
    (LSB-first), as int64; a token uses at most 9 + 7 + 9 + 15 of them.
    Reads past the window's last word are clamped to it, as in the
    kernel."""
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


def decode_turbo(win: torch.Tensor, bit0: torch.Tensor, endb: torch.Tensor,
                 lt: torch.Tensor, dt: torch.Tensor, T: int = MAX_TOKENS):
    """win (L, 96) int32 lane windows; bit0, endb (L,) int32 start / end bit
    within the window; lt, dt (512,) int32 tables.

    Returns (tokens (T, L) int32 packed, valid in [0, count); meta (4, L)
    int32: count, end bit, error flag, still-active flag)."""
    dev = win.device
    L = win.shape[0]
    _check(win, "win", torch.int32, (L, STREAM_WORDS), dev)
    for name, t, n in (("bit0", bit0, L), ("endb", endb, L),
                       ("lt", lt, TABLE), ("dt", dt, TABLE)):
        _check(t, name, torch.int32, (n,), dev)
    if not _route(win):
        return decode_turbo_plain(win, bit0, endb, lt, dt, T)
    tokens = torch.empty((T, L), dtype=torch.int32, device=dev)
    meta = torch.empty((4, L), dtype=torch.int32, device=dev)
    if L:
        _launch("decode_turbo", dev, _ptr(win), _ptr(bit0), _ptr(endb),
                _ptr(lt), _ptr(dt), ctypes.c_int(L), ctypes.c_int(T),
                _ptr(tokens), _ptr(meta))
    return tokens, meta


# ---------------------------------------------------------------------------
# stage 3: LZ resolve over 4 KiB chunk rows
#
# Replaces resolve_turbo (zlibes_tpu/ops/turbo_kernel.py:601, kernel
# _resolve_kernel :536).  The TPU kernel walks each chunk in 128-byte
# tiles: a windowed bisection finds each byte's covering token, sources in
# resolved tiles come from banked VMEM gathers and in-tile overlaps from 7
# pointer-doubling rounds.  On the card one thread block owns one chunk row
# and keeps it in shared memory (16 KB of int32 state): each byte binary-
# searches its sub-span's 384 token starts, then all 4096 bytes resolve
# together by pointer jumping, 12 rounds for any chain within 4 KiB.  It is
# bound by shared-memory traffic (12 rounds x 4096 reads and writes) and the
# block-wide barrier of each round; the chunk never leaves the SM until its
# bytes are final.
#
# Input contract: 16 sub-spans x 384 slots per chunk; starts are offsets
# within the sub-span, pad slots carry start 2048, slot 0 of an odd
# sub-span may hold the crossing token with a negative start.  A byte with
# no token starting at or before it takes slot 0.  A match copies from
# clip(q - dist, 0, 4095) within the chunk.

def _covering_slot(starts_flat: torch.Tensor, m: torch.Tensor,
                   ql: torch.Tensor) -> torch.Tensor:
    """Branch-free binary search, as in the kernel: per byte, the largest
    slot i < TOKENS_PAD of its sub-span with start[i] <= ql (else 0)."""
    lo = torch.zeros_like(ql)
    step = 1 << ((TOKENS_PAD - 1).bit_length() - 1)
    while step:
        mid = lo + step
        sv = starts_flat.gather(
            1, m * TOKENS_PAD + mid.clamp(max=TOKENS_PAD - 1))
        lo = torch.where((mid < TOKENS_PAD) & (sv <= ql), mid, lo)
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
