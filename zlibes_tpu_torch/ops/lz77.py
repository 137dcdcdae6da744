"""Sort-based LZ77 match finding (torch ops) and greedy + lazy token
selection over segment lanes (a CUDA kernel with its plain version).

Counterpart of ``zlibes_tpu/ops/lz77.py``.  ``find_matches`` (``:55``):
per sort row (a ``reset``-byte chunk, or the whole block), positions are
sorted stably by their 3-byte key, so a position's J nearest earlier
occurrences are its J predecessors in sorted order.  Either every candidate
is measured over all S probe words (levels 1-9), or candidates are ranked
by their first probe word and only the top two are measured (the turbo
profile); a dist-1 run scan covers long runs past the probe cap.

The reference's multi-operand ``lax.sort`` becomes one stable
``torch.sort`` of the key plus a gather of each operand by the
permutation: keys tie only within runs of equal keys, and the tail
sentinels ``0x1000000 + pos`` are unique, so the permutation is the
reference's.  The un-permuting sort is a scatter by that permutation.
"""
from __future__ import annotations

import ctypes

import torch

from ..spec import constants as C

from .turbo_kernel import _check, _launch, _ptr, _route

# greedy selection segment of the default profile (positions per lane)
SEG = 4096
# longest segment the select_tokens kernel takes: 7 bytes a position of one
# block's shared memory, and uint16 positions
MAX_KERNEL_SEG = 16384


def _trailing_eq_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of trailing zero bytes of a 32-bit XOR value (0..4)."""
    n = ((x & 0xFF) == 0).long() + ((x & 0xFFFF) == 0).long() \
        + ((x & 0xFFFFFF) == 0).long()
    return torch.where(x == 0, 4, n)


def _match_len(probes: torch.Tensor, cand: torch.Tensor,
               limit: torch.Tensor) -> torch.Tensor:
    """Bytes shared by each position's S probe words and its candidate's,
    counted word by word while whole words agree, clamped to ``limit``:
    four for every word before the first that differs, plus that word's
    trailing equal bytes (the reference's sum over a running product)."""
    x = probes ^ cand                                     # (S, rows, n)
    S = x.shape[0]
    differs = x != 0
    first = differs.int().argmax(0)                       # 0 where none does
    none = ~differs.any(0)
    t = _trailing_eq_bytes(x.gather(0, first[None])[0])
    return torch.minimum(torch.where(none, 4 * S, 4 * first + t), limit)


def find_matches(data: torch.Tensor, n_valid: torch.Tensor, N: int,
                 S: int, J: int, reset: int = 0, two_phase: bool = False,
                 ctx_start: torch.Tensor | None = None) -> torch.Tensor:
    """Best match per position: packed int32 ``(len << 16) | dist``.

    data (B, N + 8) uint8 padded block bytes, n_valid (B,) int32 true byte
    count per block.  len is 0 where no match of >= 3 bytes exists; matches
    stay inside the block, reach at most 32 KiB back and are clamped to the
    block's end.  ``reset`` (a power of two, 0 for none): matches never
    cross a ``reset`` boundary; where it divides N the sort runs on rows of
    ``reset`` positions.  ``two_phase``: rank the J candidates by their
    first probe word and measure only the top two (the turbo profile);
    otherwise every candidate is measured over all S words and the longest
    wins, the nearest among equals.  ``ctx_start`` (B,) int32: first real
    byte of each row; positions below it are padding in front of a context
    prefix and are never match sources.
    """
    if reset and reset & (reset - 1):
        raise ValueError("reset must be a power of two")
    B = data.shape[0]
    dev = data.device
    d = data.long()
    nv = n_valid.long()
    # little-endian 32-bit windows at every byte position (int64, < 2^32)
    w32 = d[:, :N] | (d[:, 1:N + 1] << 8) | (d[:, 2:N + 2] << 16) \
        | (d[:, 3:N + 3] << 24)
    pos = torch.arange(N, device=dev).expand(B, N)
    valid_key = pos + 3 <= nv[:, None]
    if ctx_start is not None:
        ctx = ctx_start.long()[:, None]
        valid_key = valid_key & (pos >= ctx)
    key = torch.where(valid_key, w32 & 0xFFFFFF, 0x1000000 + pos)
    # probe word s of position p is the window at p + 4s (zero past the row)
    wp = torch.nn.functional.pad(w32, (0, 4 * S))
    probes = torch.stack([wp[:, 4 * s:4 * s + N] for s in range(S)])

    n = reset if reset and N % reset == 0 else N          # sort row length
    rows = B * (N // n)
    key = key.reshape(rows, n)
    probes = probes.reshape(S, rows, n)
    skey, perm = torch.sort(key, dim=1, stable=True)
    spos = pos.reshape(rows, n).gather(1, perm)
    probes = probes.gather(2, perm.expand(S, rows, n))
    nv_row = nv.repeat_interleave(N // n)
    limit = torch.clamp(nv_row[:, None] - spos, max=C.MAX_MATCH)

    # candidate jj of sorted slot i is slot i - jj: every array padded with
    # J slots on the left (key -1, position 0, probes 0)
    skey_p = torch.nn.functional.pad(skey, (J, 0), value=-1)
    spos_p = torch.nn.functional.pad(spos, (J, 0))
    probes_p = torch.nn.functional.pad(probes, (J, 0))

    def shifted(a: torch.Tensor, jj: int) -> torch.Tensor:
        return a[..., J - jj:J - jj + n]

    def ok_of(ckey, cpos):
        dist = spos - cpos
        ok = (ckey == skey) & (dist >= 1) & (dist <= C.WINDOW_SIZE)
        if reset:
            ok = ok & (cpos // reset == spos // reset)
        return ok

    if two_phase:
        # phase A: rank candidates by the word-0 trailing-equal bytes, keep the
        # top two (strict >, nearest first, so the nearer wins a tie)
        s1 = torch.full_like(spos, -1)
        s2 = torch.full_like(spos, -1)
        j1 = torch.zeros_like(spos)
        j2 = torch.zeros_like(spos)
        for jj in range(1, J + 1):
            ok = ok_of(shifted(skey_p, jj), shifted(spos_p, jj))
            t0 = _trailing_eq_bytes(probes[0] ^ shifted(probes_p[0], jj))
            sc = torch.where(ok, torch.minimum(t0, limit), -1)
            b1 = sc > s1
            b2 = ~b1 & (sc > s2)
            s2 = torch.where(b1, s1, torch.where(b2, sc, s2))
            j2 = torch.where(b1, j1, torch.where(b2, jj, j2))
            s1 = torch.where(b1, sc, s1)
            j1 = torch.where(b1, jj, j1)

        # phase B: exact length of each finalist.  A slot never filled (score
        # -1, jsel 0) reads zeros, as the reference's select chain does, and is
        # masked by its explicit validity lane: a fake candidate at position 0
        # with key 0 would match real data on zero-byte runs.
        slot = torch.arange(n, device=dev)

        def eval_sel(jsel, valid):
            take = jsel >= 1
            idx = (J + slot - jsel).clamp(min=0)

            def pick(a):
                got = a.gather(-1, idx.expand(a.shape[:-1] + (n,)))
                return torch.where(take, got, 0)

            cpos = pick(spos_p)
            ok = valid & ok_of(pick(skey_p), cpos)
            ml = _match_len(probes, pick(probes_p), limit)
            return torch.where(ok & (ml >= C.MIN_MATCH), ml, 0), spos - cpos

        ml1, d1 = eval_sel(j1, s1 >= 0)
        ml2, d2 = eval_sel(j2, s2 >= 0)
        better2 = ml2 > ml1
        best_ml = torch.where(better2, ml2, ml1)
        best_dist = torch.where(better2, d2, d1)
    else:
        # every candidate measured in full, nearest first: strict > keeps
        # the nearer of two equally long matches
        best_ml = torch.zeros_like(spos)
        best_dist = torch.zeros_like(spos)
        for jj in range(1, J + 1):
            cpos = shifted(spos_p, jj)
            ok = ok_of(shifted(skey_p, jj), cpos)
            ml = _match_len(probes, shifted(probes_p, jj), limit)
            ml = torch.where(ok & (ml >= C.MIN_MATCH), ml, 0)
            better = ml > best_ml
            best_ml = torch.where(better, ml, best_ml)
            best_dist = torch.where(better, spos - cpos, best_dist)
    packed = torch.empty_like(spos).scatter_(1, perm,
                                             (best_ml << 16) | best_dist)
    packed = packed.reshape(B, N)

    # dist-1 runs (long RLE matches beyond the probe cap): clen[p] = length
    # of the constant-byte run starting at p, by a reverse running minimum
    pos = pos.reshape(B, N)
    eq = (d[:, :N] == d[:, 1:N + 1]) & (pos + 1 < nv[:, None])
    stop = torch.where(eq, N, pos)
    z = torch.flip(torch.cummin(torch.flip(stop, [1]), dim=1).values, [1])
    clen = z - pos + 1
    run_ml = torch.minimum(
        (torch.nn.functional.pad(clen, (1, 0))[:, :N] - 1).clamp(
            max=C.MAX_MATCH),
        nv[:, None] - pos)
    run_ok = (run_ml >= C.MIN_MATCH) & (pos >= 1)
    if reset:
        run_ok = run_ok & (pos % reset != 0)      # the source is pos - 1
    if ctx_start is not None:
        run_ok = run_ok & (pos - 1 >= ctx)
    use_run = run_ok & (run_ml > (packed >> 16))
    packed = torch.where(use_run, (run_ml << 16) | 1, packed)
    return packed.int()


# ---------------------------------------------------------------------------
# greedy + lazy token selection per segment lane, the general encoder's
#
# Replaces select_tokens (zlibes_tpu/ops/lz77.py:295), which is no Pallas
# kernel but an XLA while_loop of up to SEG_SIZE steps over all lanes in
# lock step; as eager torch ops that is SEG_SIZE steps of ~15 launches each
# (select_tokens_plain below).  On the card (select_tokens_kernel,
# csrc/encode_kernels.cu) one block owns one lane: all threads compute every
# position's token and successor at once into shared memory (they depend on
# that position and the next alone); the chain from the lane's first
# position is then marked by a warp whose 32 threads each walk one piece of
# the lane from its first position, fixed up in rounds from each piece's
# true entry (LZ parses meet again within a few tokens, and a piece's walks
# remember whom they met, so no position is walked twice); a scan of the
# marks gives each token its slot.  Bound by the pass's loads, the store and
# the longest piece walk, not by the lane's token count.  The rule itself
# (select_step) is shared with select_turbo's kernel.
#
# Contract: data (B, >= N) uint8 block rows; matches (B, N) int32, each
# ``(len << 16) | dist`` with len in 0..258; n_valid (B,) int32 bytes per
# row, ``start`` included.  Lane k of block b covers positions
# [start + k*SEG_SIZE, start + (k+1)*SEG_SIZE) clipped to n_valid[b]; a match
# is clamped at the lane's end, and then, with ``split_far`` (the reference's,
# which the shared-table encoder sets for codes of at most 9 bits), a match of
# 131 bytes or more at a distance above 2048 is cut to 130.  Returns (tv, td
# (L, SEG_SIZE) int32: token j of lane l at column j, a match as (length,
# distance), a literal as (byte, 0), zeros past the count; count (L,) int32),
# L = B * (N - start) // SEG_SIZE.

def select_tokens_plain(data: torch.Tensor, matches: torch.Tensor,
                        n_valid: torch.Tensor, N: int, SEG_SIZE: int = SEG,
                        lazy: bool = True, start: int = 0,
                        split_far: bool = False):
    B = matches.shape[0]
    nseg = (N - start) // SEG_SIZE
    L = B * nseg
    dev = matches.device
    m = matches.long()
    d = data[:, :N].long()
    lane = torch.arange(L, device=dev)
    blk = lane // nseg
    seg0 = start + (lane % nseg) * SEG_SIZE
    seg_end = torch.minimum(seg0 + SEG_SIZE, n_valid.long()[blk])
    tv = torch.zeros((L, SEG_SIZE), dtype=torch.int32, device=dev)
    td = torch.zeros((L, SEG_SIZE), dtype=torch.int32, device=dev)
    count = torch.zeros(L, dtype=torch.long, device=dev)
    c = seg0.clone()
    active = seg0 < seg_end
    # exactly SEG_SIZE steps, with no host sync: a lane advances >= 1
    # position a step, so it ends within SEG_SIZE steps
    for t in range(SEG_SIZE):
        cs = c.clamp(max=N - 1)
        pb = m[blk, cs]
        ml = torch.minimum(pb >> 16, seg_end - c)
        dist = pb & 0xFFFF
        if split_far:
            ml = torch.where((ml >= 131) & (dist >= 2049), 130, ml)
        use = ml >= C.MIN_MATCH
        if lazy:
            ml1 = m[blk, (cs + 1).clamp(max=N - 1)] >> 16
            defer = use & (ml < C.MAX_MATCH) & (ml1 > ml) & (c + 1 < seg_end)
            use = use & ~defer
        tv[:, t] = torch.where(active, torch.where(use, ml, d[blk, cs]), 0)
        td[:, t] = torch.where(active & use, dist, 0)
        count += active.long()
        c = torch.where(active, c + torch.where(use, ml, 1), c)
        active = active & (c < seg_end)
    return tv, td, count.int()


def select_tokens(data: torch.Tensor, matches: torch.Tensor,
                  n_valid: torch.Tensor, N: int, SEG_SIZE: int = SEG,
                  lazy: bool = True, start: int = 0,
                  split_far: bool = False):
    """Greedy (+ one-step lazy) token cover of every segment lane ->
    (tv, td (L, SEG_SIZE) int32, count (L,) int32); see the contract
    above.  ``start`` > 0 is the width of a preset dictionary's context
    prefix: bytes below it are match sources and never tokens.
    ``split_far`` caps far long matches at 130 bytes."""
    dev = matches.device
    B = matches.shape[0]
    _check(matches, "matches", torch.int32, (B, N), dev)
    _check(n_valid, "n_valid", torch.int32, (B,), dev)
    if data.dim() != 2 or data.shape[1] < N:
        raise ValueError(f"data has shape {tuple(data.shape)}, expected "
                         f"({B}, >= {N})")
    _check(data, "data", torch.uint8, (B, data.shape[1]), dev)
    if SEG_SIZE <= 0 or not 0 <= start < N or (N - start) % SEG_SIZE:
        raise ValueError(f"N - start ({N} - {start}) must be a positive "
                         f"multiple of SEG_SIZE ({SEG_SIZE})")
    if not _route(matches):
        return select_tokens_plain(data, matches, n_valid, N, SEG_SIZE, lazy,
                                   start, split_far)
    if SEG_SIZE > MAX_KERNEL_SEG:
        raise ValueError(f"the select_tokens kernel takes SEG_SIZE up to "
                         f"{MAX_KERNEL_SEG}, got {SEG_SIZE}")
    nseg = (N - start) // SEG_SIZE
    L = B * nseg
    tv = torch.empty((L, SEG_SIZE), dtype=torch.int32, device=dev)
    td = torch.empty((L, SEG_SIZE), dtype=torch.int32, device=dev)
    count = torch.empty(L, dtype=torch.int32, device=dev)
    if L:
        _launch("select_tokens", dev, _ptr(data),
                ctypes.c_int64(data.shape[1]), _ptr(matches), _ptr(n_valid),
                *(ctypes.c_int(int(v)) for v in (N, nseg, SEG_SIZE, start,
                                                 lazy, split_far, L)),
                _ptr(tv), _ptr(td), _ptr(count))
    return tv, td, count
