"""Sort-based LZ77 match finding, as torch ops.

Counterpart of ``find_matches`` (``zlibes_tpu/ops/lz77.py:55``) in the
branch the turbo profile takes: two-phase candidate ranking under a
window reset.  Per ``reset``-byte row, positions are sorted stably by
their 3-byte key, so a position's J nearest earlier occurrences are its J
predecessors in sorted order; candidates are ranked by their first probe
word, the top two are measured over all S probe words, and a dist-1 run
scan covers long runs past the probe cap.

The reference's multi-operand ``lax.sort`` becomes one stable
``torch.sort`` of the key plus a gather of each operand by the
permutation: keys tie only within runs of equal keys, and the tail
sentinels ``0x1000000 + pos`` are unique, so the permutation is the
reference's.  The un-permuting sort is a scatter by that permutation.
"""
from __future__ import annotations

import torch

from ..spec import constants as C


def _trailing_eq_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of trailing zero bytes of a 32-bit XOR value (0..4)."""
    n = ((x & 0xFF) == 0).long() + ((x & 0xFFFF) == 0).long() \
        + ((x & 0xFFFFFF) == 0).long()
    return torch.where(x == 0, 4, n)


def _match_len(probes: torch.Tensor, cand: torch.Tensor,
               limit: torch.Tensor) -> torch.Tensor:
    """Bytes shared by each position's S probe words and its candidate's,
    counted word by word while whole words agree, clamped to ``limit``."""
    t = _trailing_eq_bytes(probes ^ cand)                 # (S, rows, n)
    alive = torch.cumprod(torch.cat(
        [torch.ones_like(t[:1]), (t[:-1] == 4).long()]), dim=0)
    return torch.minimum((t * alive).sum(0), limit)


def find_matches(data: torch.Tensor, n_valid: torch.Tensor, N: int,
                 S: int, J: int, reset: int) -> torch.Tensor:
    """Best match per position: packed int32 ``(len << 16) | dist``.

    data (B, N + 8) uint8 padded block bytes, n_valid (B,) int32 true byte
    count per block.  len is 0 where no match of >= 3 bytes exists; matches
    never cross a ``reset`` boundary (a power of two dividing N) and are
    clamped to the block's end.
    """
    if not reset or reset & (reset - 1) or N % reset:
        raise ValueError("reset must be a power of two dividing N")
    B = data.shape[0]
    dev = data.device
    d = data.long()
    nv = n_valid.long()
    # little-endian 32-bit windows at every byte position (int64, < 2^32)
    w32 = d[:, :N] | (d[:, 1:N + 1] << 8) | (d[:, 2:N + 2] << 16) \
        | (d[:, 3:N + 3] << 24)
    pos = torch.arange(N, device=dev).expand(B, N)
    key = torch.where(pos + 3 <= nv[:, None], w32 & 0xFFFFFF, 0x1000000 + pos)
    # probe word s of position p is the window at p + 4s (zero past the row)
    wp = torch.nn.functional.pad(w32, (0, 4 * S))
    probes = torch.stack([wp[:, 4 * s:4 * s + N] for s in range(S)])

    rows = B * (N // reset)
    key = key.reshape(rows, reset)
    probes = probes.reshape(S, rows, reset)
    skey, perm = torch.sort(key, dim=1, stable=True)
    spos = pos.reshape(rows, reset).gather(1, perm)
    probes = probes.gather(2, perm.expand(S, rows, reset))
    nv_row = nv.repeat_interleave(N // reset)
    limit = torch.clamp(nv_row[:, None] - spos, max=C.MAX_MATCH)

    # candidate jj of sorted slot i is slot i - jj: every array padded with
    # J slots on the left (key -1, position 0, probes 0)
    skey_p = torch.nn.functional.pad(skey, (J, 0), value=-1)
    spos_p = torch.nn.functional.pad(spos, (J, 0))
    probes_p = torch.nn.functional.pad(probes, (J, 0))

    def shifted(a: torch.Tensor, jj: int) -> torch.Tensor:
        return a[..., J - jj:J - jj + reset]

    def ok_of(ckey, cpos):
        dist = spos - cpos
        return ((ckey == skey) & (dist >= 1) & (dist <= C.WINDOW_SIZE)
                & (cpos // reset == spos // reset))

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
    slot = torch.arange(reset, device=dev)

    def eval_sel(jsel, valid):
        take = jsel >= 1
        idx = (J + slot - jsel).clamp(min=0)

        def pick(a):
            got = a.gather(-1, idx.expand(a.shape[:-1] + (reset,)))
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
    run_ok = (run_ml >= C.MIN_MATCH) & (pos >= 1) & (pos % reset != 0)
    use_run = run_ok & (run_ml > (packed >> 16))
    packed = torch.where(use_run, (run_ml << 16) | 1, packed)
    return packed.int()
