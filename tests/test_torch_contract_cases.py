"""Hand-made inputs that pin the contracts of ``resolve_wide`` and
``select_turbo``, with the bytes and tokens they must give, and tests of
the port's plain versions against them.

Imports the port only (no JAX, nothing of ``zlibes_tpu``), so the card
tests use the same cases for kernel versus plain;
``test_torch_contracts.py`` runs them through the JAX kernels.

``resolve_wide``: four block rows of 36 KiB (nine 4 KiB tiles), mostly
seeded literals, each with one feature:

  * ``full_reach``     a match whose source lies the full 32 KiB back;
  * ``three_tiles``    a chain of matches 4 KiB apart across three tile
    edges, ending on literals of the first tile;
  * ``run_over_edge``  an overlapping run (distance 1, length 258) that
    starts before a tile edge and ends after it;
  * ``clipped``        matches whose distance reaches before the row: the
    source clips to row byte 0 (a literal).

``select_turbo``: one dispatch of 16 blocks of 16 KiB (512 lanes) whose
matches are zero except in a few lanes:

  * ``far_cap``        a match of 200 at distance 3000 is capped at 130;
    one of 200 at distance 2048 is not;
  * ``defer_at_end``   a match three positions before the segment's end is
    deferred to the longer raw length after it, which the clamp to the
    segment's end then cuts to literals; with ``lazy`` off it is taken;
  * ``empty_lane``     a lane past its block's last byte (``seg_len`` 0).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.ops import wide_kernel as wk

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# resolve_wide

NSUBB = 288                       # 36 KiB rows: nine 4 KiB tiles
ROW = NSUBB * wk.SUB
RESOLVE_CASES = ("full_reach", "three_tiles", "run_over_edge", "clipped")


def _row_tokens(case: str) -> list[tuple[int, int, int]]:
    """(start, length, dist) of the row's matches; every other byte is a
    literal."""
    if case == "full_reach":
        return [(32768 + 100, 200, 32768)]
    if case == "three_tiles":
        return [(4096 * k + 50, 100, 4096) for k in (1, 2, 3)]
    if case == "run_over_edge":
        return [(4001, 258, 1), (8190, 258, 1)]
    if case == "clipped":
        return [(5, 10, 9), (5000, 4, 6000), (20000, 3, 32768)]
    raise KeyError(case)


def resolve_case(case: str):
    """(toks (NSUBB, 256) int32, starts (NSUBB, 256) int32, the row's bytes
    (ROW,) uint8) of one case: slot 0 of a sub-span holds the token that
    covers its first byte, slots 1.. the tokens that start inside it."""
    rng = np.random.default_rng(RESOLVE_CASES.index(case) + 40)
    lits = rng.integers(0, 256, ROW, dtype=np.uint8)
    matches = {s: (ln, d) for s, ln, d in _row_tokens(case)}
    tokens = []                   # (start, packed token, length)
    out = np.zeros(ROW, np.uint8)
    q = 0
    while q < ROW:
        if q in matches:
            ln, d = matches[q]
            for k in range(ln):   # byte by byte: overlapping runs repeat
                out[q + k] = out[max(q + k - d, 0)]
            tokens.append((q, ln | (d << wk.TOK_DIST_SHIFT)
                           | wk.TOK_MATCH_BIT, ln))
            q += ln
        else:
            out[q] = lits[q]
            tokens.append((q, int(lits[q]), 1))
            q += 1
    toks = np.zeros((NSUBB, wk.TOKENS_PAD), np.int32)
    starts = np.full((NSUBB, wk.TOKENS_PAD), wk.START_PAD, np.int32)
    fill = np.ones(NSUBB, np.int64)           # next free slot, after slot 0
    for s, tok, ln in tokens:
        m0 = s // wk.SUB
        if s % wk.SUB == 0:
            toks[m0, 0], starts[m0, 0] = tok, 0
        else:
            toks[m0, fill[m0]], starts[m0, fill[m0]] = tok, s % wk.SUB
            fill[m0] += 1
        # every later sub-span whose first byte the token covers
        for m in range(m0 + 1, (s + ln - 1) // wk.SUB + 1):
            toks[m, 0], starts[m, 0] = tok, s - m * wk.SUB
    return toks, starts, out


def resolve_inputs():
    """All cases as one call: toks, starts (4, NSUBB, 256) and the rows'
    bytes (4, ROW)."""
    parts = [resolve_case(c) for c in RESOLVE_CASES]
    return tuple(np.stack(x) for x in zip(*parts))


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_wide_plain_gives_the_cases_bytes(case):
    toks, starts, want = resolve_case(case)
    got = wk.resolve_wide(torch.from_numpy(toks[None]),
                          torch.from_numpy(starts[None]))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, ROW)
    assert np.array_equal(got.numpy()[0], want)


def test_resolve_cases_hold_their_features():
    toks, starts, rows = resolve_inputs()
    dist = (toks >> wk.TOK_DIST_SHIFT) & wk.TOK_DIST_MASK
    ism = (toks & wk.TOK_MATCH_BIT) != 0
    assert (dist[0][ism[0]] == 32768).all() and ism[0].any()
    # the chain's three copies all give the first tile's literals
    for k in (1, 2, 3):
        assert np.array_equal(rows[1][4096 * k + 50 : 4096 * k + 150],
                              rows[1][50:150])
    assert (rows[2][4000:4259] == rows[2][4000]).all()
    assert (rows[2][8189:8448] == rows[2][8189]).all()
    assert (rows[3][5:10] == rows[3][0]).all()
    assert (rows[3][5000:5004] == rows[3][0]).all()
    # boundary-covering tokens sit in slot 0 with a negative start
    assert (starts[:, :, 0] <= 0).all() and (starts[2, :, 0] < -128).any()


# ---------------------------------------------------------------------------
# select_turbo

BS = 16384                        # block size: 32 lanes of 512 a block
BP = 16                           # blocks a dispatch
SELECT_CASES = ("far_cap", "defer_at_end", "empty_lane")
# lane of each case in the dispatch's (BP * 32, 512) lane order
SELECT_LANE = {"far_cap": 0, "defer_at_end": 33, "empty_lane": 34}
_NV1 = 512 + 300                  # block 1: lane 33 holds 300 bytes


def select_dispatch():
    """(blk (BP, BS + 8) uint8, matches (BP, BS) int32 as ``len << 16 |
    dist``, nv (BP,) int32) of the crafted dispatch."""
    rng = np.random.default_rng(77)
    blk = np.zeros((BP, BS + 8), np.uint8)
    blk[:, :BS] = rng.integers(0, 256, (BP, BS), dtype=np.uint8)
    nv = np.full(BP, BS, np.int32)
    nv[1] = _NV1
    nv[2:] = 0
    blk[1, _NV1:] = 0
    blk[2:] = 0
    matches = np.zeros((BP, BS), np.int32)
    # lane 0: far and long is capped, distance 2048 is not far
    matches[0, 0] = (200 << 16) | 3000
    matches[0, 130] = (200 << 16) | 2048
    # lane 33 (block 1, positions 512..811): three before the end a match of
    # 3 (raw 10) with a longer raw length behind it
    end = _NV1
    matches[1, end - 3] = (10 << 16) | 7
    matches[1, end - 2] = (50 << 16) | 9
    return blk, matches, nv


def select_expected(case: str, lazy: bool, blk: np.ndarray):
    """(count, the lane's first tokens as packed int32) that the contract
    fixes for the crafted part of ``case``'s lane."""
    match = tk.TOK_MATCH_BIT

    def m(ln, d):
        return ln | (d << tk.TOK_DIST_SHIFT) | match

    if case == "far_cap":
        # 130 capped + 200 + literals for the remaining 512 - 330 positions
        return 2 + 512 - 330, [m(130, 3000), m(200, 2048)]
    if case == "defer_at_end":
        lits = blk[1, 512:_NV1].astype(np.int64)
        if lazy:
            return 300, list(lits[-3:])
        return 298, [int(lits[-4]), m(3, 7)]
    if case == "empty_lane":
        return 0, []
    raise KeyError(case)


def select_inputs():
    """The crafted dispatch as the kernel's inputs: pv (512, 512) int32 and
    seg_len (512,) int32, CPU tensors."""
    blk, matches, nv = select_dispatch()
    return tdp.select_inputs(torch.from_numpy(blk), torch.from_numpy(matches),
                             torch.from_numpy(nv), BS)


def check_select_case(case: str, lazy: bool, toks: np.ndarray,
                      counts: np.ndarray) -> None:
    """Assert that (toks (512, 512), counts (512,)) hold ``case``'s lane as
    the contract fixes it."""
    blk, _, _ = select_dispatch()
    lane = SELECT_LANE[case]
    count, some = select_expected(case, lazy, blk)
    assert int(counts[lane]) == count
    row = toks[lane]
    if case == "far_cap":
        assert list(row[:2]) == some
    elif case == "defer_at_end":
        assert list(row[count - len(some) : count]) == some
    assert not row[count:].any()


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_turbo_plain_gives_the_cases_tokens(case, lazy):
    pv, slen = select_inputs()
    assert int(slen[SELECT_LANE["empty_lane"]]) == 0
    assert int(slen[SELECT_LANE["defer_at_end"]]) == 300
    toks, counts = tk.select_turbo(pv, slen, lazy=lazy)
    check_select_case(case, lazy, toks.numpy(), counts.numpy())


def test_select_turbo_plain_counts_a_long_seg_len_as_512():
    pv, slen = select_inputs()
    toks, counts = tk.select_turbo(pv[:4], slen[:4])
    toks2, counts2 = tk.select_turbo(pv[:4], slen[:4] + 100)
    assert torch.equal(toks, toks2) and torch.equal(counts, counts2)
