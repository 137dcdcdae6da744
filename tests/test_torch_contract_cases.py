"""Hand-made inputs that pin the contracts of ``resolve_wide``,
``select_turbo``, ``select_tokens``, ``resolve_turbo``, ``decode_turbo`` and
``decode_wide``, with the bytes and tokens they must give, and tests of the
port's plain versions against them.

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

``select_tokens``: one dispatch of 4 blocks of 8 KiB in lanes of 4,096
(8 lanes) whose matches are zero except in a few lanes:

  * ``far_distance``      a match of 200 at distance 32,768 is taken whole
    (no far cap outside the turbo profile);
  * ``max_never_deferred``  a match of 258 is taken although the next
    position claims a longer one;
  * ``clamped_at_end``    a match of 100 ten positions before the segment's
    end is cut to 10;
  * ``defer_at_end``      as for ``select_turbo``, in a lane that its
    block's end cuts to 300 positions;
  * ``empty_lane``        a lane past its block's last byte (``seg_len`` 0).

``select_tokens``' chain cases (``SELECT_CHAIN_CASES``, one lane a row),
each with the feature it stresses in the kernel's design (32 pieces walked
from their first positions, then fix-up rounds from the true entries):
a lane of 16,384 literals, lanes of 1,024 and 1,025 tokens, 258-byte
matches, lanes of 0-3 positions, a match ending at the lane's end, growing
lengths, a match at every other position, parses that never meet (a match
of 3 everywhere: 31 fix-up rounds), a match over eight pieces and random
lengths in 32-position pieces, some behind 32,768 context positions;
``select_tokens_model`` is the kernel's procedure in numpy.

``resolve_turbo``: one 4 KiB chunk row with one token a byte, seeded
non-zero literals but for a few matches:

  * ``self_copy``             a match of distance 0 copies itself and ends
    as its own index, ``q & 255``;
  * ``chain_into_self_copy``  matches that lead, over several hops, into
    such a byte end as that byte's ``q & 255`` too;
  * ``byte0_match``           byte 0 as a match (its source clips to
    itself) is 0, and so is every byte whose source clips to it.

``decode_turbo``: four lanes under the fixed Huffman tables:

  * ``past_window``  a lane that starts in word 95 reads that word again
    for every index past it;
  * ``cut_by_T``     a lane with more tokens than ``T`` stops after ``T``,
    still active, its position after the T-th token;
  * ``padded_lane``  ``bit0 == endb == 0``: no token, no error, end bit 0.

``decode_wide``: one block row of 256 lanes under codes of 1 to 15 bits
(``DEEP_LENGTHS``), one lane a case, the rare paths of a kernel that walks
two literals a step from one-level tables of fewer than 15 bits:

  * ``code_15_bits``         a literal whose code has 15 bits;
  * ``token_32_bits``        a length of 15 + 5 bits with a distance of
    15 + 9 bits: one token of 44 bits;
  * ``pair_at_last_slots``   two literals in the last two slots of ``T``;
  * ``pair_cut_by_endb``     two literals of which the second ends past the
    lane's end: the first is kept, the second is an error that does not
    move the position;
  * ``pair_ends_at_endb``    two literals that end exactly at the lane's end;
  * ``before_block``         a distance before the block's start as the
    second token, behind a literal;
  * ``eob_behind_literal``   end-of-block behind a literal, before the
    lane's end: the position moves past it and the lane stops.
"""
from __future__ import annotations

import functools
import zlib

import numpy as np
import pytest
import torch

from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.ops import lz77
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.ops import wide_kernel as wk
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec.errors import CorruptError
from test_torch_fixed_streams import fixed_lane

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


# ---------------------------------------------------------------------------
# select_tokens

TOK_N = 8192                      # block size: 2 lanes of 4,096 a block
TOK_B = 4                         # blocks of the dispatch
TOK_SEG = 4096
SELECT_TOKENS_CASES = ("far_distance", "max_never_deferred", "clamped_at_end",
                       "defer_at_end", "empty_lane")
# lane of each case in the dispatch's (TOK_B * 2, 4096) lane order
SELECT_TOKENS_LANE = {"far_distance": 0, "max_never_deferred": 0,
                      "clamped_at_end": 0, "defer_at_end": 3, "empty_lane": 5}
_TOK_NV1 = TOK_SEG + 300          # block 1: lane 3 holds 300 bytes


def select_tokens_dispatch(start: int = 0):
    """(blk (TOK_B, start + TOK_N + 8) uint8, matches (TOK_B, start + TOK_N)
    int32 as ``len << 16 | dist``, nv (TOK_B,) int32, ``start`` counted in)
    of the crafted dispatch, behind a prefix of ``start`` positions that
    claim matches of their own and must never become tokens."""
    rng = np.random.default_rng(78)
    blk = np.zeros((TOK_B, TOK_N + 8), np.uint8)
    blk[:, :TOK_N] = rng.integers(0, 256, (TOK_B, TOK_N), dtype=np.uint8)
    nv = np.array([TOK_N, _TOK_NV1, TOK_SEG, 0], np.int32)
    for b in range(TOK_B):
        blk[b, nv[b]:] = 0
    matches = np.zeros((TOK_B, TOK_N), np.int32)
    matches[0, 0] = (200 << 16) | 32768
    matches[0, 200] = (258 << 16) | 5
    matches[0, 201] = (300 << 16) | 7     # no matcher's length: only looked at
    matches[0, TOK_SEG - 10] = (100 << 16) | 9
    end = _TOK_NV1
    matches[1, end - 3] = (10 << 16) | 7
    matches[1, end - 2] = (50 << 16) | 9
    if start:
        pre = rng.integers(0, 256, (TOK_B, start), dtype=np.uint8)
        blk = np.concatenate([pre, blk], axis=1)
        pre_m = ((rng.integers(3, 259, (TOK_B, start)) << 16)
                 | rng.integers(1, 500, (TOK_B, start))).astype(np.int32)
        matches = np.concatenate([pre_m, matches], axis=1)
        nv = nv + start
    return blk, matches, nv


def select_tokens_inputs(start: int = 0):
    """The crafted dispatch as CPU tensors (data, matches, n_valid)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in select_tokens_dispatch(start))


def check_select_tokens_case(case: str, lazy: bool, tv: np.ndarray,
                             td: np.ndarray, counts: np.ndarray) -> None:
    """Assert that (tv, td (8, 4096), counts (8,)) hold ``case``'s lane as
    the contract fixes it."""
    blk, _, _ = select_tokens_dispatch()
    lane = SELECT_TOKENS_LANE[case]
    count = int(counts[lane])
    toks = list(zip(tv[lane].tolist(), td[lane].tolist()))
    assert not tv[lane, count:].any() and not td[lane, count:].any()
    if lane == 0:
        # 200 + 258 + literals up to the clamped match + that match
        assert count == 2 + (TOK_SEG - 10 - 458) + 1
        want = {"far_distance": (0, (200, 32768)),
                "max_never_deferred": (1, (258, 5)),
                "clamped_at_end": (count - 1, (10, 9))}[case]
        assert toks[want[0]] == want[1]
        assert toks[2] == (int(blk[0, 458]), 0)
    elif case == "defer_at_end":
        lits = [(int(x), 0) for x in blk[1, TOK_SEG:_TOK_NV1]]
        if lazy:
            assert count == 300 and toks[:300] == lits
        else:
            assert count == 298 and toks[:298] == lits[:297] + [(3, 7)]
    else:
        assert count == 0


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("start", [0, 4096])
def test_select_tokens_plain_gives_the_cases_tokens(lazy, start):
    """Every case of the dispatch, and the same tokens behind a prefix."""
    data, matches, nv = select_tokens_inputs(start)
    tv, td, counts = lz77.select_tokens(data, matches, nv, N=start + TOK_N,
                                        SEG_SIZE=TOK_SEG, lazy=lazy,
                                        start=start)
    assert tuple(tv.shape) == (TOK_B * 2, TOK_SEG) and tv.dtype == torch.int32
    for case in SELECT_TOKENS_CASES:
        check_select_tokens_case(case, lazy, tv.numpy(), td.numpy(),
                                 counts.numpy())


def test_select_tokens_wrapper_checks_its_inputs():
    data, matches, nv = select_tokens_inputs()
    with pytest.raises(ValueError, match="shape"):
        lz77.select_tokens(data, matches[:, :100].contiguous(), nv, N=TOK_N)
    with pytest.raises(ValueError, match="dtype"):
        lz77.select_tokens(data, matches.long(), nv, N=TOK_N)
    with pytest.raises(ValueError, match="dtype"):
        lz77.select_tokens(data.int(), matches, nv, N=TOK_N)
    with pytest.raises(ValueError, match="shape"):
        lz77.select_tokens(data[:, :100].contiguous(), matches, nv, N=TOK_N)
    with pytest.raises(ValueError, match="multiple of SEG_SIZE"):
        lz77.select_tokens(data, matches, nv, N=TOK_N, SEG_SIZE=3000)
    with pytest.raises(ValueError, match="multiple of SEG_SIZE"):
        lz77.select_tokens(data, matches, nv, N=TOK_N, start=TOK_N)


# ---------------------------------------------------------------------------
# select_tokens: chains that stress the kernel's pieces, walks and rounds
#
# The kernel (csrc/encode_kernels.cu) cuts a lane into 32 pieces, walks each
# from its first position, then fixes the walks up in rounds from each
# piece's true entry; ``select_tokens_model`` below is that procedure in
# numpy, held against ``select_tokens_plain`` on these cases.

# name -> (SEG_SIZE, start, lazy, what the case holds)
SELECT_CHAIN_CASES = {
    "literals_16384": (16384, 0, True,
                       "one lane of 16,384 literals: 512-position pieces"),
    "round_boundary": (2048, 0, True,
                       "lanes of exactly 1,024 and 1,025 tokens"),
    "matches_258": (4096, 0, True,
                    "a chain of 258-byte matches, each over two pieces"),
    "seg_len_1_2_3": (32, 0, True,
                      "lanes of 0, 1, 2 and 3 positions, a match of 3 at "
                      "each"),
    "match_to_end": (1024, 0, True,
                     "a match that ends exactly at the lane's end"),
    "match_to_end_after_prefix": (1024, 32768, True,
                                  "the same behind 32,768 context positions"),
    "growing_lengths": (1024, 0, True,
                        "strictly growing lengths: each lazy defer hands on "
                        "to the next"),
    "every_other_position": (1024, 0, True,
                             "a match of 4 at every even position: a "
                             "walk from an odd one joins after a literal"),
    "chains_never_merge": (4096, 0, True,
                           "a match of 3 at every position: walks from "
                           "neighbouring positions never meet, so every "
                           "piece's fix-up walks to its end"),
    "chains_never_merge_after_prefix": (4096, 32768, False,
                                        "the same, greedy, behind 32,768 "
                                        "context positions"),
    "skips_pieces": (512, 0, True,
                     "a 258-byte match over eight 32-position pieces"),
    "random_small_pieces": (1024, 0, True,
                            "random lengths in 32-position pieces: fix-up "
                            "walks that meet earlier fix-up walks"),
}


def _chain_lengths(case: str):
    """(match lengths (B, SEG) int64, n_valid (B,)) of ``case``'s rows, one
    lane a row, before any prefix."""
    seg = SELECT_CHAIN_CASES[case][0]
    ml = np.zeros((1, seg), np.int64)
    nv = np.array([seg])
    if case == "round_boundary":
        ml = np.zeros((2, seg), np.int64)
        ml[:, :512] = 4               # 128 matches, then 896 or 897 literals
        nv = np.array([1408, 1409])
    elif case == "matches_258":
        ml[:] = C.MAX_MATCH
    elif case == "seg_len_1_2_3":
        ml = np.full((4, seg), 3, np.int64)
        nv = np.array([0, 1, 2, 3])
    elif case.startswith("match_to_end"):
        ml[0, 900] = 100
        nv = np.array([1000])
    elif case == "growing_lengths":
        ml[0, 10:110] = 3 + np.arange(100)
    elif case == "every_other_position":
        ml[0, ::2] = 4
    elif case.startswith("chains_never_merge"):
        ml[:] = 3
    elif case == "skips_pieces":
        ml[0, 5] = C.MAX_MATCH
        nv = np.array([300])
    elif case == "random_small_pieces":
        rng = np.random.default_rng(1024)
        ml = rng.integers(0, C.MAX_MATCH + 1, (4, seg))
        ml[rng.random((4, seg)) < 0.5] = 0
        nv = np.array([seg, seg, 700, 33])
    return ml, nv


@functools.cache
def select_chain_case(case: str):
    """(data (B, N + 8) uint8, matches (B, N) int32, n_valid (B,) int32,
    kwargs of select_tokens) of ``case``: seeded bytes and distances, and
    behind a prefix its ``start`` positions of seeded matches that must
    never become tokens."""
    seg, start, lazy, _ = SELECT_CHAIN_CASES[case]
    ml, nv = _chain_lengths(case)
    B = ml.shape[0]
    rng = np.random.default_rng(sum(map(ord, case)))
    N = start + seg
    data = rng.integers(0, 256, (B, N + 8), dtype=np.uint8)
    dist = rng.integers(1, C.WINDOW_SIZE + 1, (B, N))
    full = np.concatenate([rng.integers(3, C.MAX_MATCH + 1, (B, start)), ml],
                          axis=1)
    matches = ((full << 16) | dist).astype(np.int32)
    kw = dict(N=N, SEG_SIZE=seg, lazy=lazy, start=start)
    return data, matches, (nv + start).astype(np.int32), kw


def select_chain_inputs(case: str):
    """``select_chain_case`` as CPU tensors and its kwargs."""
    data, matches, nv, kw = select_chain_case(case)
    return (torch.from_numpy(data), torch.from_numpy(matches),
            torch.from_numpy(nv)), kw


@functools.cache
def select_chain_plain(case: str):
    """``select_tokens_plain`` of ``case`` as numpy (tv, td, count): run
    once a process (the 16,384-position lane is 16,384 eager steps)."""
    args, kw = select_chain_inputs(case)
    return tuple(x.numpy() for x in lz77.select_tokens(*args, **kw))


def check_select_chain_case(case: str, tv: np.ndarray, td: np.ndarray,
                            count: np.ndarray) -> None:
    """Assert the features that ``case`` fixes on select_tokens' output
    (zeros past each count included)."""
    past = np.arange(tv.shape[1])[None, :] >= count[:, None]
    assert not tv[past].any() and not td[past].any()
    toks = [list(zip(tv[i, :n].tolist(), td[i, :n].tolist()))
            for i, n in enumerate(count.tolist())]
    n0 = int(count[0])
    if case == "literals_16384":
        assert n0 == 16384 and not td[0].any()
    elif case == "round_boundary":
        assert count.tolist() == [1024, 1025]
        assert all(t[0] == 4 and t[1] > 0 for t in toks[1][:128])
    elif case == "matches_258":
        # 15 whole matches, then the last 226 positions: each clamped match
        # is deferred to the next position's longer raw length
        assert [t[0] for t in toks[0][:15]] == [C.MAX_MATCH] * 15
        assert n0 == 15 + 4096 - 15 * C.MAX_MATCH
    elif case == "seg_len_1_2_3":
        assert count.tolist() == [0, 1, 2, 1]
        assert td[1, 0] == 0 and not td[2].any() and tv[3, 0] == 3
    elif case.startswith("match_to_end"):
        assert n0 == 901 and toks[0][-1][0] == 100 and toks[0][-1][1] > 0
    elif case == "growing_lengths":
        # literals up to the run's last position, then its match of 102
        assert not td[0, :109].any() and tv[0, 109] == 102 and td[0, 109]
        assert n0 == 110 + 1024 - 211
    elif case == "every_other_position":
        assert n0 == 256 and all(t[0] == 4 for t in toks[0])
    elif case == "chains_never_merge":
        assert n0 == 1366 and all(t[0] == 3 for t in toks[0][:1365])
    elif case == "chains_never_merge_after_prefix":
        assert n0 == 1366
    elif case == "skips_pieces":
        assert n0 == 5 + 1 + 300 - 263 and toks[0][5][0] == C.MAX_MATCH
    elif case == "random_small_pieces":
        assert count[3] > 0 and count.min() > 0


def select_tokens_model(data, matches, n_valid, N: int, SEG_SIZE: int,
                        lazy: bool = True, start: int = 0,
                        split_far: bool = False, pieces: int = 32):
    """The select_tokens kernel's procedure in numpy -> (tv, td, count,
    stats): stats (L, 3) int64 a lane: fix-up rounds, most walks of a
    piece, longest speculative walk in tokens.

    (1) each position's token (val | dist << 9 | 1 << 25 for a match) and
    successor (``split_far`` cuts a match of 131 bytes or more at a distance
    above 2048 to 130); (2) each of ``pieces`` pieces (a power of two >= 32
    positions) walked from its first position; (3) rounds: piece p looks
    up its exit from its assumed entry (at first the speculative exit of
    piece p - 1): a position some walk of the piece visited has that
    walk's exit, any other starts a new walk that stops at the piece's end
    or at a visited position; the rounds stop when no entry changes; (4)
    along the true chain each walk is entered once, and c is a token iff c
    is at or past that position of its walk; (5) the rank of a token is the
    popcount of the mark words before its own and of its word's lower
    bits."""
    data = np.asarray(data)
    matches = np.asarray(matches).astype(np.int64)
    n_valid = np.asarray(n_valid).astype(np.int64)
    B = matches.shape[0]
    nseg = (N - start) // SEG_SIZE
    L = B * nseg
    tv = np.zeros((L, SEG_SIZE), np.int32)
    td = np.zeros((L, SEG_SIZE), np.int32)
    count = np.zeros(L, np.int32)
    stats = np.zeros((L, 3), np.int64)
    for lane in range(L):
        b, k = divmod(lane, nseg)
        seg0 = start + k * SEG_SIZE
        n = int(min(max(n_valid[b] - seg0, 0), SEG_SIZE))
        if n == 0:
            continue
        m = matches[b, seg0:seg0 + n]
        c = np.arange(n)
        ml = np.minimum(m >> 16, n - c)
        if split_far:
            ml = np.where((ml >= 131) & ((m & 0xFFFF) >= 2049), 130, ml)
        use = ml >= C.MIN_MATCH
        if lazy:
            ml1 = np.append(m[1:] >> 16, 0)
            use &= ~((ml < C.MAX_MATCH) & (ml1 > ml) & (c + 1 < n))
        tok = np.where(use, ml | (m & 0xFFFF) << 9 | 1 << 25,
                       data[b, seg0:seg0 + n])
        nxt = (c + np.where(use, ml, 1)).tolist()
        marks, stats[lane] = _model_marks(nxt, n, pieces)
        # (5): rank by the words' popcounts
        words = np.packbits(np.append(marks, np.zeros(-n % 32, bool))
                            .reshape(-1, 4, 8)[:, ::-1, ::-1]).view(">u4")
        pop = np.array([bin(int(w)).count("1") for w in words], np.int64)
        pre = np.concatenate([[0], np.cumsum(pop)[:-1]])
        cm = np.flatnonzero(marks)
        below = np.array([bin(int(words[x >> 5]) & ((1 << (x & 31)) - 1))
                          .count("1") for x in cm], np.int64)
        slot = pre[cm >> 5] + below
        tv[lane, slot] = tok[cm] & 0x1FF
        td[lane, slot] = (tok[cm] >> 9) & 0xFFFF
        count[lane] = int(pop.sum())
    return tv, td, count, stats


def _model_marks(nxt: list, n: int, pieces: int):
    """(2)-(4) of ``select_tokens_model`` on one lane of ``n`` positions ->
    (marks (n,) bool, [rounds, most walks of a piece, longest speculative
    walk])."""
    lg = 5
    while (pieces << lg) < n:
        lg += 1
    P = 1 << lg
    ends = [min(p * P + P, n) if p * P < n else 0 for p in range(pieces)]
    walk_id = [0] * n                  # 1: a speculative walk; 0: unvisited
    exits = [{} for _ in range(pieces)]
    stops = [{} for _ in range(pieces)]
    longest = 0
    for p in range(pieces):
        if ends[p]:
            e, steps = p * P, 0
            while e < ends[p]:
                walk_id[e] = 1
                e, steps = nxt[e], steps + 1
            exits[p][1] = stops[p][1] = e
            longest = max(longest, steps)

    def walk(p: int, e: int) -> int:
        k = len(exits[p]) + 1
        while e < ends[p] and walk_id[e] == 0:
            walk_id[e] = k
            e = nxt[e]
        stops[p][k] = e
        exits[p][k] = exits[p][walk_id[e]] if e < ends[p] else e
        return k

    out = [exits[p][1] if ends[p] else n for p in range(pieces)]
    entry = [0] + out[:-1]
    rounds = 0
    while True:
        rounds += 1
        for p in range(pieces):
            if entry[p] < ends[p]:
                out[p] = exits[p][walk_id[entry[p]] or walk(p, entry[p])]
            elif ends[p]:
                out[p] = entry[p]
        nxt_entry = [0] + out[:-1]
        if all(nxt_entry[p] == entry[p] for p in range(pieces) if ends[p]):
            break
        entry = nxt_entry
    marks = np.zeros(n, bool)
    for p in range(pieces):
        if not ends[p]:
            continue
        enter = {}
        f = entry[p]
        while f < ends[p]:
            k = walk_id[f]
            enter[k] = f
            f = stops[p][k]
        for x in range(p * P, ends[p]):
            marks[x] = walk_id[x] in enter and x >= enter[walk_id[x]]
    walks = max(len(e) for e in exits)
    return marks, [rounds, walks, longest]


@pytest.mark.parametrize("case", SELECT_CHAIN_CASES)
def test_select_tokens_plain_gives_the_chain_cases(case):
    check_select_chain_case(case, *select_chain_plain(case))


@pytest.mark.parametrize("case", SELECT_CHAIN_CASES)
def test_select_tokens_model_matches_plain_on_chain_cases(case):
    """The kernel's procedure gives the plain version's tokens exactly; the
    cases reach what they are there for."""
    data, matches, nv, kw = select_chain_case(case)
    tv, td, count, stats = select_tokens_model(data, matches, nv, **kw)
    want = select_chain_plain(case)
    for got, w in zip((tv, td, count), want):
        assert np.array_equal(got, w)
    rounds, walks, longest = stats.max(0)
    if case.startswith("chains_never_merge"):
        # entries settle one piece a round; a piece walks each of the three
        # residues once, and later entries find them visited
        assert rounds == 31 and walks == 3
    elif case == "literals_16384":
        assert rounds == 1 and longest == 512
    elif case == "random_small_pieces":
        assert walks >= 3


def test_select_tokens_model_on_random_lanes():
    """Random lanes of 1,024, 4,096 and 300 positions, lazy and greedy."""
    rng = np.random.default_rng(7)
    for seg, lazy in ((1024, True), (4096, False), (300, True)):
        B = 3
        ml = rng.integers(0, C.MAX_MATCH + 1, (B, seg))
        ml[rng.random((B, seg)) < 0.6] = 0
        matches = ((ml << 16) | rng.integers(1, 32769, (B, seg))).astype(
            np.int32)
        data = rng.integers(0, 256, (B, seg + 8), dtype=np.uint8)
        nv = np.array([seg, seg // 3, 0], np.int32)
        got = select_tokens_model(data, matches, nv, seg, seg, lazy)[:3]
        want = lz77.select_tokens_plain(
            torch.from_numpy(data), torch.from_numpy(matches),
            torch.from_numpy(nv), seg, seg, lazy)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
# resolve_turbo

TURBO_RESOLVE_CASES = ("self_copy", "chain_into_self_copy", "byte0_match")


def _turbo_matches(case: str) -> tuple[dict[int, int], dict[int, int]]:
    """({byte: distance} of the row's matches, {byte: expected value})."""
    if case == "self_copy":
        return {1000: 0, 4095: 0, 256: 0}, {1000: 232, 4095: 255, 256: 0}
    if case == "chain_into_self_copy":
        return ({1000: 0, 1005: 5, 1010: 5, 2000: 990, 4095: 2095},
                {q: 232 for q in (1000, 1005, 1010, 2000, 4095)})
    if case == "byte0_match":
        return ({0: 7, 3: 3, 10: 4095, 300: 297},
                {0: 0, 3: 0, 10: 0, 300: 0})
    raise KeyError(case)


def turbo_resolve_case(case: str):
    """(toks, starts (16, 1, 384) int32, the row's bytes (4096,) uint8):
    slot i of a sub-span holds the token of its byte i."""
    rng = np.random.default_rng(TURBO_RESOLVE_CASES.index(case) + 60)
    want = rng.integers(1, 256, 4096).astype(np.uint8)
    matches, values = _turbo_matches(case)
    toks = np.zeros((tk.SUBS_PER_CHUNK, 1, tk.TOKENS_PAD), np.int32)
    starts = np.full(toks.shape, tk.PAD_START, np.int32)
    toks[:, 0, : tk.SUB] = want.reshape(tk.SUBS_PER_CHUNK, tk.SUB)
    starts[:, 0, : tk.SUB] = np.arange(tk.SUB)
    for q, dist in matches.items():
        toks[q // tk.SUB, 0, q % tk.SUB] = (
            3 | (dist << tk.TOK_DIST_SHIFT) | tk.TOK_MATCH_BIT)
        want[q] = values[q]
    return toks, starts, want


@pytest.mark.parametrize("case", TURBO_RESOLVE_CASES)
def test_resolve_turbo_plain_gives_the_cases_bytes(case):
    toks, starts, want = turbo_resolve_case(case)
    got = tk.resolve_turbo(torch.from_numpy(toks), torch.from_numpy(starts))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, 4096)
    assert np.array_equal(got.numpy()[0], want)


def test_resolve_turbo_plain_searches_signed_and_unsorted_starts():
    """Slot 0 with a negative start covers the bytes before slot 1; the
    bisection's probes decide the slot, not the order of the starts: with
    slot 256 at 0, every byte takes the upper half, where only the pad
    remains, so slot 256 covers the whole sub-span."""
    toks = np.zeros((tk.SUBS_PER_CHUNK, 1, tk.TOKENS_PAD), np.int32)
    starts = np.full(toks.shape, tk.PAD_START, np.int32)
    toks[:, 0, 0], starts[:, 0, 0] = 65, -40
    toks[:, 0, 1], starts[:, 0, 1] = 66, 100
    toks[1, 0, 256], starts[1, 0, 256] = 67, 0
    got = tk.resolve_turbo(torch.from_numpy(toks),
                           torch.from_numpy(starts)).numpy()[0]
    assert (got[:100] == 65).all() and (got[100:256] == 66).all()
    assert (got[256:512] == 67).all()
    assert (got[512:612] == 65).all() and (got[612:768] == 66).all()


# ---------------------------------------------------------------------------
# decode_turbo

TURBO_DECODE_CASES = ("past_window", "cut_by_T", "padded_lane")
DECODE_LANE = {"past_window": 2, "cut_by_T": 0, "padded_lane": 1}
_CUT_TOKENS = [104, (4, 2), 105, 106, 107, 108, 109]
_CUT_T = 3
# four fixed-Huffman codes of the literal 97 (0x30 + 97, 8 bits, first bit
# of the code in the lowest bit)
_WORD_OF_97 = 0x89898989
_PAST_BIT0 = 95 * 32 + 8
_PAST_COUNT = 10


def turbo_decode_case(case: str):
    """((win (4, 96), bit0 (4,), endb (4,), lt (512,), dt (512,)) int32
    arrays, T) of ``case``: its lane is ``DECODE_LANE[case]``, every other
    lane is padded."""
    lt, dt = tk.turbo_decode_tables(C.fixed_litlen_code_lengths(),
                                    C.fixed_dist_code_lengths())
    win = np.zeros((4, tk.STREAM_WORDS), np.int32)
    bit0 = np.zeros(4, np.int32)
    endb = np.zeros(4, np.int32)
    T = tk.MAX_TOKENS
    lane = DECODE_LANE[case]
    if case == "past_window":
        # word 94 differs, so only the last word can have given the tokens
        win[lane, 94] = -1
        win[lane, 95] = np.uint32(_WORD_OF_97).astype(np.int32)
        bit0[lane] = _PAST_BIT0
        endb[lane] = _PAST_BIT0 + 8 * _PAST_COUNT
    elif case == "cut_by_T":
        w, e = fixed_lane(_CUT_TOKENS, lane, lanes=4, sw=tk.STREAM_WORDS)
        win, endb = w, e
        T = _CUT_T
    elif case != "padded_lane":
        raise KeyError(case)
    return (win, bit0, endb, lt, dt), T


def check_turbo_decode_case(case: str, tokens: np.ndarray,
                            meta: np.ndarray) -> None:
    """Assert that (tokens (T, 4), meta (4, 4)) hold ``case``'s lane as the
    contract fixes it, and every other lane as a padded one."""
    lane = DECODE_LANE[case]
    match = 4 | (2 << tk.TOK_DIST_SHIFT) | tk.TOK_MATCH_BIT
    want = {
        # count, end bit, error, still active
        "past_window": ([_PAST_COUNT, _PAST_BIT0 + 8 * _PAST_COUNT, 0, 0],
                        [97] * _PAST_COUNT),
        # 8 bits, 7 + 5 bits (length 4, distance 2: no extra bits), 8 bits
        "cut_by_T": ([_CUT_T, 8 + 12 + 8, 0, 1], [104, match, 105]),
        "padded_lane": ([0, 0, 0, 0], []),
    }[case]
    assert list(meta[:, lane]) == want[0]
    assert list(tokens[: len(want[1]), lane]) == want[1]
    others = np.delete(meta, lane, axis=1)
    assert not others.any()


@pytest.mark.parametrize("case", TURBO_DECODE_CASES)
def test_decode_turbo_plain_gives_the_cases_tokens(case):
    args, T = turbo_decode_case(case)
    tokens, meta = tk.decode_turbo(*(torch.from_numpy(a) for a in args), T)
    assert tuple(tokens.shape) == (T, 4) and tuple(meta.shape) == (4, 4)
    check_turbo_decode_case(case, tokens.numpy(), meta.numpy())


def test_decode_turbo_plain_uncut_lane_ends_inactive():
    """The ``cut_by_T`` lane with room for all its tokens: seven tokens,
    then end-of-block moves the position to the lane's end."""
    (win, bit0, endb, lt, dt), _ = turbo_decode_case("cut_by_T")
    tokens, meta = tk.decode_turbo(*(torch.from_numpy(a) for a in
                                     (win, bit0, endb, lt, dt)))
    assert list(meta[:, 0].numpy()) == [7, int(endb[0]), 0, 0]
    assert int(endb[0]) == 8 + 12 + 5 * 8 + 7


# ---------------------------------------------------------------------------
# decode_wide

def _deep_lengths():
    """Complete codes with lengths 1, 2, ..., 14, 15, 15: litlen over a few
    literals, end-of-block, length symbols 257 (3, no extra bits) and 284
    (227-257, five extra bits); distances over symbols 0-14 and 20 (1025-
    1536, nine extra bits)."""
    ll = np.zeros(288, np.int64)
    for i, sym in enumerate([97, 256, 98, 99, 100, 101, 102, 103, 104, 105,
                             106, 107, 257, 108, 200, 284]):
        ll[sym] = min(i + 1, 15)
    dl = np.zeros(30, np.int64)
    for i, sym in enumerate([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 20,
                             14]):
        dl[sym] = min(i + 1, 15)
    return ll, dl


DEEP_LENGTHS = _deep_lengths()
WIDE_LPB = 256
WIDE_SW = 8
_M = wk.TOK_MATCH_BIT
_SH = wk.TOK_DIST_SHIFT
# case -> (lane, tokens, end bit of the lane or None for the end of its
# end-of-block, T, wanted meta column, wanted tokens, wanted starts)
_WIDE_DECODE = {
    "code_15_bits": (0, [97, 200, 98], None, wk.MAX_TOKENS,
                     [3, 1 + 15 + 3 + 2, 0, 0, 98, 2], [97, 200, 98],
                     [0, 1, 2]),
    # lane 16 starts 2 KiB into its block: a distance of 1030 is allowed
    "token_32_bits": (16, [(230, 1030), 97], None, wk.MAX_TOKENS,
                      [2, 44 + 1 + 2, 0, 0, 97, 230],
                      [230 | (1030 << _SH) | _M, 97], [0, 230]),
    # 1 + (13 + 1) + 3 + 4 bits; cut while active
    "pair_at_last_slots": (1, [97, (3, 1), 98, 99, 100, 101], None, 4,
                           [4, 22, 0, 1, 99, 5],
                           [97, 3 | (1 << _SH) | _M, 98, 99], [0, 1, 4, 5]),
    "pair_cut_by_endb": (2, [98, 99], 3 + 2, wk.MAX_TOKENS,
                         [1, 3, 1, 0, 98, 0], [98], [0]),
    "pair_ends_at_endb": (3, [98, 99], 3 + 4, wk.MAX_TOKENS,
                          [2, 7, 0, 0, 99, 1], [98, 99], [0, 1]),
    "before_block": (0, [97, (3, 2), 98], None, wk.MAX_TOKENS,
                     [1, 1, 1, 0, 97, 0], [97], [0]),
    "eob_behind_literal": (5, [97, 256, 98, 98, 98], None, wk.MAX_TOKENS,
                           [1, 1 + 2, 0, 0, 97, 0], [97], [0]),
}
WIDE_DECODE_CASES = tuple(_WIDE_DECODE)


def wide_decode_case(case: str):
    """((win (256, 8), bit0, endb, base (256,), lt (1, LL_W), dt (1, D_W))
    int32 arrays, LPB, T) of ``case``: its lane holds the case, every other
    lane is empty."""
    lane, tokens, end, T = _WIDE_DECODE[case][:4]
    win, endb = fixed_lane(tokens, lane, lanes=WIDE_LPB, sw=WIDE_SW,
                           lengths=DEEP_LENGTHS)
    if end is not None:
        endb[lane] = end
    lt, dt = wk.wide_decode_tables(*DEEP_LENGTHS)
    zero = np.zeros(WIDE_LPB, np.int32)
    return (win, zero, endb, zero.copy(), lt[None], dt[None]), WIDE_LPB, T


def check_wide_decode_case(case: str, tokens: np.ndarray, starts: np.ndarray,
                           meta: np.ndarray) -> None:
    """Assert that (tokens, starts (T, 256), meta (6, 256)) hold ``case``'s
    lane as the contract fixes it, and every other lane as an empty one."""
    lane, _, _, _, want_meta, want_tokens, want_starts = _WIDE_DECODE[case]
    assert list(meta[:, lane]) == want_meta
    n = len(want_tokens)
    assert list(tokens[:n, lane]) == want_tokens
    assert list(starts[:n, lane]) == want_starts
    assert not np.delete(meta, lane, axis=1).any()


@pytest.mark.parametrize("case", WIDE_DECODE_CASES)
def test_decode_wide_plain_gives_the_cases_tokens(case):
    args, LPB, T = wide_decode_case(case)
    tokens, starts, meta = wk.decode_wide(
        *(torch.from_numpy(a) for a in args), LPB=LPB, T=T)
    assert tuple(tokens.shape) == tuple(starts.shape) == (T, WIDE_LPB)
    assert tuple(meta.shape) == (6, WIDE_LPB)
    check_wide_decode_case(case, tokens.numpy(), starts.numpy(), meta.numpy())


def test_wide_decode_cases_hold_their_features():
    """The deep tables send 10- to 15-bit litlen codes and 7- to 15-bit
    distance codes through sub-tables, and the 44-bit token is one."""
    lt, dt = wk.wide_decode_tables(*DEEP_LENGTHS)
    assert (lt[: wk.LL_ROOT] & wk._SUB_FLAG).any()
    assert (dt[: wk.D_ROOT] & wk._SUB_FLAG).any()
    ll, dl = DEEP_LENGTHS
    assert ll[200] == ll[284] == dl[20] == 15
    i = int(C.LENGTH_TO_SYMBOL[230]) - 257
    d = int(C.DIST_TO_SYMBOL[1030])
    assert (i + 257, d) == (284, 20)
    assert (int(ll[284]) + int(C.LENGTH_EXTRA_BITS[i]) + int(dl[20])
            + int(C.DIST_EXTRA_BITS[d])) == 44


# ---------------------------------------------------------------------------
# decode_tokens
#
# One stream of lanes one after another, fixed codes (``deep``: the codes of
# 1 to 15 bits above), one lane a case; the other lanes of a call are
# inactive and keep their start bit.

_GENERIC_DECODE = {
    # case: (tokens, end bit past the lane's first bit or None = its last,
    #        T, tables, [(count, end bit, error, still active, tokens,
    #        starts) of each call: a lane still active resumes])
    "resumed": ([104, (4, 2), 105, 106, 107, 108, 109, 256], None, 3,
                "fixed",
                [(3, 28, 0, 1, [104, 4 | (2 << 9) | (1 << 25), 105],
                  [0, 1, 5]),
                 (3, 52, 0, 1, [106, 107, 108], [0, 1, 2]),
                 (1, 67, 0, 0, [109], [0])]),
    # the match's code ends one bit past the lane's end: kept out, error,
    # the position stays behind the second literal
    "past_end": ([97, 98, (10, 1), 256], 8 + 8 + 7 + 5 - 1, 64, "fixed",
                 [(2, 16, 1, 0, [97, 98], [0, 1])]),
    # no end-of-block: the lane stops where its end bit is
    "end_at_anchor": ([97, 98, 99], None, 64, "fixed",
                      [(3, 24, 0, 0, [97, 98, 99], [0, 1, 2])]),
    # the decode does not hold a distance against the output
    "far_distance": ([97, (3, 32768), 256], None, 64, "fixed",
                     [(2, 8 + 7 + 5 + 13 + 7, 0, 0,
                       [97, 3 | (32768 << 9) | (1 << 25)], [0, 1])]),
    # a length whose distance symbol is 30 (reserved): error behind the
    # literal
    "invalid_distance": ([97, "len3_dist30"], None, 64, "fixed",
                         [(1, 8, 1, 0, [97], [0])]),
    "inactive": ([97, 98, 256], None, 64, "fixed",
                 [(0, 0, 0, 0, [], [])]),
    # a 15-bit literal code and a 44-bit token through the sub-tables
    "deep_codes": ([200, (230, 1030), 97, 256], None, 64, "deep",
                   [(3, 15 + 44 + 1 + 2, 0, 0,
                     [200, 230 | (1030 << 9) | (1 << 25), 97],
                     [0, 1, 231])]),
}
GENERIC_DECODE_CASES = tuple(_GENERIC_DECODE)
GENERIC_LANES = 4
_GENERIC_LANE = 2


def _generic_lane_bits(case: str):
    """(the lane's stream bytes, its bit length): tokens then padding."""
    from test_torch_fixed_streams import write_tokens
    from zlibes_tpu_torch.spec.refmodel import BitWriter

    tokens, _, _, tables = _GENERIC_DECODE[case][:4]
    lengths = DEEP_LENGTHS if tables == "deep" else None
    bw = BitWriter()
    bw.write_bits(0b101, 3)   # the lane starts off a byte boundary
    for tok in tokens:
        if tok == "len3_dist30":
            write_tokens(bw, [257], lengths)
            bw.write_code(30, 5)   # fixed distance code of symbol 30
        else:
            write_tokens(bw, [tok], lengths)
    nbits = bw.bit_length
    return bw.getvalue() + bytes(16), nbits


def generic_decode_case(case: str):
    """((words (NW,) int32, lt (1, LL_W), dt (1, D_W), row (4,) int32,
    bit0, end_bit (4,) int64, active0 (4,) bool), T) of ``case``: lane 2
    holds it from bit 3 on, the other lanes are inactive."""
    from zlibes_tpu_torch.ops.inflate_kernel import stream_words

    raw, nbits = _generic_lane_bits(case)
    _, end, T, tables = _GENERIC_DECODE[case][:4]
    lengths = DEEP_LENGTHS if tables == "deep" else (
        C.fixed_litlen_code_lengths(), C.fixed_dist_code_lengths())
    lt, dt = wk.wide_decode_tables(*lengths)
    bit0 = np.array([5, 40, 3, 0], np.int64)
    endb = np.array([90, 41, 3 + (nbits - 3 if end is None else end), 0],
                    np.int64)
    active = np.zeros(GENERIC_LANES, bool)
    active[_GENERIC_LANE] = case != "inactive"
    row = np.zeros(GENERIC_LANES, np.int32)
    return (stream_words(raw), lt[None], dt[None], row, bit0, endb,
            active), T


def run_generic_decode_case(case: str, decode) -> None:
    """Run ``decode`` (``decode_tokens`` on a device) on ``case`` call
    after call, resuming lanes left active, and assert every call's lane as
    the contract fixes it and the other lanes as inactive ones."""
    args, T = generic_decode_case(case)
    words, lt, dt, row, bit0, endb, active = args
    for want in _GENERIC_DECODE[case][4]:
        tokens, starts, count, bitpos, still, err = (
            x.cpu().numpy() for x in decode(words, lt, dt, row, bit0, endb,
                                            active, T))
        n, end, bad, more, want_tok, want_st = want
        lane = _GENERIC_LANE
        assert [count[lane], bitpos[lane] - 3, err[lane], still[lane]] == \
            [n, end, bad, more]
        assert list(tokens[:n, lane]) == want_tok
        assert list(starts[:n, lane]) == want_st
        others = [i for i in range(GENERIC_LANES) if i != lane]
        assert not count[others].any() and not err[others].any()
        assert not still[others].any()
        assert np.array_equal(bitpos[others], np.asarray(bit0)[others])
        bit0, active = bitpos, still
    assert not active.any()


def _plain_decode(words, lt, dt, row, bit0, endb, active, T):
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    t = torch.from_numpy
    return ik.decode_tokens(t(words), t(lt), t(dt), t(row), t(bit0),
                            t(endb), t(active), T=T)


@pytest.mark.parametrize("case", GENERIC_DECODE_CASES)
def test_decode_tokens_plain_gives_the_cases_tokens(case):
    run_generic_decode_case(case, _plain_decode)


def check_decode_tokens(got, want, T: int, what: str = "") -> int:
    """``decode_tokens`` output ``got`` (on any device) against its plain
    version's ``want``: counts, end bits and flags equal, tokens and starts
    equal where emitted (the kernel leaves the other slots unwritten).
    Returns the largest absolute difference (0)."""
    dev = want[0].device
    got = [x.to(dev) for x in got]
    emitted = (torch.arange(T, device=dev)[:, None]
               < want[2][None, :].long())
    err = 0
    for name, a, b in (*zip(("count", "bitpos", "active", "err"), got[2:],
                            want[2:]),
                       *((n, a[emitted], b[emitted]) for n, a, b in
                         zip(("tokens", "starts"), got[:2], want[:2]))):
        assert torch.equal(a, b), f"decode_tokens {name} != plain {what}"
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def test_check_decode_tokens_ignores_unwritten_slots_only():
    args, T = generic_decode_case("resumed")
    want = _plain_decode(*args, T)
    got = [x.clone() for x in want]
    past = torch.arange(T)[:, None] >= want[2][None, :].long()
    assert past.any()
    got[0][past] = -7              # past each count: never written
    assert check_decode_tokens(got, want, T) == 0
    got[0][0, _GENERIC_LANE] += 1  # an emitted token
    with pytest.raises(AssertionError, match="tokens"):
        check_decode_tokens(got, want, T)


def zlib_flushed(data: bytes, every: int, level: int = 6, zdict=None,
                 mode=zlib.Z_FULL_FLUSH) -> bytes:
    """CPython zlib with a flush every ``every`` input bytes: full flushes
    make self-contained blocks (the seekable zlib files of zran-style
    readers), sync flushes empty stored blocks between chained ones."""
    co = (zlib.compressobj(level, zdict=zdict) if zdict
          else zlib.compressobj(level))
    out = []
    for i in range(0, len(data), every):
        out += [co.compress(data[i : i + every]), co.flush(mode)]
    return b"".join(out) + co.flush()


# ---------------------------------------------------------------------------
# resolve_global
#
# Lanes of tokens (literal ints, (length, distance) matches) tiled from
# their first byte on, behind a seeded prefix; the bytes they must give by
# the modular rule (a byte of a copy reads start - dist + (q - start) %
# dist, a byte below the prefix's end is the prefix's).

def _generic_prefix(n: int) -> np.ndarray:
    return ((np.arange(n) * 7 + 3) % 251).astype(np.uint8)


_RUN_LANES = 64
_GENERIC_RESOLVE = {
    # case: (prefix length, first lane's first byte from the prefix's end,
    #        lanes of tokens, err)
    "prefix_reach": (32768, 0, [[(258, 32768), (10, 1), 7]], False),
    "straddle": (100, -3, [[(10, 5), 1, 2], [(6, 4)]], False),
    "below_zero": (0, 0, [[1, (4, 2)], [5]], True),
    "overlap": (0, 0, [[1, 2, 3, (20, 3)], [(5, 23), 4]], False),
    # a run of distance 1 over 64 lanes: a chain of 1,024 hops
    "dist1_run": (0, 0, [[9]] + [[(258, 1)] * 16] * _RUN_LANES, False),
}
GENERIC_RESOLVE_CASES = tuple(_GENERIC_RESOLVE)


def generic_resolve_case(case: str):
    """((tokens (T, B), starts (T, B), count (B,), out_base (B,) int32,
    total, prefix (P,) uint8), the bytes (total,), err) of ``case``."""
    P, first, lanes, err = _GENERIC_RESOLVE[case]
    T = max(len(lane) for lane in lanes)
    B = len(lanes)
    tokens = np.zeros((T, B), np.int32)
    starts = np.zeros((T, B), np.int32)
    count = np.array([len(lane) for lane in lanes], np.int32)
    out_base = np.zeros(B, np.int32)
    prefix = _generic_prefix(P)
    g = P + first
    want = np.zeros(g + sum(t[0] if isinstance(t, tuple) else 1
                            for lane in lanes for t in lane), np.int64)
    want[:P] = prefix
    for b, lane in enumerate(lanes):
        out_base[b] = g
        for t, tok in enumerate(lane):
            starts[t, b] = g - out_base[b]
            if isinstance(tok, tuple):
                n, d = tok
                tokens[t, b] = n | (d << 9) | (1 << 25)
                for q in range(max(g, P), g + n):
                    want[q] = want[max(g - d + (q - g) % d, 0)]
            else:
                tokens[t, b] = tok
                if g >= P:
                    want[g] = tok
                n = 1
            g += n
    return ((tokens, starts, count, out_base, g, prefix),
            want.astype(np.uint8), err)


def check_generic_resolve_case(case: str, out: np.ndarray,
                               err: bool) -> None:
    _, want, want_err = generic_resolve_case(case)
    assert np.array_equal(out, want)
    assert err == want_err


@pytest.mark.parametrize("case", GENERIC_RESOLVE_CASES)
def test_resolve_global_plain_gives_the_cases_bytes(case):
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    (tokens, starts, count, out_base, total, prefix), _, _ = \
        generic_resolve_case(case)
    t = torch.from_numpy
    out, err = ik.resolve_global(t(tokens), t(starts), t(count),
                                 t(out_base), total, t(prefix))
    check_generic_resolve_case(case, out.numpy(), bool(err))


def test_generic_resolve_cases_hold_their_features():
    (tokens, _, _, out_base, total, prefix), want, _ = \
        generic_resolve_case("dist1_run")
    assert total == 1 + _RUN_LANES * 16 * 258 and (want == 9).all()
    (_, _, _, out_base, _, prefix), want, _ = generic_resolve_case("straddle")
    assert out_base[0] < prefix.size < out_base[0] + 10
    (_, _, _, _, _, prefix), want, _ = generic_resolve_case("prefix_reach")
    assert np.array_equal(want[32768 : 32768 + 258], prefix[:258])


def random_generic_tokens(B: int, T: int, P: int, seed: int,
                          below: bool = False, junk: bool = False):
    """Random lanes for ``resolve_global`` that tile [P, total): (tokens,
    starts (T, B), count, out_base (B,) int32, total, prefix (P,) uint8).
    Lanes hold 0 to T tokens, half literals, half matches of 3-258 bytes at
    distances up to 32,768 that stay at or above byte 0 (``below``: also
    below it, after a literal at byte 0).  Slots at or past a lane's count
    hold 0, or random words with ``junk`` (what ``decode_tokens`` leaves
    there on the card)."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, T + 1, B).astype(np.int32)
    count[0] = max(int(count[0]), 1)
    is_match = rng.random((T, B)) < 0.5
    is_match[0, 0] = False
    lens = np.where(is_match, rng.integers(3, 259, (T, B)), 1)
    lens = np.where(np.arange(T)[:, None] < count[None, :], lens, 0)
    starts = np.cumsum(lens, axis=0) - lens
    lane_len = lens.sum(axis=0)
    out_base = P + np.cumsum(lane_len) - lane_len
    g = out_base[None, :] + starts
    reach = np.minimum(g if not below else 32768, 32768)
    dist = (rng.random((T, B)) * np.maximum(reach, 1)).astype(np.int64) + 1
    tokens = np.where(is_match, lens | (dist << 9) | (1 << 25),
                      rng.integers(0, 256, (T, B)))
    tokens = np.where(lens > 0, tokens, 0).astype(np.int32)
    starts = starts.astype(np.int32)
    prefix = rng.integers(0, 256, P).astype(np.uint8)
    if junk:
        past = np.arange(T)[:, None] >= count[None, :]
        for a in (tokens, starts):
            a[past] = rng.integers(-2**31, 2**31, int(past.sum()))
    return (tokens, starts, count, out_base.astype(np.int32),
            int(P + lane_len.sum()), prefix)


def expand_generic(tokens, starts, count, out_base, total, prefix):
    """The bytes of tiling lanes by the modular rule, one byte at a time
    (a source below 0 reads byte 0): the reference's arithmetic without
    its passes."""
    out = np.zeros(total, np.int64)
    P = prefix.size
    out[:P] = prefix
    order = sorted((int(out_base[b]) + int(starts[t, b]), int(tokens[t, b]))
                   for b in range(tokens.shape[1])
                   for t in range(int(count[b])))
    for g, tok in order:
        if not tok & (1 << 25):
            if g >= P:
                out[g] = tok & 255
            continue
        n, d = tok & 511, (tok >> 9) & 0xFFFF
        for q in range(max(g, P), g + n):
            out[q] = out[max(g - d + (q - g) % d, 0)]
    return out.astype(np.uint8)


@pytest.mark.parametrize("P,below", [(0, False), (32768, False),
                                     (0, True)])
def test_resolve_global_plain_on_random_lanes(P, below):
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    args = random_generic_tokens(33, 12, P, seed=P + below, below=below)
    out, err = ik.resolve_global(*(torch.from_numpy(a) if
                                   isinstance(a, np.ndarray) else a
                                   for a in args))
    assert np.array_equal(out.numpy(), expand_generic(*args))
    assert bool(err) == below


@pytest.mark.parametrize("P", [0, 32768])
def test_resolve_global_plain_skips_the_slots_past_each_count(P):
    """Random words past each lane's count change nothing: the bytes and
    the flag are those of the same lanes with zeros there."""
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    def run(junk):
        args = random_generic_tokens(33, 12, P, seed=P + 3, junk=junk)
        return ik.resolve_global(*(torch.from_numpy(a) if
                                   isinstance(a, np.ndarray) else a
                                   for a in args)), args

    (out, err), args = run(True)
    (clean, clean_err), clean_args = run(False)
    assert not np.array_equal(args[0], clean_args[0])
    assert torch.equal(out, clean) and bool(err) == bool(clean_err)
    assert np.array_equal(out.numpy(), expand_generic(*clean_args))


def garbage_generic_lanes(B: int, seed: int = 0):
    """B lanes over random stream words under the fixed tables and random
    complete and incomplete codes of up to 15 bits, at random start bits
    (some inactive, some ending past the stream)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, 8192, dtype=np.int64).astype(np.int32)
    rows = [(C.fixed_litlen_code_lengths(), C.fixed_dist_code_lengths())]
    for _ in range(3):
        ll = np.zeros(288, np.int64)
        ll[rng.permutation(288)[:200]] = rng.integers(7, 16, 200)
        ll[rng.permutation(288)[:6]] = rng.integers(3, 7, 6)
        dl = np.zeros(30, np.int64)
        dl[:] = rng.integers(4, 16, 30)
        rows.append((ll, dl))
    lt = np.zeros((len(rows), wk.LL_W), np.int32)
    dt = np.zeros((len(rows), wk.D_W), np.int32)
    for r, (ll, dl) in enumerate(rows):
        try:
            lt[r], dt[r] = wk.wide_decode_tables(ll, dl)
        except CorruptError:   # over-subscribed: no codes
            pass
    bit0 = rng.integers(0, 8192 * 32, B)
    t = torch.from_numpy
    return (t(words), t(lt), t(dt), t(rng.integers(0, len(rows), B)
                                      .astype(np.int32)),
            t(bit0), t(bit0 + rng.integers(0, 6000, B)),
            t(rng.random(B) < 0.9))


# ---------------------------------------------------------------------------
# decode_tokens: lanes that a walk from one-level roots takes apart
#
# Lanes one after another in one stream (bit 3 on), each under a row of its
# call's tables; a lane ends where its last token ends, less ``cut`` bits.
# What a lane must give follows from where each of its tokens ends: the
# tokens that end at or before the lane's end bit, up to its end-of-block;
# the first that ends past it is an error that leaves the position behind
# the token before.

def _random_code(rng, nsym: int, nused: int, max_len: int = 15):
    """Code lengths of a complete code (a package-merge of max_len bits)
    over ``nused`` random symbols of ``nsym``, by random frequencies."""
    freq = np.zeros(nsym, np.int64)
    freq[rng.permutation(nsym)[:nused]] = rng.integers(1, 1000, nused)
    return bt.package_merge_np(freq, max_len).astype(np.int64)


def _skewed_code(nsym: int, scale: float):
    """Code lengths over all ``nsym`` symbols by Zipf frequencies (symbol i
    of rank i has 2^20 / (i + 1)^scale): the rarest get 12- to 15-bit
    codes."""
    freq = (2.0 ** 20 / (np.arange(nsym) + 1.0) ** scale).astype(np.int64)
    return bt.package_merge_np(np.maximum(freq, 1), 15).astype(np.int64)


def _draw_tokens(rng, lengths, n: int, eob: bool):
    """``n`` tokens of literals and matches whose symbols all have codes
    under ``lengths`` (symbols drawn evenly, so rare codes come often), then
    end-of-block when ``eob``."""
    ll, dl = lengths
    lits = np.flatnonzero(ll[:256])
    lens = np.flatnonzero(ll[257:286]) + 257
    dists = np.flatnonzero(dl[:30])
    out = []
    for _ in range(n):
        if rng.random() < 0.5 or not lens.size or not dists.size:
            out.append(int(rng.choice(lits)))
            continue
        i = int(rng.choice(lens)) - 257
        d = int(rng.choice(dists))
        length = int(C.LENGTH_BASE[i]) + int(
            rng.integers(0, 1 << int(C.LENGTH_EXTRA_BITS[i])))
        dist = int(C.DIST_BASE[d]) + int(
            rng.integers(0, 1 << int(C.DIST_EXTRA_BITS[d])))
        out.append((min(length, 258), dist))
    return out + [C.END_OF_BLOCK] if eob else out


def _walk_case_spec(case: str):
    """(row code lengths, lanes as (row, tokens, cut bits), T)."""
    fixed = (C.fixed_litlen_code_lengths(), C.fixed_dist_code_lengths())
    if case == "warp_32_rows":
        rng = np.random.default_rng(90)
        rows = []
        for _ in range(32):
            ll = _random_code(rng, 286, int(rng.integers(20, 286)))
            ll[C.END_OF_BLOCK] = ll[C.END_OF_BLOCK] or 15
            rows.append((bt.package_merge_np(
                np.where(ll > 0, 2 ** (15 - np.minimum(ll, 15)), 0), 15
            ).astype(np.int64), _random_code(rng, 30, int(rng.integers(2, 30)))))
        return rows, [(r, _draw_tokens(rng, rows[r], 40, eob=r % 2 == 0), 0)
                      for r in range(32)], 64
    if case == "long_codes":
        rng = np.random.default_rng(91)
        ll = _skewed_code(286, 2.0)
        dl = _skewed_code(30, 3.0)   # symbols 28, 29 (13 extra bits) rarest
        return [(ll, dl)], [(0, _draw_tokens(rng, (ll, dl), 150, eob=k == 3),
                             0) for k in range(4)], 256
    if case == "lane_ends":
        # two literals ending at the end bit and one bit past it, a match
        # ending at it, a 44-bit token ending at it and one bit past it
        return [fixed, DEEP_LENGTHS], [
            (0, [97, 98], 0), (0, [97, 98], 1), (0, [97, (10, 5)], 0),
            (1, [97, (230, 1030)], 0), (1, [97, (230, 1030)], 1),
            (0, [97, 98, 99], 2)], 64
    if case == "scan_lane":
        # one lane of more tokens than a scan call takes (65,536)
        rng = np.random.default_rng(93)
        toks = [int(t) for t in rng.integers(0, 256, 65800)]
        for i in rng.integers(1, 65800, 6000):
            toks[int(i)] = (int(rng.integers(3, 259)),
                            int(rng.integers(1, 32769)))
        return [fixed], [(0, toks + [C.END_OF_BLOCK], 0)], 65536
    raise KeyError(case)


WALK_CASES = ("warp_32_rows", "long_codes", "lane_ends", "scan_lane")


def _token_bits(tok, lengths) -> int:
    """Bits of a literal, end-of-block or (length, distance) token."""
    ll, dl = lengths
    if isinstance(tok, int):
        return int(ll[tok])
    s = int(C.LENGTH_TO_SYMBOL[tok[0]])
    d = int(C.DIST_TO_SYMBOL[tok[1]])
    return (int(ll[s]) + int(C.LENGTH_EXTRA_BITS[s - 257]) + int(dl[d])
            + int(C.DIST_EXTRA_BITS[d]))


@functools.cache
def walk_case(case: str):
    """((words (NW,) int32, lt (NB, LL_W), dt (NB, D_W), rows (B,) int32,
    bit0, end_bit (B,) int64, active0 (B,) bool), T, the tokens each lane
    must give (packed), the end bit and error flag each must end with) of
    ``case`` (cached: callers do not write to the arrays)."""
    from test_torch_fixed_streams import write_tokens
    from zlibes_tpu_torch.ops.inflate_kernel import stream_words
    from zlibes_tpu_torch.spec.refmodel import BitWriter

    rows, lanes, T = _walk_case_spec(case)
    lt = np.zeros((len(rows), wk.LL_W), np.int32)
    dt = np.zeros((len(rows), wk.D_W), np.int32)
    for r, lengths in enumerate(rows):
        lt[r], dt[r] = wk.wide_decode_tables(*lengths)
    bw = BitWriter()
    bw.write_bits(0b101, 3)
    bit0, endb, want = [], [], []
    for r, toks, cut in lanes:
        bit0.append(bw.bit_length)
        write_tokens(bw, toks, rows[r])
        ends = bit0[-1] + np.cumsum([_token_bits(tok, rows[r])
                                     for tok in toks])
        assert ends[-1] == bw.bit_length
        end = int(ends[-1]) - cut
        got, pos, err = [], bit0[-1], False
        for tok, e in zip(toks, ends):
            if e > end:
                err = True
                break
            pos = int(e)
            if tok == C.END_OF_BLOCK:
                break
            got.append(tok if isinstance(tok, int) else
                       tok[0] | (tok[1] << 9) | (1 << 25))
        endb.append(end)
        want.append((got, pos, err))
    B = len(lanes)
    args = (stream_words(bw.getvalue() + bytes(16)), lt, dt,
            np.array([r for r, _, _ in lanes], np.int32),
            np.array(bit0, np.int64), np.array(endb, np.int64),
            np.ones(B, bool))
    return args, T, want


def run_walk_case(case: str, decode) -> list:
    """Run ``decode`` (``decode_tokens`` on numpy arguments and ``T``, any
    device) on ``case``, resuming lanes left active until none is, and
    assert each lane's tokens, starts, end bit and error flag.  Returns the
    calls' outputs as numpy arrays."""
    args, T, want = walk_case(case)
    words, lt, dt, rows, bit0, endb, active = args
    B = bit0.size
    got = [[] for _ in range(B)]
    calls = []
    err = np.zeros(B, bool)
    while active.any():
        out = [x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
               for x in decode(words, lt, dt, rows, bit0, endb, active, T)]
        tokens, starts, count, bitpos, still, bad = out
        for b in range(B):
            n = int(count[b])
            lens = np.where(tokens[:n, b] & (1 << 25), tokens[:n, b] & 511, 1)
            assert np.array_equal(starts[:n, b], np.cumsum(lens) - lens)
            got[b] += tokens[:n, b].tolist()
        assert not (still & bad).any()
        err |= bad
        calls.append(out)
        bit0, active = bitpos, still
    for b, (toks, pos, e) in enumerate(want):
        assert got[b] == toks, f"lane {b}"
        assert (int(bit0[b]), bool(err[b])) == (pos, e), f"lane {b}"
    return calls


def test_walk_cases_hold_their_features():
    """``warp_32_rows`` is one warp over 32 distinct rows; ``long_codes``
    has literals of 12- to 15-bit codes, distances with 13 extra bits and
    tokens of 32 bits and more; ``lane_ends`` ends lanes on and one bit
    before a token's end, behind a pair of literals, a match and a 44-bit
    token; ``scan_lane`` is one lane of more than 65,536 tokens."""
    args, T, want = walk_case("warp_32_rows")
    rows = args[3]
    assert rows.size == 32 and np.unique(rows).size == 32
    assert np.unique(args[1], axis=0).shape[0] == 32
    assert all(toks and not e for toks, _, e in want)
    ll, dl = _walk_case_spec("long_codes")[0][0]
    toks = [t for _, ts, _ in _walk_case_spec("long_codes")[1] for t in ts]
    assert {12, 13, 14, 15} <= {int(ll[t]) for t in toks
                                if isinstance(t, int) and t < 256}
    assert any(not isinstance(t, int) and t[1] > 16384 for t in toks)
    assert max(_token_bits(t, (ll, dl)) for t in toks) >= 32
    _, _, want = walk_case("lane_ends")
    assert [(len(t), e) for t, _, e in want] == [
        (2, False), (1, True), (2, False), (2, False), (1, True), (2, True)]
    _, T, want = walk_case("scan_lane")
    assert len(want) == 1 and len(want[0][0]) > T == 65536


def _plain_walk(words, lt, dt, rows, bit0, endb, active, T):
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    t = torch.from_numpy
    return ik.decode_tokens(t(words), t(lt), t(dt), t(rows),
                            t(np.asarray(bit0)), t(endb),
                            t(np.asarray(active)), T=T)


@pytest.mark.parametrize("case", WALK_CASES)
def test_decode_tokens_plain_gives_the_walk_cases(case):
    calls = run_walk_case(case, _plain_walk)
    if case == "scan_lane":
        assert len(calls) == 2 and int(calls[0][2][0]) == 65536


# ---------------------------------------------------------------------------
# resolve_global: spans that a tiled resolve takes apart
#
# Lanes of tokens (as for the cases above), each case's bytes computed
# token by token:
#
#   * ``megabyte_run``    a literal, then a distance-1 run over 16 lanes:
#     1,052,641 bytes, a chain that crosses 257 tiles of 4 KiB;
#   * ``tiles_and_lanes`` 64 random lanes of 300-2,000 bytes behind a
#     32 KiB prefix: copies that cross tile and lane boundaries and reach
#     the prefix;
#   * ``overlapping``     copies of distance 1-9 over 100-258 bytes, at
#     tile boundaries too;
#   * ``scan_window``     one lane, shape (n, 1), of 1,050,000 tokens behind
#     a 32 KiB prefix, as the scan's resolve passes a window.

RESOLVE_SPAN_CASES = ("megabyte_run", "tiles_and_lanes", "overlapping",
                      "scan_window")


def _span_lanes(case: str):
    """(prefix length, lanes of tokens)."""
    if case == "megabyte_run":
        return 0, [[65] + [(258, 1)] * 255] + [[(258, 1)] * 255] * 15
    rng = np.random.default_rng(RESOLVE_SPAN_CASES.index(case) + 70)
    if case == "tiles_and_lanes":
        lanes, g = [], 32768
        for _ in range(64):
            lane, n = [], 0
            target = int(rng.integers(300, 2000))
            while n < target:
                if rng.random() < 0.3:
                    lane.append(int(rng.integers(0, 256)))
                    n += 1
                else:
                    ln = int(rng.integers(3, 259))
                    lane.append((ln, int(rng.integers(1, min(g + n, 32768)
                                                      + 1))))
                    n += ln
            lanes.append(lane)
            g += n
        return 32768, lanes
    if case == "overlapping":
        lanes = []
        for _ in range(16):
            lane = [int(x) for x in rng.integers(0, 256, 12)]
            for _ in range(12):
                lane.append((int(rng.integers(100, 259)),
                             int(rng.integers(1, 10))))
                lane.append(int(rng.integers(0, 256)))
            lanes.append(lane)
        return 0, lanes
    if case == "scan_window":
        n = 1_050_000
        kind = rng.random(n) < 0.8
        toks = np.where(kind, rng.integers(0, 256, n),
                        rng.integers(3, 31, n)
                        | (rng.integers(1, 32769, n) << 9) | (1 << 25))
        return 32768, [toks.tolist()]
    raise KeyError(case)


def _expand_lanes(prefix: np.ndarray, lanes) -> np.ndarray:
    """The bytes of packed or (length, distance) tokens one after another
    behind ``prefix``."""
    out = bytearray(prefix.tobytes())
    for lane in lanes:
        for tok in lane:
            if not isinstance(tok, tuple):
                if not tok & (1 << 25):
                    out.append(tok & 255)
                    continue
                tok = (tok & 511, (tok >> 9) & 0xFFFF)
            n, d = tok
            src = len(out) - d
            if d >= n:
                out += out[src : src + n]
            else:
                out += (out[src:] * (n // d + 1))[:n]
    return np.frombuffer(bytes(out), np.uint8)


@functools.cache
def span_case(case: str):
    """((tokens (T, B), starts (T, B), count (B,), out_base (B,) int32,
    total, prefix (P,) uint8), the bytes (total,)) of ``case`` (cached:
    callers do not write to the arrays)."""
    P, lanes = _span_lanes(case)
    T, B = max(len(lane) for lane in lanes), len(lanes)
    tokens = np.zeros((T, B), np.int32)
    starts = np.zeros((T, B), np.int32)
    count = np.array([len(lane) for lane in lanes], np.int32)
    out_base = np.zeros(B, np.int32)
    g = P
    for b, lane in enumerate(lanes):
        packed = np.array([t if not isinstance(t, tuple) else
                           t[0] | (t[1] << 9) | (1 << 25) for t in lane],
                          np.int64)
        lens = np.where(packed & (1 << 25), packed & 511, 1)
        tokens[: len(lane), b] = packed
        starts[: len(lane), b] = np.cumsum(lens) - lens
        out_base[b] = g
        g += int(lens.sum())
    prefix = _generic_prefix(P)
    want = _expand_lanes(prefix, lanes)
    assert want.size == g
    return (tokens, starts, count, out_base, g, prefix), want


def test_span_cases_hold_their_features():
    (_, _, _, _, total, _), want = span_case("megabyte_run")
    assert total >= 1 << 20 and (want == 65).all()
    (tokens, starts, count, out_base, total, P), _ = span_case(
        "tiles_and_lanes")
    g = out_base[None, :] + starts
    ln = np.where(tokens & (1 << 25), tokens & 511, 1)
    d = (tokens >> 9) & 0xFFFF
    valid = np.arange(tokens.shape[0])[:, None] < count[None, :]
    ism = valid & ((tokens & (1 << 25)) != 0)
    assert (ism & (g // 4096 != (g + ln - 1) // 4096)).any()  # over an edge
    assert (ism & (g - d < out_base[None, :])).any()      # from a lane before
    assert (ism & (g - d < P.size)).any()                  # from the prefix
    assert (np.diff(out_base) < 4096).all()                # lanes in a tile
    (tokens, _, count, _, _, _), _ = span_case("overlapping")
    ism = (tokens & (1 << 25)) != 0
    assert (ism & (((tokens >> 9) & 0xFFFF) < (tokens & 511))).sum() > 100
    (tokens, _, count, out_base, total, P), _ = span_case("scan_window")
    assert tokens.shape[1] == 1 and count[0] >= 1_000_000
    assert P.size == 32768 and total < P.size + (9 << 19)  # ~4 MiB window


@pytest.mark.parametrize("case", RESOLVE_SPAN_CASES)
def test_resolve_global_plain_gives_the_span_cases(case):
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    args, want = span_case(case)
    out, err = ik.resolve_global(*(torch.from_numpy(a) if
                                   isinstance(a, np.ndarray) else a
                                   for a in args))
    assert not bool(err)
    assert np.array_equal(out.numpy(), want)
