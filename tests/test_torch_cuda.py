"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs a CUDA card and ``nvcc``; skips elsewhere.  Imports no JAX and
nothing of ``zlibes_tpu``, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import collections
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlibes_tpu_torch
from zlibes_tpu_torch import StreamIndex
from zlibes_tpu_torch.bench_corpus import bench_data
from zlibes_tpu_torch.codec import turbo as tb
from zlibes_tpu_torch.codec import wide as wd
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.ops import wide_kernel as wk
from zlibes_tpu_torch.spec import constants as C
import block_tables_cases as bt_cases
import test_torch_wide_lanes as wl
from test_torch_contract_cases import (SELECT_CHAIN_CASES,
                                       check_decode_tokens, zlib_flushed)
from test_torch_fixed_streams import expand, fixed_lane, fixed_stream

torch.set_num_threads(2)

# the condition is a string, so it is evaluated when each test is set up
pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def fixture_stream():
    comp = (GOLDEN / "turbo_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "turbo_bench.idx.npz")
    return comp, index


@pytest.fixture(scope="module")
def plans(fixture_stream):
    comp, index = fixture_stream
    return (tb.TurboPlan.build(comp, index, "cpu"),
            tb.TurboPlan.build(comp, index, "cuda"))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu(), b.cpu())


def test_lane_windows_kernel_matches_plain(plans):
    _, p = plans
    got = tk.lane_windows(p.words, p.start_w)
    torch.cuda.synchronize()
    assert _same(got, tk.lane_windows_plain(p.words, p.start_w))
    # starts past the end of the stream read zeros
    tail = torch.tensor([p.words.numel() - 3, p.words.numel() + 5],
                        dtype=torch.int32, device="cuda")
    assert _same(tk.lane_windows(p.words, tail),
                 tk.lane_windows_plain(p.words, tail))


def _decode_both(win, bit0, endb, lt, dt, T=tk.MAX_TOKENS):
    tok_k, meta_k = tk.decode_turbo(win, bit0, endb, lt, dt, T)
    torch.cuda.synchronize()
    tok_p, meta_p = tk.decode_turbo_plain(win, bit0, endb, lt, dt, T)
    assert tuple(tok_k.shape) == (T, win.shape[0])
    assert _same(meta_k, meta_p)
    emitted = (torch.arange(tok_k.shape[0], device=win.device)[:, None]
               < meta_p[0][None, :])
    assert _same(tok_k[emitted], tok_p[emitted])
    return meta_p


def test_decode_kernel_matches_plain(plans):
    _, p = plans
    win = tk.lane_windows(p.words, p.start_w)
    meta = _decode_both(win, p.bit0, p.endb, p.lt, p.dt)
    p.check_meta(meta.cpu().numpy())


def _stream_tail_lanes(p, width):
    """Lanes whose windows leave the stream: (start_w, bit0, endb) int32 on
    the card, first words before the stream's start, around its end and
    past it."""
    nw = p.words.numel()
    start_w = torch.tensor([-5, -width - 3, nw - 3, nw - width + 1, nw,
                            nw + 7, 0], dtype=torch.int32, device="cuda")
    bit0 = torch.arange(start_w.numel(), dtype=torch.int32, device="cuda")
    endb = bit0 + (width - 4) * 32
    return start_w, bit0, endb


def test_decode_kernel_stages_its_windows_from_the_stream(plans):
    """``decode_turbo((words, start_w), ...)`` equals the plain decode of
    the plain windows: on the fixture, and on lanes whose windows leave the
    stream at either end (zeros there)."""
    _, p = plans
    tok_k, meta_k = tk.decode_turbo((p.words, p.start_w), p.bit0, p.endb,
                                    p.lt, p.dt)
    torch.cuda.synchronize()
    win = tk.lane_windows_plain(p.words, p.start_w)
    tok_p, meta_p = tk.decode_turbo_plain(win, p.bit0, p.endb, p.lt, p.dt)
    assert _same(meta_k, meta_p)
    emitted = (torch.arange(tok_k.shape[0], device="cuda")[:, None]
               < meta_p[0][None, :])
    assert _same(tok_k[emitted], tok_p[emitted])
    p.check_meta(meta_k.cpu().numpy())
    start_w, bit0, endb = _stream_tail_lanes(p, tk.STREAM_WORDS)
    tok_k, meta_k = tk.decode_turbo((p.words, start_w), bit0, endb, p.lt,
                                    p.dt)
    torch.cuda.synchronize()
    win = tk.lane_windows_plain(p.words, start_w)
    assert not win[4:6].any() and win[0, 5:].any()
    tok_p, meta_p = tk.decode_turbo_plain(win, bit0, endb, p.lt, p.dt)
    assert _same(meta_k, meta_p)
    emitted = (torch.arange(tok_k.shape[0], device="cuda")[:, None]
               < meta_p[0][None, :])
    assert _same(tok_k[emitted], tok_p[emitted])


def garbage_lanes(L: int, seed: int = 0):
    """Random windows with random spans: (win (L, 96), bit0, endb) int32 on
    the CPU."""
    g = torch.Generator().manual_seed(seed)
    win = torch.randint(-2**31, 2**31 - 1, (L, tk.STREAM_WORDS),
                        generator=g, dtype=torch.int64).int()
    bit0 = torch.randint(0, 32, (L,), generator=g, dtype=torch.int32)
    endb = bit0 + torch.randint(0, 92 * 32 - 31, (L,), generator=g,
                                dtype=torch.int32)
    return win, bit0, endb


def test_decode_kernel_matches_plain_on_garbage(plans):
    """Random windows: error, end-of-block and overrun paths agree too."""
    _, p = plans
    win, bit0, endb = garbage_lanes(4096)
    meta = _decode_both(win.cuda(), bit0.cuda(), endb.cuda(), p.lt, p.dt)
    assert meta[2].any() and (meta[2] == 0).any()


@pytest.mark.parametrize("L", [1, 33, 4097])
def test_decode_kernel_matches_plain_where_no_block_is_full(plans, L):
    """Lane counts that fill no whole block of the kernel: the fixture's
    first lanes, then garbage lanes."""
    _, p = plans
    win = tk.lane_windows(p.words, p.start_w)[:L].contiguous()
    meta = _decode_both(win, p.bit0[:L].contiguous(),
                        p.endb[:L].contiguous(), p.lt, p.dt)
    assert not meta[2].any() and not meta[3].any()
    gwin, bit0, endb = garbage_lanes(L, seed=L)
    _decode_both(gwin.cuda(), bit0.cuda(), endb.cuda(), p.lt, p.dt)


def test_decode_kernel_matches_plain_when_cut_by_T(plans):
    """T = 64: lanes with more tokens stop there, still active, with their
    position after the 64th token."""
    _, p = plans
    win = tk.lane_windows(p.words, p.start_w)
    full = tk.decode_turbo_plain(win, p.bit0, p.endb, p.lt, p.dt)[1]
    meta = _decode_both(win, p.bit0, p.endb, p.lt, p.dt, T=64)
    cut = full[0] > 64
    assert cut.any() and not cut.all()
    assert (meta[3][cut] == 1).all() and (meta[0][cut] == 64).all()
    assert (meta[3][~cut] == 0).all() and _same(meta[:, ~cut], full[:, ~cut])
    gwin, bit0, endb = garbage_lanes(4096)
    _decode_both(gwin.cuda(), bit0.cuda(), endb.cuda(), p.lt, p.dt, T=64)


def test_decode_kernel_padded_lanes_are_empty(plans):
    """A lane with bit0 == endb == 0 gives count 0, end bit 0, no error."""
    _, p = plans
    win = torch.zeros((40, tk.STREAM_WORDS), dtype=torch.int32, device="cuda")
    zero = torch.zeros(40, dtype=torch.int32, device="cuda")
    meta = _decode_both(win, zero, zero, p.lt, p.dt)
    assert not meta.any()


def test_resolve_kernel_matches_plain(plans):
    _, p = plans
    win = tk.lane_windows(p.words, p.start_w)
    tokens, meta = tk.decode_turbo(win, p.bit0, p.endb, p.lt, p.dt)
    toks16, starts16 = tb._glue_tokens(tokens, meta[0], p.base, p.C_pad)
    got = tk.resolve_turbo(toks16, starts16)
    torch.cuda.synchronize()
    assert _same(got, tk.resolve_turbo_plain(toks16, starts16))
    # one chunk row alone
    one = tk.resolve_turbo(toks16[:, 5:6].contiguous(),
                           starts16[:, 5:6].contiguous())
    torch.cuda.synchronize()
    assert _same(one, got[5:6])


def garbage_chunks(C_rows: int, seed: int = 1):
    """Random tokens, a tenth of them matches of distance 0 (self-copies),
    under random unsorted starts, negative ones among them: (toks, starts)
    (16, C_rows, 384) int32 on the CPU."""
    g = torch.Generator().manual_seed(seed)
    shape = (tk.SUBS_PER_CHUNK, C_rows, tk.TOKENS_PAD)
    toks = torch.randint(0, 1 << 22, shape, generator=g, dtype=torch.int32)
    self_copy = torch.rand(shape, generator=g) < 0.1
    keep = ~(tk.TOK_DIST_MASK << tk.TOK_DIST_SHIFT)
    toks = torch.where(self_copy, (toks & keep) | tk.TOK_MATCH_BIT, toks)
    starts = torch.randint(-300, 2100, shape, generator=g, dtype=torch.int32)
    return toks, starts


@pytest.mark.parametrize("C_rows", [1, 32, 133])
def test_resolve_kernel_matches_plain_on_garbage(C_rows):
    toks, starts = garbage_chunks(C_rows)
    match = (toks & tk.TOK_MATCH_BIT) != 0
    dist = (toks >> tk.TOK_DIST_SHIFT) & tk.TOK_DIST_MASK
    assert (match & (dist == 0)).any() and (starts < 0).any()
    assert (starts[..., 1:] < starts[..., :-1]).any()      # unsorted
    got = tk.resolve_turbo(toks.cuda(), starts.cuda())
    torch.cuda.synchronize()
    assert _same(got, tk.resolve_turbo_plain(toks, starts))


@pytest.mark.parametrize("case", ["self_copy", "chain_into_self_copy",
                                  "byte0_match"])
def test_resolve_kernel_gives_the_contract_cases(case):
    from test_torch_contract_cases import turbo_resolve_case

    toks, starts, want = turbo_resolve_case(case)
    got = tk.resolve_turbo(torch.from_numpy(toks).cuda(),
                           torch.from_numpy(starts).cuda())
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy()[0], want)


@pytest.mark.parametrize("case", ["past_window", "cut_by_T", "padded_lane"])
def test_decode_kernel_gives_the_contract_cases(case):
    from test_torch_contract_cases import check_turbo_decode_case, \
        turbo_decode_case

    args, T = turbo_decode_case(case)
    tokens, meta = tk.decode_turbo(*(torch.from_numpy(a).cuda()
                                     for a in args), T)
    torch.cuda.synchronize()
    check_turbo_decode_case(case, tokens.cpu().numpy(), meta.cpu().numpy())


def test_inflate_on_card_counts_launches(fixture_stream):
    comp, index = fixture_stream
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.inflate(comp, index=index, device="cuda")
    assert out == zlib.decompress(comp)
    assert dict(tk.LAUNCHES) == {"decode_turbo": 1, "resolve_turbo": 1}


def test_wrapper_rejects_mixed_devices(plans):
    cpu, p = plans
    with pytest.raises(ValueError, match="expected cuda"):
        tk.lane_windows(p.words, cpu.start_w)


def test_cuda_tensor_never_takes_plain(plans, monkeypatch):
    """With the library unloadable, a CUDA tensor raises instead of
    falling back to the plain version."""
    from zlibes_tpu_torch.runtime import kernels

    _, p = plans

    def broken():
        raise RuntimeError("no library")

    monkeypatch.setattr(kernels, "library", broken)
    with pytest.raises(RuntimeError, match="no library"):
        tk.lane_windows(p.words, p.start_w)


# ---------------------------------------------------------------------------
# wide (default-profile) kernels, on the committed level-6 fixture

@pytest.fixture(scope="module")
def wide_stream():
    comp = (GOLDEN / "wide_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "wide_bench.idx.npz")
    return comp, index, zlib.decompress(comp)


@pytest.fixture(scope="module")
def wide_plan(wide_stream):
    comp, index, _ = wide_stream
    return wd.WidePlan.build(comp, index, "cuda")


def test_lane_windows_kernel_matches_plain_at_wide_width(wide_plan):
    p = wide_plan
    got = tk.lane_windows(p.words, p.start_w, width=p.SW)
    torch.cuda.synchronize()
    assert got.shape == (p.Cb * p.LPB, p.SW)
    assert _same(got, tk.lane_windows_plain(p.words, p.start_w, p.SW))


def _decode_wide_both(win, bit0, endb, base, lt, dt, LPB,
                      T=wk.MAX_TOKENS):
    tok_k, st_k, meta_k = wk.decode_wide(win, bit0, endb, base, lt, dt,
                                         LPB=LPB, T=T)
    torch.cuda.synchronize()
    tok_p, st_p, meta_p = wk.decode_wide_plain(win, bit0, endb, base, lt, dt,
                                               LPB, T)
    assert tuple(tok_k.shape) == tuple(st_k.shape) == (T, win.shape[0])
    assert _same(meta_k, meta_p)
    emitted = (torch.arange(tok_k.shape[0], device=win.device)[:, None]
               < meta_p[0][None, :])
    assert _same(tok_k[emitted], tok_p[emitted])
    assert _same(st_k[emitted], st_p[emitted])
    return tok_k, st_k, meta_k


def test_decode_wide_kernel_matches_plain(wide_plan):
    p = wide_plan
    win = tk.lane_windows(p.words, p.start_w, width=p.SW)
    _, _, meta = _decode_wide_both(win, p.bit0, p.endb, p.base, p.lt, p.dt,
                                   p.LPB)
    p.check_meta(meta.cpu().numpy())


def test_decode_wide_kernel_stages_its_windows_from_the_stream(wide_plan):
    """``decode_wide((words, start_w), ..., SW=)`` equals the plain decode
    of the plain windows: on the fixture, and on a row of lanes whose
    windows leave the stream at either end (zeros there)."""
    p = wide_plan
    tok_k, st_k, meta_k = wk.decode_wide((p.words, p.start_w), p.bit0,
                                         p.endb, p.base, p.lt, p.dt,
                                         LPB=p.LPB, SW=p.SW)
    torch.cuda.synchronize()
    win = tk.lane_windows_plain(p.words, p.start_w, p.SW)
    tok_p, st_p, meta_p = wk.decode_wide_plain(win, p.bit0, p.endb, p.base,
                                               p.lt, p.dt, p.LPB)
    assert _same(meta_k, meta_p)
    emitted = (torch.arange(tok_k.shape[0], device="cuda")[:, None]
               < meta_p[0][None, :])
    assert _same(tok_k[emitted], tok_p[emitted])
    assert _same(st_k[emitted], st_p[emitted])
    p.check_meta(meta_k.cpu().numpy())
    some, bit0, endb = _stream_tail_lanes(p, p.SW)
    start_w = torch.zeros(128, dtype=torch.int32, device="cuda")
    start_w[: some.numel()] = some
    zero = torch.zeros_like(start_w)
    b0, eb = zero.clone(), zero.clone()
    b0[: some.numel()], eb[: some.numel()] = bit0, endb
    tok_k, st_k, meta_k = wk.decode_wide((p.words, start_w), b0, eb, zero,
                                         p.lt[:1], p.dt[:1], LPB=128,
                                         SW=p.SW)
    torch.cuda.synchronize()
    win = tk.lane_windows_plain(p.words, start_w, p.SW)
    tok_p, st_p, meta_p = wk.decode_wide_plain(win, b0, eb, zero, p.lt[:1],
                                               p.dt[:1], 128)
    assert _same(meta_k, meta_p)
    emitted = (torch.arange(tok_k.shape[0], device="cuda")[:, None]
               < meta_p[0][None, :])
    assert _same(tok_k[emitted], tok_p[emitted])
    assert _same(st_k[emitted], st_p[emitted])


def garbage_wide_lanes(Cb: int, LPB: int = 128, SW: int = 40, seed: int = 0):
    """Random windows with random spans and first offsets: (win (Cb * LPB,
    SW), bit0, endb, base) int32 on the CPU."""
    g = torch.Generator().manual_seed(seed)
    L = Cb * LPB
    win = torch.randint(-2**31, 2**31 - 1, (L, SW), generator=g,
                        dtype=torch.int64).int()
    bit0 = torch.randint(0, 32, (L,), generator=g, dtype=torch.int32)
    endb = bit0 + torch.randint(0, (SW - 3) * 32, (L,), generator=g,
                                dtype=torch.int32)
    base = torch.randint(0, 300, (L,), generator=g, dtype=torch.int32)
    return win, bit0, endb, base


@pytest.mark.parametrize("T", [wk.MAX_TOKENS, 5])
def test_decode_wide_kernel_matches_plain_on_garbage(wide_plan, T):
    """Random windows under the fixture's tables: error, end-of-block,
    distance and overrun paths agree too, with room for every token and
    with ``T`` cut to 5."""
    p = wide_plan
    lanes = garbage_wide_lanes(p.Cb)
    _, _, meta = _decode_wide_both(*(t.cuda() for t in lanes), p.lt, p.dt,
                                   128, T)
    assert meta[2].any() and (meta[2] == 0).any()
    assert T != 5 or meta[3].any()


def test_decode_wide_kernel_matches_plain_on_garbage_under_deep_tables():
    """Random bits under complete codes of 1 to 15 bits: most tokens pass
    the kernel's one-level roots."""
    import test_torch_contract_cases as cases

    lt, dt = (torch.from_numpy(x[None]).cuda()
              for x in wk.wide_decode_tables(*cases.DEEP_LENGTHS))
    win, bit0, endb, base = garbage_wide_lanes(1, LPB=1024, seed=7)
    # far into the block, so that long distances are allowed there
    _, _, meta = _decode_wide_both(win.cuda(), bit0.cuda(), endb.cuda(),
                                   (base + 400).cuda(), lt, dt, 1024)
    assert (meta[0] > 8).any()


def test_decode_wide_kernel_matches_plain_when_cut_by_T(wide_plan):
    """The fixture at T = 16: lanes with more tokens stop there, still
    active."""
    p = wide_plan
    win = tk.lane_windows(p.words, p.start_w, width=p.SW)
    _, _, meta = _decode_wide_both(win, p.bit0, p.endb, p.base, p.lt, p.dt,
                                   p.LPB, T=16)
    assert meta[3].any() and not meta[3].all() and not meta[2].any()
    assert (meta[0][meta[3] == 1] == 16).all()


@pytest.mark.parametrize("case", ["code_15_bits", "token_32_bits",
                                  "pair_at_last_slots", "pair_cut_by_endb",
                                  "pair_ends_at_endb", "before_block",
                                  "eob_behind_literal"])
def test_decode_wide_kernel_gives_the_contract_cases(case):
    from test_torch_contract_cases import check_wide_decode_case, \
        wide_decode_case

    args, LPB, T = wide_decode_case(case)
    tokens, starts, meta = wk.decode_wide(
        *(torch.from_numpy(a).cuda() for a in args), LPB=LPB, T=T)
    torch.cuda.synchronize()
    check_wide_decode_case(case, tokens.cpu().numpy(), starts.cpu().numpy(),
                           meta.cpu().numpy())


@pytest.mark.parametrize("tokens,m,ok", [([(3, 1)], 0, False),
                                         ([97, (3, 1)], 0, True),
                                         ([(3, 129)], 1, False),
                                         ([(3, 128)], 1, True)])
def test_decode_wide_kernel_flags_distance_before_block_start(tokens, m, ok):
    win, endb = fixed_lane(tokens, m)
    lt, dt = (torch.from_numpy(x[None]).cuda() for x in wk.wide_decode_tables(
        C.fixed_litlen_code_lengths(), C.fixed_dist_code_lengths()))
    zero = torch.zeros(win.shape[0], dtype=torch.int32, device="cuda")
    _, _, meta = _decode_wide_both(torch.from_numpy(win).cuda(), zero,
                                   torch.from_numpy(endb).cuda(), zero, lt,
                                   dt, 128)
    assert int(meta[2, m]) == (0 if ok else 1)


def test_resolve_wide_kernel_matches_plain(wide_stream, wide_plan):
    p = wide_plan
    win = tk.lane_windows(p.words, p.start_w, width=p.SW)
    tokens, starts, meta = wk.decode_wide(win, p.bit0, p.endb, p.base, p.lt,
                                          p.dt, LPB=p.LPB)
    toks, sts = wd._glue_wide(tokens, starts, meta, p.Cb, p.LPB)
    got = wk.resolve_wide(toks, sts)
    torch.cuda.synchronize()
    assert _same(got, wk.resolve_wide_plain(toks, sts))
    assert got.reshape(-1)[: p.total_out].cpu().numpy().tobytes() == \
        wide_stream[2]


def test_resolve_wide_kernel_matches_plain_on_garbage():
    """Random tokens and unsorted starts: far sources, clipped sources and
    self-copies agree too."""
    g = torch.Generator().manual_seed(1)
    shape = (4, 96, wk.TOKENS_PAD)
    toks = torch.randint(0, 1 << 26, shape, generator=g, dtype=torch.int32)
    starts = torch.randint(-300, 2100, shape, generator=g, dtype=torch.int32)
    got = wk.resolve_wide(toks.cuda(), starts.cuda())
    torch.cuda.synchronize()
    assert _same(got, wk.resolve_wide_plain(toks, starts))


def test_wide_inflate_on_card_counts_launches(wide_stream, monkeypatch):
    """One launch of each wide kernel, none of the stand-alone window
    kernel, and no plain version runs."""
    comp, index, data = wide_stream

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((tk, "lane_windows_plain"), (wk, "wide_lanes_plain"),
                      (wk, "decode_wide_plain"), (wk, "resolve_wide_plain")):
        monkeypatch.setattr(mod, name, plain)
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.inflate(comp, index=index, device="cuda")
    assert out == data
    assert dict(tk.LAUNCHES) == {"decode_tables": 1, "wide_lanes": 1,
                                 "decode_wide": 1, "resolve_wide": 1}


def test_wide_inflate_range_and_to_device_on_card(wide_stream):
    comp, index, data = wide_stream
    for start, length in [(0, 100), (131070, 300), (400000, 80000),
                          (len(data) - 1, 1)]:
        assert zlibes_tpu_torch.inflate_range(
            comp, index, start, length, device="cuda") == \
            data[start : start + length]
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                        device="cuda")
    assert out.is_cuda and (off, n) == (0, len(data))
    assert out[:n].cpu().numpy().tobytes() == data


# ---------------------------------------------------------------------------
# the wide plan's lane spans: wide_lanes

def _wide_lanes_both(index, LPB: int = 1024):
    """``wide_lanes`` on the card against its plain version on the CPU, for
    the coded blocks of ``index``; returns the kernel's results."""
    ids = [i for i, b in enumerate(index.blocks)
           if b.btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC) and b.out_len]
    host = [torch.from_numpy(x) for x in wd.anchor_rows(index, ids)]
    got = wk.wide_lanes(*(t.cuda() for t in host), LPB)
    torch.cuda.synchronize()
    want = wk.wide_lanes_plain(*host, LPB)
    for g, w, name in zip(got, want, ("start_w", "bit0", "endb", "base",
                                      "status")):
        assert g.dtype == w.dtype == torch.int32 and _same(g, w), name
    return got


@pytest.mark.parametrize("case", ["fixture", "tiled_x9", "unsorted",
                                  *wl.FAULTS])
def test_wide_lanes_kernel_matches_plain(case):
    """The fixture, the fixture tiled nine times (270 blocks, 270,225
    anchors), its anchors out of block order, and each one-fault index."""
    comp, index = wl.fixture()
    if case == "tiled_x9":
        comp, index = wl.tile(comp, index, 9)
    elif case == "unsorted":
        index = wl.unsorted(index)
    elif case != "fixture":
        index = wl.faulty(index, case)
    status = _wide_lanes_both(index)[-1].cpu()
    # a missing or extra anchor shifts the block's later anchors by a lane
    # (the host raises on its count first), so only the others are pinned
    if case not in ("missing_anchor", "extra_anchor"):
        flagged = case in ("non_monotone_bit", "rel_below_zero",
                           "rel_past_limit")
        assert int(status[0]) == flagged


@pytest.mark.parametrize("LPB", [128, 1024])
def test_wide_lanes_kernel_matches_plain_on_random_anchors(LPB):
    """Random anchors (negative, past 2**31 bits, out of order) under
    random rows that keep first + count <= NA, some with more anchors than
    lanes: every lane value, the flag and the clamped widest end."""
    g = np.random.default_rng(LPB)
    NA, Cb = 50000, 333
    abit = g.integers(-(1 << 33), 1 << 40, NA, dtype=np.int64)
    abit[: NA // 2].sort()
    aout = g.integers(-1000, 1 << 20, NA, dtype=np.int64)
    first = g.integers(0, NA, Cb)
    count = np.minimum(g.integers(0, LPB + 50, Cb), NA - first)
    count[::7] = 0
    rows = np.stack([first, count, g.integers(0, 1 << 20, Cb),
                     g.integers(-(1 << 33), 1 << 40, Cb)], 1).astype(np.int64)
    host = [torch.from_numpy(x) for x in (abit, aout, rows)]
    got = wk.wide_lanes(*(t.cuda() for t in host), LPB)
    torch.cuda.synchronize()
    want = wk.wide_lanes_plain(*host, LPB)
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same(a, b), k
    assert want[-1].tolist() == [1, (1 << 31) - 1]


def test_wide_plan_reads_back_once_and_launches_wide_lanes_once(
        wide_stream, monkeypatch):
    """``inflate_to_device`` of the wide fixture: one ``wide_lanes`` launch,
    one ``zlibes.readback`` in the plan (the headers' and lanes' statuses
    together), no host sync once the plan is built (CUDA's sync debug mode
    raises on one), no plain version, and every lane in
    ``device_lanes``."""
    from zlibes_tpu_torch.ops import decode_tables as dtab

    comp, index, data = wide_stream

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((dtab, "decode_tables_plain"), (wk, "wide_lanes_plain"),
                      (wk, "decode_wide_plain"), (wk, "resolve_wide_plain")):
        monkeypatch.setattr(mod, name, plain)
    spans = collections.Counter()
    real_trace, real_build = wd.trace, wd.WidePlan.build
    plans = []

    def counted(name, into=None):
        spans[name] += 1
        return real_trace(name, into)

    def planned_then_no_sync(*args, **kwargs):
        plans.append(real_build(*args, **kwargs))
        assert spans["zlibes.readback"] == 1, dict(spans)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        return plans[-1]

    monkeypatch.setattr(wd, "trace", counted)
    monkeypatch.setattr(wd.WidePlan, "build",
                        staticmethod(planned_then_no_sync))
    stats = zlibes_tpu_torch.CodecStats()
    tk.LAUNCHES.clear()
    try:
        (out, off, n), = zlibes_tpu_torch.inflate_to_device(
            comp, index, device="cuda", stats=stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.cpu().numpy().tobytes() == data and (off, n) == (0, len(data))
    assert dict(tk.LAUNCHES) == {"decode_tables": 1, "wide_lanes": 1,
                                 "decode_wide": 1, "resolve_wide": 1}
    assert spans["zlibes.readback"] == 1
    p, = plans
    assert stats.device_lanes == p.Cb * p.LPB == 30 * 1024
    assert stats.device_headers == p.Cb


def test_wide_check_meta_compares_on_the_card(wide_plan):
    """``check_meta`` holds the decode's end bits to the lanes' on the
    card: a lane one bit off raises, the decode's own meta passes."""
    p = wide_plan
    _, _, meta = wk.decode_wide((p.words, p.start_w), p.bit0, p.endb, p.base,
                                p.lt, p.dt, LPB=p.LPB, SW=p.SW)
    p.check_meta(meta)
    bad = meta.clone()
    bad[1, 1000] += 1
    with pytest.raises(zlibes_tpu_torch.CorruptError, match="did not end"):
        p.check_meta(bad)
    bad = meta.clone()
    bad[2, 7] = 1
    with pytest.raises(zlibes_tpu_torch.CorruptError, match="invalid Huffman"):
        p.check_meta(bad)


def test_turbo_inflate_to_device_on_card(fixture_stream):
    comp, index = fixture_stream
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                        device="cuda")
    assert out.is_cuda
    assert out[:n].cpu().numpy().tobytes() == zlib.decompress(comp)


def test_distance_before_block_start_raises_on_card():
    tokens = [(3, 1), 97, 98, 99]
    comp, index = fixed_stream([tokens], trailer=zlib.adler32(
        expand(tokens, clip=True)).to_bytes(4, "big"))
    with pytest.raises(zlibes_tpu_torch.CorruptError):
        zlibes_tpu_torch.inflate(comp, index=index, device="cuda")


# ---------------------------------------------------------------------------
# turbo encoder kernels (select_turbo, encode_fields) and the encoder

@pytest.fixture(scope="module")
def corpus():
    return bench_data()


def _select_both(pv, slen, lazy):
    toks_k, cnt_k = tk.select_turbo(pv, slen, lazy=lazy)
    torch.cuda.synchronize()
    toks_p, cnt_p = tk.select_turbo_plain(pv, slen, lazy)
    assert _same(cnt_k, cnt_p)
    assert _same(toks_k, toks_p)      # both write 0 past each count
    return toks_k, cnt_k


@pytest.mark.parametrize("lazy", [True, False])
def test_select_turbo_kernel_matches_plain_on_random(lazy):
    g = torch.Generator().manual_seed(2)
    L = 4096
    ml = torch.randint(0, 259, (L, tk.SEL_SEG), generator=g)
    # each lane its own share of literals, from none to nearly all
    lit_share = torch.rand((L, 1), generator=g)
    ml = torch.where(torch.rand((L, tk.SEL_SEG), generator=g) < lit_share, 0,
                     ml)
    dist = torch.randint(1, 4096, (L, tk.SEL_SEG), generator=g)
    lit = torch.randint(0, 256, (L, tk.SEL_SEG), generator=g)
    pv = (dist | (ml << tk.SEL_LEN_SHIFT) | (lit << tk.SEL_LIT_SHIFT)).int()
    slen = torch.randint(-3, tk.SEL_SEG + 1, (L,), generator=g,
                         dtype=torch.int32)
    _, cnt = _select_both(pv.cuda(), slen.cuda(), lazy)
    assert (cnt == 0).any() and (cnt > 100).any()


def _first_dispatch(corpus):
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops.lz77 import find_matches

    cfg = zlibes_tpu_torch.CodecConfig.turbo()
    N = cfg.block_size
    blk, nv = stage_rows(np.frombuffer(corpus, np.uint8), 0,
                         cfg.blocks_per_dispatch, N)
    blk, nv = torch.from_numpy(blk).cuda(), torch.from_numpy(nv).cuda()
    matches = find_matches(blk, nv, N=N, S=cfg.probe_words,
                           J=cfg.candidates, reset=cfg.chunk_reset,
                           two_phase=True)
    return cfg, blk, nv, matches


def test_select_turbo_kernel_matches_plain_on_corpus(corpus):
    from zlibes_tpu_torch.codec import deflate_pipeline as tdp

    cfg, blk, nv, matches = _first_dispatch(corpus)
    pv, slen = tdp.select_inputs(blk, matches, nv, cfg.block_size)
    assert pv.shape == (cfg.blocks_per_dispatch * 256, tk.SEL_SEG)
    _select_both(pv, slen, True)


def _fields_both(tv, td, en, lt, dt):
    from zlibes_tpu_torch.ops import encode_kernel as ek

    val_k, nb_k = ek.encode_fields(tv, td, en, lt, dt)
    torch.cuda.synchronize()
    val_p, nb_p = ek.encode_fields_plain(tv, td, en, lt, dt)
    assert _same(val_k, val_p)        # code1 is unmasked in both
    assert _same(nb_k, nb_p)


def _corpus_tables(fixture_stream):
    from zlibes_tpu_torch.codec.inflate_pipeline import _block_code_lengths
    from zlibes_tpu_torch.ops import block_tables as bt
    from zlibes_tpu_torch.ops import encode_kernel as ek

    comp, index = fixture_stream
    ll, dl = _block_code_lengths(comp, index.blocks[0])
    ll_code, d_code = bt._encode_tables(np.asarray(ll, np.int64),
                                         np.asarray(dl, np.int64))
    return [t.cuda() for t in ek.pack_tables(ll_code, ll, d_code, dl)]


def test_encode_fields_kernel_matches_plain_on_random(fixture_stream):
    lt, dt = _corpus_tables(fixture_stream)
    g = torch.Generator().manual_seed(3)
    n = 1 << 20
    tv = torch.randint(-50, 600, (n,), generator=g, dtype=torch.int32)
    td = torch.randint(-5, 40000, (n,), generator=g, dtype=torch.int32)
    en = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    _fields_both(tv.cuda(), td.cuda(), en.cuda(), lt, dt)


def test_encode_fields_kernel_matches_plain_on_corpus(corpus,
                                                      fixture_stream):
    from zlibes_tpu_torch.codec import deflate_pipeline as tdp
    from zlibes_tpu_torch.ops import deflate_kernel as dk

    cfg, blk, nv, matches = _first_dispatch(corpus)
    tv, td, cnt = tdp.select_glue(blk, matches, nv, cfg.block_size, True)
    _, _, valid, _, _ = dk.token_symbols(tv, td, cnt, nseg=256)
    lt, dt = _corpus_tables(fixture_stream)
    _fields_both(tv.reshape(-1), td.reshape(-1), valid.int().reshape(-1),
                 lt, dt)


def test_encode_wrappers_never_take_plain(monkeypatch):
    from zlibes_tpu_torch.ops import encode_kernel as ek
    from zlibes_tpu_torch.runtime import kernels

    def broken():
        raise RuntimeError("no library")

    monkeypatch.setattr(kernels, "library", broken)
    z = torch.zeros((4, tk.SEL_SEG), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no library"):
        tk.select_turbo(z, z[:, 0].contiguous())
    with pytest.raises(RuntimeError, match="no library"):
        ek.encode_fields(z[0], z[1], z[2], z[0, :288].contiguous(),
                         z[0, :32].contiguous())
    from zlibes_tpu_torch.ops import block_tables as bt
    ll, d, nv, nblocks, final = bt_cases.case("random")
    with pytest.raises(RuntimeError, match="no library"):
        bt.block_tables(ll.cuda(), d.cuda(), nv.cuda(), nblocks, final)


def test_deflate_on_card_equals_cpu_and_fixture(corpus, fixture_stream,
                                                monkeypatch):
    """The bench corpus on the card: the committed fixture byte for byte,
    its index field by field, equal to the CPU run, through both encode
    kernels and no plain version."""
    from zlibes_tpu_torch.codec import deflate_pipeline as tdp
    from zlibes_tpu_torch.ops import encode_kernel as ek

    comp, index = fixture_stream
    cfg = zlibes_tpu_torch.CodecConfig.turbo()
    cpu = zlibes_tpu_torch.deflate(corpus, config=cfg, device="cpu")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(tk, "select_turbo_plain", plain)
    monkeypatch.setattr(ek, "encode_fields_plain", plain)
    tk.LAUNCHES.clear()
    out, idx = tdp.deflate(corpus, with_index=True, config=cfg,
                           device="cuda")
    assert tk.LAUNCHES["select_turbo"] >= 1
    assert tk.LAUNCHES["encode_fields"] >= 1
    assert out == comp == cpu
    assert idx.blocks == index.blocks
    for f in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(idx, f), getattr(index, f)), f
    assert (idx.turbo, idx.chunk_reset, idx.max_tokens) == \
        (index.turbo, index.chunk_reset, index.max_tokens)
    assert zlibes_tpu_torch.inflate(out, index=idx, device="cuda") == corpus


# ---------------------------------------------------------------------------
# the shared-table encoder outside the turbo profile: the kernel variants
# its configs launch, and each config's card output against its CPU output

def _far_packed(L: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """select_turbo inputs: (L, 512) packed positions with matches of 0-258
    bytes to 4,095 back, a fifth of them long and farther than 2048, and
    (L,) segment lengths of 0-512."""
    g = torch.Generator().manual_seed(seed)
    shape = (L, tk.SEL_SEG)
    ml = torch.randint(0, 259, shape, generator=g)
    ml = torch.where(torch.rand(shape, generator=g) < 0.4, 0, ml)
    dist = torch.randint(1, 4096, shape, generator=g)
    far = torch.rand(shape, generator=g) < 0.2
    ml = torch.where(far, torch.randint(131, 259, shape, generator=g), ml)
    dist = torch.where(far, torch.randint(2049, 4096, shape, generator=g),
                       dist)
    lit = torch.randint(0, 256, shape, generator=g)
    pv = (dist | (ml << tk.SEL_LEN_SHIFT) | (lit << tk.SEL_LIT_SHIFT)).int()
    slen = torch.randint(0, tk.SEL_SEG + 1, (L,), generator=g,
                         dtype=torch.int32)
    return pv, slen


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("split_far", [False, True])
def test_select_turbo_kernel_matches_plain_either_split_far(split_far, lazy):
    """Both instances of the kernel on far long matches: with split_far off
    some stay over 130 bytes, with it on none does."""
    pv, slen = _far_packed(1024, 41)
    toks, cnt = tk.select_turbo(pv.cuda(), slen.cuda(), lazy=lazy,
                                split_far=split_far)
    torch.cuda.synchronize()
    toks_p, cnt_p = tk.select_turbo_plain(pv, slen, lazy, split_far)
    assert _same(cnt, cnt_p) and _same(toks, toks_p)
    t = toks_p
    far = (((t & tk.TOK_MATCH_BIT) != 0)
           & (((t >> tk.TOK_DIST_SHIFT) & tk.TOK_DIST_MASK) > 2048))
    assert bool((far & ((t & tk.TOK_VAL_MASK) > 130)).any()) != split_far


@pytest.mark.parametrize("seg", [512, 1024, 4096])
@pytest.mark.parametrize("lazy", [True, False])
def test_select_tokens_kernel_matches_plain_with_split_far(seg, lazy):
    """Random matches to 32 KiB back, a fifth long and farther than 2048:
    the split_far instance cuts each to 130 bytes, as its plain version
    does."""
    from zlibes_tpu_torch.ops import lz77

    g = torch.Generator().manual_seed(seg + lazy)
    B, N = 2, 32768
    data = torch.randint(0, 256, (B, N + 8), generator=g, dtype=torch.uint8)
    ml = torch.randint(0, 259, (B, N), generator=g)
    ml = torch.where(torch.rand((B, N), generator=g) < 0.4, 0, ml)
    dist = torch.randint(1, 32769, (B, N), generator=g)
    far = torch.rand((B, N), generator=g) < 0.2
    ml = torch.where(far, torch.randint(131, 259, (B, N), generator=g), ml)
    dist = torch.where(far, torch.randint(2049, 32769, (B, N), generator=g),
                       dist)
    m = ((ml << 16) | dist).int()
    nv = torch.tensor([N, N // 3], dtype=torch.int32)
    kw = dict(N=N, SEG_SIZE=seg, lazy=lazy, split_far=True)
    tv, td, cnt = lz77.select_tokens(data.cuda(), m.cuda(), nv.cuda(), **kw)
    torch.cuda.synchronize()
    tv_p, td_p, cnt_p = lz77.select_tokens_plain(data, m, nv, **kw)
    assert _same(cnt, cnt_p) and _same(tv, tv_p) and _same(td, td_p)
    assert bool(((tv_p == 130) & (td_p > 2048)).any())
    assert not bool(((tv_p > 130) & (td_p > 2048)).any())


def test_encode_fields_kernel_matches_plain_on_fields_over_32_bits():
    """15-bit codes on the longest lengths at the farthest distances: fields
    of 33-48 bits, mixed with literals and short matches."""
    from shared_tables_cases import deep_tables
    from zlibes_tpu_torch.ops import block_tables as bt
    from zlibes_tpu_torch.ops import encode_kernel as ek

    ll_len, d_len = deep_tables()
    ll_code, d_code = bt._encode_tables(ll_len, d_len)
    lt, dt = (t.cuda() for t in ek.pack_tables(ll_code, ll_len, d_code,
                                               d_len))
    g = torch.Generator().manual_seed(43)
    n = 1 << 20
    tv = torch.randint(3, 259, (n,), generator=g, dtype=torch.int32)
    td = torch.randint(1, 32769, (n,), generator=g, dtype=torch.int32)
    wide = torch.rand(n, generator=g) < 0.5
    tv = torch.where(wide, torch.randint(227, 258, (n,), generator=g,
                                         dtype=torch.int32), tv)
    td = torch.where(wide, torch.randint(16385, 32769, (n,), generator=g,
                                         dtype=torch.int32), td)
    lit = torch.rand(n, generator=g) < 0.2
    tv = torch.where(lit, tv % 256, tv)
    td = torch.where(lit, 0, td)
    en = (torch.rand(n, generator=g) < 0.9).int()
    _fields_both(tv.cuda(), td.cuda(), en.cuda(), lt, dt)
    _, nb = ek.encode_fields_plain(tv, td, en, lt.cpu(), dt.cpu())
    assert int(nb.max()) == 48 and int((nb > 32).sum()) > n // 4


@pytest.mark.parametrize("buffer", ["raw", "skewed", "far_copies"])
@pytest.mark.parametrize("name", ["shared_full", "shared_turbo15",
                                  "shared_seg1024"])
def test_shared_config_on_card_equals_cpu(name, buffer, monkeypatch):
    """Each shared-tables config on the card, through its kernels and no
    plain version: the CPU run's stream and index, and the stream decodes
    back through the group decode on the card."""
    import dataclasses

    from shared_tables_cases import (SHARED_CONFIGS, far_copy_data,
                                     skewed_data)
    from zlibes_tpu_torch.codec import deflate_pipeline as tdp
    from zlibes_tpu_torch.ops import encode_kernel as ek
    from zlibes_tpu_torch.ops import lz77

    data = {"raw": lambda: (GOLDEN / "raw.bin").read_bytes()[:2 * 32768
                                                            + 777],
            "skewed": skewed_data, "far_copies": far_copy_data}[buffer]()
    cfg = dataclasses.replace(SHARED_CONFIGS[name], blocks_per_dispatch=2)
    cpu, cpu_idx = tdp.deflate(data, with_index=True, config=cfg,
                               block_size=32768, device="cpu")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, fn in ((tk, "select_turbo_plain"), (ek, "encode_fields_plain"),
                    (lz77, "select_tokens_plain")):
        monkeypatch.setattr(mod, fn, plain)
    tk.LAUNCHES.clear()
    out, idx = tdp.deflate(data, with_index=True, config=cfg,
                           block_size=32768, device="cuda")
    select = "select_turbo" if name == "shared_turbo15" else "select_tokens"
    assert tk.LAUNCHES[select] >= 1 and tk.LAUNCHES["encode_fields"] >= 1
    assert out == cpu and idx.blocks == cpu_idx.blocks
    for f in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(idx, f), getattr(cpu_idx, f)), f
    assert (idx.turbo, idx.chunk_reset, idx.max_tokens) == \
        (cpu_idx.turbo, cpu_idx.chunk_reset, cpu_idx.max_tokens)
    assert zlib.decompress(out) == data
    tk.LAUNCHES.clear()
    spans = zlibes_tpu_torch.inflate_to_device(out, idx, device="cuda")
    assert tk.LAUNCHES["decode_tokens"] >= 1
    assert tk.LAUNCHES["resolve_global"] >= 1
    got = b"".join(t[:n].cpu().numpy().tobytes() for t, _, n in spans)
    assert got == data


# ---------------------------------------------------------------------------
# the contract cases of test_torch_contract_cases.py, kernel versus plain,
# and the shapes beside the bench's

def test_resolve_wide_kernel_matches_plain_on_contract_cases():
    import test_torch_contract_cases as cases

    toks, starts, want = cases.resolve_inputs()
    toks, starts = torch.from_numpy(toks), torch.from_numpy(starts)
    got = wk.resolve_wide(toks.cuda(), starts.cuda())
    torch.cuda.synchronize()
    assert _same(got, wk.resolve_wide_plain(toks, starts))
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("nsubb,in_smem", [(32, True), (256, True),
                                           (1792, True), (1824, False),
                                           (2048, False)])
def test_resolve_wide_kernel_matches_plain_at_other_row_lengths(nsubb,
                                                                in_smem):
    """Rows of 4 KiB, 32 KiB and 224 KiB keep their bytes in shared memory;
    rows of 228 KiB and 256 KiB take the kernel's path that keeps them in
    the output array.  Sorted starts, so that chains are long and far
    sources common."""
    assert (nsubb * wk.SUB <= wk.RESOLVE_SMEM_ROW) == in_smem
    g = torch.Generator().manual_seed(nsubb)
    shape = (3, nsubb, wk.TOKENS_PAD)
    lit = torch.randint(0, 256, shape, generator=g, dtype=torch.int32)
    ln = torch.randint(3, 259, shape, generator=g, dtype=torch.int32)
    dist = torch.randint(1, 32769, shape, generator=g, dtype=torch.int32)
    ism = torch.rand(shape, generator=g) < 0.7
    toks = torch.where(ism, ln | (dist << wk.TOK_DIST_SHIFT)
                       | wk.TOK_MATCH_BIT, lit)
    starts = torch.randint(-200, 128, shape, generator=g,
                           dtype=torch.int32).sort(dim=2).values
    starts[:, :, 40:] = wk.START_PAD
    got = wk.resolve_wide(toks.cuda(), starts.cuda())
    torch.cuda.synchronize()
    assert _same(got, wk.resolve_wide_plain(toks, starts))


@pytest.mark.parametrize("lazy", [True, False])
def test_select_turbo_kernel_matches_plain_on_contract_cases(lazy):
    import test_torch_contract_cases as cases

    pv, slen = cases.select_inputs()
    toks, cnt = _select_both(pv.cuda(), slen.cuda(), lazy)
    for case in cases.SELECT_CASES:
        cases.check_select_case(case, lazy, toks.cpu().numpy(),
                                cnt.cpu().numpy())


@pytest.mark.parametrize("lanes", [1, 7, 8, 9, 4099])
def test_select_turbo_kernel_matches_plain_on_ragged_dispatches(lanes):
    """Lane counts that do not fill the kernel's last block, with padded
    lanes (``seg_len`` 0) and ``lazy`` off."""
    g = torch.Generator().manual_seed(lanes)
    ml = torch.randint(0, 259, (lanes, tk.SEL_SEG), generator=g)
    ml = torch.where(torch.rand((lanes, tk.SEL_SEG), generator=g) < 0.5, 0,
                     ml)
    dist = torch.randint(1, 4096, (lanes, tk.SEL_SEG), generator=g)
    lit = torch.randint(0, 256, (lanes, tk.SEL_SEG), generator=g)
    pv = (dist | (ml << tk.SEL_LEN_SHIFT) | (lit << tk.SEL_LIT_SHIFT)).int()
    slen = torch.randint(0, tk.SEL_SEG + 1, (lanes,), generator=g,
                         dtype=torch.int32)
    slen[::3] = 0
    _, cnt = _select_both(pv.cuda(), slen.cuda(), False)
    assert (cnt[::3] == 0).all()


# ---------------------------------------------------------------------------
# the general encoder's kernel (select_tokens) and the encoder

def _tokens_both(data, matches, nv, N, SEG, lazy, start):
    """``select_tokens`` on the card against its plain version on the CPU
    copies: counts, tokens in [0, count), zeros past it."""
    from zlibes_tpu_torch.ops import lz77

    tv_k, td_k, cnt_k = lz77.select_tokens(data.cuda(), matches.cuda(),
                                           nv.cuda(), N=N, SEG_SIZE=SEG,
                                           lazy=lazy, start=start)
    torch.cuda.synchronize()
    tv_p, td_p, cnt_p = lz77.select_tokens_plain(data, matches, nv, N, SEG,
                                                 lazy, start)
    assert _same(cnt_k, cnt_p)
    assert _same(tv_k, tv_p) and _same(td_k, td_p)      # zeros past the count
    return tv_k.cpu(), td_k.cpu(), cnt_k.cpu()


def random_select_tokens_inputs(B: int, N: int, start: int, seed: int):
    """Random bytes and random matches (lengths 0..258, 40% none; distances
    1..32768) of B rows, with ragged and empty rows."""
    g = torch.Generator().manual_seed(seed)
    data = torch.randint(0, 256, (B, N + 8), generator=g, dtype=torch.uint8)
    ml = torch.randint(0, 259, (B, N), generator=g)
    ml = torch.where(torch.rand((B, N), generator=g) < 0.4, 0, ml)
    dist = torch.randint(1, 32769, (B, N), generator=g)
    matches = ((ml << 16) | dist).int()
    nv = torch.randint(start, N + 1, (B,), generator=g, dtype=torch.int32)
    nv[0] = N
    nv[-1] = start
    return data, matches, nv


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("SEG,start", [(4096, 0), (1024, 0), (4096, 32768),
                                       (1024, 32768), (16384, 0)])
def test_select_tokens_kernel_matches_plain_on_random(SEG, start, lazy):
    N = start + 16384
    data, matches, nv = random_select_tokens_inputs(5, N, start, SEG + start)
    _, _, cnt = _tokens_both(data, matches, nv, N, SEG, lazy, start)
    assert (cnt == 0).any() and int(cnt.max()) > 10


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("start", [0, 4096])
def test_select_tokens_kernel_matches_plain_on_contract_cases(lazy, start):
    import test_torch_contract_cases as cases

    data, matches, nv = cases.select_tokens_inputs(start)
    tv, td, cnt = _tokens_both(data, matches, nv, start + cases.TOK_N,
                               cases.TOK_SEG, lazy, start)
    for case in cases.SELECT_TOKENS_CASES:
        cases.check_select_tokens_case(case, lazy, tv.numpy(), td.numpy(),
                                       cnt.numpy())


@pytest.mark.parametrize("case", SELECT_CHAIN_CASES)
def test_select_tokens_kernel_matches_plain_on_chain_cases(case):
    """The cases that stress the kernel's pieces, walks and fix-up rounds
    (``SELECT_CHAIN_CASES``), each also holding its own features."""
    import test_torch_contract_cases as cases

    (data, matches, nv), kw = cases.select_chain_inputs(case)
    tv, td, cnt = _tokens_both(data, matches, nv, kw["N"], kw["SEG_SIZE"],
                               kw["lazy"], kw["start"])
    cases.check_select_chain_case(case, tv.numpy(), td.numpy(), cnt.numpy())


def test_select_tokens_kernel_matches_plain_on_corpus():
    """Real matches of two 128 KiB blocks of raw.bin at level 6, the second
    one short."""
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops.lz77 import find_matches

    cfg = zlibes_tpu_torch.CodecConfig.from_level(6)
    N = cfg.block_size
    raw = np.frombuffer((GOLDEN / "raw.bin").read_bytes()[: N + 50000],
                        np.uint8)
    blk, nv = stage_rows(raw, 0, 2, N, 3)
    blk, nv = torch.from_numpy(blk), torch.from_numpy(nv)
    matches = find_matches(blk.cuda(), nv.cuda(), N=N, S=cfg.probe_words,
                           J=cfg.candidates).cpu()
    _, _, cnt = _tokens_both(blk, matches, nv, N, cfg.seg_size, True, 0)
    assert int(cnt.sum()) > 10000 and not cnt[-32:].any()


def test_select_tokens_wrapper_checks_and_never_takes_plain(monkeypatch):
    from zlibes_tpu_torch.ops import lz77
    from zlibes_tpu_torch.runtime import kernels

    data, matches, nv = (t.cuda() for t in
                         random_select_tokens_inputs(2, 8192, 0, 1))
    with pytest.raises(ValueError, match="dtype"):
        lz77.select_tokens(data, matches.long(), nv, N=8192)
    with pytest.raises(ValueError, match="expected cuda"):
        lz77.select_tokens(data.cpu(), matches, nv, N=8192)
    with pytest.raises(ValueError, match="SEG_SIZE up to"):
        lz77.select_tokens(
            *(t.cuda() for t in random_select_tokens_inputs(1, 32768, 0, 2)),
            N=32768, SEG_SIZE=32768)

    def broken():
        raise RuntimeError("no library")

    monkeypatch.setattr(kernels, "library", broken)
    with pytest.raises(RuntimeError, match="no library"):
        lz77.select_tokens(data, matches, nv, N=8192)


def test_general_deflate_on_card_equals_cpu(monkeypatch):
    """raw.bin at level 6 on the card: the CPU run's bytes and index, through
    the select_tokens and block_tables kernels and not their plain
    versions; CPython and the port's own inflate give the input back."""
    import dataclasses

    from zlibes_tpu_torch.codec import deflate_pipeline as tdp
    from zlibes_tpu_torch.ops import block_tables as bt
    from zlibes_tpu_torch.ops import lz77

    raw = (GOLDEN / "raw.bin").read_bytes()
    cfg = dataclasses.replace(zlibes_tpu_torch.CodecConfig.from_level(6),
                              blocks_per_dispatch=2)
    cpu, cpu_idx = tdp.deflate(raw, with_index=True, config=cfg, device="cpu")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(lz77, "select_tokens_plain", plain)
    monkeypatch.setattr(bt, "block_tables_plain", plain)
    tk.LAUNCHES.clear()
    out, idx = tdp.deflate(raw, with_index=True, config=cfg, device="cuda")
    assert tk.LAUNCHES["select_tokens"] == 2
    assert tk.LAUNCHES["block_tables"] == 2
    assert out == cpu and len(out) == 191419
    assert idx.blocks == cpu_idx.blocks and idx.wide
    for f in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(idx, f), getattr(cpu_idx, f)), f
    assert zlib.decompress(out) == raw
    tk.LAUNCHES.clear()
    assert zlibes_tpu_torch.inflate(out, index=idx, device="cuda") == raw
    assert dict(tk.LAUNCHES) == {"decode_tables": 1, "wide_lanes": 1,
                                 "decode_wide": 1, "resolve_wide": 1}


# ---------------------------------------------------------------------------
# the general encoder's per-block tables: block_tables

def _tables_both(ll, d, nv, nblocks, final):
    """The kernel's results on the card and the plain route's on the CPU,
    for the same CPU inputs; they must be equal."""
    from zlibes_tpu_torch.ops import block_tables as bt

    got = bt.block_tables(ll.cuda(), d.cuda(), nv.cuda(), nblocks, final)
    torch.cuda.synchronize()
    got = tuple(t.cpu() for t in got)
    plain = bt.block_tables(ll, d, nv, nblocks, final)
    for name, g, p in zip(("ll_code", "ll_len", "d_code", "d_len",
                           "hdr_bits", "enabled", "info"), got, plain):
        assert g.dtype == p.dtype and torch.equal(g, p), name
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(bt_cases.CASES))
def test_block_tables_kernel_matches_plain(name, seed):
    args = bt_cases.case(name, seed)
    got = _tables_both(*args)
    bt_cases.check(got, bt_cases.expected(*args), args[0].shape[0])


def test_block_tables_kernel_matches_plain_on_a_level6_dispatch():
    """The histograms of raw.bin's one level-6 dispatch as the card's
    symbols stage leaves them: four blocks of 16, the last short and the
    stream's end."""
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops import deflate_kernel as dk
    from zlibes_tpu_torch.ops import lz77

    cfg = zlibes_tpu_torch.CodecConfig.from_level(6)
    N, Bp, SEG = cfg.block_size, cfg.blocks_per_dispatch, cfg.seg_size
    raw = np.frombuffer((GOLDEN / "raw.bin").read_bytes(), np.uint8)
    nblocks = -(-raw.size // N)
    blk, nv = stage_rows(raw, 0, nblocks, N, Bp)
    blk, nv = torch.from_numpy(blk).cuda(), torch.from_numpy(nv).cuda()
    matches = lz77.find_matches(blk, nv, N=N, S=cfg.probe_words,
                                J=cfg.candidates)
    tv, td, cnt = lz77.select_tokens(blk, matches, nv, N=N, SEG_SIZE=SEG,
                                     lazy=cfg.lazy)
    *_, ll, d = dk.token_symbols(tv, td, cnt, nseg=N // SEG)
    args = (ll.cpu(), d.cpu(), nv.cpu(), nblocks, nblocks - 1)
    got = _tables_both(*args)
    assert got[6][:nblocks, 0].tolist() == [C.BTYPE_DYNAMIC] * nblocks
    bt_cases.check(got, bt_cases.expected(*args), Bp)


def _host_tables(ll_freq, d_freq, n_valid, nblocks, final):
    """block_tables as the host planner: the histograms down, the plain
    route on the host, the tables up again."""
    from zlibes_tpu_torch.ops import block_tables as bt

    outs = bt.block_tables_plain(ll_freq.cpu(), d_freq.cpu(), n_valid.cpu(),
                                 nblocks, final)
    return tuple(t.to(ll_freq.device) for t in outs)


@pytest.mark.parametrize("what", ["level1", "level6", "level9", "dictionary",
                                  "random_bytes"])
def test_general_deflate_device_tables_equal_host_tables(what, monkeypatch):
    """deflate on the card with the block_tables kernel gives the bytes and
    the index of the same call with the host planner's tables;
    CodecStats.device_tables counts every block the card planned."""
    from zlibes_tpu_torch import CodecStats
    from zlibes_tpu_torch.codec import deflate_pipeline as tdp

    raw = (GOLDEN / "raw.bin").read_bytes()
    level, data, zdict = 6, raw, None
    if what.startswith("level"):
        level = int(what[5:])
    elif what == "dictionary":
        data, zdict = raw[:300000], raw[-20000:]
    else:       # every block stored
        data = np.random.default_rng(5).integers(
            0, 256, 300000, dtype=np.uint8).tobytes()
    cfg = zlibes_tpu_torch.CodecConfig.from_level(level)
    nblocks = -(-len(data) // cfg.block_size)

    def run():
        stats = CodecStats()
        tk.LAUNCHES.clear()
        out = tdp.deflate(data, with_index=True, config=cfg, stats=stats,
                          dictionary=zdict, device="cuda")
        return out, stats, tk.LAUNCHES["block_tables"]

    (out, idx), stats, launches = run()
    assert launches == stats.dispatches == 1
    assert stats.device_tables == nblocks
    coded = [b for b in idx.blocks if b.btype != C.BTYPE_STORED]
    if what == "random_bytes":
        assert not coded
    else:
        assert len(coded) == nblocks
    monkeypatch.setattr(tdp, "block_tables", _host_tables)
    (ref, ref_idx), _, launches = run()
    assert launches == 0
    assert out == ref
    assert idx.blocks == ref_idx.blocks and idx.wide == ref_idx.wide
    for f in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(idx, f), getattr(ref_idx, f)), f
    z = zlib.decompressobj(zdict=zdict) if zdict else zlib.decompressobj()
    assert z.decompress(out) == data


# ---------------------------------------------------------------------------
# the generic indexed decode: decode_tokens and resolve_global

@pytest.fixture(scope="module")
def generic_stream():
    """raw.bin through CPython zlib with a full flush every 32 KiB,
    indexed by ``build_index``: self-contained, 4 KiB anchors."""
    data = (GOLDEN / "raw.bin").read_bytes()
    comp = zlib_flushed(data, 32768)
    index = zlibes_tpu_torch.build_index(comp)
    assert index.self_contained and not index.wide
    return data, comp, index


def _decode_tokens_both(args, T):
    """decode_tokens on the card against its plain version on the CPU:
    counts, end bits, flags equal, tokens and starts where emitted."""
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    got = ik.decode_tokens(*(a.cuda() for a in args), T=T)
    torch.cuda.synchronize()
    want = ik.decode_tokens_plain(*(a.cpu() for a in args), T)
    check_decode_tokens(got, want, T)
    return want


def _group_args(comp, index):
    from zlibes_tpu_torch.codec import inflate_pipeline as ip
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    p = ip.plan_groups(comp, index, "cpu")[0]
    words = torch.from_numpy(ik.stream_words(comp))
    return p, (words, p.lt, p.dt, p.rows, p.bit0, p.endb, p.active)


def test_decode_tokens_kernel_matches_plain_on_a_group(generic_stream):
    data, comp, index = generic_stream
    p, args = _group_args(comp, index)
    count, bitpos, still, err = _decode_tokens_both(args, p.T)[2:]
    assert not err.any() and not still.any()
    assert np.array_equal(bitpos.numpy(), p.lane_end)


def test_decode_tokens_kernel_resumes_like_plain(generic_stream):
    """T cut to 300: every call, lanes stopped while active resume from
    their end bit."""
    data, comp, index = generic_stream
    p, (words, lt, dt, rows, bit0, endb, active) = _group_args(comp, index)
    calls = 0
    while bool(active.any()):
        *_, bit0, active, err = _decode_tokens_both(
            (words, lt, dt, rows, bit0, endb, active), 300)
        assert not err.any()
        calls += 1
    assert calls > 3 and np.array_equal(bit0.numpy(), p.lane_end)


@pytest.mark.parametrize("B", [1, 33, 4097])
def test_decode_tokens_kernel_matches_plain_on_garbage(B):
    from test_torch_contract_cases import garbage_generic_lanes

    _decode_tokens_both(garbage_generic_lanes(B, seed=B), 64)


@pytest.mark.parametrize("case", ["resumed", "past_end", "end_at_anchor",
                                  "far_distance", "invalid_distance",
                                  "inactive", "deep_codes"])
def test_decode_tokens_kernel_gives_the_contract_cases(case):
    from test_torch_contract_cases import run_generic_decode_case
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    def decode(*args):
        *lanes, T = args
        out = ik.decode_tokens(*(torch.as_tensor(a).cuda() for a in lanes),
                               T=T)
        torch.cuda.synchronize()
        return out

    run_generic_decode_case(case, decode)


def _resolve_global_both(tokens, starts, count, out_base, total, prefix):
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    t = torch.as_tensor
    got, err = ik.resolve_global(t(tokens).cuda(), t(starts).cuda(),
                                 t(count).cuda(), t(out_base).cuda(), total,
                                 t(prefix).cuda())
    torch.cuda.synchronize()
    want, want_err = ik.resolve_global_plain(
        t(tokens).cpu(), t(starts).cpu(), t(count).cpu(), t(out_base).cpu(),
        total, t(prefix).cpu())
    assert torch.equal(got.cpu(), want)
    assert bool(err) == bool(want_err)
    return want, bool(err)


@pytest.mark.parametrize("B,P,below", [(1, 0, False), (33, 32768, False),
                                       (4097, 0, False), (4097, 32768, False),
                                       (33, 0, True)])
def test_resolve_global_kernel_matches_plain_on_random_lanes(B, P, below):
    from test_torch_contract_cases import random_generic_tokens

    T = 600 if B == 1 else 8
    args = random_generic_tokens(B, T, P, seed=B + P, below=below)
    _, err = _resolve_global_both(*args)
    assert err == below


@pytest.mark.parametrize("B,P", [(33, 0), (4097, 32768)])
def test_resolve_global_kernel_skips_the_slots_past_each_count(B, P):
    """Random words past each lane's count, as the decoder leaves them in
    the (T, B) arrays that run_group(check=False) passes on."""
    from test_torch_contract_cases import random_generic_tokens

    _resolve_global_both(*random_generic_tokens(B, 8, P, seed=B + 1,
                                                junk=True))


@pytest.mark.parametrize("case", ["prefix_reach", "straddle", "below_zero",
                                  "overlap", "dist1_run"])
def test_resolve_global_kernel_gives_the_contract_cases(case):
    from test_torch_contract_cases import (check_generic_resolve_case,
                                           generic_resolve_case)

    args, _, _ = generic_resolve_case(case)
    out, err = _resolve_global_both(*args)
    check_generic_resolve_case(case, out.numpy(), err)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_resolve_global_kernel_matches_plain_on_a_group(generic_stream,
                                                        with_prefix):
    """The group's own tokens from byte 0, and from its eleventh lane (past
    the first 32 KiB) on behind the 32 KiB before it."""
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    data, comp, index = generic_stream
    p, args = _group_args(comp, index)
    tokens, starts, count = (x.cuda() for x in ik.decode_tokens(
        *(a.cuda() for a in args), T=p.T)[:3])
    out_base = p.out_base.cuda()
    raw = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).cuda()
    total, prefix = p.d_total, raw[:0]
    if with_prefix:
        k0 = 10
        cut = int(index.anchor_out[k0])
        assert cut >= 32768
        tokens = tokens[:, k0:].contiguous()
        starts = starts[:, k0:].contiguous()
        count = count[k0:].contiguous()
        prefix = raw[cut - 32768 : cut]
        out_base = (out_base[k0:] - cut + 32768).contiguous()
        total = 32768 + len(data) - cut
    out, err = _resolve_global_both(tokens, starts, count, out_base, total,
                                    prefix)
    assert not err
    skip = 0 if not with_prefix else 32768
    assert out[skip:].numpy().tobytes() == data[len(data) - (total - skip):]


def test_generic_paths_on_card_count_launches(generic_stream, monkeypatch):
    """inflate_to_device and inflate_range on the generic index, the
    device branch of the scan, and inflate() without the native runtime,
    through the kernels and not their plain versions."""
    from zlibes_tpu_torch.codec import inflate_pipeline as ip
    from zlibes_tpu_torch.ops import inflate_kernel as ik
    from zlibes_tpu_torch.runtime import native

    data, comp, index = generic_stream

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(ik, "decode_tokens_plain", plain)
    monkeypatch.setattr(ik, "resolve_global_plain", plain)
    tk.LAUNCHES.clear()
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                        device="cuda")
    assert out.is_cuda and (off, n) == (0, len(data))
    assert out.cpu().numpy().tobytes() == data
    assert dict(tk.LAUNCHES) == {"decode_tables": 1, "decode_tokens": 1,
                                 "resolve_global": 1}
    assert zlibes_tpu_torch.inflate_range(comp, index, 32700, 300,
                                          device="cuda") == data[32700:33000]
    small = zlib.compress(data[:50000], 6)
    tk.LAUNCHES.clear()
    got, blocks, _ = ip.inflate_raw_scan(small, 2, device="cuda")
    assert got.cpu().numpy().tobytes() == data[:50000]
    assert tk.LAUNCHES["resolve_global"] == 1
    assert tk.LAUNCHES["decode_tokens"] == sum(b.btype != 0 for b in blocks)
    monkeypatch.setattr(native, "available", lambda: False)
    assert zlibes_tpu_torch.inflate(comp, device="cuda") == data
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cuda") == data
    bad = bytearray(comp)
    bad[len(bad) // 2] ^= 0x55
    with pytest.raises((zlibes_tpu_torch.CorruptError,
                        zlibes_tpu_torch.ChecksumError)):
        zlibes_tpu_torch.inflate(bytes(bad), index=index, device="cuda")


def _stock_zlib_10mb():
    """10,000,000 B of seeded 64-256 KiB slices of raw.bin through CPython
    zlib at its defaults (level 6, windowBits 15, memLevel 8, no flush),
    with its chained ``build_index`` (4 KiB anchors)."""
    raw = (GOLDEN / "raw.bin").read_bytes()
    ring = raw + raw[:1 << 18]
    rng = np.random.default_rng(19)
    parts, have = [], 0
    while have < 10_000_000:
        n = min(int(rng.integers(1 << 16, (1 << 18) + 1)), 10_000_000 - have)
        off = int(rng.integers(0, len(raw)))
        parts.append(ring[off : off + n])
        have += n
    data = b"".join(parts)
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8)
    comp = c.compress(data) + c.flush()
    index = zlibes_tpu_torch.build_index(comp)
    assert not index.self_contained and not index.wide
    return data, comp, index


def test_stock_zlib_stream_decodes_to_the_card(monkeypatch):
    """A 10 MB stock-zlib stream through ``inflate_to_device``: zlib's bytes
    on the card, one ``decode_tables`` a call (every coded block in
    ``device_headers``), one ``decode_tokens`` and one ``resolve_global`` a
    group (two groups or more, each after the first behind the one
    before), no plain version, and no host sync once the groups are
    planned (CUDA's sync debug mode raises on one)."""
    from zlibes_tpu_torch.codec import inflate_pipeline as ip
    from zlibes_tpu_torch.ops import decode_tables as dtab
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    data, comp, index = _stock_zlib_10mb()

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(ik, "decode_tokens_plain", plain)
    monkeypatch.setattr(ik, "resolve_global_plain", plain)
    monkeypatch.setattr(dtab, "decode_tables_plain", plain)
    real_plan = ip.plan_groups

    def planned_then_no_sync(*args, **kwargs):
        plans = real_plan(*args, **kwargs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        return plans

    monkeypatch.setattr(ip, "plan_groups", planned_then_no_sync)
    stats = zlibes_tpu_torch.CodecStats()
    tk.LAUNCHES.clear()
    try:
        (out, off, n), = zlibes_tpu_torch.inflate_to_device(
            comp, index, device="cuda", stats=stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.is_cuda and (off, n) == (0, len(data))
    assert out.cpu().numpy().tobytes() == data == zlib.decompress(comp)
    groups = stats.dispatches
    assert groups >= 2 and stats.chained_groups == groups - 1
    assert dict(tk.LAUNCHES) == {"decode_tables": 1, "decode_tokens": groups,
                                 "resolve_global": groups}
    assert (stats.bytes_in, stats.bytes_out, stats.blocks) == (
        len(comp), len(data), len(index.blocks))
    assert stats.device_headers == sum(1 for b in index.blocks
                                       if b.out_len and b.btype != 0)


def test_stock_zlib_stream_random_reads_on_the_card(monkeypatch):
    """Reads of the 10 MB stock-zlib stream from access points every 1 MiB
    (``build_index(..., point_every=)``, 32 KiB windows), as zlib's
    examples/zran.c reads: zlib's bytes; each read one ``decode_tables``,
    one ``decode_tokens`` and one ``resolve_global`` (one group behind the
    point's window), no plain version, and nothing that waits for the card
    before the one readback of the range and its statuses (two copies
    from one workspace); ``point_reads``
    the reads and ``lead_bytes`` the leads worked out from the index, each
    below a span and a block."""
    from zlibes_tpu_torch.codec import inflate_pipeline as ip
    from zlibes_tpu_torch.ops import decode_tables as dtab
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    data, comp, _ = _stock_zlib_10mb()
    every = 1 << 20
    index = zlibes_tpu_torch.build_index(comp, point_every=every)
    pts = [index.blocks[b].out_start for b in index.point_block]
    assert len(pts) >= 9 and index.point_window[0] == b""
    assert all(w == data[o - 32768 : o] for o, w in
               zip(pts[1:], index.point_window[1:]))

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(ik, "decode_tokens_plain", plain)
    monkeypatch.setattr(ik, "resolve_global_plain", plain)
    monkeypatch.setattr(dtab, "decode_tables_plain", plain)
    rng = np.random.default_rng(29)
    reads = [(0, 4096), (len(data) - 1, 1), (pts[3], 65536),
             (pts[5] + 100, 30000), (pts[6] - 1000, 2 * every)]
    reads += [(int(s), int(min(len(data) - s, rng.integers(1024, 1 << 18))))
              for s in rng.integers(0, len(data), 20)]
    widest = max(b.out_len for b in index.blocks)
    stats = zlibes_tpu_torch.CodecStats()
    leads = 0
    real_to_host = ip._to_host
    waits = []

    def waited(tensors):
        torch.cuda.set_sync_debug_mode("default")
        waits.append(len(tensors))
        return real_to_host(tensors)

    monkeypatch.setattr(ip, "_to_host", waited)
    for s, n in reads:
        tk.LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = zlibes_tpu_torch.inflate_range(comp, index, s, n,
                                                 device="cuda", stats=stats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert got == data[s : s + n], (s, n)
        assert dict(tk.LAUNCHES) == {"decode_tables": 1, "decode_tokens": 1,
                                     "resolve_global": 1}, (s, n)
        lead = s - pts[int(np.searchsorted(pts, s, side="right")) - 1]
        assert 0 <= lead < every + widest
        leads += lead
    assert (stats.point_reads, stats.lead_bytes) == (len(reads), leads)
    assert stats.bytes_out == sum(n for _, n in reads)
    assert waits == [2] * len(reads)
    plain_index = zlibes_tpu_torch.build_index(comp)
    with pytest.raises(zlibes_tpu_torch.CorruptError, match="point_every="):
        zlibes_tpu_torch.inflate_range(comp, plain_index, 100, 10,
                                       device="cuda")


def test_stock_zlib_point_reads_launch_as_the_wrappers_do(monkeypatch):
    """A point read's card group (pointer launches into one workspace)
    returns what the same group through the kernels' wrappers returns:
    the bytes of seeded reads, and the error of windows cut to their last
    100 bytes (a copy escapes the history)."""
    from zlibes_tpu_torch.codec import inflate_pipeline as ip
    from zlibes_tpu_torch.spec.refmodel import StreamIndex

    data, comp, _ = _stock_zlib_10mb()
    index = zlibes_tpu_torch.build_index(comp, point_every=1 << 20)
    pts = [index.blocks[b].out_start for b in index.point_block]
    short = StreamIndex(index.blocks, index.anchor_bit, index.anchor_out,
                        index.anchor_block, False,
                        point_block=index.point_block,
                        point_window=[w[-100:] for w in index.point_window])
    rng = np.random.default_rng(31)
    reads = [(int(s), int(min(len(data) - s, rng.integers(1024, 1 << 18))))
             for s in rng.integers(0, len(data), 12)]

    def run():
        got = [zlibes_tpu_torch.inflate_range(comp, index, s, n,
                                              device="cuda")
               for s, n in reads]
        with pytest.raises(zlibes_tpu_torch.CorruptError) as e:
            zlibes_tpu_torch.inflate_range(comp, short, pts[3], 32768,
                                           device="cuda")
        return got, str(e.value)

    card = run()
    monkeypatch.setattr(ip, "_CardGroup", ip._Group)
    assert run() == card
    assert card[0] == [data[s : s + n] for s, n in reads]


@pytest.mark.parametrize("level,stored", [(1, False), (6, False),
                                          (9, False), (6, True)])
def test_stock_zlib_point_reads_at_each_level_on_the_card(level, stored):
    """Point reads (a point every 64 KiB) of 1 MB stock-zlib streams at
    levels 1, 6 and 9, and of one whose middle is 120,000 random bytes
    that zlib stores, on the card: zlib's bytes, for seeded reads and for
    reads that start at a point, end at the stream's end or cross the
    stored blocks (the group decode, split at them)."""
    raw = (GOLDEN / "raw.bin").read_bytes()
    ring = raw + raw[:1 << 16]
    rng = np.random.default_rng(level)
    parts, have = [], 0
    while have < 1_000_000:
        n = min(int(rng.integers(1 << 14, (1 << 16) + 1)), 1_000_000 - have)
        off = int(rng.integers(0, len(raw)))
        parts.append(ring[off : off + n])
        have += n
    if stored:
        parts.insert(len(parts) // 2, rng.integers(
            0, 256, 120000, np.uint8).tobytes())
    data = b"".join(parts)
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8)
    comp = c.compress(data) + c.flush()
    index = zlibes_tpu_torch.build_index(comp, point_every=1 << 16)
    kept = [b for b in index.blocks if b.btype == C.BTYPE_STORED
            and b.out_len]
    assert bool(kept) == stored
    pts = [index.blocks[b].out_start for b in index.point_block]
    reads = [(0, 1), (pts[3], 70000), (len(data) - 5000, 5000)]
    reads += [(int(s), int(min(len(data) - s, rng.integers(1, 1 << 18))))
              for s in rng.integers(0, len(data), 16)]
    if stored:
        reads.append((kept[0].out_start - 3000,
                      kept[-1].out_start + kept[-1].out_len + 6000
                      - kept[0].out_start))
    for s, n in reads:
        got = zlibes_tpu_torch.inflate_range(comp, index, s, n, device="cuda")
        assert got == data[s : s + n], (s, n)


@pytest.mark.parametrize("case", ["warp_32_rows", "long_codes", "lane_ends",
                                  "scan_lane"])
def test_decode_tokens_kernel_gives_the_walk_cases(case):
    """The kernel holds each case's tokens call after call, and (but for the
    65,800-token lane, which the CPU tests hold) equals its plain version
    call for call."""
    from test_torch_contract_cases import run_walk_case
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    def decode(*args):
        *lanes, T = args
        lanes = [torch.as_tensor(np.asarray(a)) for a in lanes]
        got = ik.decode_tokens(*(a.cuda() for a in lanes), T=T)
        torch.cuda.synchronize()
        if case != "scan_lane":
            check_decode_tokens(got, ik.decode_tokens_plain(*lanes, T), T)
        return got

    run_walk_case(case, decode)


@pytest.mark.parametrize("case", ["megabyte_run", "tiles_and_lanes",
                                  "overlapping", "scan_window"])
def test_resolve_global_kernel_gives_the_span_cases(case):
    """The kernel equals its plain version and the case's bytes, and its
    last round leaves no byte open."""
    from test_torch_contract_cases import span_case
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    args, want = span_case(case)
    out, err = _resolve_global_both(*args)
    assert not err and np.array_equal(out.numpy(), want)
    cuda = [torch.as_tensor(a).cuda() if isinstance(a, np.ndarray) else a
            for a in args]
    got, _, open_ = ik._resolve_global_cuda(*cuda)
    assert torch.equal(got.cpu(), out)
    assert open_.numel() == ik.resolve_rounds(args[4]) + 1
    assert int(open_[-1]) == 0


# ---------------------------------------------------------------------------
# block parallelism (zlibes_tpu_torch.parallel) at world 1, on the card

RAW = (GOLDEN / "raw.bin").read_bytes()


def _parallel_modes():
    return {"dynamic": dict(block_size=16384),
            "fixed": dict(block_size=16384, dynamic=False),
            "turbo": dict(block_size=16384, turbo=True, with_index=True)}


@pytest.mark.parametrize("mode", ["dynamic", "fixed", "turbo"])
def test_parallel_deflate_on_card_equals_cpu(mode):
    """parallel_deflate on a card mesh of one writes the CPU mesh's bytes
    and index, and parallel_inflate on the card gives the input back."""
    from zlibes_tpu_torch import parallel as P

    data = RAW[:131072]
    kw = _parallel_modes()[mode]
    cuda, cpu = P.make_mesh(1, device="cuda"), P.make_mesh(1, device="cpu")
    got = P.parallel_deflate(data, cuda, **kw)
    want = P.parallel_deflate(data, cpu, **kw)
    if mode == "turbo":
        assert got[0] == want[0] and got[1].blocks == want[1].blocks
        for f in ("anchor_bit", "anchor_out", "anchor_block"):
            assert np.array_equal(getattr(got[1], f), getattr(want[1], f))
        assert P.parallel_inflate(*got, cuda) == data
    else:
        assert got == want and zlib.decompress(got) == data


def test_parallel_inflate_on_card_equals_cpu():
    """The wide and generic paths of parallel_inflate on the card."""
    from zlibes_tpu_torch import parallel as P
    from zlibes_tpu_torch.codec import deflate_pipeline as tdp
    from zlibes_tpu_torch.spec import refmodel as rm

    data = RAW[:98304]
    wide, w_index = tdp.deflate(data, with_index=True, level=1,
                                block_size=16384, device="cpu")
    gen, g_index = rm.deflate(data[:40000], block_size=8192, with_index=True,
                              anchor_every=1024)
    cuda, cpu = P.make_mesh(1, device="cuda"), P.make_mesh(1, device="cpu")
    tk.LAUNCHES.clear()
    assert P.parallel_inflate(wide, w_index, cuda) == data
    assert P.parallel_inflate(gen, g_index, cuda) == data[:40000]
    assert {k: tk.LAUNCHES[k] for k in ("wide_lanes", "decode_wide",
                                        "resolve_wide", "decode_tokens",
                                        "resolve_global")} \
        == dict(wide_lanes=1, decode_wide=1, resolve_wide=1, decode_tokens=1,
                resolve_global=1)
    assert P.parallel_inflate(wide, w_index, cpu) == data


def test_parallel_turbo_round_trip_on_card_never_takes_plain(monkeypatch):
    """The parallel turbo encode and inflate with every plain version they
    could reach patched to raise: the kernels carry the path."""
    from zlibes_tpu_torch import parallel as P
    from zlibes_tpu_torch.ops import encode_kernel as ek

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((tk, "select_turbo_plain"), (ek, "encode_fields_plain"),
                      (tk, "decode_turbo_plain"), (tk, "resolve_turbo_plain")):
        monkeypatch.setattr(mod, name, plain)
    data = RAW[:131072]
    mesh = P.make_mesh(1, device="cuda")
    tk.LAUNCHES.clear()
    comp, index = P.parallel_deflate(data, mesh, block_size=16384,
                                     turbo=True, with_index=True)
    assert zlib.decompress(comp) == data
    assert P.parallel_inflate(comp, index, mesh) == data
    assert {k: tk.LAUNCHES[k] for k in ("select_turbo", "encode_fields",
                                        "decode_turbo", "resolve_turbo")} \
        == dict(select_turbo=1, encode_fields=1, decode_turbo=1,
                resolve_turbo=1)
