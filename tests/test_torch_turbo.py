"""The PyTorch port's turbo inflate, stage by stage, against the JAX package.

The same turbo streams (made by the JAX encoder at test time) go through
each JAX stage (Pallas kernels in interpret mode on the CPU) and through
the port's counterpart (plain PyTorch versions on the CPU).  Every array is
an integer array or bytes, so every comparison is exact.
"""
import zlib

import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.codec import inflate_pipeline as jip
from zlibes_tpu.codec import turbo as jtb
from zlibes_tpu.config import CodecConfig
from zlibes_tpu.ops import turbo_kernel as jtk

import zlibes_tpu_torch
from zlibes_tpu_torch.codec import turbo as tb
from zlibes_tpu_torch.ops import turbo_kernel as tk

torch.set_num_threads(2)

CFG = CodecConfig.turbo(candidates=4, probe_words=4)
BS = 16384  # small blocks keep CPU compiles fast


def _mixed_data(n=40000, seed=0):
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)
    rnd = rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()
    rle = b"A" * 1200 + b"ab" * 700 + bytes(range(256)) * 4
    out = (text + rnd + rle) * 3
    return out[:n]


STREAMS = {
    "mixed": lambda: _mixed_data(),
    "rle": lambda: b"x" * 5000 + b"yz" * 3000 + b"x" * 300,
    "incompressible": lambda: np.random.default_rng(7).integers(
        0, 256, 12000, dtype=np.uint8).tobytes(),
}


def plan_from_reference(arrays: dict[str, np.ndarray],
                        lane_block: int) -> tb.TurboPlan:
    """The port's CPU plan from the arrays of a JAX ``TurboPlan`` (as
    numpy), built with ``sort_lanes=False``: undoes the TPU lane grid, folds
    the 128-word block index and residue into one start word, and keeps the
    reference's L_pad."""
    assert np.array_equal(arrays["chunk_inv"],
                          np.arange(arrays["chunk_inv"].size)), \
        "reference plan was built with sorted lanes"

    def lanes(grid):  # (8, L_pad//8) lane grid -> (L_pad,) lane order
        g = np.asarray(grid, np.int32)
        L_pad = g.size
        return np.ascontiguousarray(
            g.reshape(8, L_pad // lane_block, lane_block // 8)
            .transpose(1, 0, 2)).reshape(L_pad)

    def t(x):
        return torch.from_numpy(np.array(x, np.int32))

    p = tb.TurboPlan()
    p.words = t(np.asarray(arrays["words"]).reshape(-1))
    shift = np.asarray(arrays["shift_idx"])
    p.start_w = t(np.asarray(arrays["starts_w"]) * 128 + shift[:, 0])
    p.bit0 = t(lanes(arrays["bit0"]))
    p.endb = t(lanes(arrays["endb"]))
    p.base = t(lanes(arrays["base_g"]))
    p.endb_host = p.endb.numpy()
    p.lt = t(np.asarray(arrays["lt"])[0])
    p.dt = t(np.asarray(arrays["dt"])[0])
    p.L = int(arrays["L"])
    p.L_pad = p.start_w.numel()
    p.C_pad = p.L_pad // tk.SUBS_PER_CHUNK
    p.T = int(arrays["T"])
    p.total_out = int(arrays["total_out"])
    return p


class Ref:
    """One stream with the JAX package's stage outputs, in lane order."""

    def __init__(self, data: bytes):
        self.data = data
        self.comp, self.index = dp.deflate(data, with_index=True, config=CFG,
                                           block_size=BS)
        jp = jtb.TurboPlan.build(self.comp, self.index, sort_lanes=False)
        self.jplan = jp
        self.arrays = {k: np.asarray(getattr(jp, k))
                       for k in jtb.TurboPlan.__slots__}
        LB = jp.LB
        fetched = jtk.extract_lanes(jp.words, jp.starts_w)
        lanes = jtk.shift_lanes(fetched, jp.shift_idx, LB=LB)
        self.windows = np.asarray(lanes)
        tg, mg = jtk.decode_turbo(jtb._to_planes(lanes, LB=LB), jp.bit0,
                                  jp.endb, jp.lt, jp.dt, T=jp.T, LB=LB)
        self.tokens = np.asarray(jtb._from_grid(tg, LB=LB))
        self.meta = np.asarray(jtb._from_grid(mg, LB=LB))
        t16, s16 = jtb._glue_tokens(tg, mg[0], jp.base_g, T=jp.T,
                                    C_pad=jp.C_pad, LB=LB)
        self.toks16 = np.asarray(t16)
        self.starts16 = np.asarray(s16)
        self.rows = np.asarray(jtk.resolve_turbo(t16, s16))
        self.plan = plan_from_reference(self.arrays, LB)


@pytest.fixture(scope="module", params=sorted(STREAMS))
def ref(request):
    return Ref(STREAMS[request.param]())


def _t(x):
    return torch.from_numpy(np.array(x))


def test_constants_match_reference():
    for name in ("M_BITS", "TABLE", "SEG_SPAN", "SUB", "SUBS_PER_CHUNK",
                 "STREAM_WORDS", "MAX_TOKENS", "TOKENS_PAD", "TOK_VAL_MASK",
                 "TOK_DIST_SHIFT", "TOK_DIST_MASK", "TOK_MATCH_BIT",
                 "_KIND_LIT", "_KIND_EOB", "_KIND_LEN", "_KIND_INVALID"):
        assert getattr(tk, name) == getattr(jtk, name), name


def test_decode_tables_match_reference(ref):
    blk = next(b for b in ref.index.blocks if b.btype == 2)
    ll, dl = jip._block_code_lengths(ref.comp, blk)
    jlt, jdt = jtk.turbo_decode_tables(ll, dl)
    lt, dt = tk.turbo_decode_tables(ll, dl)
    assert (jlt == lt[None, :]).all() and (jdt == dt[None, :]).all()


def test_plan_matches_reference(ref):
    built = tb.TurboPlan.build(ref.comp, ref.index, "cpu")
    want = ref.plan
    assert (built.L, built.T, built.total_out) == (want.L, want.T,
                                                   want.total_out)
    L = built.L
    for name in ("start_w", "bit0", "endb", "base"):
        got, exp = getattr(built, name), getattr(want, name)
        assert torch.equal(got[:L], exp[:L]), name
        assert not got[L:].any() and not exp[L:].any(), name
    assert torch.equal(built.lt, want.lt) and torch.equal(built.dt, want.dt)
    n = built.words.numel()
    assert torch.equal(built.words, want.words[:n])
    assert not want.words[n:].any()


def test_lane_windows_match_reference(ref):
    win = tk.lane_windows(ref.plan.words, ref.plan.start_w)
    assert np.array_equal(win.numpy(), ref.windows)


def test_decode_matches_reference(ref):
    p = ref.plan
    tokens, meta = tk.decode_turbo(_t(ref.windows), p.bit0, p.endb, p.lt,
                                   p.dt, T=p.T)
    assert np.array_equal(meta.numpy(), ref.meta)
    counts = ref.meta[0]
    emitted = np.arange(p.T)[:, None] < counts[None, :]
    assert np.array_equal(tokens.numpy()[emitted], ref.tokens[emitted])
    assert counts[: p.L].sum() > 0
    p.check_meta(meta.numpy())


def test_glue_matches_reference(ref):
    p = ref.plan
    toks16, starts16 = tb._glue_tokens(_t(ref.tokens), _t(ref.meta[0]),
                                       p.base, p.C_pad)
    assert np.array_equal(toks16.numpy(), ref.toks16)
    assert np.array_equal(starts16.numpy(), ref.starts16)


def test_resolve_matches_reference(ref):
    rows = tk.resolve_turbo(_t(ref.toks16), _t(ref.starts16))
    # bytes past total_out (the last chunk's tail) are covered by no token:
    # they are cut from the output, and the two searches differ there
    n = ref.plan.total_out
    got = rows.numpy().reshape(-1)[:n]
    assert np.array_equal(got, ref.rows.reshape(-1)[:n])
    assert got.tobytes() == ref.data


def test_inflate_matches_reference(ref):
    out = zlibes_tpu_torch.inflate(ref.comp, index=ref.index, device="cpu")
    assert out == ref.data
    assert out == zlib.decompress(ref.comp)
    assert out == jip.inflate(ref.comp, index=ref.index)


def test_run_turbo_on_reference_plan(ref):
    rows = tb.run_turbo(ref.plan)
    assert rows.reshape(-1)[: ref.plan.total_out].numpy().tobytes() == ref.data
