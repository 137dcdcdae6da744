"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs a CUDA card and ``nvcc``; skips elsewhere.  Imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlibes_tpu_torch
from zlibes_tpu.spec.refmodel import StreamIndex
from zlibes_tpu_torch.codec import turbo as tb
from zlibes_tpu_torch.ops import turbo_kernel as tk

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


def _decode_both(win, bit0, endb, lt, dt):
    tok_k, meta_k = tk.decode_turbo(win, bit0, endb, lt, dt)
    torch.cuda.synchronize()
    tok_p, meta_p = tk.decode_turbo_plain(win, bit0, endb, lt, dt)
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


def test_decode_kernel_matches_plain_on_garbage(plans):
    """Random windows: error, end-of-block and overrun paths agree too."""
    _, p = plans
    g = torch.Generator().manual_seed(0)
    L = 4096
    win = torch.randint(-2**31, 2**31 - 1, (L, tk.STREAM_WORDS),
                        generator=g, dtype=torch.int64).int()
    bit0 = torch.randint(0, 32, (L,), generator=g, dtype=torch.int32)
    endb = bit0 + torch.randint(0, 92 * 32 - 31, (L,), generator=g,
                                dtype=torch.int32)
    meta = _decode_both(win.cuda(), bit0.cuda(), endb.cuda(), p.lt, p.dt)
    assert meta[2].any() and (meta[2] == 0).any()


def test_resolve_kernel_matches_plain(plans):
    _, p = plans
    win = tk.lane_windows(p.words, p.start_w)
    tokens, meta = tk.decode_turbo(win, p.bit0, p.endb, p.lt, p.dt)
    toks16, starts16 = tb._glue_tokens(tokens, meta[0], p.base, p.C_pad)
    got = tk.resolve_turbo(toks16, starts16)
    torch.cuda.synchronize()
    assert _same(got, tk.resolve_turbo_plain(toks16, starts16))


def test_resolve_kernel_matches_plain_on_garbage():
    g = torch.Generator().manual_seed(1)
    shape = (tk.SUBS_PER_CHUNK, 32, tk.TOKENS_PAD)
    toks = torch.randint(0, 1 << 22, shape, generator=g, dtype=torch.int32)
    starts = torch.randint(-300, 2100, shape, generator=g, dtype=torch.int32)
    got = tk.resolve_turbo(toks.cuda(), starts.cuda())
    torch.cuda.synchronize()
    assert _same(got, tk.resolve_turbo_plain(toks, starts))


def test_inflate_on_card_counts_launches(fixture_stream):
    comp, index = fixture_stream
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.inflate(comp, index=index, device="cuda")
    assert out == zlib.decompress(comp)
    assert all(tk.LAUNCHES[k] == 1 for k in
               ("lane_windows", "decode_turbo", "resolve_turbo"))


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
