"""Hand-made dispatches for ``block_tables`` (``zlibes_tpu_torch.ops.
block_tables``) and what the host functions it stands for make of them.

Each case is (ll_freq (B, 288), d_freq (B, 32) int64, n_valid (B,) int32,
nblocks, final) as the general encoder hands them over: histograms as
``token_symbols`` counts them (no end of block), the bytes of each block,
the real blocks and the stream's last one.  ``expected`` composes
``package_merge_np``, ``_dynamic_header``, ``_payload_bits`` and
``_encode_tables`` by hand, block by block; the CPU test holds the plain
route to it, the card test holds the kernel to both.
"""
import numpy as np
import torch

from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.spec import constants as C

NH = C.NUM_LITLEN_SYMBOLS
ND = C.NUM_DIST_SYMBOLS
N = C.BLOCK_MAX_BUFFER_LEN


def _bytes_of(ll: np.ndarray, mean_match: int = 6) -> int:
    """A block size that fits the histogram: a byte a literal, a few a
    match."""
    return int(ll[:256].sum() + mean_match * ll[257:286].sum())


def _random(rng, B=4):
    ll = rng.integers(0, 1000, (B, NH)) * (rng.random((B, NH)) < 0.8)
    ll[:, 256] = 0
    ll[:, 286:] = 0
    d = rng.integers(0, 400, (B, ND)) * (rng.random((B, ND)) < 0.9)
    d[:, 30:] = 0
    # as many distances as length symbols
    d[:, 0] += np.maximum(ll[:, 257:286].sum(1) - d.sum(1), 0)
    ll[:, 257] += np.maximum(d.sum(1) - ll[:, 257:286].sum(1), 0)
    nv = np.array([_bytes_of(r) for r in ll])
    return ll, d, np.minimum(nv, N), B, B - 1


def _zipf(rng, B=4):
    ll = np.zeros((B, NH), np.int64)
    d = np.zeros((B, ND), np.int64)
    for i in range(B):
        a = rng.uniform(0.6, 2.0)
        w = 1.0 / np.arange(1, 287) ** a
        ll[i, rng.permutation(286)] = (w / w.sum() * 60000).astype(np.int64)
        ll[i, 256] = 0
        nm = int(ll[i, 257:286].sum())
        wd = 1.0 / np.arange(1, 31) ** rng.uniform(0.5, 1.5)
        d[i, rng.permutation(30)] = np.floor(wd / wd.sum() * nm)
        d[i, 0] += nm - int(d[i].sum())
    nv = np.array([min(_bytes_of(r), N) for r in ll])
    return ll, d, nv, B, -1


def _no_distances(rng):
    ll = np.zeros((2, NH), np.int64)
    ll[:, :256] = rng.integers(0, 300, (2, 256))
    d = np.zeros((2, ND), np.int64)
    return ll, d, ll[:, :256].sum(1), 2, -1


def _one_symbol(rng):
    """A block of one literal byte repeated, and one whose histogram is
    empty: the end of block is its only symbol."""
    ll = np.zeros((2, NH), np.int64)
    ll[0, 65] = 5000
    d = np.zeros((2, ND), np.int64)
    return ll, d, np.array([5000, 1]), 2, 1


def _stored_wins(rng):
    """Every byte value equally often, no match: no code beats 8 bits a
    byte, and the header tips it to stored."""
    ll = np.zeros((2, NH), np.int64)
    ll[:, :256] = N // 256
    d = np.zeros((2, ND), np.int64)
    return ll, d, np.array([N, N]), 2, -1


def _fixed_wins(rng):
    """Ten literals: a dynamic header costs more than fixed codes save."""
    ll = np.zeros((2, NH), np.int64)
    ll[0, [97, 98, 99, 100, 101]] = 2
    ll[1, 97:107] = 1
    ll[1, 258] = 1
    d = np.zeros((2, ND), np.int64)
    d[1, 3] = 1
    return ll, d, np.array([10, 14]), 2, -1


def _final(rng):
    ll, d, nv, B, _ = _random(rng, 3)
    return ll, d, nv, B, 2


def _short_last(rng):
    """Three real blocks of five, the last short and the stream's end."""
    ll, d, nv, _, _ = _random(rng, 5)
    ll[2] //= 50
    d[2] //= 50
    ll[2, 257] += max(int(d[2].sum()) - int(ll[2, 257:286].sum()), 0)
    nv[2] = _bytes_of(ll[2])
    ll[3:] = 0
    d[3:] = 0
    nv[3:] = 0
    return ll, d, nv, 3, 2


CASES = {
    "random": _random,
    "zipf": _zipf,
    "no_distances": _no_distances,
    "one_symbol": _one_symbol,
    "stored_wins": _stored_wins,
    "fixed_wins": _fixed_wins,
    "final": _final,
    "short_last": _short_last,
}
# the coding each case must lead to where it is named for it, a block each
WANT_BTYPE = {
    "stored_wins": [C.BTYPE_STORED] * 2,
    "fixed_wins": [C.BTYPE_FIXED] * 2,
}


def case(name: str, seed: int = 0):
    """The case's CPU tensors (ll_freq, d_freq, n_valid) and ints (nblocks,
    final)."""
    ll, d, nv, nblocks, final = CASES[name](np.random.default_rng(seed))
    return (torch.from_numpy(np.asarray(ll, np.int64)),
            torch.from_numpy(np.asarray(d, np.int64)),
            torch.from_numpy(np.asarray(nv, np.int32)), nblocks, final)


def expected(ll_freq, d_freq, n_valid, nblocks: int, final: int) -> list:
    """Per real block, by the host functions alone: (btype, ll_len,
    d_len, ll_code, d_code, header bytes, header bits, EOB code, EOB
    length); the tables None for a stored block."""
    out = []
    for i in range(nblocks):
        llf = ll_freq[i].numpy().astype(np.int64)
        llf[C.END_OF_BLOCK] += 1
        dfq = d_freq[i].numpy().astype(np.int64)
        ll_len = bt.package_merge_np(llf, 15)
        d_len = bt.package_merge_np(dfq, 15)
        if not d_len.any():
            d_len[0] = 1
        bfinal = int(i == final)
        hdr, hbits = bt._dynamic_header(ll_len, d_len, bfinal)
        dyn = hbits + bt._payload_bits(llf, dfq, ll_len, d_len) \
            + int(ll_len[C.END_OF_BLOCK])
        fll = C.fixed_litlen_code_lengths()
        fd = C.fixed_dist_code_lengths()
        fix = 3 + bt._payload_bits(llf, dfq, fll, fd) + int(fll[256])
        nb = int(n_valid[i])
        if nb + 5 * (-(-nb // 65535)) < min(dyn, fix) // 8:
            out.append((C.BTYPE_STORED,) + (None,) * 8)
            continue
        if fix <= dyn:
            btype, ll_len, d_len = C.BTYPE_FIXED, fll, fd
            hdr, hbits = bytes([bfinal | 2]), 3
        else:
            btype = C.BTYPE_DYNAMIC
        ll_code, d_code = bt._encode_tables(ll_len, d_len)
        out.append((btype, ll_len, d_len, ll_code, d_code, hdr, hbits,
                    int(ll_code[256]), int(ll_len[256])))
    return out


def check(got, want: list, B: int) -> None:
    """``block_tables``' results ``got`` (CPU tensors) against
    ``expected``'s ``want``: every field of every real block, zeros
    elsewhere."""
    ll_code, ll_len, d_code, d_len, hdr_bits, enabled, info = (
        t.numpy() for t in got)
    assert info.shape == (B, bt.INFO)
    for i in range(B):
        w = want[i] if i < len(want) else (C.BTYPE_STORED,) + (None,) * 8
        btype, wll_len, wd_len, wll_code, wd_code, hdr, hbits, eobc, eobl = w
        assert info[i, 0] == btype, (i, info[i, 0], btype)
        if btype == C.BTYPE_STORED:
            for a in (ll_code, ll_len, d_code, d_len, info):
                assert not a[i].any(), i
            assert hdr_bits[i] == 0 and not enabled[i]
            continue
        assert enabled[i]
        assert np.array_equal(ll_len[i], wll_len), i
        assert np.array_equal(d_len[i], wd_len), i
        assert np.array_equal(ll_code[i], wll_code), i
        assert np.array_equal(d_code[i], wd_code), i
        assert hdr_bits[i] == hbits == info[i, 3], i
        assert tuple(info[i, 1:3]) == (eobc, eobl), i
        hb = info[i, 4:].view(np.uint8)
        assert hb[: len(hdr)].tobytes() == hdr, i
        assert not hb[len(hdr):].any(), i
