"""Each block's coding choice and tables for the general encoder: the
``block_tables`` kernel for NVIDIA Hopper, with its plain version, the host
planner.

For every block of a dispatch, from its litlen (288) and distance (32)
histograms as the symbols stage leaves them: the end-of-block count added,
length-limited (15-bit) code lengths by package-merge, one distance code
where no distance is used, the dynamic header, the exact dynamic, fixed and
stored costs and the cheapest of the three, and the canonical bit-reversed
codes of the chosen tables.  The outputs are ``pack_payload``'s table
arguments and what the host needs to splice the block (``info``).

The JAX package plans each block on the host (``_plan_block`` in
``zlibes_tpu/codec/deflate_pipeline.py``); there is no Pallas kernel.  The
plain version here is that planner (``package_merge_np``,
``_dynamic_header``, ``_payload_bits``, ``_encode_tables``), one block at a
time in numpy.  On the card one CTA a block builds the same bits
(``csrc/encode_kernels.cu``), so the histograms need not come to the host
and the tables need not go back before the pack.

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; any other device raises.  Launches count in
``turbo_kernel.LAUNCHES``.  The shared-table encoders build one table pair
a stream with the host functions below directly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import huffman
from ..spec import constants as C
from ..spec.refmodel import BitWriter, _rle_code_lengths

from .turbo_kernel import _check, _launch, _ptr, _route

_RLE_EXTRA_BITS = {16: 2, 17: 3, 18: 7}
_FIXED_LL_LEN = C.fixed_litlen_code_lengths()
_FIXED_D_LEN = C.fixed_dist_code_lengths()

# int64 words of header bytes a block in ``info``: 320 bytes, and a header
# has at most 17 + 19 * 3 + 316 * 7 = 2,286 bits (no code-length symbol
# costs more than 7 bits a code length it stands for)
HDR_WORDS = 40
# ``info`` columns: btype, end-of-block code, its length, header bits, then
# the header's bytes, little-endian, 8 a word
INFO = 4 + HDR_WORDS


# ---------------------------------------------------------------------------
# host header work (numpy; the port's own copies of the reference's)

def package_merge_np(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Length-limited Huffman lengths via matrix-form package-merge
    (package membership tracked as count vectors)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    S = freqs.size
    lengths = np.zeros(S, dtype=np.int32)
    active = np.nonzero(freqs)[0]
    n = active.size
    if n == 0:
        return lengths
    if n == 1:
        lengths[active[0]] = 1
        return lengths
    order = np.argsort(freqs[active], kind="stable")
    sw = freqs[active][order]
    sm = np.eye(n, dtype=np.int32)[order]
    mw, mm = sw, sm
    for _ in range(max_len - 1):
        k = (mw.size // 2) * 2
        pw = mw[0:k:2] + mw[1:k:2]
        pm = mm[0:k:2] + mm[1:k:2]
        mw = np.concatenate([sw, pw])
        mm = np.concatenate([sm, pm])
        o = np.argsort(mw, kind="stable")
        mw, mm = mw[o], mm[o]
    lengths[active] = mm[: 2 * n - 2].sum(axis=0)
    return lengths


def _encode_tables(ll_len: np.ndarray, d_len: np.ndarray):
    """Canonical codes (bit-reversed, ready for LSB-first packing)."""
    codes_ll = huffman.canonical_codes_batch(ll_len[None, :])[0]
    codes_d = huffman.canonical_codes_batch(d_len[None, :])[0]
    rev = huffman._REV16
    ll_code = np.where(
        ll_len > 0, rev[codes_ll.astype(np.uint32)] >> (16 - np.maximum(ll_len, 1)), 0
    ).astype(np.uint32)
    d_code = np.where(
        d_len > 0, rev[codes_d.astype(np.uint32)] >> (16 - np.maximum(d_len, 1)), 0
    ).astype(np.uint32)
    return ll_code, d_code


def _dynamic_header(ll_len: np.ndarray, d_len: np.ndarray,
                    bfinal: int) -> tuple[bytes, int]:
    """A dynamic block header bit-string, 3-bit block prefix included
    (RFC 1951 §3.2.7) -> (bytes, number of bits)."""
    bw = BitWriter()
    bw.write_bits(bfinal, 1)
    bw.write_bits(C.BTYPE_DYNAMIC, 2)
    hlit = max(257, int(np.nonzero(ll_len)[0].max(initial=256)) + 1)
    hdist = max(1, int(np.nonzero(d_len)[0].max(initial=0)) + 1)
    all_lengths = np.concatenate([ll_len[:hlit], d_len[:hdist]])
    rle = _rle_code_lengths(all_lengths)
    clc_freq = np.zeros(C.NUM_CODELEN_SYMBOLS, dtype=np.int64)
    for sym, _ in rle:
        clc_freq[sym] += 1
    clc_len = package_merge_np(clc_freq, C.MAX_CLC_BITS)
    clc_codes = huffman.canonical_codes_batch(clc_len[None, :].astype(np.int64))[0]
    hclen = 19
    while hclen > 4 and clc_len[int(C.CODELEN_ORDER[hclen - 1])] == 0:
        hclen -= 1
    bw.write_bits(hlit - 257, 5)
    bw.write_bits(hdist - 1, 5)
    bw.write_bits(hclen - 4, 4)
    for i in range(hclen):
        bw.write_bits(int(clc_len[int(C.CODELEN_ORDER[i])]), 3)
    for sym, extra in rle:
        bw.write_code(int(clc_codes[sym]), int(clc_len[sym]))
        if sym in _RLE_EXTRA_BITS:
            bw.write_bits(extra, _RLE_EXTRA_BITS[sym])
    nbits = bw.bit_length
    return bytes(bw.out) + (bytes([bw.bitbuf]) if bw.bitcnt else b""), nbits


def _payload_bits(ll_freq, d_freq, ll_len, d_len):
    """Exact coded payload size (tokens only, EOB excluded) of the
    histograms along the last axis."""
    lf = ll_freq[..., 257:286]
    df = d_freq[..., :30]
    return ((ll_freq * ll_len).sum(-1) + (d_freq * d_len).sum(-1)
            + (lf * C.LENGTH_EXTRA_BITS[: lf.shape[-1]]).sum(-1)
            + (df * C.DIST_EXTRA_BITS[: df.shape[-1]]).sum(-1))


class _BlockPlan:
    """How one block is coded: stored, or under fixed or dynamic tables
    with its header bits and end-of-block code."""
    __slots__ = ("btype", "bfinal", "hdr_bytes", "hdr_bits", "ll_len",
                 "d_len", "ll_code", "d_code", "eob_code", "eob_len")


def _plan_block(llf: np.ndarray, dfq: np.ndarray, nb: int,
                bfinal: int) -> _BlockPlan:
    """The cheapest of stored, fixed and dynamic for a block of ``nb``
    bytes with the litlen and distance histograms ``llf`` (end-of-block
    counted) and ``dfq``, with its tables."""
    ll_len = package_merge_np(llf, C.MAX_CODELEN_BITS)
    d_len = package_merge_np(dfq, C.MAX_CODELEN_BITS)
    if d_len.max(initial=0) == 0:
        d_len[0] = 1
    hdr, hdr_nbits = _dynamic_header(ll_len, d_len, bfinal)
    dyn_bits = hdr_nbits + _payload_bits(llf, dfq, ll_len, d_len) \
        + int(ll_len[C.END_OF_BLOCK])
    fix_bits = 3 + _payload_bits(llf, dfq, _FIXED_LL_LEN, _FIXED_D_LEN) \
        + int(_FIXED_LL_LEN[C.END_OF_BLOCK])
    stored_bytes = nb + 5 * (-(-nb // 65535))
    plan = _BlockPlan()
    plan.bfinal = bfinal
    if stored_bytes < min(dyn_bits, fix_bits) // 8:
        plan.btype = C.BTYPE_STORED
        return plan
    if fix_bits <= dyn_bits:
        plan.btype = C.BTYPE_FIXED
        plan.hdr_bytes = bytes([bfinal | (C.BTYPE_FIXED << 1)])
        plan.hdr_bits = 3
        plan.ll_len, plan.d_len = _FIXED_LL_LEN, _FIXED_D_LEN
    else:
        plan.btype = C.BTYPE_DYNAMIC
        plan.hdr_bytes = hdr
        plan.hdr_bits = hdr_nbits
        plan.ll_len, plan.d_len = ll_len, d_len
    plan.ll_code, plan.d_code = _encode_tables(plan.ll_len, plan.d_len)
    plan.eob_code = int(plan.ll_code[C.END_OF_BLOCK])
    plan.eob_len = int(plan.ll_len[C.END_OF_BLOCK])
    return plan


# ---------------------------------------------------------------------------
# the stage: kernel and plain version

def block_tables_plain(ll_freq, d_freq, n_valid, nblocks: int, final: int):
    """The host planner, ``_plan_block`` a block, on CPU tensors; the
    arguments and results of ``block_tables``."""
    B = ll_freq.shape[0]
    llf_all = ll_freq.numpy()
    dfq_all = d_freq.numpy()
    nv = n_valid.numpy()
    ll_code = np.zeros((B, C.NUM_LITLEN_SYMBOLS), np.int64)
    ll_len = np.zeros((B, C.NUM_LITLEN_SYMBOLS), np.int64)
    d_code = np.zeros((B, C.NUM_DIST_SYMBOLS), np.int64)
    d_len = np.zeros((B, C.NUM_DIST_SYMBOLS), np.int64)
    hdr_bits = np.zeros(B, np.int64)
    enabled = np.zeros(B, bool)
    info = np.zeros((B, INFO), np.int64)
    for i in range(nblocks):
        llf = llf_all[i].astype(np.int64)
        llf[C.END_OF_BLOCK] += 1
        plan = _plan_block(llf, dfq_all[i].astype(np.int64), int(nv[i]),
                           int(i == final))
        if plan.btype == C.BTYPE_STORED:
            continue
        ll_code[i] = plan.ll_code
        ll_len[i] = plan.ll_len
        d_code[i] = plan.d_code
        d_len[i] = plan.d_len
        hdr_bits[i] = plan.hdr_bits
        enabled[i] = True
        info[i, :4] = (plan.btype, plan.eob_code, plan.eob_len, plan.hdr_bits)
        hb = np.frombuffer(plan.hdr_bytes, np.uint8)
        info[i, 4:].view(np.uint8)[: hb.size] = hb
    return tuple(torch.from_numpy(x) for x in (
        ll_code, ll_len, d_code, d_len, hdr_bits, enabled, info))


def block_tables(ll_freq: torch.Tensor, d_freq: torch.Tensor,
                 n_valid: torch.Tensor, nblocks: int, final: int):
    """Each block's coding choice and tables.

    ll_freq (B, 288), d_freq (B, 32) int64 each block's histograms (the end
    of block not counted), n_valid (B,) int32 its bytes; blocks [0,
    nblocks) are real, the others padding; ``final`` is the block that
    ends the stream (BFINAL), or -1.  Returns (ll_code, ll_len (B, 288),
    d_code, d_len (B, 32), hdr_bits (B,) int64 and enabled (B,) bool:
    ``pack_payload``'s table arguments; info (B, INFO) int64: btype, the
    end-of-block code and its length, the header's bits, then its bytes).
    A stored or padding block is zeros throughout, btype 0 included."""
    dev = ll_freq.device
    B = ll_freq.shape[0]
    _check(ll_freq, "ll_freq", torch.int64, (B, C.NUM_LITLEN_SYMBOLS), dev)
    _check(d_freq, "d_freq", torch.int64, (B, C.NUM_DIST_SYMBOLS), dev)
    _check(n_valid, "n_valid", torch.int32, (B,), dev)
    if not 0 <= nblocks <= B or not -1 <= final < nblocks:
        raise ValueError(f"nblocks {nblocks} and final {final} do not fit "
                         f"{B} blocks")
    if not _route(ll_freq):
        return block_tables_plain(ll_freq, d_freq, n_valid, nblocks, final)
    outs = tuple(torch.empty(shape, dtype=dtype, device=dev)
                 for shape, dtype in (
                     ((B, C.NUM_LITLEN_SYMBOLS), torch.int64),
                     ((B, C.NUM_LITLEN_SYMBOLS), torch.int64),
                     ((B, C.NUM_DIST_SYMBOLS), torch.int64),
                     ((B, C.NUM_DIST_SYMBOLS), torch.int64),
                     ((B,), torch.int64), ((B,), torch.bool),
                     ((B, INFO), torch.int64)))
    if B:
        _launch("block_tables", dev, _ptr(ll_freq), _ptr(d_freq),
                _ptr(n_valid), *(ctypes.c_int(v) for v in (B, nblocks, final)),
                *(_ptr(t) for t in outs))
    return outs
