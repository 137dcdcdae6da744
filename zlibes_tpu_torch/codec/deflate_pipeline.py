"""Turbo-profile deflate for the PyTorch port.

Counterpart of the shared-table branch of
``zlibes_tpu/codec/deflate_pipeline.py`` (``_deflate_turbo``, the encoder
of ``CodecConfig.turbo()``).  The input splits into blocks; per dispatch of
``cfg.blocks_per_dispatch`` blocks, padded, on the requested device:

  phase 1  sort-based match finding -> ``select_turbo`` (CUDA kernel) over
           512-byte segment lanes -> symbols and per-block histograms, and
           Adler-32 partial sums; after every dispatch, the stream-wide
           length-limited code lengths (package-merge on the device) ride
           the same single readback;
  host     one dynamic header (identical but for BFINAL) and the shared
           canonical codes;
  phase 2  ``encode_fields`` (CUDA kernel) and the pack into a compacted
           stream image per dispatch, one readback for all dispatches;
  host     splice headers, EOB codes, empty stored sync blocks and the
           paired 512-byte anchors into the stream and its StreamIndex.

The whole encode reads the device back twice.  Beyond
``cfg.phase1_cache_blocks`` blocks phase 2 runs match and select again
instead of keeping phase 1's tokens; the bytes are the same.  Every stage
is integer work, so the bytes equal the JAX package's, on any device.

Other configurations, levels and preset dictionaries raise
NotImplementedError: the general per-block-table encoder is ROADMAP queue 1
item 7.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import CodecConfig, CodecStats
from ..ops import huffman
from ..spec import constants as C
from ..spec.refmodel import (
    BitWriter,
    BlockInfo,
    StreamIndex,
    _rle_code_lengths,
)

from ..ops import turbo_kernel as tk
from ..ops.deflate_kernel import pack_payload_turbo_dense, token_symbols
from ..ops.encode_kernel import pack_tables
from ..ops.entropy import limited_lengths_pair
from ..ops.lz77 import find_matches

_RLE_EXTRA_BITS = {16: 2, 17: 3, 18: 7}
_ADLER_CHUNK = 2048
_M = C.ADLER_MOD
_F = 80  # filler slots per block (header + EOB tail words)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the port encodes only the turbo profile "
        f"(CodecConfig.turbo()); the general encoder is ROADMAP queue 1 "
        f"item 7")


def check_turbo_config(cfg: CodecConfig | None) -> CodecConfig:
    """The config, if it is one the port encodes: shared tables, 512-byte
    segments, a 4 KiB window reset and codes of at most 9 bits."""
    if cfg is None:
        raise _not_ported("the default config")
    if not isinstance(cfg, CodecConfig):
        raise TypeError(
            f"config is a {type(cfg).__module__}.{type(cfg).__qualname__}, "
            f"not zlibes_tpu_torch.CodecConfig; convert it with "
            f"zlibes_tpu_torch.config.config_from_reference")
    if not (cfg.shared_tables and cfg.seg_size == 512
            and cfg.chunk_reset == 4096 and cfg.max_code_bits <= 9
            and not cfg.force_stored):
        raise _not_ported(f"config {cfg}")
    return cfg


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


def _payload_bits(ll_freq, d_freq, ll_len, d_len) -> int:
    """Exact coded payload size (tokens only, EOB excluded)."""
    bits = int((ll_freq * ll_len).sum()) + int((d_freq * d_len).sum())
    lf = ll_freq[257:286]
    bits += int((lf * C.LENGTH_EXTRA_BITS[: lf.size]).sum())
    df = d_freq[:30]
    bits += int((df * C.DIST_EXTRA_BITS[: df.size]).sum())
    return bits


def _or_bits(buf: np.ndarray, bit_off: int, value: int, nbits: int) -> None:
    """OR an LSB-first bit-string into a byte buffer at a bit offset."""
    v = value << (bit_off & 7)
    pos = bit_off >> 3
    nbytes = (nbits + (bit_off & 7) + 7) // 8
    for i in range(nbytes):
        buf[pos + i] |= (v >> (8 * i)) & 0xFF


# ---------------------------------------------------------------------------
# device stages of one dispatch

def adler_terms(dev_bytes: torch.Tensor, n_valid: torch.Tensor):
    """Per-2048-byte-chunk Adler-32 partial sums of the block rows:
    A = sum d_j mod m, B = sum j*d_j mod m -> (A, B) (Bp * N/2048,) int64.
    The host combines them (the s2 term of a chunk at offset o is
    (n - o)*A - B), so the trailer needs no pass of its own."""
    Bp, Npad = dev_bytes.shape
    N = Npad - 8
    d = dev_bytes[:, :N].long()
    pos = torch.arange(N, device=d.device)
    d = torch.where(pos[None, :] < n_valid.long()[:, None], d, 0)
    dd = d.reshape(Bp, N // _ADLER_CHUNK, _ADLER_CHUNK)
    jj = torch.arange(_ADLER_CHUNK, device=d.device)
    return (dd.sum(2) % _M).reshape(-1), ((dd * jj).sum(2) % _M).reshape(-1)


def select_inputs(dev_bytes: torch.Tensor, matches: torch.Tensor,
                  n_valid: torch.Tensor, N: int):
    """Each position packed as ``dist | len << 12 | lit << 21``, in lanes of
    512 -> (pv (L, 512) int32, valid positions per lane (L,) int32)."""
    SEG = tk.SEL_SEG
    B = matches.shape[0]
    nseg = N // SEG
    L = B * nseg
    ml = (matches >> 16) & 0x1FF
    dist = matches & 0xFFF
    lit = dev_bytes[:, :N].int()
    pv = (dist | (ml << tk.SEL_LEN_SHIFT) | (lit << tk.SEL_LIT_SHIFT))
    seg0 = (torch.arange(L, device=pv.device) % nseg) * SEG
    nv = n_valid.repeat_interleave(nseg)
    slen = (nv - seg0).clamp(0, SEG).int()
    return pv.reshape(L, SEG).contiguous(), slen


def select_glue(dev_bytes: torch.Tensor, matches: torch.Tensor,
                n_valid: torch.Tensor, N: int, lazy: bool):
    """Select tokens per 512-byte lane (``select_turbo``) and unpack them to
    (tv, td, cnt) (``_select_turbo_glue``,
    zlibes_tpu/codec/deflate_pipeline.py:214), in lane order: no
    word-planes."""
    pv, slen = select_inputs(dev_bytes, matches, n_valid, N)
    toks, cnt = tk.select_turbo(pv, slen, lazy=lazy)
    is_m = (toks & tk.TOK_MATCH_BIT) != 0
    tv = toks & tk.TOK_VAL_MASK
    td = torch.where(is_m, (toks >> tk.TOK_DIST_SHIFT) & tk.TOK_DIST_MASK, 0)
    return tv, td, cnt


def block_rows(arr: np.ndarray, d0: int, d1: int, N: int, Bp: int):
    blk_bytes = np.zeros((Bp, N + 8), dtype=np.uint8)
    n_valid = np.zeros(Bp, dtype=np.int32)
    for i, bi in enumerate(range(d0, d1)):
        chunk = arr[bi * N : (bi + 1) * N]
        blk_bytes[i, : chunk.size] = chunk
        n_valid[i] = chunk.size
    return blk_bytes, n_valid


def _deflate_turbo(arr: np.ndarray, N: int, cfg: CodecConfig,
                   stats: CodecStats, dev: torch.device):
    """Shared-table encode: one stream-wide length-limited table pair and
    one block header (identical but for BFINAL) for every block."""
    n = arr.size
    nblocks = -(-n // N)
    SEG_SIZE = cfg.seg_size
    nseg = N // SEG_SIZE
    Bp = cfg.blocks_per_dispatch
    keep_tokens = nblocks <= cfg.phase1_cache_blocks

    def run_dispatch(d0: int, d1: int):
        blk_bytes, n_valid = block_rows(arr, d0, d1, N, Bp)
        dev_bytes = torch.from_numpy(blk_bytes).to(dev)
        dev_nv = torch.from_numpy(n_valid).to(dev)
        ad_a, ad_b = adler_terms(dev_bytes, dev_nv)
        with stats.timer("match"):
            matches = find_matches(dev_bytes, dev_nv, N=N, S=cfg.probe_words,
                                   J=cfg.candidates, reset=cfg.chunk_reset)
        with stats.timer("select"):
            tv, td, cnt = select_glue(dev_bytes, matches, dev_nv, N,
                                      cfg.lazy)
        return tv, td, cnt, n_valid, ad_a, ad_b

    # --- phase 1: every dispatch queued before one readback
    nh = C.NUM_LITLEN_SYMBOLS
    nd = C.NUM_DIST_SYMBOLS
    kept = {}
    nv_all = {}
    handles = []
    ll_parts = []
    d_parts = []
    spans = [(d0, min(nblocks, d0 + Bp)) for d0 in range(0, nblocks, Bp)]
    nchunks = N // _ADLER_CHUNK
    nt = Bp * nchunks
    for d0, d1 in spans:
        tv, td, cnt, n_valid, ad_a, ad_b = run_dispatch(d0, d1)
        with stats.timer("symbols"):
            _ls, _ds, valid, ll_freq, d_freq = token_symbols(tv, td, cnt,
                                                            nseg=nseg)
        # per-block histograms give the host each block's exact payload bits
        # once the shared lengths exist, so phase 2 needs no sizing sync
        handles.append(torch.cat([ll_freq.reshape(-1), d_freq.reshape(-1),
                                  cnt.max().long()[None], ad_a, ad_b]))
        ll_parts.append(ll_freq.sum(0))
        d_parts.append(d_freq.sum(0))
        nv_all[d0] = n_valid
        if keep_tokens:
            kept[d0] = (tv, td, valid)
        stats.dispatches += 1
    # the shared code lengths, built on the device, ride the same readback
    with stats.timer("entropy"):
        ll_tot = sum(ll_parts)
        ll_tot[C.END_OF_BLOCK] += nblocks
        ll_d, d_d = limited_lengths_pair(ll_tot.clamp(max=1 << 28),
                                         sum(d_parts).clamp(max=1 << 28),
                                         cfg.max_code_bits)
        handles.append(ll_d.long())
        handles.append(d_d.long())
    with stats.timer("readback"):
        hist_all = torch.cat(handles).cpu().numpy()
    ll_len = hist_all[-(nh + nd) : -nd]
    d_len = hist_all[-nd:]
    hist_all = hist_all[: -(nh + nd)]
    per = Bp * nh + Bp * nd + 1 + 2 * nt
    ll_blocks = np.zeros((len(spans), Bp, nh), np.int64)
    d_blocks = np.zeros((len(spans), Bp, nd), np.int64)
    max_tokens = 0
    s1_sum = 0
    s2_sum = 0
    for k, (d0, d1) in enumerate(spans):
        h = hist_all[k * per : (k + 1) * per]
        ll_blocks[k] = h[: Bp * nh].reshape(Bp, nh)
        d_blocks[k] = h[Bp * nh : Bp * (nh + nd)].reshape(Bp, nd)
        max_tokens = max(max_tokens, int(h[Bp * (nh + nd)]))
        a_c = h[-2 * nt : -nt]
        b_c = h[-nt:]
        offs = ((np.arange(nt, dtype=np.int64) // nchunks + d0) * N
                + (np.arange(nt, dtype=np.int64) % nchunks) * _ADLER_CHUNK)
        s1_sum += int(a_c.sum())
        s2_sum += int((((n - offs) % _M) * a_c - b_c).sum())
    stats.adler = (((n + s2_sum) % _M) << 16) | ((1 + s1_sum) % _M)

    # --- host side of the entropy stage: header bits and canonical codes
    with stats.timer("entropy"):
        hdr0, hb0 = _dynamic_header(ll_len, d_len, 0)
        hdr1, hb1 = _dynamic_header(ll_len, d_len, 1)
        ll_code, d_code = _encode_tables(ll_len, d_len)
        eob_code = int(ll_code[C.END_OF_BLOCK])
        eob_len = int(ll_len[C.END_OF_BLOCK])
    lt, dt = (t.to(dev) for t in pack_tables(ll_code, ll_len, d_code, d_len))

    # --- phase 2: pack every dispatch to its compacted stream image, one
    # readback for all; the phase-1 histograms size each block exactly
    out_parts: list[bytes] = []
    blocks: list[BlockInfo] = []
    anchor_bit: list[int] = []
    anchor_out: list[int] = []
    anchor_block: list[int] = []
    stream_bit = 0
    R = cfg.pack_row_width(SEG_SIZE)
    if hb0 // 32 + 3 > _F or hb1 // 32 + 3 > _F:
        raise RuntimeError("dynamic header exceeds the filler budget")
    L_ = Bp * nseg
    layout = []
    handles2 = []
    dense_cap = L_ * R + Bp * _F
    for k, (d0, d1) in enumerate(spans):
        B = d1 - d0
        hdr_bits_arr = np.full(Bp, hb0, np.int32)
        if d1 == nblocks:
            hdr_bits_arr[B - 1] = hb1
        pe_h = np.zeros(Bp, np.int64)
        for i in range(Bp):
            pe_h[i] = hdr_bits_arr[i] + _payload_bits(
                ll_blocks[k, i], d_blocks[k, i], ll_len, d_len)
        used = (pe_h + eob_len + 31) // 32 + 1
        blk_off = np.concatenate([[0], np.cumsum(used)]).astype(np.int64)
        if int(blk_off[-1]) > dense_cap:
            # a silent clamp would shorten the slices below and emit a
            # corrupt stream
            raise RuntimeError(
                f"packed word spans ({int(blk_off[-1])}) exceed the dense "
                f"pack capacity ({dense_cap})")
        total_pad = min(dense_cap, -(-int(blk_off[-1]) // 2048) * 2048)
        layout.append((pe_h, blk_off, total_pad))

        if keep_tokens:
            tv, td, valid = kept.pop(d0)
        else:
            tv, td, cnt, _nv, _aa, _ab = run_dispatch(d0, d1)
            _ls, _ds, valid, _lf, _df = token_symbols(tv, td, cnt, nseg=nseg)
        with stats.timer("pack"):
            dense, pe, lb, sb, so = pack_payload_turbo_dense(
                tv, td, valid, lt, dt,
                torch.from_numpy(hdr_bits_arr).to(dev), eob_len,
                nseg=nseg, R=R, F=_F)
            handles2.append(torch.cat([torch.cat([pe, lb, sb, so]).int(),
                                       dense[:total_pad]]))
    with stats.timer("readback"):
        blob = torch.cat(handles2).cpu().numpy()

    # --- host: splice headers, EOB codes, sync blocks and anchors
    with stats.timer("splice"):
        pos = 0
        for k, (d0, d1) in enumerate(spans):
            pe_h, blk_off, total_pad = layout[k]
            B = d1 - d0
            n_valid = nv_all[d0]
            mlen = Bp + 3 * L_
            meta = blob[pos : pos + mlen]
            span_dense = blob[pos + mlen : pos + mlen + total_pad]
            pos += mlen + total_pad
            payload_end_np = meta[:Bp]
            lane_bit0_np = meta[Bp : Bp + L_]
            split_bit_np = meta[Bp + L_ : Bp + 2 * L_]
            split_out_np = meta[Bp + 2 * L_ :]
            if not np.array_equal(payload_end_np.astype(np.int64), pe_h):
                raise RuntimeError(
                    "host/device payload layout desync (per-block histogram "
                    "bit counts disagree with the packed payload ends)")

            for i in range(B):
                bi = d0 + i
                bfinal = 1 if bi == nblocks - 1 else 0
                nb = int(n_valid[i])
                out_start = bi * N
                hdr = hdr1 if bfinal else hdr0
                hdr_bits = hb1 if bfinal else hb0
                buf = span_dense[int(blk_off[i]) : int(blk_off[i + 1])].view(
                    np.uint8).copy()
                end_bits = int(payload_end_np[i])
                hb = np.frombuffer(hdr, dtype=np.uint8)
                buf[: hb.size] |= hb
                _or_bits(buf, end_bits, eob_code, eob_len)
                end_bits += eob_len
                start_bit = stream_bit
                blocks.append(BlockInfo(
                    C.BTYPE_DYNAMIC, bool(bfinal), start_bit,
                    start_bit + hdr_bits, start_bit + end_bits, out_start, nb))
                for s in range(-(-nb // SEG_SIZE)):
                    lane = i * nseg + s
                    lb_ = int(lane_bit0_np[lane])
                    anchor_bit.append(start_bit + lb_)
                    anchor_out.append(out_start + s * SEG_SIZE)
                    anchor_block.append(len(blocks) - 1)
                    # mid-segment split anchor; with no token starting at or
                    # after SUB it is the lane end (an empty second half-lane)
                    lane_end = (int(lane_bit0_np[lane + 1]) if s + 1 < nseg
                                else int(payload_end_np[i]))
                    sb_, so_ = int(split_bit_np[lane]), int(split_out_np[lane])
                    if sb_ >= 1 << 30:
                        sb_, so_ = lane_end - lb_, min(nb - s * SEG_SIZE,
                                                       SEG_SIZE)
                    anchor_bit.append(start_bit + lb_ + sb_)
                    anchor_out.append(out_start + s * SEG_SIZE + so_)
                    anchor_block.append(len(blocks) - 1)
                if bfinal:
                    nbytes = (end_bits + 7) // 8
                    out_parts.append(buf[:nbytes].tobytes())
                    stream_bit += nbytes * 8
                else:
                    # an empty stored block: the next block starts on a byte
                    sync_start = end_bits
                    nbytes = (end_bits + 3 + 7) // 8
                    part = buf[:nbytes].tobytes() + b"\x00\x00\xff\xff"
                    out_parts.append(part)
                    blocks.append(BlockInfo(
                        C.BTYPE_STORED, False, start_bit + sync_start,
                        start_bit + nbytes * 8,
                        stream_bit + len(part) * 8, out_start + nb, 0))
                    stream_bit += len(part) * 8

    body = b"".join(out_parts)
    stats.bytes_out += len(body)
    stats.blocks += len(blocks)
    index = StreamIndex(
        blocks,
        np.asarray(anchor_bit, np.int64),
        np.asarray(anchor_out, np.int64),
        np.asarray(anchor_block, np.int32),
        chunk_reset=cfg.chunk_reset,
        turbo=True,
        max_tokens=max_tokens,
    )
    return body, index


def deflate_raw(data: bytes, block_size: int = C.BLOCK_MAX_BUFFER_LEN,
                config: CodecConfig | None = None,
                stats: CodecStats | None = None,
                dictionary: bytes | None = None, *,
                device: torch.device | str = "cuda"):
    """Encode a raw DEFLATE stream on ``device`` -> (bytes, StreamIndex)."""
    cfg = check_turbo_config(config)
    if dictionary is not None:
        raise _not_ported("a preset dictionary")
    stats = stats if stats is not None else CodecStats()
    # a reused CodecStats must not carry a previous stream's Adler-32
    stats.adler = None
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    n = arr.size
    stats.bytes_in += n
    if n == 0:
        body = b"\x01\x00\x00\xff\xff"
        blocks = [BlockInfo(C.BTYPE_STORED, True, 0, 8, 40, 0, 0)]
        # counted, so that stats.ratio describes the member a user stores
        # (the reference leaves this block out of bytes_out and blocks)
        stats.bytes_out += len(body)
        stats.blocks += 1
        stats.adler = 1     # the Adler-32 of no bytes
        return body, StreamIndex(blocks, np.zeros(0, np.int64),
                                 np.zeros(0, np.int64), np.zeros(0, np.int32))
    N = block_size
    if N % cfg.seg_size:
        raise ValueError("block_size must be a multiple of config.seg_size")
    if N % _ADLER_CHUNK:
        raise ValueError(
            f"shared-tables encode requires block_size to be a multiple of "
            f"{_ADLER_CHUNK} (fused Adler tiling); got {N}")
    return _deflate_turbo(arr, N, cfg, stats, torch.device(device))


def deflate(data: bytes, block_size: int | None = None,
            with_index: bool = False, level: int | None = None,
            config: CodecConfig | None = None,
            stats: CodecStats | None = None,
            dictionary: bytes | None = None, *,
            device: torch.device | str = "cuda"):
    """zlib-container deflate of the turbo profile on ``device``; with
    ``with_index`` returns (bytes, StreamIndex)."""
    if level is not None:
        raise _not_ported(f"level={level}")
    if stats is None:
        stats = CodecStats()
    body, index = deflate_raw(data, block_size or C.BLOCK_MAX_BUFFER_LEN,
                              config=config, stats=stats,
                              dictionary=dictionary, device=device)
    # the Adler-32 partial sums rode the phase-1 readback
    trailer = stats.adler.to_bytes(4, "big")
    header = C.ZLIB_HEADER
    stats.bytes_out += len(header) + len(trailer)
    out = header + body + trailer
    if with_index:
        return out, index.shifted(len(header) * 8)
    return out
