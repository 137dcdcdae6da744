"""The deflate pipeline of the PyTorch port: match, select, tables and
pack on the device, splice on the host.

Counterpart of ``zlibes_tpu/codec/deflate_pipeline.py``.  The input splits
into blocks of ``block_size`` bytes; per dispatch of
``cfg.blocks_per_dispatch`` blocks, padded, on the requested device.  Two
encoders, chosen as the reference chooses:

**General** (``_deflate_general``: levels 1-9, the default config, any
config without shared tables, and every stream with a preset dictionary),
per dispatch:

  device   sort-based match finding over the full 32 KiB window ->
           ``select_tokens`` (CUDA kernel) over ``seg_size``-byte segment
           lanes -> symbols and per-block histograms -> ``block_tables``
           (CUDA kernel; on the CPU the host planner): per block
           length-limited code lengths (package-merge), the dynamic header,
           the choice of stored, fixed or dynamic and the codes ->
           ``pack_payload`` under the per-block tables, with the 128-byte
           sub-anchors of the wide index; one readback of the metadata and
           the blocks' choices and headers, one of the used words;
  host     splice headers, end-of-block codes, stored blocks, empty stored
           sync blocks and the anchors into the stream and its StreamIndex
           (``wide`` unless a dictionary was given).

A preset dictionary's last 32 KiB ride in front of the first block's row as
a context prefix the matcher may copy from and the selector never
tokenizes.  Level 0 (``force_stored``) writes stored blocks on the host.

**Shared tables** (``_deflate_turbo``: every config with
``shared_tables``, ``CodecConfig.turbo()`` among them, without a
dictionary):

  phase 1  match finding (under the config's window reset) -> token
           selection over ``seg_size``-byte segment lanes: ``select_turbo``
           (CUDA kernel) at the turbo geometry of 512-byte lanes and a
           4 KiB reset, ``select_tokens`` (CUDA kernel) at any other; far
           long matches cut at 130 bytes (``split_far``) when codes have at
           most 9 bits -> symbols and per-block histograms, and Adler-32
           partial sums; after every dispatch, the stream-wide
           length-limited code lengths (package-merge on the device) ride
           the same single readback;
  host     one dynamic header (identical but for BFINAL) and the shared
           canonical codes;
  phase 2  ``encode_fields`` (CUDA kernel: coded fields of up to 48 bits)
           and the pack into a compacted stream image per dispatch, one
           readback for all dispatches;
  host     splice headers, EOB codes, empty stored sync blocks and the
           paired anchors (each segment's start and its first token at or
           past byte 256) into the stream and its StreamIndex, a turbo
           index for the turbo profile's geometry and codes.

The shared-table encode reads the device back twice.  Beyond
``cfg.phase1_cache_blocks`` blocks phase 2 runs match and select again
instead of keeping phase 1's tokens; the bytes are the same.  Every stage
is integer work, so the bytes equal the JAX package's, on any device,
wherever every coded token fits 32 bits.  Where one does not (codes above
9 bits with a far match), the reference's 32-bit pack writes bytes that
CPython rejects; the port keeps the whole field.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, CodecConfig, CodecStats, span, trace
from ..spec import constants as C
from ..spec.refmodel import BlockInfo, StreamIndex, adler32

from ..ops import turbo_kernel as tk
from ..ops.adler32 import adler32_device, adler_partials, adler_value
# the host functions of the tables live with the block_tables kernel; the
# shared-table encoders, parallel/ and the tests take them from here too
from ..ops.block_tables import (  # noqa: F401
    INFO,
    _FIXED_D_LEN,
    _FIXED_LL_LEN,
    _dynamic_header,
    _encode_tables,
    _payload_bits,
    block_tables,
    package_merge_np,
)
from ..ops.deflate_kernel import (
    gather_compressed,
    pack_payload,
    pack_payload_turbo_dense,
    token_symbols,
)
from ..ops.encode_kernel import pack_tables
from ..ops.entropy import limited_lengths_pair
from ..ops.lz77 import find_matches, select_tokens
from ..ops.wide_kernel import SUB as WIDE_SUB

_ADLER_CHUNK = 2048
_M = C.ADLER_MOD
_F = 80  # filler slots per block (header + EOB tail words)


def _own_config(cfg: CodecConfig | None) -> CodecConfig:
    """``cfg``, or the default config for None; an object of another class
    (the JAX package's config included) raises TypeError."""
    if cfg is None:
        return DEFAULT_CONFIG
    if not isinstance(cfg, CodecConfig):
        raise TypeError(
            f"config is a {type(cfg).__module__}.{type(cfg).__qualname__}, "
            f"not zlibes_tpu_torch.CodecConfig; convert it with "
            f"zlibes_tpu_torch.config.config_from_reference")
    return cfg


# ---------------------------------------------------------------------------
# host splice helper

def _or_bits(buf: np.ndarray, bit_off: int, value: int, nbits: int) -> None:
    """OR an LSB-first bit-string into a byte buffer at a bit offset."""
    v = value << (bit_off & 7)
    pos = bit_off >> 3
    nbytes = (nbits + (bit_off & 7) + 7) // 8
    for i in range(nbytes):
        buf[pos + i] |= (v >> (8 * i)) & 0xFF


# ---------------------------------------------------------------------------
# device stages of one dispatch

def adler_terms(dev_bytes: torch.Tensor, n_valid: torch.Tensor,
                chunk: int = _ADLER_CHUNK):
    """Per-``chunk``-byte Adler-32 partial sums of the block rows:
    A = sum d_j mod m, B = sum j*d_j mod m -> (A, B) (Bp * N/chunk,) int64.
    The host combines them (the s2 term of a chunk at offset o is
    (n - o)*A - B), so the trailer needs no pass of its own."""
    Bp, Npad = dev_bytes.shape
    N = Npad - 8
    d = dev_bytes[:, :N].long()
    pos = torch.arange(N, device=d.device)
    d = torch.where(pos[None, :] < n_valid.long()[:, None], d, 0)
    dd = d.reshape(Bp, N // chunk, chunk)
    jj = torch.arange(chunk, device=d.device)
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
                n_valid: torch.Tensor, N: int, lazy: bool,
                split_far: bool = True):
    """Select tokens per 512-byte lane (``select_turbo``) and unpack them to
    (tv, td, cnt) (``_select_turbo_glue``,
    zlibes_tpu/codec/deflate_pipeline.py:214), in lane order: no
    word-planes."""
    pv, slen = select_inputs(dev_bytes, matches, n_valid, N)
    toks, cnt = tk.select_turbo(pv, slen, lazy=lazy, split_far=split_far)
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


def _row_width(cfg: CodecConfig) -> int:
    """Word slots of a segment lane's row in the shared-table pack: its
    coded bits, up to 31 bits of offset into the first word, and 2 spare.

    ``cfg.pack_row_width()`` counts ``max_code_bits`` bits a byte.  A
    literal costs at most that; a match of L bytes at most 2 codes + 5
    length-extra bits (none for L <= 10) + the distance-extra bits.  At 15
    bits a byte costs at most 15: a 3-byte match costs at most 15 + 0 + 15
    + 13 = 43 <= 45 bits, a match of 227-257 bytes 48 bits.  Below 13-bit
    codes a 3-byte match can cost more than 3 codes (9 bits: 9 + 9 + 13 =
    31 > 27, or 9 + 9 + 10 = 28 with distances under a 4 KiB reset), so
    the row is sized for lanes of 3-byte matches where they cost more."""
    c = cfg.max_code_bits
    reset = cfg.chunk_reset
    far = min(13, reset.bit_length() - 3) if reset else 13
    bits = max(c * cfg.seg_size, -(-cfg.seg_size * (2 * c + far) // 3))
    return max(cfg.pack_row_width(), -(-((bits + 31) // 32 + 2) // 8) * 8)


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
    # as in the reference: with codes of at most 9 bits (the turbo decode's)
    # match candidates are ranked in two phases, and far long matches are
    # cut so that no coded token passes 32 bits
    short_codes = cfg.max_code_bits <= 9
    turbo_lanes = SEG_SIZE == tk.SEL_SEG and cfg.chunk_reset == 4096

    def run_dispatch(d0: int, d1: int):
        blk_bytes, n_valid = block_rows(arr, d0, d1, N, Bp)
        with trace("zlibes.upload"):
            dev_bytes = torch.from_numpy(blk_bytes).to(dev)
            dev_nv = torch.from_numpy(n_valid).to(dev)
        ad_a, ad_b = adler_terms(dev_bytes, dev_nv)
        with trace("zlibes.match", stats.stage_s):
            matches = find_matches(dev_bytes, dev_nv, N=N, S=cfg.probe_words,
                                   J=cfg.candidates, reset=cfg.chunk_reset,
                                   two_phase=short_codes)
        with trace("zlibes.select", stats.stage_s):
            if turbo_lanes:     # distances fit 12 bits
                tv, td, cnt = select_glue(dev_bytes, matches, dev_nv, N,
                                          cfg.lazy, split_far=short_codes)
            else:
                tv, td, cnt = select_tokens(dev_bytes, matches, dev_nv, N=N,
                                            SEG_SIZE=SEG_SIZE, lazy=cfg.lazy,
                                            split_far=short_codes)
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
        with trace("zlibes.symbols", stats.stage_s):
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
    with trace("zlibes.entropy", stats.stage_s):
        ll_tot = sum(ll_parts)
        ll_tot[C.END_OF_BLOCK] += nblocks
        ll_d, d_d = limited_lengths_pair(ll_tot.clamp(max=1 << 28),
                                         sum(d_parts).clamp(max=1 << 28),
                                         cfg.max_code_bits)
        handles.append(ll_d.long())
        handles.append(d_d.long())
    with trace("zlibes.readback", stats.stage_s):
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
        s1, s2 = adler_partials(a_c, b_c, offs, n)
        s1_sum += int(s1)
        s2_sum += int(s2)
    stats.adler = adler_value(s1_sum, s2_sum, n)

    # --- host side of the entropy stage: header bits and canonical codes
    with trace("zlibes.entropy", stats.stage_s):
        hdr0, hb0 = _dynamic_header(ll_len, d_len, 0)
        hdr1, hb1 = _dynamic_header(ll_len, d_len, 1)
        ll_code, d_code = _encode_tables(ll_len, d_len)
        eob_code = int(ll_code[C.END_OF_BLOCK])
        eob_len = int(ll_len[C.END_OF_BLOCK])
    tables = pack_tables(ll_code, ll_len, d_code, d_len)
    with trace("zlibes.upload"):
        lt, dt = (t.to(dev) for t in tables)

    # --- phase 2: pack every dispatch to its compacted stream image, one
    # readback for all; the phase-1 histograms size each block exactly
    out_parts: list[bytes] = []
    blocks: list[BlockInfo] = []
    anchor_bit: list[int] = []
    anchor_out: list[int] = []
    anchor_block: list[int] = []
    stream_bit = 0
    R = _row_width(cfg)
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
        with trace("zlibes.pack", stats.stage_s):
            dense, pe, lb, sb, so = pack_payload_turbo_dense(
                tv, td, valid, lt, dt,
                torch.from_numpy(hdr_bits_arr).to(dev), eob_len,
                nseg=nseg, R=R, F=_F)
            handles2.append(torch.cat([torch.cat([pe, lb, sb, so]).int(),
                                       dense[:total_pad]]))
    with trace("zlibes.readback", stats.stage_s):
        blob = torch.cat(handles2).cpu().numpy()

    # --- host: splice headers, EOB codes, sync blocks and anchors
    with trace("zlibes.splice", stats.stage_s):
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
        turbo=turbo_lanes and short_codes,
        max_tokens=max_tokens,
    )
    return body, index


def _stored_blocks(raw: np.ndarray, bfinal: int, bit: int, out_start: int):
    """``raw`` (not empty) as stored blocks of at most 65,535 bytes, the
    first at stream bit ``bit`` (on a byte) and output byte ``out_start``,
    the last with ``bfinal`` -> [(bytes, BlockInfo)]."""
    out = []
    for pos in range(0, raw.size, 65535):
        chunk = raw[pos : pos + 65535]
        bf = bfinal if pos + 65535 >= raw.size else 0
        ln = chunk.size
        part = bytes([bf]) + ln.to_bytes(2, "little") \
            + (~ln & 0xFFFF).to_bytes(2, "little") + chunk.tobytes()
        out.append((part, BlockInfo(C.BTYPE_STORED, bool(bf), bit, bit + 8,
                                    bit + len(part) * 8, out_start + pos,
                                    ln)))
        bit += len(part) * 8
    return out


def _stored_stream(arr: np.ndarray, stats: CodecStats):
    """Level 0: stored blocks only, no device work."""
    parts, blocks = zip(*_stored_blocks(arr, 1, 0, 0))
    body = b"".join(parts)
    stats.bytes_out += len(body)
    stats.blocks += len(blocks)
    return body, StreamIndex(list(blocks), np.zeros(0, np.int64),
                             np.zeros(0, np.int64), np.zeros(0, np.int32))


def general_rows(arr: np.ndarray, d0: int, d1: int, N: int, Bp: int,
                 dict_np: np.ndarray | None):
    """Block rows of one dispatch of the general encoder -> (blk_bytes
    (Bp, CTX + N + 8) uint8, n_valid (Bp,) int32 bytes per block, ctx_start
    (Bp,) int32 first real byte of each row or None).  CTX is 32 KiB with a
    dictionary and 0 without; the dictionary's tail sits just below CTX in
    block 0's row only, and the padding below it (every other row's whole
    prefix) is no match source."""
    CTX = C.WINDOW_SIZE if dict_np is not None else 0
    blk_bytes = np.zeros((Bp, CTX + N + 8), dtype=np.uint8)
    n_valid = np.zeros(Bp, dtype=np.int32)
    for i, bi in enumerate(range(d0, d1)):
        chunk = arr[bi * N : (bi + 1) * N]
        blk_bytes[i, CTX : CTX + chunk.size] = chunk
        n_valid[i] = chunk.size
    if not CTX:
        return blk_bytes, n_valid, None
    ctx_start = np.full(Bp, CTX, np.int32)
    if d0 == 0:
        blk_bytes[0, CTX - dict_np.size : CTX] = dict_np
        ctx_start[0] = CTX - dict_np.size
    return blk_bytes, n_valid, ctx_start


def _deflate_general(arr: np.ndarray, N: int, cfg: CodecConfig,
                     stats: CodecStats, dev: torch.device,
                     dict_np: np.ndarray | None):
    """Per-block-table encode: every block gets the cheapest of stored,
    fixed and dynamic coding under its own length-limited tables."""
    n = arr.size
    nblocks = -(-n // N)
    SEG_SIZE = cfg.seg_size
    nseg = N // SEG_SIZE
    Bp = cfg.blocks_per_dispatch
    CTX = C.WINDOW_SIZE if dict_np is not None else 0
    W = (15 * N + 4096) // 32           # words of one block's buffer
    L_ = Bp * nseg
    nsub_lane = SEG_SIZE // WIDE_SUB

    out_parts: list[bytes] = []
    blocks: list[BlockInfo] = []
    anchor_bit: list[int] = []
    anchor_out: list[int] = []
    anchor_block: list[int] = []
    stream_bit = 0      # every block starts on a byte

    for d0 in range(0, nblocks, Bp):
        d1 = min(nblocks, d0 + Bp)
        B = d1 - d0
        stats.dispatches += 1
        blk_bytes, n_valid, ctx_np = general_rows(arr, d0, d1, N, Bp, dict_np)
        with trace("zlibes.upload"):
            dev_bytes = torch.from_numpy(blk_bytes).to(dev)
            dev_n = torch.from_numpy(n_valid).to(dev)
            dev_nv = dev_n + CTX if CTX else dev_n
            ctx_dev = torch.from_numpy(ctx_np).to(dev) if CTX else None
        with trace("zlibes.match", stats.stage_s):
            if cfg.candidates > 0:
                matches = find_matches(dev_bytes, dev_nv, N=CTX + N,
                                       S=cfg.probe_words, J=cfg.candidates,
                                       reset=cfg.chunk_reset,
                                       ctx_start=ctx_dev)
            else:       # literals only
                matches = torch.zeros((Bp, CTX + N), dtype=torch.int32,
                                      device=dev)
        with trace("zlibes.select", stats.stage_s):
            tv, td, cnt = select_tokens(dev_bytes, matches, dev_nv,
                                        N=CTX + N, SEG_SIZE=SEG_SIZE,
                                        lazy=cfg.lazy, start=CTX)
        with trace("zlibes.symbols", stats.stage_s):
            lsym, dsym, valid, ll_freq, d_freq = token_symbols(tv, td, cnt,
                                                               nseg=nseg)

        # --- each block's coding choice and tables, where the histograms
        # are: the card's block_tables kernel, or the host planner on the CPU
        with trace("zlibes.tables", stats.stage_s):
            t_ll_code, t_ll_len, t_d_code, t_d_len, t_hdr, t_en, info = \
                block_tables(ll_freq, d_freq, dev_n, B,
                             nblocks - 1 - d0 if d1 == nblocks else -1)
        if info.is_cuda:
            stats.device_tables += B

        # --- device: the payload pack, with the wide index's sub-anchors
        with trace("zlibes.pack", stats.stage_s):
            words, payload_end, lane_bit0, sub_bit, sub_out = pack_payload(
                tv, td, lsym, dsym, valid,
                t_ll_code, t_ll_len, t_d_code, t_d_len, t_hdr, t_en,
                nseg=nseg, W=W, sub_every=WIDE_SUB)
        with trace("zlibes.readback", stats.stage_s):
            meta_np = torch.cat([payload_end, lane_bit0, sub_bit.reshape(-1),
                                 sub_out.reshape(-1),
                                 info.reshape(-1)]).cpu().numpy()
        payload_end_np = meta_np[:Bp]
        sub_end = Bp + L_ + 2 * L_ * nsub_lane
        sub_bit_np = meta_np[Bp + L_ : Bp + L_ + L_ * nsub_lane].reshape(
            L_, nsub_lane)
        sub_out_np = meta_np[Bp + L_ + L_ * nsub_lane : sub_end].reshape(
            L_, nsub_lane)
        # per block: btype, end-of-block code and length, header bits, then
        # the header's bytes
        info_np = meta_np[sub_end:].reshape(Bp, INFO)
        btype_np, eob_code_np, eob_len_np, hdr_bits_np = info_np[:, :4].T

        # one indexed read of the words the coded blocks used
        used_words = np.where(btype_np[:B] != C.BTYPE_STORED,
                              (payload_end_np[:B] + eob_len_np[:B] + 31)
                              // 32 + 1, 0)
        offs = np.concatenate([[0], np.cumsum(used_words)]).astype(np.int64)
        if offs[-1]:
            flat_idx = np.concatenate(
                [np.arange(used_words[i], dtype=np.int64) + i * W
                 for i in range(B)])
            with trace("zlibes.readback", stats.stage_s):
                dense = gather_compressed(
                    words.reshape(-1),
                    torch.from_numpy(flat_idx).to(dev)).cpu().numpy()
        else:
            dense = np.zeros(0, np.int32)

        # --- host: splice the blocks
        with trace("zlibes.splice", stats.stage_s):
            for i in range(B):
                bi = d0 + i
                bfinal = bi == nblocks - 1
                btype = int(btype_np[i])
                nb = int(n_valid[i])
                out_start = bi * N
                if btype == C.BTYPE_STORED:
                    for part, binfo in _stored_blocks(
                            arr[out_start : out_start + nb], int(bfinal),
                            stream_bit, out_start):
                        out_parts.append(part)
                        blocks.append(binfo)
                        stream_bit = binfo.end_bit
                    continue
                buf = dense[int(offs[i]) : int(offs[i + 1])].view(
                    np.uint8).copy()
                end_bits = int(payload_end_np[i])
                hdr_bits = int(hdr_bits_np[i])
                eob_len = int(eob_len_np[i])
                # the device left the header's bits [0, hdr_bits) free
                nhb = (hdr_bits + 7) // 8
                buf[:nhb] |= info_np[i, 4:].view(np.uint8)[:nhb]
                _or_bits(buf, end_bits, int(eob_code_np[i]), eob_len)
                end_bits += eob_len
                start_bit = stream_bit
                blocks.append(BlockInfo(
                    btype, bfinal, start_bit, start_bit + hdr_bits,
                    start_bit + end_bits, out_start, nb))
                # one anchor every 128 output bytes of the block (the wide
                # decode's lanes).  A boundary with no token starting at or
                # after it in its own selection lane takes the next
                # boundary's: the valid (bit, out) pairs do not decrease in
                # boundary order, so that is a suffix minimum over the
                # block's flattened arrays with the block's end appended;
                # repeated anchors mark empty decode lanes.
                na_b = -(-nb // WIDE_SUB)
                lanes_i = slice(i * nseg, (i + 1) * nseg)
                flat_bit = np.concatenate(
                    [sub_bit_np[lanes_i].reshape(-1)[:na_b],
                     [end_bits]]).astype(np.int64)
                flat_out = np.concatenate(
                    [(np.arange(nseg, dtype=np.int64)[:, None] * SEG_SIZE
                      + sub_out_np[lanes_i]).reshape(-1)[:na_b],
                     [nb]])
                fb = np.minimum.accumulate(flat_bit[::-1])[::-1][:-1]
                fo = np.minimum.accumulate(flat_out[::-1])[::-1][:-1]
                anchor_bit.extend(start_bit + fb)
                anchor_out.extend(out_start + fo)
                anchor_block.extend([len(blocks) - 1] * na_b)
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
        # a dictionary stream's first block copies from the dictionary,
        # which the wide resolve kernel does not hold: it keeps the host
        # decode
        wide=dict_np is None,
    )
    return body, index


@span("zlibes.deflate")
def deflate_raw(data: bytes, block_size: int = C.BLOCK_MAX_BUFFER_LEN,
                config: CodecConfig | None = None,
                stats: CodecStats | None = None,
                dictionary: bytes | None = None, *,
                device: torch.device | str = "cuda"):
    """Encode a raw DEFLATE stream on ``device`` -> (bytes, StreamIndex).

    ``dictionary``: a preset dictionary (RFC 1950 FDICT).  Its last 32 KiB
    ride as a context prefix on the first block's row: the matcher sees it
    (``find_matches(ctx_start=)``), the selector never tokenizes it
    (``select_tokens(start=)``); later blocks are self-contained.  With a
    dictionary even the turbo profile takes the general path (its 4 KiB
    window resets could never reach one).  The call is one span,
    ``zlibes.deflate``."""
    cfg = _own_config(config)
    dev = torch.device(device)
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
    if cfg.force_stored:
        return _stored_stream(arr, stats)
    if cfg.shared_tables and not dictionary:
        if N % _ADLER_CHUNK:
            raise ValueError(
                f"shared-tables encode requires block_size to be a multiple "
                f"of {_ADLER_CHUNK} (fused Adler tiling); got {N}")
        return _deflate_turbo(arr, N, cfg, stats, dev)
    dict_np = (np.frombuffer(bytes(dictionary[-C.WINDOW_SIZE:]), np.uint8)
               if dictionary else None)
    return _deflate_general(arr, N, cfg, stats, dev, dict_np)


@span("zlibes.deflate")
def deflate(data: bytes, block_size: int | None = None,
            with_index: bool = False, level: int | None = None,
            config: CodecConfig | None = None,
            stats: CodecStats | None = None,
            dictionary: bytes | None = None, *,
            device: torch.device | str = "cuda"):
    """zlib-container deflate on ``device``; with ``with_index`` returns
    (bytes, StreamIndex).

    ``level`` (0..9) selects a ``CodecConfig`` preset; ``config``
    overrides it; neither gives the default config (level 6).
    ``dictionary`` emits an FDICT member (RFC 1950 §2.2): the header
    carries the dictionary's Adler-32 as DICTID.  The call is one span,
    ``zlibes.deflate``."""
    data = bytes(data)
    if config is None and level is not None:
        config = CodecConfig.from_level(level)
    if stats is None:
        stats = CodecStats()
    body, index = deflate_raw.__wrapped__(
        data, block_size or C.BLOCK_MAX_BUFFER_LEN, config, stats,
        dictionary, device=device)
    if stats.adler is not None:
        # the Adler-32 partial sums rode the encode's dispatches
        trailer = stats.adler.to_bytes(4, "big")
    else:
        with trace("zlibes.adler"):
            with trace("zlibes.upload"):
                arr = torch.from_numpy(np.frombuffer(
                    data, dtype=np.uint8).copy()).to(device)
            adler = adler32_device(arr)
            with trace("zlibes.readback"):
                trailer = int(adler).to_bytes(4, "big")
    if dictionary is not None:
        flg = 0x20 + (2 << 6)
        flg += (31 - (0x78 * 256 + flg) % 31) % 31
        header = bytes([0x78, flg]) + adler32(dictionary).to_bytes(4, "big")
    else:
        header = C.ZLIB_HEADER
    # the container's framing counts toward the emitted bytes
    stats.bytes_out += len(header) + len(trailer)
    out = header + body + trailer
    if with_index:
        return out, index.shifted(len(header) * 8)
    return out
