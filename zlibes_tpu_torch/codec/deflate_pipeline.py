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
  host     the framing of ``framing.py``: blocks, sync blocks and the wide
           index's anchors (``wide`` unless a dictionary was given).

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
  host     the framing of ``framing.py``: blocks, sync blocks and the paired
           anchors, a turbo index for the turbo profile's geometry and codes.

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
from ..spec.refmodel import StreamIndex

from ..ops import turbo_kernel as tk
from ..ops.adler32 import adler32_device, adler_partials, adler_value
from ..ops.block_tables import (
    INFO,
    _dynamic_header,
    _encode_tables,
    _payload_bits,
    block_tables,
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
from .framing import (
    block_infos,
    frame_blocks,
    lane_anchors,
    stage_rows,
    stored_stream,
    sub_anchors,
    zlib_header,
)

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
        blk_bytes, n_valid = stage_rows(arr, d0, d1, N, Bp)
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
        return tv, td, cnt, ad_a, ad_b

    # --- phase 1: every dispatch queued before one readback
    nh = C.NUM_LITLEN_SYMBOLS
    nd = C.NUM_DIST_SYMBOLS
    kept = {}
    handles = []
    ll_parts = []
    d_parts = []
    spans = [(d0, min(nblocks, d0 + Bp)) for d0 in range(0, nblocks, Bp)]
    nchunks = N // _ADLER_CHUNK
    nt = Bp * nchunks
    for d0, d1 in spans:
        tv, td, cnt, ad_a, ad_b = run_dispatch(d0, d1)
        with trace("zlibes.symbols", stats.stage_s):
            _ls, _ds, valid, ll_freq, d_freq = token_symbols(tv, td, cnt,
                                                            nseg=nseg)
        # per-block histograms give the host each block's exact payload bits
        # once the shared lengths exist, so phase 2 needs no sizing sync
        handles.append(torch.cat([ll_freq.reshape(-1), d_freq.reshape(-1),
                                  cnt.max().long()[None], ad_a, ad_b]))
        ll_parts.append(ll_freq.sum(0))
        d_parts.append(d_freq.sum(0))
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
    # per dispatch: block histograms, most tokens in a lane, Adler-32 terms
    h = hist_all[: -(nh + nd)].reshape(len(spans), -1)
    ll_blocks = h[:, : Bp * nh].reshape(-1, Bp, nh)
    d_blocks = h[:, Bp * nh : Bp * (nh + nd)].reshape(-1, Bp, nd)
    max_tokens = int(h[:, Bp * (nh + nd)].max())
    j = np.arange(nt, dtype=np.int64)
    offs = ((np.arange(len(spans), dtype=np.int64)[:, None] * Bp
             + j // nchunks) * N + j % nchunks * _ADLER_CHUNK)
    s1, s2 = adler_partials(h[:, -2 * nt : -nt].reshape(-1),
                            h[:, -nt:].reshape(-1), offs.reshape(-1), n)
    stats.adler = adler_value(int(s1), int(s2), n)

    # --- host side of the entropy stage: header bits and canonical codes;
    # the last block's header differs only in BFINAL, which the framing sets
    with trace("zlibes.entropy", stats.stage_s):
        hdr, hb = _dynamic_header(ll_len, d_len, 0)
        ll_code, d_code = _encode_tables(ll_len, d_len)
        eob_code = int(ll_code[C.END_OF_BLOCK])
        eob_len = int(ll_len[C.END_OF_BLOCK])
    tables = pack_tables(ll_code, ll_len, d_code, d_len)
    with trace("zlibes.upload"):
        lt, dt = (t.to(dev) for t in tables)

    # --- phase 2: pack every dispatch to its compacted stream image, one
    # readback for all; the phase-1 histograms size each block exactly
    R = _row_width(cfg)
    if hb // 32 + 3 > _F:
        raise RuntimeError("dynamic header exceeds the filler budget")
    L_ = Bp * nseg
    handles2 = []
    dense_cap = L_ * R + Bp * _F
    hdr_bits = torch.full((Bp,), hb, dtype=torch.int32, device=dev)
    # each block's payload end, and its words' offset in its dispatch's
    # image (dispatch by block)
    pe_h = hb + _payload_bits(ll_blocks, d_blocks, ll_len, d_len)
    used = (pe_h + eob_len + 31) // 32 + 1
    total = int(used.sum(1).max())
    if total > dense_cap:
        # a silent clamp would shorten the slices below and emit a corrupt
        # stream
        raise RuntimeError(f"packed word spans ({total}) exceed the dense "
                           f"pack capacity ({dense_cap})")
    blk_off = np.cumsum(used, 1) - used
    total_pad = np.minimum(dense_cap, -(-used.sum(1) // 2048) * 2048)
    for (d0, d1), pad in zip(spans, total_pad.tolist()):
        if keep_tokens:
            tv, td, valid = kept.pop(d0)
        else:
            tv, td, cnt, _aa, _ab = run_dispatch(d0, d1)
            _ls, _ds, valid, _lf, _df = token_symbols(tv, td, cnt, nseg=nseg)
        with trace("zlibes.pack", stats.stage_s):
            dense, pe, lb, sb, so = pack_payload_turbo_dense(
                tv, td, valid, lt, dt, hdr_bits, eob_len,
                nseg=nseg, R=R, F=_F)
            handles2.append(torch.cat([torch.cat([pe, lb, sb, so]).int(),
                                       dense[:pad]]))
    with trace("zlibes.readback", stats.stage_s):
        blob = torch.cat(handles2).cpu().numpy()

    # --- host: frame the blocks, and the paired anchors (each segment's
    # start and its first token at or past byte 256)
    with trace("zlibes.splice", stats.stage_s):
        # per dispatch: payload ends, then each lane's first bit, split bit
        # and split output offset, then the image
        mlen = Bp + 3 * L_
        pos = np.cumsum(mlen + total_pad) - (mlen + total_pad)
        meta = blob[pos[:, None] + np.arange(mlen)].astype(np.int64)
        if not np.array_equal(meta[:, :Bp], pe_h):
            raise RuntimeError(
                "host/device payload layout desync (per-block histogram "
                "bit counts disagree with the packed payload ends)")
        payload_end = meta[:, :Bp].reshape(-1)[:nblocks]
        lane_bit0, split_bit, split_out = meta[:, Bp:].reshape(
            -1, 3, Bp, nseg).transpose(1, 0, 2, 3).reshape(
                3, -1, nseg)[:, :nblocks]
        out_start = np.arange(nblocks, dtype=np.int64) * N
        nb = np.minimum(N, n - out_start)
        body, table, start, row = frame_blocks(
            blob, (pos[:, None] + mlen + blk_off).reshape(-1)[:nblocks],
            payload_end, np.frombuffer(hdr, np.uint8), hb, eob_code,
            eob_len, C.BTYPE_DYNAMIC, nb, out_start,
            out_start == out_start[-1])
        anchor_bit, anchor_out, anchor_block = lane_anchors(
            start, row, nb, out_start, lane_bit0, SEG_SIZE,
            split=(split_bit, split_out, payload_end))

    stats.bytes_out += len(body)
    stats.blocks += len(table)
    return body, StreamIndex(
        block_infos(table), anchor_bit, anchor_out,
        anchor_block.astype(np.int32), chunk_reset=cfg.chunk_reset,
        turbo=turbo_lanes and short_codes, max_tokens=max_tokens)


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
    nsub = Bp * N // WIDE_SUB           # sub-anchor boundaries a dispatch

    out_parts: list[bytes] = []
    blocks = []
    anchors = []
    stream_bit = 0      # every block starts on a byte

    for d0 in range(0, nblocks, Bp):
        d1 = min(nblocks, d0 + Bp)
        B = d1 - d0
        stats.dispatches += 1
        # a dictionary's tail sits just below CTX in block 0's row only; the
        # padding below it (every other row's whole prefix) is no match
        # source
        blk_bytes, n_valid = stage_rows(arr, d0, d1, N, Bp, CTX)
        if CTX:
            ctx_np = np.full(Bp, CTX, np.int32)
            if d0 == 0:
                blk_bytes[0, CTX - dict_np.size : CTX] = dict_np
                ctx_np[0] = CTX - dict_np.size
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
        # the real blocks' payload ends, sub-anchors (bits, then output
        # offsets) and info: btype, end-of-block code and length, header
        # bits, then the header's bytes
        pe_np, _lb, sub_bit_np, sub_out_np, info_np = (
            x.reshape(Bp, -1)[:B] for x in np.split(
                meta_np, np.cumsum([Bp, L_, nsub, nsub])))
        btype, eob_code, eob_len, hdr_bits = info_np[:, :4].T
        pe_np = pe_np[:, 0]
        coded = btype != C.BTYPE_STORED

        # one indexed read of the words the coded blocks used
        used_words = np.where(coded, (pe_np + eob_len + 31) // 32 + 1, 0)
        offs = np.concatenate([[0], np.cumsum(used_words)]).astype(np.int64)
        if offs[-1]:
            flat_idx = np.arange(offs[-1]) + np.repeat(
                np.arange(B, dtype=np.int64) * W - offs[:-1], used_words)
            with trace("zlibes.readback", stats.stage_s):
                dense = gather_compressed(
                    words.reshape(-1),
                    torch.from_numpy(flat_idx).to(dev)).cpu().numpy()
        else:
            dense = np.zeros(0, np.int32)

        # --- host: frame the blocks, and one anchor every 128 output bytes
        # of each coded block (the wide decode's lanes)
        with trace("zlibes.splice", stats.stage_s):
            out_start = np.arange(d0, d1, dtype=np.int64) * N
            nb = n_valid[:B]
            body, table, start, row = frame_blocks(
                dense, offs[:-1], pe_np,
                np.ascontiguousarray(info_np[:, 4:]).view(np.uint8),
                hdr_bits, eob_code, eob_len, btype, nb, out_start,
                out_start == (nblocks - 1) * N, raw=arr)
            c = coded
            a_bit, a_out, a_blk = sub_anchors(
                start[c], row[c], (pe_np + eob_len)[c], nb[c], out_start[c],
                sub_bit_np[c], sub_out_np[c], SEG_SIZE, WIDE_SUB)
            anchors.append((a_bit + stream_bit, a_out, a_blk + len(blocks)))
            blocks += block_infos(table, stream_bit)
            out_parts.append(body)
            stream_bit += 8 * len(body)

    body = b"".join(out_parts)
    stats.bytes_out += len(body)
    stats.blocks += len(blocks)
    anchor_bit, anchor_out, anchor_block = (np.concatenate(a)
                                            for a in zip(*anchors))
    index = StreamIndex(
        blocks, anchor_bit, anchor_out, anchor_block.astype(np.int32),
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
    N = block_size
    if n == 0:
        stats.adler = 1     # the Adler-32 of no bytes
    elif N % cfg.seg_size:
        raise ValueError("block_size must be a multiple of config.seg_size")
    if n == 0 or cfg.force_stored:
        # stored blocks only, no device work; the empty input's one empty
        # block is counted, so that stats.ratio describes the member a user
        # stores (the reference leaves it out of bytes_out and blocks)
        body, index = stored_stream(arr)
        stats.bytes_out += len(body)
        stats.blocks += len(index.blocks)
        return body, index
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
    header = zlib_header(dictionary)
    # the container's framing counts toward the emitted bytes
    stats.bytes_out += len(header) + len(trailer)
    out = header + body + trailer
    if with_index:
        return out, index.shifted(len(header) * 8)
    return out
