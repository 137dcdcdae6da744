"""Batch compression with a shared preset dictionary, over the mesh (the
port of ``zlibes_tpu/parallel/batch.py``).

Many small related payloads (documents, rows, RPC bodies), each its own
zlib member that references one shared dictionary (RFC 1950 FDICT):

  * payload rows split over the ranks, rank r the rows [r*Bd, (r+1)*Bd);
  * every rank holds the dictionary's last 32 KiB, which every row's
    matcher sees as a context prefix;
  * match, select, pack (fixed Huffman) and each payload's Adler-32 run on
    the rank's device, in dispatches of at most ``ROWS_PER_DISPATCH`` rows;
    the host frames each member (FDICT header + trailer), and the members
    are gathered to every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from ..codec.deflate_pipeline import adler_terms
from ..codec.framing import frame_blocks, stage_rows, zlib_header
from ..config import span, trace
from ..ops.adler32 import adler_partials, adler_value
from ..ops.block_tables import _FIXED_D_LEN, _FIXED_LL_LEN, _encode_tables
from ..ops.deflate_kernel import pack_payload, token_symbols
from ..ops.lz77 import find_matches, select_tokens
from ..spec import constants as C
from .block_parallel import (
    LAST_TIMINGS,
    Mesh,
    _all_gather,
    _collective_read,
    _dispatch,
    _fixed_tables,
    _gather_ragged,
    _span,
    make_mesh,
)

_DICT = C.WINDOW_SIZE  # context prefix size (dictionary tail)
# payload rows a dispatch: bounds the matcher's device memory; the bytes do
# not depend on it
ROWS_PER_DISPATCH = 64


def _batch_step(dict_row: torch.Tensor, dict_start: int, rows: torch.Tensor,
                n_valid: torch.Tensor, P_CAP: int, SEG_SIZE: int, W: int):
    """Fixed-Huffman encode of payload rows (B, P_CAP + 8) uint8 behind the
    dictionary's tail ``dict_row`` (32 KiB, left-padded; ``dict_start`` its
    first real byte, below which nothing is a match source), the
    reference's ``_batch_step`` body (batch.py:38) -> (words (B, W),
    payload_end (B,), adler (B,) each payload's Adler-32), on the rows'
    device."""
    B = rows.shape[0]
    dev = rows.device
    N = _DICT + P_CAP
    nseg = P_CAP // SEG_SIZE
    data = torch.cat([dict_row[None, :].expand(B, _DICT), rows], 1)
    nv_full = n_valid + _DICT
    ctx = torch.full((B,), dict_start, dtype=torch.int32, device=dev)
    with trace("zlibes.match"):
        matches = find_matches(data, nv_full, N=N, S=8, J=8, ctx_start=ctx)
    with trace("zlibes.select"):
        tv, td, cnt = select_tokens(data, matches, nv_full, N=N,
                                    SEG_SIZE=SEG_SIZE, start=_DICT)
    with trace("zlibes.symbols"):
        lsym, dsym, valid, _lf, _df = token_symbols(tv, td, cnt, nseg=nseg)
    with trace("zlibes.pack"):
        tables = tuple(t.to(dev) for t in _fixed_tables(B))
        hdr = torch.full((B,), 3, dtype=torch.long, device=dev)
        en = torch.ones(B, dtype=torch.bool, device=dev)
        words, payload_end, _b0 = pack_payload(tv, td, lsym, dsym, valid,
                                               *tables, hdr, en, nseg=nseg,
                                               W=W)
    # each payload is its own zlib member: per-row Adler-32
    chunk = min(2048, P_CAP)
    a_c, b_c = adler_terms(rows, n_valid, chunk)
    offs = torch.arange(P_CAP // chunk, device=dev) * chunk
    nv = n_valid.long()[:, None]
    s1, s2 = adler_partials(a_c.reshape(B, -1), b_c.reshape(B, -1), offs, nv)
    return words, payload_end, adler_value(s1, s2, nv[:, 0])


@span("zlibes.compress_batch")
def compress_batch(payloads: list[bytes], dictionary: bytes,
                   mesh: Mesh | None = None, seg_size: int = 1024, *,
                   device: torch.device | str = "cuda") -> list[bytes]:
    """Compress many payloads against one shared dictionary -> one FDICT
    zlib member a payload, on every rank of the mesh (a world of one on
    ``device`` when ``mesh`` is None), each decodable with
    ``inflate(member, dictionary=dictionary)`` or any zlib's
    ``decompressobj(zdict=...)``.  Payloads are padded to one power-of-two
    row and split over the ranks.  The call is the span
    ``zlibes.compress_batch``."""
    if mesh is None:
        mesh = make_mesh(1, device=device)
    if not payloads:
        return []
    dev = mesh.device
    dict_tail = np.zeros(_DICT, np.uint8)
    dt = np.frombuffer(bytes(dictionary[-_DICT:]), np.uint8)
    dict_tail[_DICT - dt.size :] = dt

    pmax = max(len(p) for p in payloads)
    P_CAP = max(seg_size, 1 << (max(pmax, 1) - 1).bit_length())
    if P_CAP % seg_size:
        raise ValueError("seg_size must divide the payload row size")
    nb = len(payloads)
    lo, hi, per = _span(nb, mesh)
    W = (15 * P_CAP + 4096) // 32
    handles = []
    with trace("zlibes.host_stage", LAST_TIMINGS):
        dict_row = torch.from_numpy(dict_tail).to(dev)
    for r0 in range(lo, hi, ROWS_PER_DISPATCH):
        r1 = min(hi, r0 + ROWS_PER_DISPATCH)
        with trace("zlibes.host_stage", LAST_TIMINGS):
            rows, n_valid = stage_rows(payloads.__getitem__, r0, r1, P_CAP)
        with _dispatch():
            words, pe, adler = _batch_step(
                dict_row, _DICT - dt.size, torch.from_numpy(rows).to(dev),
                torch.from_numpy(n_valid).to(dev), P_CAP, seg_size, W)
            w = torch.where(words >= 1 << 31, words - (1 << 32), words)
            handles.append((pe.long(), adler.long(), w.reshape(-1)))
    with trace("zlibes.readback", LAST_TIMINGS):
        # the payload ends of every dispatch, their Adler-32s, their words
        blob = (torch.cat([torch.cat(x) for x in zip(*handles)]).cpu().numpy()
                if handles else np.zeros(0, np.int64))

    ll_code, _ = _encode_tables(_FIXED_LL_LEN, _FIXED_D_LEN)
    header = zlib_header(dictionary)
    with trace("zlibes.host_splice", LAST_TIMINGS):
        # every member is a stream of one fixed-Huffman block
        k = hi - lo
        body, table, _start, _row = frame_blocks(
            blob.astype(np.int32), 2 * k + np.arange(k) * W, blob[:k],
            np.array([C.BTYPE_FIXED << 1], np.uint8), 3,
            int(ll_code[C.END_OF_BLOCK]), int(_FIXED_LL_LEN[C.END_OF_BLOCK]),
            C.BTYPE_FIXED, [len(p) for p in payloads[lo:hi]], 0, True)
        own = [header + body[s // 8 : (e + 7) // 8] + int(a).to_bytes(4, "big")
               for s, e, a in zip(table[:, 2], table[:, 4], blob[k : 2 * k])]

    # members to every rank: their lengths, then their bytes
    lens = np.zeros(per, np.int64)
    lens[: len(own)] = [len(m) for m in own]
    gathered = _all_gather(mesh, torch.from_numpy(lens))
    with _collective_read(mesh), trace("zlibes.readback"):
        all_lens = [x.cpu().numpy() for x in gathered]
    mine = torch.from_numpy(np.frombuffer(b"".join(own), np.uint8).copy())
    parts = _gather_ragged(mesh, mine, [int(x.sum()) for x in all_lens])
    with _collective_read(mesh), trace("zlibes.readback"):
        blobs = [part.cpu().numpy().tobytes() for part in parts]
    members = []
    for blob, ls in zip(blobs, all_lens):
        offs = np.concatenate([[0], np.cumsum(ls)])
        members += [blob[offs[k] : offs[k + 1]] for k in range(ls.size)
                    if ls[k]]
    return members[:nb]


def decompress_batch(members: list[bytes], dictionary: bytes, *,
                     device: torch.device | str = "cuda") -> list[bytes]:
    """Inverse of ``compress_batch``: each member through the port's
    ``inflate(dictionary=)`` (the native runtime on the host when it is
    there, else the scan on ``device``)."""
    from ..codec import inflate_pipeline as ip

    return [ip.inflate(m, dictionary=dictionary, device=device)
            for m in members]
