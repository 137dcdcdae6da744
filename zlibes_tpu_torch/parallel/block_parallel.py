"""Block parallelism over a ``torch.distributed`` process group, one rank
per device.

Counterpart of ``zlibes_tpu/parallel/block_parallel.py``.  The reference's
``Mesh`` + ``shard_map`` (one controller over many devices) becomes one
process a device in a process group; its ``psum`` and the gather of its
sharded outputs become collectives of that group.  DEFLATE blocks are the
unit of work:

  * deflate: rank r owns blocks [r*Bd, (r+1)*Bd) (the rows the reference's
    ``P("blocks")`` sharding gives device r), match-finds, selects and
    packs them on its device, in dispatches of at most ``DISPATCH_BLOCKS``
    blocks, and splices them into bytes and its part of the index relative
    to its first byte: every block but the last ends on a byte, behind an
    empty stored sync block.  One ``all_reduce`` sums the Adler-32 partials
    (with the dynamic tables' 288 + 32 symbol histograms in the same
    tensor, before the shared code lengths are built on the device); one
    ``all_gather`` of the sizes and one of the bytes (and index arrays)
    give every rank the whole stream;
  * inflate: every rank plans from the same bytes and index, decodes its
    span (whole 4 KiB chunk rows of a turbo stream, whole coded blocks of a
    wide one, whole blocks balanced by lanes of any other), and every rank
    learns whether any failed by one ``all_reduce(MAX)`` of a status code
    before one ``all_gather`` gives it the whole output.  So all ranks
    raise the same error and none waits in a collective another has left.

A call's collectives are O(1) in its blocks.  Their transport is the
group's own backend (``dist.get_backend``): under NCCL the tensors go on
the rank's card, under gloo on the CPU; the port never picks or switches a
backend.  A world of one without a process group (``make_mesh(1)``) runs
no collective.  The kernels route by the device of their tensors, as
everywhere in the port, and the bytes equal the reference's at every
world size.
"""
from __future__ import annotations

import contextlib
import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from ..codec.api import _device, _own_index
from ..codec.deflate_pipeline import adler_terms, select_glue
from ..codec.framing import (
    TABLE_FIELDS,
    block_infos,
    frame_blocks,
    lane_anchors,
    stage_rows,
    stored_stream,
)
from ..codec.inflate_pipeline import inflate_raw_indexed
from ..config import CodecConfig, span, trace
from ..ops import turbo_kernel as tk
from ..ops import wide_kernel as wk
from ..ops.adler32 import adler_partials, adler_value
from ..ops.block_tables import (
    _FIXED_D_LEN,
    _FIXED_LL_LEN,
    _dynamic_header,
    _encode_tables,
)
from ..ops.deflate_kernel import (
    _BIGS,
    pack_payload,
    pack_payload_turbo,
    token_symbols,
)
from ..ops.encode_kernel import pack_tables
from ..ops.entropy import limited_lengths_pair
from ..ops.lz77 import find_matches, select_tokens
from ..spec import constants as C
from ..spec.errors import CorruptError
from ..spec.refmodel import BlockInfo, StreamIndex

# per-call phase timings (seconds; ``dispatches`` counts device dispatches):
# callers clear LAST_TIMINGS, run one codec call, then read host_stage,
# dispatch, readback, host_splice and collective (the time inside
# torch.distributed calls).  Each is the host time of the span of that name
# (``zlibes.host_stage``, ...) that ``trace(..., LAST_TIMINGS)`` enters; the
# other spans of a call feed nothing here.
LAST_TIMINGS: dict = {}

# blocks a find_matches dispatch: bounds the matcher's device memory (about
# 1.3 GB at 32 KiB blocks); the bytes do not depend on it
DISPATCH_BLOCKS = 16
# the reference's matcher defaults (S_WORDS, J_CANDS of zlibes_tpu/ops/lz77.py)
_S = 16
_J = 16


def _dispatch():
    """The span of one device dispatch, ``zlibes.dispatch``, counted in
    ``LAST_TIMINGS["dispatches"]``."""
    LAST_TIMINGS["dispatches"] = LAST_TIMINGS.get("dispatches", 0) + 1
    return trace("zlibes.dispatch", LAST_TIMINGS)


class Mesh:
    """The ranks of a process group and this rank's place in it: ``group``
    (None for a world of one without a process group), ``rank``, ``size``
    and ``device``, the ``torch.device`` this rank's kernels run on."""

    __slots__ = ("group", "rank", "size", "device")

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device


def _rank_device(device, rank: int) -> torch.device:
    """``device`` for this rank: ``cuda`` without an index is
    ``cuda:<LOCAL_RANK>``, or ``cuda:<rank % device_count>`` when
    LOCAL_RANK is unset."""
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: int | None = None, *, device="cuda",
              group=None) -> Mesh:
    """A mesh over the process group ``group`` (the default group when
    None), one rank a device.  Without a process group it is a world of one
    that runs no collective.  A mesh spans its whole group: ``n_devices``
    other than the group's size raises ValueError (make a group of that
    many ranks with ``torch.distributed.new_group`` and pass it).
    ``device="cuda"`` without a card raises RuntimeError."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group of "
                f"{n_devices} (torch.distributed.init_process_group, or "
                f"multihost.initialize); without one a mesh is a world of one")
        return Mesh(None, 0, 1, _rank_device(device, 0))
    g = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(g)
    rank = dist.get_rank(g)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"the process group has {size} ranks, not {n_devices}: a mesh "
            f"spans its whole group (pass group= a group of {n_devices})")
    return Mesh(g, rank, size, _rank_device(device, rank))


# ---------------------------------------------------------------------------
# collectives

def _coll_device(mesh: Mesh) -> torch.device:
    """Where the group's backend takes its tensors: the rank's card under
    NCCL, the CPU under any other (gloo)."""
    if dist.get_backend(mesh.group) == "nccl":
        return mesh.device
    return torch.device("cpu")


def _all_reduce(mesh: Mesh, t: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the mesh's ranks (a copy, on the collective's
    device; ``t`` itself for a world without a group)."""
    if mesh.group is None:
        return t
    with trace("zlibes.collective", LAST_TIMINGS):
        x = t.to(_coll_device(mesh), copy=True).contiguous()
        dist.all_reduce(x, op=op, group=mesh.group)
    return x


def _all_gather(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape and dtype on every rank), in rank
    order, on the collective's device."""
    if mesh.group is None:
        return [t]
    with trace("zlibes.collective", LAST_TIMINGS):
        x = t.to(_coll_device(mesh)).contiguous()
        out = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(out, x, group=mesh.group)
    return out


def _gather_ragged(mesh: Mesh, x: torch.Tensor,
                   sizes: list[int]) -> list[torch.Tensor]:
    """Every rank's 1-D ``x``, whose lengths ``sizes`` every rank knows."""
    if mesh.group is None:
        return [x]
    pad = x.new_zeros(max(sizes))
    pad[: x.numel()] = x
    return [g[:s] for g, s in zip(_all_gather(mesh, pad), sizes)]


def _collective_read(mesh: Mesh):
    """The span of a blocking read of what a collective returned,
    ``zlibes.collective`` (outside ``LAST_TIMINGS``, whose ``collective``
    times the calls alone).  Under NCCL a collective is only queued, so the
    host waits here: for its own work queued before it, the exchange, and
    the slowest rank.  Nothing without a group."""
    if mesh.group is None:
        return contextlib.nullcontext()
    return trace("zlibes.collective")


def _agree(mesh: Mesh, exc: BaseException | None) -> None:
    """Raise on every rank when any rank's work raised ``exc``, before the
    output gather that would wait for it: CorruptError on every rank when
    the failures were CorruptErrors (the reference's class), else this
    rank's own exception, or RuntimeError on the ranks that did not
    fail."""
    status = 0 if exc is None else 1 if isinstance(exc, CorruptError) else 2
    worst = status
    if mesh.group:
        t = _all_reduce(mesh, torch.tensor([status]), dist.ReduceOp.MAX)
        with _collective_read(mesh), trace("zlibes.readback"):
            worst = int(t[0])
    if worst == 1:
        raise CorruptError(
            "parallel inflate failed (corrupt or mis-indexed)") from exc
    if worst == 2:
        if exc is not None:
            raise exc
        raise RuntimeError("parallel inflate failed on another rank")


def _span(total: int, mesh: Mesh) -> tuple[int, int, int]:
    """This rank's contiguous [lo, hi) of ``total`` items split in equal
    shares of ``per`` (the last ranks' shares may be short or empty)."""
    per = -(-total // mesh.size)
    lo = min(total, mesh.rank * per)
    return lo, min(total, lo + per), per


# ---------------------------------------------------------------------------
# deflate

def _fixed_tables(Bd: int):
    """Per-block fixed-Huffman encode tables (ll_code, ll_len (Bd, 288),
    d_code, d_len (Bd, 32)), int64 CPU tensors."""
    ll_code, d_code = _encode_tables(_FIXED_LL_LEN, _FIXED_D_LEN)
    return tuple(torch.from_numpy(np.asarray(x, np.int64)).expand(Bd, -1)
                 for x in (ll_code, _FIXED_LL_LEN, d_code, _FIXED_D_LEN))


def _tokens(dev_bytes, dev_nv, N: int, seg_size: int, reset: int,
            turbo: bool):
    """Match and select one dispatch's blocks -> (tv, td, cnt), in the
    spans ``zlibes.match`` and ``zlibes.select``."""
    with trace("zlibes.match"):
        matches = find_matches(dev_bytes, dev_nv, N=N, S=_S, J=_J,
                               reset=reset, two_phase=turbo)
    with trace("zlibes.select"):
        if turbo:
            return select_glue(dev_bytes, matches, dev_nv, N, lazy=True)
        return select_tokens(dev_bytes, matches, dev_nv, N=N,
                             SEG_SIZE=seg_size)


def _adler_shard(dev_bytes, dev_nv, d0: int, N: int, n: int):
    """(s1, s2) Adler-32 partials of blocks d0, d0 + 1, ... of an n-byte
    input, held on the device as the rows ``dev_bytes``."""
    chunk = min(2048, N)
    a_c, b_c = adler_terms(dev_bytes, dev_nv, chunk)
    nc = N // chunk
    blk = torch.arange(dev_bytes.shape[0], device=a_c.device) + d0
    offs = (blk[:, None] * N
            + torch.arange(nc, device=a_c.device)[None, :] * chunk)
    return adler_partials(a_c, b_c, offs.reshape(-1), n)


def _pack(tv, td, cnt, tables, hdr_bits, nseg: int, W: int, R: int):
    """Pack one dispatch's tokens -> (words (B, W), payload_end (B,),
    lane_bit0, split_bit, split_out (L,)); ``tables`` are the turbo pack's
    (lt, dt) when R > 0, else per-block (ll_code, ll_len, d_code, d_len);
    in the spans ``zlibes.symbols`` and ``zlibes.pack``."""
    with trace("zlibes.symbols"):
        lsym, dsym, valid, _lf, _df = token_symbols(tv, td, cnt, nseg=nseg)
    with trace("zlibes.pack"):
        if R:
            lt, dt = tables
            return pack_payload_turbo(tv, td, valid, lt, dt, hdr_bits,
                                      nseg=nseg, W=W, R=R)
        B = hdr_bits.numel()
        enabled = torch.ones(B, dtype=torch.bool, device=tv.device)
        words, pe, lb = pack_payload(tv, td, lsym, dsym, valid, *tables,
                                     hdr_bits, enabled, nseg=nseg, W=W)
        big = torch.full_like(lb, _BIGS)       # no split anchors
        return words, pe, lb, big, big


def _pack_handle(words, pe, lb, sb, so) -> tuple:
    """One dispatch's pack outputs as int32 tensors for the readback:
    payload ends, each lane's first bit, split bit and split output offset,
    and the blocks' words."""
    w = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return tuple(x.reshape(-1).int() for x in (pe, lb, sb, so, w))


def sharded_deflate_step(rows: torch.Tensor, n_valid: torch.Tensor, d0: int,
                         n_total: int, N: int, SEG_SIZE: int, W: int):
    """Fixed-Huffman encode of this rank's block rows (the reference's
    ``shard_map`` body, zlibes_tpu/parallel/block_parallel.py:113): rows
    (B, N + 8) uint8 and n_valid (B,) int32 on the rank's device, its first
    block the input's block ``d0``.  Returns (words (B, W) int64 holding
    32-bit words, payload_end (B,), lane_bit0 (L,), (s1, s2) Adler-32
    partials of these rows); the caller sums the partials over the mesh."""
    nseg = N // SEG_SIZE
    tv, td, cnt = _tokens(rows, n_valid, N, SEG_SIZE, 0, False)
    B = rows.shape[0]
    tables = tuple(t.to(rows.device) for t in _fixed_tables(B))
    hdr = torch.full((B,), 3, dtype=torch.long, device=rows.device)
    words, pe, lb, _sb, _so = _pack(tv, td, cnt, tables, hdr, nseg, W, 0)
    return words, pe, lb, _adler_shard(rows, n_valid, d0, N, n_total)


def sharded_histogram_step(rows: torch.Tensor, n_valid: torch.Tensor,
                           d0: int, n_total: int, N: int, SEG_SIZE: int,
                           reset: int = 0, turbo: bool = False):
    """Phase 1 of the dynamic-table encode on this rank's block rows (the
    reference's ``shard_map`` body, block_parallel.py:169): match and
    select -> (tv, td, cnt, hist (288 + 32 + 2,) int64: the summed litlen
    and distance histograms of the rows, then their (s1, s2) Adler-32
    partials).  ``parallel_deflate`` sums ``hist`` over the mesh in one
    ``all_reduce`` and builds the shared code lengths from it."""
    nseg = N // SEG_SIZE
    tv, td, cnt = _tokens(rows, n_valid, N, SEG_SIZE, reset, turbo)
    with trace("zlibes.symbols"):
        _ls, _ds, _v, llf, dfq = token_symbols(tv, td, cnt, nseg=nseg)
    s1, s2 = _adler_shard(rows, n_valid, d0, N, n_total)
    return tv, td, cnt, torch.cat([llf.sum(0), dfq.sum(0), s1[None],
                                   s2[None]])


def sharded_pack_step(tv, td, cnt, tables, hdr_bits: torch.Tensor,
                      N: int, SEG_SIZE: int, W: int, R: int = 0):
    """Phase 2: pack this rank's tokens with the shared tables (block_
    parallel.py:234).  ``R`` > 0 packs through ``pack_payload_turbo`` with
    ``tables`` the packed (lt, dt); else ``pack_payload`` with ``tables``
    the shared (ll_code, ll_len, d_code, d_len).  Returns (words (B, W),
    payload_end (B,), lane_bit0, split_bit, split_out (L,)); split_* are
    2^30 without R."""
    nseg = N // SEG_SIZE
    B = hdr_bits.numel()
    if not R:
        tables = tuple(t.expand(B, -1) for t in tables)
    return _pack(tv, td, cnt, tables, hdr_bits, nseg, W, R)


@span("zlibes.parallel_deflate")
def parallel_deflate(data: bytes | None, mesh: Mesh, block_size: int = 32768,
                     seg_size: int = 1024, dynamic: bool = True,
                     max_code_bits: int = 15, turbo: bool = False,
                     with_index: bool = False, n_bytes: int | None = None,
                     block_provider=None):
    """Block-parallel deflate across the mesh -> zlib stream (and, with
    ``with_index``, its StreamIndex), the same on every rank.

    ``dynamic=True`` (the default): one length-limited table pair for the
    whole stream, from the histograms summed over the mesh; ``dynamic=
    False``: fixed-Huffman blocks.  ``turbo=True``: the turbo profile
    (512-byte segments, 4 KiB window resets, codes of at most 9 bits, the
    split anchors that pair each segment for ``parallel_inflate``).

    Per-rank input: pass ``data=None`` with ``n_bytes`` (the whole input's
    size) and ``block_provider``, a callable ``(block_idx) -> bytes`` that
    is asked only for this rank's blocks (``multihost.host_shard`` of
    ``mesh.size * ceil(blocks / mesh.size)`` rows), so no rank holds more
    than its share of the input.  The call is the span
    ``zlibes.parallel_deflate``.
    """
    if turbo:
        seg_size, max_code_bits, dynamic = 512, 9, True
        if block_size % 4096:
            raise ValueError("turbo needs a 4 KiB-aligned block size")
    N = block_size
    if N % seg_size or N % min(2048, N):
        raise ValueError(f"block_size {N} must be a multiple of seg_size "
                         f"{seg_size} and of 2048 above 2048")
    reset = 4096 if turbo else 0
    if data is not None:
        src = np.frombuffer(bytes(data), dtype=np.uint8)
        n = src.size
    else:
        if n_bytes is None or block_provider is None:
            raise ValueError("data=None requires n_bytes and block_provider")
        src, n = block_provider, n_bytes
    if n == 0:
        body, index = stored_stream(np.zeros(0, np.uint8))
        out = C.ZLIB_HEADER + body + (1).to_bytes(4, "big")
        return (out, index.shifted(16)) if with_index else out
    dev = mesh.device
    nblocks = -(-n // N)
    lo, hi, _Bd = _span(nblocks, mesh)
    W = (15 * N + 4096) // 32
    nseg = N // seg_size
    R = CodecConfig.turbo().pack_row_width(seg_size) if turbo else 0

    # phase 1 (dynamic) or the whole encode (fixed), a dispatch at a time
    kept = []
    handles = []
    acc = torch.zeros(C.NUM_LITLEN_SYMBOLS + C.NUM_DIST_SYMBOLS + 2,
                      dtype=torch.long, device=dev)
    max_cnt = torch.zeros((), dtype=torch.int32, device=dev)
    for d0 in range(lo, hi, DISPATCH_BLOCKS):
        d1 = min(hi, d0 + DISPATCH_BLOCKS)
        with trace("zlibes.host_stage", LAST_TIMINGS):
            rows_np, nv_np = stage_rows(src, d0, d1, N)
        with _dispatch():
            rows = torch.from_numpy(rows_np).to(dev)
            nv = torch.from_numpy(nv_np).to(dev)
            if dynamic:
                tv, td, cnt, hist = sharded_histogram_step(
                    rows, nv, d0, n, N, seg_size, reset, turbo)
                acc += hist
                max_cnt = torch.maximum(max_cnt, cnt.max())
                kept.append((d0, d1, tv, td, cnt))
            else:
                words, pe, lb, (s1, s2) = sharded_deflate_step(
                    rows, nv, d0, n, N, seg_size, W)
                acc[-2] += s1
                acc[-1] += s2
                big = torch.full_like(lb, _BIGS)
                handles.append(_pack_handle(words, pe, lb, big, big))

    # the one all_reduce: histograms and Adler-32 partials together
    if dynamic:
        tot = _all_reduce(mesh, acc).to(dev)
        nh = C.NUM_LITLEN_SYMBOLS
        ll_tot = tot[:nh].clone()
        ll_tot[C.END_OF_BLOCK] += nblocks
        ll_d, d_d = limited_lengths_pair(ll_tot, tot[nh:-2], max_code_bits)
        with _collective_read(mesh), trace("zlibes.readback", LAST_TIMINGS):
            host = torch.cat([ll_d.long(), d_d.long(), tot[-2:]]).cpu().numpy()
        ll_len = host[:nh]
        d_len = host[nh:-2]
        s1, s2 = (int(x) for x in host[-2:])
        with trace("zlibes.entropy"):
            # the last block's header differs only in BFINAL, which the
            # framing sets
            hdr, hb = _dynamic_header(ll_len, d_len, 0)
            hdr = np.frombuffer(hdr, np.uint8)
            ll_code, d_code = _encode_tables(ll_len, d_len)
            host_tables = (pack_tables(ll_code, ll_len, d_code, d_len)
                           if turbo else
                           tuple(torch.from_numpy(np.asarray(x, np.int64))
                                 for x in (ll_code, ll_len, d_code, d_len)))
        with trace("zlibes.upload"):
            tables = tuple(t.to(dev) for t in host_tables)
        for d0, d1, tv, td, cnt in kept:
            with _dispatch():
                handles.append(_pack_handle(*sharded_pack_step(
                    tv, td, cnt, tables,
                    torch.full((d1 - d0,), hb, dtype=torch.long, device=dev),
                    N, seg_size, W, R)))
        kept.clear()
    else:
        adler = _all_reduce(mesh, acc[-2:])
        with _collective_read(mesh), trace("zlibes.readback"):
            s1, s2 = (int(x) for x in adler.cpu())
        ll_code, _ = _encode_tables(_FIXED_LL_LEN, _FIXED_D_LEN)
        ll_len = _FIXED_LL_LEN
        hdr, hb = np.array([C.BTYPE_FIXED << 1], np.uint8), 3
    with trace("zlibes.readback", LAST_TIMINGS):
        # each output of every dispatch, then the next output
        blob = (torch.cat([torch.cat(x) for x in zip(*handles)]).cpu().numpy()
                if handles else np.zeros(0, np.int32))
        max_tokens = int(max_cnt) if dynamic and with_index else 0

    # this rank's blocks as bytes and their part of the index, relative to
    # the rank's first byte
    with trace("zlibes.host_splice", LAST_TIMINGS):
        k = hi - lo
        m = k * (1 + 3 * nseg)
        pe = blob[:k].astype(np.int64)
        out_start = np.arange(lo, hi, dtype=np.int64) * N
        nb = np.clip(n - out_start, 0, N)
        body, binfo, start, row = frame_blocks(
            blob, m + np.arange(k, dtype=np.int64) * W, pe, hdr, hb,
            int(ll_code[C.END_OF_BLOCK]), int(ll_len[C.END_OF_BLOCK]),
            C.BTYPE_DYNAMIC if dynamic else C.BTYPE_FIXED, nb, out_start,
            out_start == (nblocks - 1) * N)
        anchors = (np.zeros(0, np.int64),) * 3
        if with_index:
            lane_bit0, split_bit, split_out = blob[k:m].reshape(3, k, nseg)
            anchors = lane_anchors(
                start, row, nb, out_start, lane_bit0, seg_size,
                split=(split_bit, split_out, pe) if turbo else None)
        own = np.frombuffer(body, np.uint8)
        idx = (np.concatenate([binfo.reshape(-1), *anchors])
               if with_index else np.zeros(0, np.int64))
        payload = np.concatenate([own, idx.view(np.uint8)])
        sizes = np.array([own.size, binfo.shape[0], anchors[0].size,
                          max_tokens, payload.size], np.int64)

    # the gathers: sizes, then the bytes and index arrays of every rank
    # (the reads of what they gathered wait for the slowest rank)
    gathered = _all_gather(mesh, torch.from_numpy(sizes))
    with _collective_read(mesh), trace("zlibes.readback"):
        all_sizes = [s.cpu().numpy() for s in gathered]
    gathered = _gather_ragged(mesh, torch.from_numpy(payload),
                              [int(s[4]) for s in all_sizes])
    with _collective_read(mesh), trace("zlibes.readback"):
        parts = [p.cpu().numpy() for p in gathered]
    with trace("zlibes.host_splice", LAST_TIMINGS):
        trailer = adler_value(s1 % C.ADLER_MOD, s2 % C.ADLER_MOD,
                              n).to_bytes(4, "big")
        out = C.ZLIB_HEADER + b"".join(
            p[: int(s[0])].tobytes() for p, s in zip(parts, all_sizes)) \
            + trailer
        if not with_index:
            return out
        return out, _gathered_index(parts, all_sizes, reset, turbo)


def _gathered_index(parts, all_sizes, reset: int, turbo: bool):
    """The whole stream's StreamIndex from every rank's part, each shifted
    by the bits of the ranks before it and the 16-bit zlib header."""
    blocks, anchors = [], []
    base_bit = 0
    for p, s in zip(parts, all_sizes):
        nbytes, nb, na = int(s[0]), int(s[1]), int(s[2])
        x = np.frombuffer(p[nbytes:].tobytes(), np.int64)
        # (bit, out, block) rows, moved by the ranks before this one
        anchors.append(x[nb * TABLE_FIELDS :].reshape(3, na)
                       + np.array([[base_bit], [0], [len(blocks)]]))
        blocks += block_infos(x[: nb * TABLE_FIELDS], base_bit)
        base_bit += 8 * nbytes
    bits, outs, blks = np.concatenate(anchors, 1)
    return StreamIndex(
        blocks, bits, outs, blks.astype(np.int32), chunk_reset=reset,
        turbo=turbo, max_tokens=max(int(s[3]) for s in all_sizes),
    ).shifted(16)


# ---------------------------------------------------------------------------
# inflate

def _plan_rows(plan, lo: int, hi: int, lanes_per_row: int, **rows):
    """A copy of a turbo or wide plan cut to its rows [lo, hi): the
    per-lane tensors (and a turbo plan's host lane ends) to those rows'
    lanes, and ``rows``' per-row fields (cut here) and counts set."""
    sub = copy.copy(plan)
    lanes = slice(lo * lanes_per_row, hi * lanes_per_row)
    for name in ("start_w", "bit0", "endb", "base", "endb_host"):
        if hasattr(plan, name):
            setattr(sub, name, getattr(plan, name)[lanes])
    for name, value in rows.items():
        setattr(sub, name, value)
    return sub


def sharded_turbo_inflate_step(plan, c0: int, c1: int,
                               check: bool = True) -> torch.Tensor:
    """The turbo pipeline (decode_turbo -> glue -> resolve_turbo,
    ``run_turbo``) on chunk rows [c0, c1) of a ``TurboPlan`` alone
    (block_parallel.py:316): their lanes, ``SUBS_PER_CHUNK`` each, both
    lanes of every split pair.  Returns the (c1 - c0, 4096) uint8 rows;
    ``check`` raises CorruptError where a lane failed or did not end at its
    anchor."""
    from ..codec.turbo import run_turbo

    return run_turbo(_plan_rows(plan, c0, c1, tk.SUBS_PER_CHUNK,
                                C_pad=c1 - c0), check)


@span("zlibes.parallel_inflate")
def parallel_inflate_turbo(data: bytes, index: StreamIndex, mesh: Mesh,
                           check: bool = True) -> bytes:
    """Turbo inflate with whole 4 KiB chunk rows split across the mesh;
    the call is the span ``zlibes.parallel_inflate``."""
    from ..codec.turbo import TurboPlan

    index = _own_index(index)
    with trace("zlibes.host_stage", LAST_TIMINGS):
        plan = TurboPlan.build(bytes(data), index, mesh.device)
        c0, c1, per = _span(plan.C_pad, mesh)
    exc = None
    rows = torch.zeros((per, 4096), dtype=torch.uint8, device=mesh.device)
    try:
        with _dispatch():
            if c1 > c0:
                rows[: c1 - c0] = sharded_turbo_inflate_step(plan, c0, c1,
                                                             check)
    except Exception as e:      # every rank raises, in _agree
        exc = e
    _agree(mesh, exc)
    with trace("zlibes.readback", LAST_TIMINGS):
        flat = torch.cat(_all_gather(mesh, rows)).reshape(-1)
        with _collective_read(mesh):
            return flat[: plan.total_out].cpu().numpy().tobytes()


def sharded_wide_inflate_step(plan, cb0: int, cb1: int,
                              check: bool = True) -> torch.Tensor:
    """The wide pipeline (decode_wide -> glue -> resolve_wide,
    ``run_wide``) on coded blocks [cb0, cb1) of a ``WidePlan`` alone
    (block_parallel.py:423): one row a coded block.  Returns the
    (cb1 - cb0, LPB * 128) uint8 rows; ``check`` raises CorruptError where a
    lane failed or did not end at its anchor."""
    from ..codec.wide import run_wide

    return run_wide(_plan_rows(plan, cb0, cb1, plan.LPB, Cb=cb1 - cb0,
                               lt=plan.lt[cb0:cb1], dt=plan.dt[cb0:cb1]),
                    check)


@span("zlibes.parallel_inflate")
def parallel_inflate_wide(data: bytes, index: StreamIndex, mesh: Mesh,
                          check: bool = True) -> bytes:
    """Wide (default-profile) inflate with whole coded blocks split across
    the mesh, one row each; stored blocks are spliced in after the gather,
    as on one device.  The call is the span ``zlibes.parallel_inflate``."""
    from ..codec.wide import WidePlan, wide_output

    index = _own_index(index)
    data = bytes(data)
    with trace("zlibes.host_stage", LAST_TIMINGS):
        plan = WidePlan.build(data, index, mesh.device)
        if not plan.coded:
            raise ValueError("all-stored stream has no device work")
        cb0, cb1, per = _span(plan.Cb, mesh)
    exc = None
    rows = torch.zeros((per, plan.LPB * wk.SUB), dtype=torch.uint8,
                       device=mesh.device)
    try:
        with _dispatch():
            if cb1 > cb0:
                rows[: cb1 - cb0] = sharded_wide_inflate_step(plan, cb0, cb1,
                                                              check)
    except Exception as e:      # every rank raises, in _agree
        exc = e
    _agree(mesh, exc)
    with trace("zlibes.readback", LAST_TIMINGS):
        rows = torch.cat(_all_gather(mesh, rows)).to(mesh.device)
        out = wide_output(plan, rows, data)
        with _collective_read(mesh):
            return out.cpu().numpy().tobytes()


def _block_spans(index: StreamIndex, D: int) -> list:
    """Whole blocks in D contiguous spans balanced by anchor lanes
    (block_parallel.py:777-787), per rank (first block, last block) or
    None: the reference's lane split, each rank's span widened to the next
    rank's first block (and the first to block 0, the last to the last
    block), so that every block, stored ones too, is decoded by one rank."""
    lane_block = np.asarray(index.anchor_block, np.int64)
    nlanes = lane_block.size
    firsts = []
    target = -(-nlanes // D)
    i = 0
    for _d in range(D):
        j = min(nlanes, i + target)
        while j < nlanes and lane_block[j] == lane_block[j - 1]:
            j += 1
        firsts.append(int(lane_block[i]) if j > i else None)
        i = j
    nblocks = len(index.blocks)
    starts = [b for b in firsts if b is not None]
    if not starts:                  # no coded block: rank 0 copies them all
        return [(0, nblocks - 1)] + [None] * (D - 1)
    starts[0] = 0
    ends = [b - 1 for b in starts[1:]] + [nblocks - 1]
    spans = iter(zip(starts, ends))
    return [None if b is None else next(spans) for b in firsts]


def _sub_index(index: StreamIndex, b0: int, b1: int) -> StreamIndex:
    """Blocks [b0, b1] of ``index`` (and their anchors) as an index of their
    own output, which starts at block b0's first byte: neither turbo nor
    wide, so the group decode takes it."""
    out_lo = index.blocks[b0].out_start
    mask = (index.anchor_block >= b0) & (index.anchor_block <= b1)
    return StreamIndex(
        [BlockInfo(b.btype, b.bfinal, b.start_bit, b.payload_start_bit,
                   b.end_bit, b.out_start - out_lo, b.out_len)
         for b in index.blocks[b0 : b1 + 1]],
        index.anchor_bit[mask], index.anchor_out[mask] - out_lo,
        (index.anchor_block[mask] - b0).astype(np.int32),
        getattr(index, "self_contained", True))


def sharded_inflate_step(data: bytes, index: StreamIndex, b0: int, b1: int,
                         device: torch.device) -> torch.Tensor:
    """The group decode (decode_tokens + resolve_global: ``plan_groups`` /
    ``run_group`` through ``inflate_raw_indexed``, stored payloads spliced
    in) of blocks [b0, b1] behind no prefix (block_parallel.py:277): their
    output as a uint8 tensor on ``device``.  A copy from before block b0
    raises CorruptError."""
    return inflate_raw_indexed(data, _sub_index(index, b0, b1), device)


@span("zlibes.parallel_inflate")
def parallel_inflate(data: bytes, index: StreamIndex, mesh: Mesh) -> bytes:
    """Block-parallel inflate of an indexed stream across the mesh; every
    rank returns the whole output.

    A turbo index takes ``parallel_inflate_turbo``; a wide, self-contained
    one with coded output ``parallel_inflate_wide``; any other index the
    group decode (``decode_tokens`` + ``resolve_global``) of whole blocks
    balanced by lanes, each rank's blocks resolved behind no prefix, so a
    chained index raises CorruptError wherever a copy crosses into another
    rank's span, as in the reference.  ``index`` must be the port's own
    StreamIndex (TypeError otherwise).  The call is the span
    ``zlibes.parallel_inflate``."""
    index = _own_index(index)
    if getattr(index, "turbo", False):
        return parallel_inflate_turbo.__wrapped__(data, index, mesh)
    if (getattr(index, "wide", False)
            and getattr(index, "self_contained", True)
            and any(b.btype != C.BTYPE_STORED and b.out_len
                    for b in index.blocks)):
        return parallel_inflate_wide.__wrapped__(data, index, mesh)
    data = bytes(data)
    spans = _block_spans(index, mesh.size)
    sizes = [sum(b.out_len for b in index.blocks[sp[0] : sp[1] + 1])
             if sp else 0 for sp in spans]
    exc = None
    out = torch.zeros(0, dtype=torch.uint8, device=mesh.device)
    try:
        with _dispatch():
            if spans[mesh.rank]:
                out = sharded_inflate_step(data, index, *spans[mesh.rank],
                                           mesh.device)
    except Exception as e:      # every rank raises, in _agree
        exc = e
    _agree(mesh, exc)
    with trace("zlibes.readback", LAST_TIMINGS):
        parts = _gather_ragged(mesh, out, sizes) if any(sizes) else []
        with _collective_read(mesh):
            return b"".join(p.cpu().numpy().tobytes() for p in parts)
