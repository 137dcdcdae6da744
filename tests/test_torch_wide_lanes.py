"""The wide plan's lane spans (``wide_lanes``, plain route on the CPU)
against the host loop they replaced, kept here as the oracle.

``WidePlan.build`` takes every coded block's anchors as a run of the
anchors sorted by block and builds each lane's first window word, start
and end bit and first token's offset in one ``wide_lanes`` call, and the
lane window ``SW`` from its status.  The oracle is the per-block loop that
built them on the host before: one ``np.nonzero`` over every anchor a
block.  Both run on the committed level-6 fixture, on the fixture tiled
nine times (an nci-sized stream of 270 blocks), on an index whose anchors
are not sorted by block, and on one index a fault, where both raise the
same class and message.  Imports the port alone (no JAX), so the card
tests import its helpers.
"""
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlibes_tpu_torch
from zlibes_tpu_torch import CodecStats, CorruptError, StreamIndex
from zlibes_tpu_torch.codec import wide as wd
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.ops import wide_kernel as wk
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec.refmodel import BlockInfo

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "golden"
SUB = wk.SUB


def fixture():
    """The committed level-6 stream (128 KiB blocks) and its wide index."""
    return ((GOLDEN / "wide_bench.zz").read_bytes(),
            StreamIndex.load(GOLDEN / "wide_bench.idx.npz"))


def tile(comp: bytes, index: StreamIndex, k: int):
    """The zlib stream's body ``k`` times behind one header, and its index:
    each copy's blocks and anchors moved by the bits and bytes before it.
    Every block keeps its header, so the indexed decode gives the output
    ``k`` times (the trailer is the first copy's)."""
    body = comp[2:-4]
    nbits, nout, nblk = 8 * len(body), index.total_out, len(index.blocks)
    blocks = [BlockInfo(b.btype, b.bfinal, b.start_bit + i * nbits,
                        b.payload_start_bit + i * nbits, b.end_bit + i * nbits,
                        b.out_start + i * nout, b.out_len)
              for i in range(k) for b in index.blocks]
    a = [np.concatenate([np.asarray(x, np.int64) + i * d for i in range(k)])
         for x, d in ((index.anchor_bit, nbits), (index.anchor_out, nout),
                      (index.anchor_block, nblk))]
    return (comp[:2] + body * k + comp[-4:],
            StreamIndex(blocks, a[0], a[1], a[2].astype(np.int32),
                        wide=True))


def oracle_lanes(index: StreamIndex, LPB: int):
    """The host loop ``WidePlan.build`` ran before ``wide_lanes``: every
    coded block's anchors by ``np.nonzero`` over all of them.  Returns
    start_w, bit0, endb, base (int32) and SW, or raises as it raised."""
    coded = [b for b in index.blocks
             if b.btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC) and b.out_len]
    L = len(coded) * LPB
    abit = np.asarray(index.anchor_bit, np.int64)
    aout = np.asarray(index.anchor_out, np.int64)
    ablk = np.asarray(index.anchor_block, np.int64)
    bit0_abs = np.zeros(L, np.int64)
    end_abs = np.zeros(L, np.int64)
    base = np.zeros(L, np.int64)
    block_of = {id(b): i for i, b in enumerate(index.blocks)}
    for cb, b in enumerate(coded):
        sel = np.nonzero(ablk == block_of[id(b)])[0]
        na_b = -(-b.out_len // SUB)
        if sel.size != na_b:
            raise CorruptError(
                f"wide index must carry one anchor per {SUB} B of "
                f"block output ({na_b} expected, {sel.size} found)")
        ab = abit[sel]
        rel = aout[sel] - b.out_start - np.arange(na_b) * SUB
        if (np.diff(ab) < 0).any() or (rel < 0).any() \
                or (rel >= SUB + C.MAX_MATCH + 1).any():
            raise CorruptError("wide anchors are not monotone uniform")
        lo = cb * LPB
        bit0_abs[lo : lo + na_b] = ab
        end_abs[lo : lo + na_b] = np.concatenate([ab[1:], [b.end_bit]])
        base[lo : lo + na_b] = rel
    start_w = bit0_abs >> 5
    endb = end_abs - (start_w << 5)
    wneed = -(-int(endb.max(initial=0)) // 32) + 2
    SW = max(8, -(-wneed // 8) * 8)
    if SW > wd.MAX_SW:
        raise CorruptError("anchor span exceeds the lane stream window")
    return tuple(x.astype(np.int32) for x in (start_w, bit0_abs & 31, endb,
                                              base)) + (SW,)


def _replace(index: StreamIndex, bit=None, out=None, blk=None):
    return StreamIndex(index.blocks,
                       index.anchor_bit if bit is None else bit,
                       index.anchor_out if out is None else out,
                       index.anchor_block if blk is None else blk,
                       wide=True)


def unsorted(index: StreamIndex) -> StreamIndex:
    """The same anchors with the blocks' runs in reverse block order."""
    blk = np.asarray(index.anchor_block)
    order = np.argsort(-blk.astype(np.int64), kind="stable")
    return _replace(index, index.anchor_bit[order], index.anchor_out[order],
                    blk[order])


# one fault each, in block 3 of the fixture (anchor 100 of its run)
FAULTS = ["missing_anchor", "extra_anchor", "non_monotone_bit",
          "rel_below_zero", "rel_past_limit", "window_too_wide"]


def faulty(index: StreamIndex, fault: str) -> StreamIndex:
    """``index`` with one fault in coded block 3, at its anchor 100."""
    blk = np.asarray(index.anchor_block)
    j = int(np.searchsorted(blk, 3)) + 100
    m = 100
    bit = np.array(index.anchor_bit, np.int64)
    out = np.array(index.anchor_out, np.int64)
    if fault == "missing_anchor":
        keep = np.arange(blk.size) != j
        return _replace(index, bit[keep], out[keep], blk[keep])
    if fault == "extra_anchor":
        at = np.insert(np.arange(blk.size), j, j)
        return _replace(index, bit[at], out[at], blk[at])
    start = index.blocks[3].out_start + m * SUB
    if fault == "non_monotone_bit":
        bit[j] = bit[j + 1] + 1
    elif fault == "rel_below_zero":
        out[j] = start - 1
    elif fault == "rel_past_limit":
        out[j] = start + SUB + C.MAX_MATCH + 1
    else:
        # 20 lanes start where the one before them starts: the last of them
        # spans 21 sub-spans of coded bits, past the widest window
        bit[j : j + 20] = bit[j - 1]
    return _replace(index, bit, out)


def _plan_lanes(plan):
    return tuple(getattr(plan, n).numpy()
                 for n in ("start_w", "bit0", "endb", "base")) + (plan.SW,)


def _same_lanes(got, want):
    for g, w, name in zip(got, want, ("start_w", "bit0", "endb", "base",
                                      "SW")):
        assert np.array_equal(g, w), name


@pytest.fixture(scope="module")
def stream():
    return fixture()


@pytest.mark.parametrize("copies", [1, 9])
def test_plan_lanes_equal_the_host_loop(stream, copies):
    comp, index = tile(*stream, copies) if copies > 1 else stream
    tk.LAUNCHES.clear()
    plan = wd.WidePlan.build(comp, index, "cpu")
    assert not tk.LAUNCHES
    assert (plan.Cb, plan.LPB) == (30 * copies, 1024)
    assert index.anchor_bit.size == 30025 * copies
    _same_lanes(_plan_lanes(plan), oracle_lanes(index, plan.LPB))


def test_tiled_stream_decodes_to_the_tiled_output(stream):
    """The tiled stream the plan tests read is a stream: three copies
    decode to the corpus three times through the indexed decode."""
    comp, index = tile(*stream, 3)
    want = zlib.decompress(stream[0])
    (out, _, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                      device="cpu")
    assert n == 3 * len(want) and out.numpy().tobytes() == want * 3


def test_anchors_out_of_block_order_give_the_same_lanes(stream):
    comp, index = stream
    shuffled = unsorted(index)
    blk = np.asarray(shuffled.anchor_block)
    assert (blk[1:] < blk[:-1]).any()
    plan = wd.WidePlan.build(comp, shuffled, "cpu")
    _same_lanes(_plan_lanes(plan), oracle_lanes(index, plan.LPB))
    _same_lanes(_plan_lanes(plan), oracle_lanes(shuffled, plan.LPB))


@pytest.mark.parametrize("fault", FAULTS)
def test_single_fault_raises_what_the_host_loop_raised(stream, fault):
    comp, index = stream
    bad = faulty(index, fault)
    with pytest.raises(CorruptError) as want:
        oracle_lanes(bad, 1024)
    with pytest.raises(CorruptError) as got:
        wd.WidePlan.build(comp, bad, "cpu")
    assert type(got.value) is CorruptError
    assert str(got.value) == str(want.value)


def test_wide_lanes_plain_flags_each_fault_in_its_status(stream):
    """``wide_lanes``' status on the lane faults (the counts are the
    host's): the flag is set, and the widest end bit sizes the window."""
    _, index = stream
    ids = list(range(len(index.blocks)))
    for fault, flag in (("non_monotone_bit", 1), ("rel_below_zero", 1),
                        ("rel_past_limit", 1), ("window_too_wide", 0)):
        abit, aout, rows = wd.anchor_rows(faulty(index, fault), ids)
        *_, status = wk.wide_lanes(*map(torch.from_numpy, (abit, aout, rows)),
                                   1024)
        assert status.dtype == torch.int32 and status[0] == flag, fault
        assert (int(status[1]) > 32 * (wd.MAX_SW - 2)) == (not flag), fault


def test_wide_lanes_wrapper_checks_its_inputs(stream):
    _, index = stream
    abit, aout, rows = map(torch.from_numpy,
                           wd.anchor_rows(index, range(len(index.blocks))))
    with pytest.raises(ValueError, match="dtype"):
        wk.wide_lanes(abit.int(), aout, rows, 1024)
    with pytest.raises(ValueError, match="shape"):
        wk.wide_lanes(abit, aout, rows[:, :3].contiguous(), 1024)
    with pytest.raises(ValueError, match="LPB must be positive"):
        wk.wide_lanes(abit, aout, rows, 0)


def test_device_lanes_is_zero_on_the_cpu(stream):
    comp, index = stream
    stats = CodecStats()
    zlibes_tpu_torch.inflate_to_device(comp, index, device="cpu",
                                       stats=stats)
    assert (stats.device_lanes, stats.device_headers) == (0, 0)
