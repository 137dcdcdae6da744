"""``decode_tables``: each coded block's decode-table row, on the CPU
through its plain route (the host parse) and on a card through the kernel.

The CPU tests hold the plain route to the host path a block
(``decode_tables_cases.expected``: ``_block_code_lengths`` and
``wide_decode_tables``) on the cases of ``decode_tables_cases``, and raise
each bad header's error through every call that plans a decode:
``plan_groups``, ``WidePlan.build``, ``inflate_to_device`` and
``inflate_range``.  The card tests (skipped without CUDA) hold the
kernel's rows and statuses bit for bit to the plain route's, the same
errors to the same calls, ``CodecStats.device_headers`` to the coded
blocks of a call, and the plans to one launch and no plain version.  An
over-subscribed litlen or distance code raises ``CorruptError`` ("over-
subscribed Huffman code") on both routes, as ``canonical_codes_batch``
raises it on the host.  Imports no JAX.
"""
import numpy as np
import pytest
import torch

import decode_tables_cases as cases
import zlibes_tpu_torch
from zlibes_tpu_torch import CodecStats, CorruptError, TruncatedError
from zlibes_tpu_torch.codec import inflate_pipeline as ip
from zlibes_tpu_torch.codec import wide as wd
from zlibes_tpu_torch.ops import decode_tables as dtab
from zlibes_tpu_torch.ops import turbo_kernel as tk

torch.set_num_threads(2)

ALL = sorted(cases.CASES) + sorted(cases.ERRORS)
# the calls that plan a decode, each given a one-block error stream
CALLS = ["plan_groups", "wide_plan", "inflate_to_device_wide",
         "inflate_to_device_generic", "inflate_range_wide",
         "inflate_range_generic"]

# the condition is a string, so it is evaluated when each test is set up
on_card = pytest.mark.skipif("not torch.cuda.is_available()",
                             reason="needs a CUDA card")


def _call(call: str, comp: bytes, blocks, device: str):
    wide, generic = cases.indexes(comp, blocks)
    if call == "plan_groups":
        return ip.plan_groups(comp, generic, device)
    if call == "wide_plan":
        return wd.WidePlan.build(comp, wide, device)
    index = wide if call.endswith("wide") else generic
    if call.startswith("inflate_to_device"):
        return zlibes_tpu_torch.inflate_to_device(comp, index, device=device)
    return zlibes_tpu_torch.inflate_range(comp, index, 0, 10, device=device)


@pytest.mark.parametrize("name", ALL)
def test_plain_route_equals_the_host_path(name):
    comp, blocks = cases.stream(name)
    tk.LAUNCHES.clear()
    lt, dt, status = dtab.decode_tables(*cases.inputs(comp, blocks))
    assert not tk.LAUNCHES
    want = cases.expected(comp, blocks)
    for got, w in zip((lt, dt, status), want):
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), w)
    if name in cases.ERRORS:
        cls, msg = cases.ERRORS[name][1]
        assert status.tolist() == [dtab.STATUS.index((cls, msg)) + 1]
    else:
        assert not status.any()


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("name", sorted(cases.ERRORS))
def test_bad_header_raises_through_every_plan(name, call):
    comp, blocks = cases.stream(name)
    cls, msg = cases.ERRORS[name][1]
    with pytest.raises(cls) as e:
        _call(call, comp, blocks, "cpu")
    assert type(e.value) is cls and str(e.value) == msg


def test_raise_status_keeps_the_host_order():
    """A wide plan raises its first bad block's error; a group plan parses
    all of a group's headers before it builds a row, so a group's parse
    error comes before its table error, and the first bad group's
    before any later group's."""
    st = np.array([0, 8, 3, 0, 1], np.int32)
    with pytest.raises(CorruptError, match="sub-table overflow"):
        dtab.raise_status(st)
    with pytest.raises(CorruptError, match="^invalid Huffman code$"):
        dtab.raise_status(st, np.array([0, 1, 3, 5]))
    with pytest.raises(CorruptError, match="sub-table overflow"):
        dtab.raise_status(st, np.array([0, 2, 5]))
    with pytest.raises(TruncatedError, match="^bit stream overrun$"):
        dtab.raise_status(np.array([0, 0, 0, 1]), np.array([0, 2, 4]))
    dtab.raise_status(np.zeros(3, np.int32), np.array([0, 3]))


def test_fixed_blocks_share_one_build(monkeypatch):
    comp, blocks = cases.stream("zlib_fixed")
    blocks = blocks * 3
    built = []
    real = dtab.wk.wide_decode_tables

    def spy(ll, dl):
        built.append(1)
        return real(ll, dl)

    monkeypatch.setattr(dtab.wk, "wide_decode_tables", spy)
    lt, _, status = dtab.decode_tables(*cases.inputs(comp, blocks))
    assert len(built) == 1 and not status.any()
    assert (lt == lt[0]).all()


def test_wrapper_checks_its_arguments():
    words, hdr, nbits = cases.inputs(*cases.stream("zlib_level6"))
    with pytest.raises(ValueError, match="dtype"):
        dtab.decode_tables(words, hdr.int(), nbits)
    with pytest.raises(ValueError, match="shape"):
        dtab.decode_tables(words, hdr[:, :2].contiguous(), nbits)
    with pytest.raises(ValueError, match="do not fit"):
        dtab.decode_tables(words, hdr, 32 * words.shape[0] + 1)


# ---------------------------------------------------------------------------
# the kernel

@on_card
@pytest.mark.parametrize("name", ALL)
def test_kernel_rows_equal_the_plain_route(name):
    comp, blocks = cases.stream(name)
    tk.LAUNCHES.clear()
    got = dtab.decode_tables(*cases.inputs(comp, blocks, "cuda"))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["decode_tables"] == 1
    want = dtab.decode_tables(*cases.inputs(comp, blocks))
    for g, w, what in zip(got, want, ("lt", "dt", "status")):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w), what


@on_card
@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("name", sorted(cases.ERRORS))
def test_bad_header_raises_on_the_card(name, call, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(dtab, "decode_tables_plain", plain)
    comp, blocks = cases.stream(name)
    cls, msg = cases.ERRORS[name][1]
    with pytest.raises(cls) as e:
        _call(call, comp, blocks, "cuda")
    assert type(e.value) is cls and str(e.value) == msg


@on_card
@pytest.mark.parametrize("kind", ["wide", "stock_zlib"])
def test_device_headers_count_every_coded_block(kind, monkeypatch):
    """``inflate_to_device`` of the port's level-6 fixture (a wide plan)
    and of a stock-zlib stream (a chained group plan of several groups):
    one ``decode_tables`` launch a call, no plain version, every coded
    block counted, zlib's bytes on the card."""
    import zlib

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(dtab, "decode_tables_plain", plain)
    if kind == "wide":
        comp, _ = cases.stream("port_level6")
        index = zlibes_tpu_torch.StreamIndex.load(
            cases.GOLDEN / "wide_bench.idx.npz")
    else:
        monkeypatch.setattr(ip, "_LANES", 64)
        comp = zlib.compress(cases.RAW * 3, 6)
        index = zlibes_tpu_torch.build_index(comp)
    coded = sum(1 for b in index.blocks if b.out_len
                and b.btype != 0)
    stats = CodecStats()
    tk.LAUNCHES.clear()
    (out, _, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                      device="cuda",
                                                      stats=stats)
    assert out.cpu().numpy().tobytes() == zlib.decompress(comp)
    assert tk.LAUNCHES["decode_tables"] == 1
    assert stats.device_headers == coded > 1
    if kind == "stock_zlib":
        assert stats.dispatches > 1
