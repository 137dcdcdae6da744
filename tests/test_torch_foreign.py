"""``inflate_to_device`` of stock-zlib streams: the chained index that
``build_index`` makes of a stream whose copies cross every block boundary,
decoded on the CPU through the group path (plain versions of
``decode_tokens`` and ``resolve_global``), its groups in stream order, each
behind the output before it.

Each stream's bytes are held against CPython's ``zlib.decompress`` and
against the benchmark's plain DEFLATE reader (``benchmark/reference/
inflater.py``), which shares no code with the port.  The streams: zlib's
memLevel 4 (blocks of 4,096 symbols), the same ending in a short fixed
block after three dynamic ones (a fixed block's tables were once those of
block 1: the plan keyed both alike), sync flushes (empty stored blocks and
a stored block of random bytes between chained ones), and zlib's default
settings (level 6, windowBits 15, memLevel 8) cut into three or more
groups.  Imports the port alone.
"""
import importlib.util
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlibes_tpu_torch
from zlibes_tpu_torch import CodecStats, CorruptError, HeaderError
from zlibes_tpu_torch.codec import inflate_pipeline as ip
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.spec import constants as C
from test_torch_contract_cases import zlib_flushed

_INFLATER = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
             / "inflater.py")
_spec = importlib.util.spec_from_file_location("bench_inflater", _INFLATER)
inf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(inf)

torch.set_num_threads(2)

RAW = (Path(__file__).resolve().parent / "golden" / "raw.bin").read_bytes()


def _mixed() -> bytes:
    """Text, 40,000 random bytes, text: at 16 KiB sync flushes zlib stores
    the random middle (output 49,152-65,536) between chained blocks."""
    rnd = np.random.default_rng(0).integers(0, 256, 40000, np.uint8)
    return RAW[:40000] + rnd.tobytes() + RAW[40000:80000]


def _stock(data: bytes, mem_level: int) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, 15, mem_level)
    return c.compress(data) + c.flush()


# name -> (data, stream, anchor_every, lanes a group or None)
STREAMS = {
    "chained": lambda: (RAW[:90000], _stock(RAW[:90000], 4), 4096, None),
    # blocks dynamic, dynamic, dynamic, fixed (the last 20 bytes)
    "fixed_tail": lambda: (RAW[:23183], _stock(RAW[:23183], 4), 1024, None),
    "sync_chained": lambda: (_mixed(), zlib_flushed(
        _mixed(), 16384, mode=zlib.Z_SYNC_FLUSH), 4096, None),
    # zlib's defaults: three blocks of 116, 75 and 9 KB; one a group
    "default_3_groups": lambda: (RAW[:200000], _stock(RAW[:200000], 8),
                                 1024, 64),
}


@pytest.fixture(scope="module")
def streams():
    out = {}
    for name, make in STREAMS.items():
        data, comp, every, lanes = make()
        out[name] = (data, comp,
                     zlibes_tpu_torch.build_index(comp, anchor_every=every),
                     lanes)
    return out


def plain_inflate(comp: bytes) -> bytes:
    """The zlib stream's payload by the benchmark's plain reader."""
    bits = inf.Bits(comp)
    out = bytearray()
    pos = 16
    while True:
        bfinal, btype, ll, dl, pos = inf.read_header(bits, pos)
        if btype == 0:
            at = pos // 8
            n = comp[at] | comp[at + 1] << 8
            out += comp[at + 4 : at + 4 + n]
            pos = 8 * (at + 4 + n)
        else:
            ltab, dtab = inf.table(ll), inf.table(dl)
            while True:
                s, n, dist, pos = inf.read_token(bits, pos, ltab, dtab)
                if s == inf.EOB:
                    break
                if n == 0:
                    out.append(s)
                else:
                    for _ in range(n):
                        out.append(out[-dist])
        if bfinal:
            return bytes(out)


def _decode(comp, index, stats=None):
    tk.LAUNCHES.clear()
    spans = zlibes_tpu_torch.inflate_to_device(comp, index, device="cpu",
                                               stats=stats)
    assert not tk.LAUNCHES
    return spans


@pytest.fixture(scope="module")
def decoded(streams):
    """Each stream's ``inflate_to_device`` on the CPU, once: (spans, the
    CodecStats it filled, its groups)."""
    out = {}
    for name, (data, comp, index, lanes) in streams.items():
        with pytest.MonkeyPatch.context() as mp:
            if lanes is not None:
                mp.setattr(ip, "_LANES", lanes)
            groups = len(ip.plan_groups(comp, index, "cpu"))
            stats = CodecStats()
            out[name] = (_decode(comp, index, stats), stats, groups)
    return out


@pytest.mark.parametrize("name", list(STREAMS))
def test_chained_index_decodes_to_the_stream(streams, decoded, name):
    data, comp, index, lanes = streams[name]
    assert not index.self_contained and not index.wide and not index.turbo
    if name == "fixed_tail":
        assert [b.btype for b in index.blocks] == [C.BTYPE_DYNAMIC] * 3 + [
            C.BTYPE_FIXED]
    ((out, off, n),), _, groups = decoded[name]
    assert groups >= (3 if lanes else 1)
    assert (out.device.type, out.dtype, off, n) == ("cpu", torch.uint8, 0,
                                                    len(data))
    got = out.numpy().tobytes()
    assert got == zlib.decompress(comp) == plain_inflate(comp) == data


def test_a_stored_block_between_two_groups(streams, decoded):
    """The sync-flushed stream's stored block of random bytes lies between
    two groups: it is spliced before the groups, and the group after it
    copies from it through its prefix."""
    data, comp, index, _ = streams["sync_chained"]
    plans = ip.plan_groups(comp, index, "cpu")
    (stored,) = [b for b in index.blocks
                 if b.btype == C.BTYPE_STORED and b.out_len]
    assert (stored.out_start, stored.out_len) == (49152, 16384)
    ends = [(p.d_base, p.d_base + p.d_total) for p in plans]
    k = next(i for i, (_, e) in enumerate(ends) if e > stored.out_start)
    assert ends[k - 1][1] <= stored.out_start
    assert ends[k][0] >= stored.out_start + stored.out_len
    assert len(plans) > k + 1
    ((out, _, _),), _, _ = decoded["sync_chained"]
    lo, hi = stored.out_start, stored.out_start + stored.out_len
    assert out[lo:hi].numpy().tobytes() == data[lo:hi]
    assert out.numpy().tobytes() == data


@pytest.mark.parametrize("name", list(STREAMS))
def test_the_counters_say_the_chain_engaged(streams, decoded, name):
    data, comp, index, _ = streams[name]
    _, stats, groups = decoded[name]
    assert (stats.bytes_in, stats.bytes_out, stats.blocks) == (
        len(comp), len(data), len(index.blocks))
    assert stats.dispatches == groups
    assert stats.chained_groups == groups - 1


def test_self_contained_indexes_chain_no_group(monkeypatch):
    """A stream with a full flush every 16 KiB: its groups do not chain,
    though there are several."""
    data = RAW[:60000]
    comp = zlib_flushed(data, 16384)
    index = zlibes_tpu_torch.build_index(comp, anchor_every=2048)
    assert index.self_contained
    monkeypatch.setattr(ip, "_LANES", 8)
    stats = CodecStats()
    (out, _, _), = _decode(comp, index, stats)
    assert out.numpy().tobytes() == data
    assert stats.dispatches > 1 and stats.chained_groups == 0


def test_a_preset_dictionary_is_still_refused():
    """An FDICT stream's own (chained) index: ``inflate_to_device`` raises
    HeaderError and names ``inflate(..., dictionary=)``."""
    zdict = RAW[-20000:]
    comp = zlib_flushed(RAW[:30000], 16384, zdict=zdict)
    from zlibes_tpu_torch.runtime import native

    _, _, index, _, _ = native.scan(comp, bit_offset=48, anchor_every=2048,
                                    dict_len=len(zdict))
    assert not index.self_contained
    with pytest.raises(HeaderError, match="inflate\\(..., dictionary="):
        zlibes_tpu_torch.inflate_to_device(comp, index, device="cpu")


def test_inflate_range_still_refuses_a_chained_index(streams):
    data, comp, index, _ = streams["chained"]
    with pytest.raises(CorruptError, match="self-contained blocks"):
        zlibes_tpu_torch.inflate_range(comp, index, 100, 10, device="cpu")
    # inflate() keeps its host decode, the index checked against the bytes
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
