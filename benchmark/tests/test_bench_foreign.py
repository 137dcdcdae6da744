"""The ``foreign`` configuration and the two whole-stream decode cells,
``foreign.decompress`` (stock-zlib streams and their chained
``build_index``) and ``zlib6.decompress`` (the port's level-6 streams and
their wide index): the ``cpython_zlib`` encoder entry, the contract bytes
of ``decode_tokens`` and ``resolve_global`` counted by hand, the
``generic_roofline.inflate`` reader without a device trace, and tiny runs
of both cells on the CPU, sound and under their control."""
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import zlibes_tpu_torch as zt
from harness import spec
from harness.codec import index_arrays
from reference import inflater as inf
from roofline import decode_tokens, resolve_global

from benchlib import BENCH, ROOT, run_cpu, tiny_copy

torch.set_num_threads(2)

CELLS = ["foreign.decompress", "zlib6.decompress"]
RAW = (ROOT / "benchmark" / "data" / "raw.bin").read_bytes()


def _encoder():
    cfg = spec.load_cell(ROOT / "BENCHMARK.json", "foreign.decompress").config
    return cfg["encoder"], spec.plugin(BENCH, "apis", "cpython_zlib").make(
        cfg["encoder"], torch.device("cpu"), None)


def test_cpython_zlib_writes_stock_streams_with_a_chained_index():
    settings, encode = _encoder()
    assert (settings["level"], settings["window_bits"],
            settings["mem_level"]) == (6, 15, 8)
    data = RAW[:300000]
    stream, index = encode(data)
    # zlib's own stream, unchanged, and one zlib member that inflates
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8)
    assert stream == c.compress(data) + c.flush()
    assert stream[:2] == b"\x78\x9c" and zlib.decompress(stream) == data
    assert isinstance(index, zt.StreamIndex)
    assert not index.self_contained and not index.wide and not index.turbo
    assert len(index.blocks) > 1 and index.total_out == len(data)
    # one access point about every anchor_every output bytes
    gaps = np.diff(np.asarray(index.anchor_out))
    assert gaps.max() < settings["anchor_every"] + 259


def test_the_roofline_bytes_of_a_hand_counted_stream():
    """"hello hello hello!" at level 6: one fixed block of the seven
    literals "hello h", a copy of 10 at distance 6 and the literal "!": 9
    tokens, one lane, one coded block."""
    data = b"hello hello hello!"
    comp = zlib.compress(data, 6)
    ix = index_arrays(zt.build_index(comp))
    bits, pos = inf.Bits(comp), 16
    _, btype, ll, dl, pos = inf.read_header(bits, pos)
    walked = []
    while True:
        s, n, d, pos = inf.read_token(bits, pos, inf.table(ll), inf.table(dl))
        if s == inf.EOB:
            break
        walked.append((s, n, d))
    assert btype == 1 and walked == [(c, 0, 0) for c in b"hello h"] + [
        (264, 10, 6), (ord("!"), 0, 0)]
    assert decode_tokens.lanes_blocks_tokens(comp, ix) == (1, 1, 9)
    assert decode_tokens.contract_bytes(len(comp), 1, 1, 9) == (
        4 * -(-len(comp) // 4) + (8 + 8 + 4) + 4 * (1024 + 768) + 8 * 9)
    assert resolve_global.contract_bytes(9, len(data)) == 8 * 9 + 18


def test_the_token_count_walks_each_block_under_its_own_tables():
    """A chained stream of several dynamic blocks: the lock-step count over
    every lane equals the plain reader's count block by block."""
    _, encode = _encoder()
    data = RAW[:400000]
    comp, index = encode(data)
    ix = index_arrays(index)
    end = decode_tokens.lane_ends(ix)
    bits, want = inf.Bits(comp), 0
    blocks = np.unique(ix["block"])
    assert blocks.size > 3
    for b in blocks:
        sel = ix["block"] == b
        _, _, ll, dl, _ = inf.read_header(bits, int(ix["blocks"][b, 2]))
        want += inf.count_tokens(comp, ix["bit"][sel], end[sel], ll, dl)
    assert decode_tokens.lanes_blocks_tokens(comp, ix) == (
        ix["bit"].size, blocks.size, want)


def test_generic_roofline_reads_nothing_without_a_device_trace():
    read = spec.reader(BENCH, "generic_roofline.inflate")
    op = SimpleNamespace(calls=[(0, 0.0, 1.0, 1 << 20)])
    for trace in (None, SimpleNamespace(ops=[]),
                  SimpleNamespace(ops=[1], time_s=lambda pattern: 0.0)):
        assert read(SimpleNamespace(op=op, trace=trace)) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_run_is_correct(tiny, cell):
    res = run_cpu(tiny, cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for name in ("plan_ms.inflate", "upload_ms.inflate"):
        assert res["metrics"][name]["value"] > 0, name
    # the CPU holds no device record: no device metric is written
    assert "generic_roofline.inflate" not in res["metrics"]
    assert "idle_share.inflate" not in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_row_pad_control_is_caught(tiny, cell):
    res = run_cpu(tiny, cell, control=True)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_outputs"]["value"] > 0
