"""The reference that decides ``correct`` rejects what it must: a flipped
byte, a cut stream, a wrong Adler-32, a wrong anchor in an index, a wrong
range, and each cell's control; and accepts the port's own streams."""
import zlib

import numpy as np
import pytest
import torch

from harness import corpus
from harness.codec import index_arrays
from reference import controls, judge

from benchlib import SEED

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    return corpus.make_file(corpus.raw_corpus(), 300_000, SEED, 0)


@pytest.fixture(scope="module")
def port_stream(data):
    import dataclasses

    import zlibes_tpu_torch as zt
    from zlibes_tpu_torch.codec import deflate_pipeline

    cfg = dataclasses.replace(zt.CodecConfig(), blocks_per_dispatch=2)
    comp, index = deflate_pipeline.deflate(data, with_index=True, config=cfg,
                                           device="cpu")
    return comp, index_arrays(index)


def test_the_ports_stream_and_index_pass(data, port_stream):
    comp, ix = port_stream
    assert ix["wide"]
    assert judge.stream_faults(comp, data) == 0
    assert judge.block_faults(comp, data, ix) == 0
    assert judge.anchor_faults(comp, data, ix, corpus.rng(SEED, 4),
                               samples=400) == 0


def test_a_flipped_byte_a_cut_stream_and_a_wrong_adler(data, port_stream):
    comp, ix = port_stream
    flipped = bytearray(comp)
    flipped[len(comp) // 2] ^= 0x10
    assert judge.stream_faults(bytes(flipped), data) == 1
    assert judge.block_faults(bytes(flipped), data, ix) >= 1
    assert judge.stream_faults(comp[:len(comp) // 2], data) == 1
    adler = comp[:-4] + ((int.from_bytes(comp[-4:], "big") + 1)
                         % 2**32).to_bytes(4, "big")
    assert judge.stream_faults(adler, data) == 1
    assert judge.stream_faults(comp + b"\x00", data) == 1
    assert judge.stream_faults(b"\x78\x01" + comp[2:], data) == 1


@pytest.mark.parametrize("shift", [1, 3, 8])
def test_a_wrong_anchor(data, port_stream, shift):
    comp, ix = port_stream
    k = int(np.flatnonzero(ix["block"] == ix["block"][0])[5])
    # one anchor's bit moved: the walk from it, or to it, breaks
    bad = dict(ix, bit=ix["bit"].copy())
    bad["bit"][k] += shift
    assert judge.anchor_faults(comp, data, bad, corpus.rng(SEED, 4),
                               samples=10**9) >= 1
    # a wrong output offset breaks the grid or the walk
    bad = dict(ix, out=ix["out"].copy())
    bad["out"][k] -= 200
    assert judge.anchor_faults(comp, data, bad, corpus.rng(SEED, 4)) >= 1
    # an anchor left out breaks the count of its block
    keep = np.ones(ix["bit"].size, bool)
    keep[k] = False
    bad = {**ix, "bit": ix["bit"][keep], "out": ix["out"][keep],
           "block": ix["block"][keep]}
    assert judge.anchor_faults(comp, data, bad, corpus.rng(SEED, 4)) >= 1


def test_a_sampled_anchor_walk_catches_a_moved_anchor(data, port_stream):
    comp, ix = port_stream
    bad = dict(ix, bit=ix["bit"].copy())
    bad["bit"][-1] += 2      # the sample always holds the last anchor
    assert judge.anchor_faults(comp, data, bad, corpus.rng(SEED, 4),
                               samples=0) >= 1


def test_a_wrong_block_entry(data, port_stream):
    comp, ix = port_stream
    bad = dict(ix, blocks=ix["blocks"].copy())
    bad["blocks"][0, 5] += 1
    assert judge.block_faults(comp, data, bad) >= 1


def test_a_wrong_range(data):
    assert judge.range_faults(data[100:900], data, 100, 800) == 0
    assert judge.range_faults(data[101:901], data, 100, 800) == 1
    assert judge.range_faults(data[100:899], data, 100, 800) == 1


def test_the_controls_fail(data):
    comp, ix = controls.wide_index(data)
    assert judge.stream_faults(comp, data) == 0
    assert judge.block_faults(comp, data, ix) == 0
    assert judge.anchor_faults(comp, data, ix, corpus.rng(SEED, 4)) > 0
    assert judge.stream_faults(controls.adler_share(data, 4, 16384),
                               data) == 1
    assert controls.row_pad(zlib.compress(data)) != data
    assert judge.range_faults(controls.grain(data, 100, 800), data,
                              100, 800) == 1


def test_an_empty_last_grain_is_no_fault():
    """A long match over a block's last 128 bytes leaves its grain with no
    token: its anchor is the block's end, and walking to it or from it is
    sound."""
    import dataclasses

    import zlibes_tpu_torch as zt
    from zlibes_tpu_torch.codec import deflate_pipeline

    raw = bytearray(corpus.make_file(corpus.raw_corpus(), 262_144, SEED, 1))
    raw[131_072 - 200:131_072 + 64] = bytes(264)
    data = bytes(raw)
    cfg = dataclasses.replace(zt.CodecConfig(), blocks_per_dispatch=2)
    comp, index = deflate_pipeline.deflate(data, with_index=True, config=cfg,
                                           device="cpu")
    ix = index_arrays(index)
    b0 = ix["blocks"][0]
    last = np.flatnonzero(ix["block"] == 0)[-1]
    assert (ix["bit"][last], ix["out"][last]) == (b0[4], b0[5] + b0[6])
    assert judge.anchor_faults(comp, data, ix, corpus.rng(SEED, 4),
                               samples=10**9) == 0
