"""The port's host framing (``zlibes_tpu_torch/codec/framing.py``) through
the public encoders, held byte for byte and field for field against the
JAX package's encoders, on inputs of several dispatches with a short last
block: one case for each kind of anchors the framing builds and one for a
batch member.  And its row stager against a loop over the blocks.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as jdp
from zlibes_tpu.config import CodecConfig as JaxCodecConfig

from zlibes_tpu_torch import config_from_reference
from zlibes_tpu_torch import parallel as P
from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.codec.framing import stage_rows

from test_torch_deflate import _same_index

torch.set_num_threads(2)

RAW = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()
NOISE = np.random.default_rng(21).integers(0, 256, 16384,
                                           np.uint8).tobytes()


def _single_card(jcfg, data: bytes, block_size: int):
    """The single-card encoder and the reference's under one config."""
    jcfg = dataclasses.replace(jcfg, blocks_per_dispatch=2)
    got = tdp.deflate(data, with_index=True, config=config_from_reference(
        jcfg), block_size=block_size, device="cpu")
    return got, jdp.deflate(data, with_index=True, config=jcfg,
                            block_size=block_size)


def _turbo_pairs():
    """Turbo pairs: five blocks in dispatches of two, the last dispatch
    one short block."""
    return _single_card(JaxCodecConfig.turbo(), RAW[: 4 * 16384 + 5000],
                        16384)


def _segment_starts():
    """Segment starts: ``parallel_deflate(with_index=True)`` at world 1,
    dynamic tables without turbo, 20 blocks in dispatches of 16."""
    from zlibes_tpu.parallel import make_mesh, parallel_deflate

    data, kw = RAW[:39000], dict(block_size=2048, seg_size=256,
                                 with_index=True)
    return (P.parallel_deflate(data, P.make_mesh(1, device="cpu"), **kw),
            parallel_deflate(data, make_mesh(1), **kw))


def _sub_anchors():
    """The wide index's 128-byte anchors on the general path, a stored
    (level-0) block of noise between coded ones, the last block short."""
    data = RAW[:2 * 16384] + NOISE + RAW[2 * 16384 : 3 * 16384 + 7000]
    return _single_card(JaxCodecConfig.from_level(6), data, 16384)


def _batch_members():
    """Batch members: 70 payloads, two dispatches of 64 rows and 6."""
    from zlibes_tpu.parallel import make_mesh
    from zlibes_tpu.parallel.batch import compress_batch

    dictionary = RAW[-8000:]
    payloads = [RAW[97 * i : 97 * i + 40 + 13 * i] for i in range(70)]
    return (P.compress_batch(payloads, dictionary, device="cpu"),
            compress_batch(payloads, dictionary, mesh=make_mesh(1)))


@pytest.mark.parametrize("case", [_turbo_pairs, _segment_starts,
                                  _sub_anchors, _batch_members],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_framing_equals_reference(case):
    got, want = case()
    if isinstance(got, list):
        assert got == want
        return
    assert got[0] == want[0]
    assert _same_index(got[1], want[1])
    assert len(got[1].blocks) > 4


def _rows_loop(data: bytes, lo: int, hi: int, N: int, B: int, prefix: int):
    rows = np.zeros((B, prefix + N + 8), np.uint8)
    n_valid = np.zeros(B, np.int32)
    for r, i in enumerate(range(lo, hi)):
        chunk = np.frombuffer(data[i * N : (i + 1) * N], np.uint8)
        rows[r, prefix : prefix + chunk.size] = chunk
        n_valid[r] = chunk.size
    return rows, n_valid


@pytest.mark.parametrize("src, prefix", [("array", 0), ("provider", 0),
                                         ("array", 64)],
                         ids=["array", "provider", "dictionary_prefix"])
def test_stage_rows_equals_a_loop(src, prefix):
    """Blocks 1-5 of a 4.3-block input in rows of 7: two whole blocks, a
    short one, an empty one past the end and padding rows."""
    N = 1024
    data = RAW[: 4 * N + 300]
    arr = np.frombuffer(data, np.uint8)
    feed = arr if src == "array" else lambda i: data[i * N : (i + 1) * N]
    rows, n_valid = stage_rows(feed, 1, 6, N, 7, prefix)
    want_rows, want_nv = _rows_loop(data, 1, 6, N, 7, prefix)
    assert np.array_equal(rows, want_rows)
    assert np.array_equal(n_valid, want_nv)
    assert list(n_valid[:5]) == [N, N, N, 300, 0]
