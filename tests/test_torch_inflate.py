"""The PyTorch port's public inflate on the CPU: routing, typed errors,
Adler-32, corruption and the committed bench fixture.  The JAX package and
CPython zlib are the references; an index the JAX encoder made is carried
across with ``index_from_reference`` before the port sees it, and every
error expected from a port call is the port's own class."""
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.codec import inflate_pipeline as jip
from zlibes_tpu.config import CodecConfig
from zlibes_tpu.ops.adler32 import adler32_device as jax_adler32
from zlibes_tpu.spec import errors as JE

import zlibes_tpu_torch
from zlibes_tpu_torch import StreamIndex, index_from_reference
from zlibes_tpu_torch import errors as E
from zlibes_tpu_torch.bench_corpus import bench_data
from zlibes_tpu_torch.ops.adler32 import adler32_device
from zlibes_tpu_torch.ops import turbo_kernel as tk
from zlibes_tpu_torch.runtime import native

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
CFG = CodecConfig.turbo(candidates=4, probe_words=4)
BS = 16384


def _data(n=30000, seed=0):
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox jumps over the lazy dog. " * 300
    return (text[: n // 2] + rng.integers(0, 256, n // 4, np.uint8).tobytes()
            + b"ab" * (n // 8))


@pytest.fixture(scope="module")
def turbo_stream():
    data = _data()
    comp, index = dp.deflate(data, with_index=True, config=CFG, block_size=BS)
    return data, comp, index_from_reference(index)


@pytest.mark.parametrize("name", ["ZlibError", "HeaderError", "TruncatedError",
                                  "CorruptError", "ChecksumError"])
def test_port_raises_the_reference_error_types(name):
    """The port's error classes are its own, under the reference's names and
    with the reference's hierarchy."""
    own, ref = getattr(zlibes_tpu_torch, name), getattr(JE, name)
    assert own is getattr(E, name) and own is not ref
    assert own.__module__ == "zlibes_tpu_torch.spec.errors"
    assert [c.__name__ for c in own.__mro__] == [c.__name__
                                                 for c in ref.__mro__]


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 100003])
def test_adler32_matches_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    got = int(adler32_device(torch.from_numpy(data)))
    assert got == zlib.adler32(data.tobytes())
    assert got == int(jax_adler32(jnp.asarray(data), n))


def test_bench_fixture_decodes_to_corpus():
    comp = (GOLDEN / "turbo_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "turbo_bench.idx.npz")
    assert index.turbo
    assert zlibes_tpu_torch.inflate(comp, index=index,
                                    device="cpu") == bench_data()


def test_launch_count_stays_zero_on_cpu(turbo_stream):
    data, comp, index = turbo_stream
    tk.LAUNCHES.clear()
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
    assert sum(tk.LAUNCHES.values()) == 0


def _header_cases():
    body = zlib.compress(b"hello hello hello", 6)
    fdict = bytes([0x78, 0xBB]) + body[2:]  # FDICT set, FCHECK valid
    assert (0x78 * 256 + 0xBB) % 31 == 0
    return {
        "short": body[:4],
        "bad_cm": bytes([0x79]) + body[1:],
        "bad_cinfo": bytes([0x88, 0x1C]) + body[2:],
        "bad_fcheck": bytes([0x78, 0x9D]) + body[2:],
        "fdict_without_dictionary": fdict,
        "no_trailer": body[:-4],
    }


@pytest.mark.parametrize("case", sorted(_header_cases()))
def test_container_errors_typed_as_reference(case):
    bad = _header_cases()[case]
    with pytest.raises(JE.ZlibError) as want:
        jip.inflate(bad)
    with pytest.raises(E.ZlibError) as got:
        zlibes_tpu_torch.inflate(bad, device="cpu")
    assert type(got.value) is getattr(E, type(want.value).__name__)


def test_checksum_error(turbo_stream):
    data, comp, index = turbo_stream
    bad = comp[:-1] + bytes([comp[-1] ^ 1])
    with pytest.raises(E.ChecksumError):
        zlibes_tpu_torch.inflate(bad, index=index, device="cpu")
    out = zlibes_tpu_torch.inflate(bad, index=index, device="cpu",
                                   verify_checksum=False)
    assert out == data


def test_payload_corruption_detected(turbo_stream):
    """A flipped payload byte raises CorruptError or ChecksumError — and
    then CPython zlib rejects the stream too — or, landing in a bit gap
    the decode never reads, gives back the original bytes."""
    data, comp, index = turbo_stream
    rng = np.random.default_rng(3)
    raised = 0
    for _ in range(8):
        bad = bytearray(comp)
        pos = int(rng.integers(16, len(bad) - 8))
        bad[pos] ^= int(rng.integers(1, 256))
        bad = bytes(bad)
        try:
            zlib.decompress(bad)
            zlib_ok = True
        except zlib.error:
            zlib_ok = False
        try:
            out = zlibes_tpu_torch.inflate(bad, index=index, device="cpu")
        except (E.CorruptError, E.ChecksumError):
            raised += 1
            assert not zlib_ok
        else:
            assert out == data
    assert raised >= 6


def test_corrupt_lane_raises_corrupt_error(turbo_stream):
    """One flipped byte inside every decode lane makes lanes fail their
    meta checks (invalid codes or a missed anchor), before any Adler-32."""
    data, comp, index = turbo_stream
    rng = np.random.default_rng(5)
    bad = bytearray(comp)
    bits = index.anchor_bit
    for lo, hi in zip(bits[:-1] // 8 + 1, bits[1:] // 8):
        if hi > lo:
            bad[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
    bad = bytes(bad)
    raised = None
    try:
        zlibes_tpu_torch.inflate(bad, index=index, device="cpu")
    except E.CorruptError as exc:
        raised = exc
    assert isinstance(raised, E.CorruptError)
    with pytest.raises(zlib.error):
        zlib.decompress(bad)


def test_non_turbo_indexes_not_ported():
    """A generic index (neither turbo nor wide anchors), and any non-turbo
    index on an FDICT stream, still raise, naming the ROADMAP item that
    ports them."""
    data = _data(20000)
    comp, wide_index = dp.deflate(data, with_index=True, block_size=BS)
    wide_index = index_from_reference(wide_index)
    generic = StreamIndex(wide_index.blocks, wide_index.anchor_bit,
                          wide_index.anchor_out, wide_index.anchor_block)
    with pytest.raises(NotImplementedError, match="item 8"):
        zlibes_tpu_torch.inflate(comp, index=generic, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        zlibes_tpu_torch.inflate_range(comp, generic, 0, 10, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        zlibes_tpu_torch.inflate_to_device(comp, generic, device="cpu")
    zd = b"brown fox lazy dog"
    co = zlib.compressobj(6, zdict=zd)
    fcomp = co.compress(data) + co.flush()
    for index in (generic, wide_index):
        with pytest.raises(NotImplementedError, match="item 8"):
            zlibes_tpu_torch.inflate(fcomp, index=index, dictionary=zd,
                                     device="cpu")


def test_wide_index_decodes():
    data = _data(20000)
    comp, wide_index = dp.deflate(data, with_index=True, block_size=BS)
    wide_index = index_from_reference(wide_index)
    assert wide_index.wide and not wide_index.turbo
    assert zlibes_tpu_torch.inflate(comp, index=wide_index,
                                    device="cpu") == data


@pytest.mark.parametrize("start,length", [(0, 28500), (0, 1), (16380, 10),
                                          (20000, 8500), (28499, 1)])
def test_turbo_inflate_range(turbo_stream, start, length):
    data, comp, index = turbo_stream
    assert len(data) == 28500
    got = zlibes_tpu_torch.inflate_range(comp, index, start, length,
                                         device="cpu")
    assert got == data[start : start + length]


def test_turbo_inflate_to_device(turbo_stream):
    data, comp, index = turbo_stream
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, index,
                                                        device="cpu")
    assert (out.device.type, out.dtype, off, n) == ("cpu", torch.uint8, 0,
                                                    len(data))
    assert out[:n].numpy().tobytes() == data


def test_no_index_decodes_through_native():
    data = _data(50000, seed=4)
    assert zlibes_tpu_torch.inflate(zlib.compress(data, 6),
                                    device="cpu") == data
    co = zlib.compressobj(6, zdict=b"brown fox lazy dog")
    comp = co.compress(data) + co.flush()
    assert zlibes_tpu_torch.inflate(comp, dictionary=b"brown fox lazy dog",
                                    device="cpu") == data


def test_no_index_without_native_raises(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(NotImplementedError, match="item 8"):
        zlibes_tpu_torch.inflate(zlib.compress(b"abc" * 100), device="cpu")


def test_cuda_without_card_raises(turbo_stream, monkeypatch):
    data, comp, index = turbo_stream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        zlibes_tpu_torch.inflate(comp, index=index, device="cuda")


def test_unsupported_device_raises(turbo_stream):
    data, comp, index = turbo_stream
    with pytest.raises(ValueError):
        zlibes_tpu_torch.inflate(comp, index=index, device="meta")


def test_wrapper_rejects_bad_inputs():
    words = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        tk.lane_windows(words, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tk.lane_windows(torch.zeros(128, dtype=torch.int32)[::2],
                        torch.zeros(4, dtype=torch.int32))
