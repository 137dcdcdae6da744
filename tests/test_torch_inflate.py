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

import zlibes_tpu
from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.codec import inflate_pipeline as jip
from zlibes_tpu.config import CodecConfig
from zlibes_tpu.ops.adler32 import adler32_device as jax_adler32
from zlibes_tpu.runtime import native as jnative
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


def _generic(index):
    """``index`` (of either package) without its turbo or wide flag: a
    generic index of the same class."""
    return type(index)(index.blocks, index.anchor_bit, index.anchor_out,
                       index.anchor_block)


@pytest.fixture(scope="module")
def wide_stream():
    data = _data(20000)
    comp, index = dp.deflate(data, with_index=True, block_size=BS)
    return data, comp, index


def test_non_turbo_indexes_not_ported(wide_stream, monkeypatch):
    """A generic index (neither turbo nor wide anchors) of the reference's
    wide stream: the seek and the device-resident output go through the
    group decode, and so does, without the native runtime, its whole-stream
    decode; only ``build_index`` still needs that runtime."""
    data, comp, index = wide_stream
    generic = _generic(index_from_reference(index))
    assert zlibes_tpu_torch.inflate_range(comp, generic, 0, 10,
                                          device="cpu") == data[:10]
    (out, off, n), = zlibes_tpu_torch.inflate_to_device(comp, generic,
                                                        device="cpu")
    assert (off, n) == (0, len(data)) and out.numpy().tobytes() == data
    monkeypatch.setattr(native, "available", lambda: False)
    assert zlibes_tpu_torch.inflate(comp, index=generic, device="cpu") == data
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        zlibes_tpu_torch.build_index(comp)


def _fdict_stream(data: bytes, zd: bytes) -> bytes:
    co = zlib.compressobj(6, zdict=zd)
    return co.compress(data) + co.flush()


def _indexed_cases():
    """name -> (data, stream, reference index, dictionary) of the indexed
    streams that decode on the host: the card's paths take none of them."""
    data = _data(20000)
    comp, wide = dp.deflate(data, with_index=True, block_size=BS)
    generic = _generic(wide)
    raw = (GOLDEN / "raw.bin").read_bytes()       # several chained blocks
    foreign = zlib.compress(raw, 6)
    zd = b"brown fox lazy dog"
    fcomp = _fdict_stream(data, zd)
    # an FDICT stream's deflate body starts at byte 6, not 2: its index
    # comes from a scan at that offset
    _, _, fgeneric, _, _ = jnative.scan(fcomp, bit_offset=48,
                                        dict_len=len(zd))
    fwide = type(fgeneric)(fgeneric.blocks, fgeneric.anchor_bit,
                           fgeneric.anchor_out, fgeneric.anchor_block,
                           fgeneric.self_contained, wide=True)
    return {
        "generic": (data, comp, generic, None),
        "foreign_chained": (raw, foreign,
                            zlibes_tpu.build_index(foreign), None),
        "fdict_generic": (data, fcomp, fgeneric, zd),
        "fdict_wide": (data, fcomp, fwide, zd),
    }


@pytest.fixture(scope="module")
def indexed_cases():
    return _indexed_cases()


@pytest.mark.parametrize("case", ["generic", "foreign_chained",
                                  "fdict_generic", "fdict_wide"])
def test_other_indexes_decode_through_native(indexed_cases, case):
    """A generic index, a chained index of a CPython stream and both index
    kinds on an FDICT stream decode to the data, as in the JAX package on
    the same inputs."""
    data, comp, ref_index, zd = indexed_cases[case]
    index = index_from_reference(ref_index)
    if case == "foreign_chained":
        assert not index.self_contained and len(index.blocks) > 1
    if case == "fdict_wide":
        assert index.wide
    want = zlibes_tpu.inflate(comp, index=ref_index, dictionary=zd)
    tk.LAUNCHES.clear()
    got = zlibes_tpu_torch.inflate(comp, index=index, dictionary=zd,
                                   device="cpu")
    assert got == want == data
    assert sum(tk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("case", ["generic", "foreign_chained",
                                  "fdict_generic"])
def test_mismatched_index_raises_corrupt_error(indexed_cases, case):
    """An index of another stream: the host decode succeeds, the index does
    not describe it, and the port's own CorruptError says so (the JAX
    package raises its own on the same inputs)."""
    data, comp, ref_index, zd = indexed_cases[case]
    other = zlib.compress(data[:-100] + b"x" * 50, 6) if zd is None \
        else _fdict_stream(data[:-100], zd)
    with pytest.raises(JE.CorruptError, match="index does not match"):
        zlibes_tpu.inflate(other, index=ref_index, dictionary=zd)
    with pytest.raises(E.CorruptError, match="index does not match"):
        zlibes_tpu_torch.inflate(other, index=index_from_reference(ref_index),
                                 dictionary=zd, device="cpu")


def test_turbo_index_on_fdict_stream_is_a_header_error(turbo_stream):
    data, comp, index = turbo_stream
    zd = b"brown fox lazy dog"
    with pytest.raises(E.HeaderError, match="never carry FDICT"):
        zlibes_tpu_torch.inflate(_fdict_stream(data, zd), index=index,
                                 dictionary=zd, device="cpu")


def test_build_index_equals_reference():
    """``build_index`` at its default gives the reference's index, field by
    field; ``anchor_every`` is passed on to the scan (the reference accepts
    it and drops it)."""
    data = _data(60000, seed=2)
    comp = zlib.compress(data, 6)
    want = zlibes_tpu.build_index(comp)
    got = zlibes_tpu_torch.build_index(comp)
    assert isinstance(got, StreamIndex)
    assert got.blocks == index_from_reference(want).blocks
    for f in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.self_contained, got.turbo, got.wide, got.total_out) == \
        (want.self_contained, False, False, len(data))
    assert zlibes_tpu_torch.inflate(comp, index=got, device="cpu") == data
    dense = zlibes_tpu_torch.build_index(bytearray(comp), anchor_every=1024)
    assert dense.anchor_bit.size > 2 * got.anchor_bit.size
    assert dense.blocks == got.blocks
    assert zlibes_tpu_torch.inflate(comp, index=dense, device="cpu") == data


def test_build_index_and_constants_are_exported():
    from zlibes_tpu_torch.codec import api
    from zlibes_tpu_torch.spec import constants

    assert zlibes_tpu_torch.build_index is api.build_index
    assert zlibes_tpu_torch.constants is constants
    assert {"build_index", "constants"} <= set(zlibes_tpu_torch.__all__)


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
    """Without the native runtime a stream without an index decodes on the
    device path (the scan); what it refuses, it refuses with the port's
    errors."""
    monkeypatch.setattr(native, "available", lambda: False)
    comp = zlib.compress(b"abc" * 100)
    assert zlibes_tpu_torch.inflate(comp, device="cpu") == b"abc" * 100
    with pytest.raises(E.ChecksumError):
        zlibes_tpu_torch.inflate(comp[:-1] + bytes([comp[-1] ^ 1]),
                                 device="cpu")
    # a body cut short fails at its last token, as in the reference's
    # device scan
    with pytest.raises(E.CorruptError):
        zlibes_tpu_torch.inflate(comp[:-6], device="cpu")


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
