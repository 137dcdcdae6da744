"""Twins, for the PyTorch port, of the reference's single-device encode
tests: ``tests/test_deflate_tpu.py``, the encode tests of
``tests/test_config.py`` and the single-device tests of
``tests/test_dictionary.py``, plus ``backend=`` and ``deflate_indexed``.

Imports the port alone (no JAX, nothing of ``zlibes_tpu``) and runs its
plain versions on the CPU; the oracle is CPython's ``zlib``.  Where the
reference's test runs 16 blocks of 128 KiB a dispatch, the twin runs fewer
or smaller blocks: the bytes of a stream do not depend on how many blocks
share a dispatch.
"""
import dataclasses
import zlib as pyzlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlibes_tpu_torch
from zlibes_tpu_torch import CodecConfig, CodecStats, StreamIndex, errors
from zlibes_tpu_torch.codec import deflate_pipeline as dp
from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec import refmodel as rm

torch.set_num_threads(2)

RAW = (Path(__file__).parent / "golden" / "raw.bin").read_bytes()
DICT = b"the quick brown fox jumps over the lazy dog " * 40
DATA = b"a lazy dog jumps; the quick brown fox naps " * 30
BS = 16384      # where a test takes its own block size


def _small(level: int | None = None, **kw) -> CodecConfig:
    """A level's preset (the default config for None) at four blocks a
    dispatch."""
    cfg = CodecConfig() if level is None else CodecConfig.from_level(level)
    return dataclasses.replace(cfg, blocks_per_dispatch=4, **kw)


# ---------------------------------------------------------------------------
# tests/test_deflate_tpu.py

def test_package_merge_np_matches_refmodel():
    rng = np.random.default_rng(0)
    for _ in range(20):
        freqs = rng.integers(0, 1000, 288)
        freqs[rng.random(288) < 0.5] = 0
        a = bt.package_merge_np(freqs, 15)
        b = rm.package_merge_lengths(freqs, 15)
        assert (a[freqs == 0] == 0).all() and (a[freqs > 0] > 0).all()
        assert ((freqs > 0) * (1 << (15 - np.maximum(a, 1)))).sum() <= 1 << 15
        assert (freqs * a).sum() == (freqs * b).sum()


@pytest.mark.parametrize("payload", [
    b"",
    b"Q",
    b"This is zlib.es",
    b"0123456789" * 100,           # 258-match repeats
    b"a" * 100000,                 # long RLE, stored/dynamic choice
    RAW[:100000],
    RAW[:300000],                  # multi-block
], ids=["empty", "one_byte", "short", "repeats", "rle", "raw100k", "raw300k"])
def test_deflate_oracle_roundtrip(payload):
    # 128 KiB blocks where the payload has more than one, small ones else
    out = dp.deflate(payload, config=_small(), device="cpu",
                     block_size=None if len(payload) > 131072 else BS)
    assert out[:2] == bytes([0x78, 0x9C])
    assert pyzlib.decompress(out) == payload
    assert zlibes_tpu_torch.inflate(out, device="cpu") == payload


def test_deflate_incompressible_uses_stored():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes()
    out, index = dp.deflate(data, with_index=True, config=_small(),
                            device="cpu")
    assert pyzlib.decompress(out) == data
    # stored blocks keep the overhead tiny
    assert len(out) < len(data) * 1.001 + 64
    assert {b.btype for b in index.blocks} == {C.BTYPE_STORED}


def test_deflate_index_feeds_indexed_inflate():
    data = RAW[:300000]
    out, index = dp.deflate(data, with_index=True, config=_small(),
                            device="cpu")
    assert pyzlib.decompress(out) == data
    assert index.wide
    assert zlibes_tpu_torch.inflate(out, index=index, device="cpu") == data


def test_deflate_size_competitive():
    """The default config on raw.bin: at most the 191,734 bytes of the
    encoder the reference was measured against; exactly 191,419."""
    out = dp.deflate(RAW, config=_small(), device="cpu")
    assert pyzlib.decompress(out) == RAW
    assert len(out) == 191419 <= 191734


def test_turbo_size_bar():
    """The turbo profile trades ratio for kernel-decodable structure: its
    measured size on raw.bin (201,595 B) + 0.5%."""
    cfg = dataclasses.replace(CodecConfig.turbo(), blocks_per_dispatch=4)
    out = dp.deflate(RAW, config=cfg, device="cpu")
    assert pyzlib.decompress(out) == RAW
    assert len(out) <= int(201595 * 1.005)


# ---------------------------------------------------------------------------
# tests/test_config.py, the encode tests

def test_level_presets():
    data = RAW[:131072]
    sizes = {}
    for level in [0, 1, 6]:
        out = zlibes_tpu_torch.deflate(data, level=level, block_size=BS,
                                       device="cpu")
        assert pyzlib.decompress(out) == data
        sizes[level] = len(out)
    assert sizes[0] > len(data)  # stored
    assert sizes[6] < sizes[1] < sizes[0]


def test_stats_collection():
    data = RAW[:131072]
    st = CodecStats()
    zlibes_tpu_torch.deflate(data, stats=st, block_size=BS, device="cpu")
    assert st.bytes_in == len(data)
    assert st.bytes_out > 0 and st.bytes_out < len(data)
    assert st.blocks >= 1 and st.dispatches >= 1
    assert 0 < st.ratio < 1
    assert "match" in st.stage_s


def test_custom_config_seg_size():
    cfg = CodecConfig(seg_size=1024, blocks_per_dispatch=2)
    out, index = dp.deflate(RAW[:65536], with_index=True, config=cfg,
                            block_size=32768, device="cpu")
    assert pyzlib.decompress(out) == RAW[:65536]
    assert zlibes_tpu_torch.inflate(out, index=index,
                                    device="cpu") == RAW[:65536]


def test_stats_reuse_across_configs():
    """Reusing one CodecStats across calls must not carry the previous
    stream's fused Adler-32 into the next trailer."""
    st = CodecStats()
    a = RAW[:16384]
    b = bytes(reversed(RAW[:20480]))
    out_turbo = zlibes_tpu_torch.deflate(a, config=CodecConfig.turbo(),
                                         block_size=4096, stats=st,
                                         device="cpu")
    assert pyzlib.decompress(out_turbo) == a
    assert st.adler == pyzlib.adler32(a)
    out_plain = zlibes_tpu_torch.deflate(b, block_size=4096, stats=st,
                                         device="cpu")    # per-block tables
    assert pyzlib.decompress(out_plain) == b and st.adler is None
    out_stored = zlibes_tpu_torch.deflate(b, level=0, stats=st, device="cpu")
    assert pyzlib.decompress(out_stored) == b
    assert st.bytes_in == len(a) + 2 * len(b)


def test_shared_tables_block_size_validation():
    """The twin of tests/test_config.py's test, under the reference's own
    config, CodecConfig(seg_size=512, shared_tables=True)."""
    cfg = CodecConfig(seg_size=512, shared_tables=True)
    with pytest.raises(ValueError, match="multiple of 2048"):
        zlibes_tpu_torch.deflate(RAW[:4096], config=cfg, block_size=1536,
                                 device="cpu")


def test_index_sidecar_roundtrip(tmp_path):
    _, idx = zlibes_tpu_torch.deflate_indexed(RAW[:8192], block_size=4096,
                                              device="cpu")
    p = tmp_path / "s.npz"
    idx.save(p)
    idx2 = StreamIndex.load(p)
    assert np.array_equal(idx2.anchor_bit, idx.anchor_bit)
    assert idx2.wide and idx2.blocks == idx.blocks


def test_level_size_ordering():
    """Level-9 size <= level-6 size <= 191,734 on raw.bin; sizes do not
    depend on the hardware, so they are held exactly."""
    s6 = len(zlibes_tpu_torch.deflate(RAW, config=_small(6), device="cpu"))
    s9 = len(zlibes_tpu_torch.deflate(RAW, config=_small(9), device="cpu"))
    assert s9 <= s6 <= 191734, (s9, s6)
    assert (s6, s9) == (191419, 188386)


# ---------------------------------------------------------------------------
# tests/test_dictionary.py, the single-device tests

def test_deflate_with_dictionary_oracle():
    out = zlibes_tpu_torch.deflate(DATA, dictionary=DICT, block_size=BS,
                                   config=_small(), device="cpu")
    plain = zlibes_tpu_torch.deflate(DATA, block_size=BS, config=_small(),
                                     device="cpu")
    assert len(out) < len(plain)  # the dictionary must actually help
    d = pyzlib.decompressobj(zdict=DICT)
    assert d.decompress(out) == DATA


def test_inflate_with_dictionary_both_directions():
    ours = zlibes_tpu_torch.deflate(DATA, dictionary=DICT, block_size=BS,
                                    config=_small(), device="cpu")
    assert zlibes_tpu_torch.inflate(ours, dictionary=DICT,
                                    device="cpu") == DATA
    co = pyzlib.compressobj(6, pyzlib.DEFLATED, 15, 8, 0, DICT)
    foreign = co.compress(DATA) + co.flush()
    assert zlibes_tpu_torch.inflate(foreign, dictionary=DICT,
                                    device="cpu") == DATA


def test_dictionary_errors():
    out = zlibes_tpu_torch.deflate(DATA, dictionary=DICT, block_size=BS,
                                   config=_small(), device="cpu")
    with pytest.raises(errors.HeaderError):
        zlibes_tpu_torch.inflate(out, device="cpu")  # missing dictionary
    with pytest.raises(errors.HeaderError):
        zlibes_tpu_torch.inflate(out, dictionary=b"wrong dictionary",
                                 device="cpu")


def test_indexed_inflate_with_dictionary():
    """index= and dictionary= compose, for the encoder's own index (not a
    wide one: the first block copies from the dictionary) and for the host
    model's."""
    data = (DATA + bytes(np.random.default_rng(5).integers(
        0, 256, 3000, dtype=np.uint8))) * 4
    for comp, index in (
            dp.deflate(data, with_index=True, block_size=4096,
                       config=_small(), dictionary=DICT, device="cpu"),
            rm.deflate(data, block_size=4096, with_index=True,
                       anchor_every=1024, dictionary=DICT)):
        assert not index.wide and not index.turbo
        d = pyzlib.decompressobj(zdict=DICT)
        assert d.decompress(comp) == data
        assert zlibes_tpu_torch.inflate(comp, index=index, dictionary=DICT,
                                        device="cpu") == data
        with pytest.raises(errors.HeaderError):
            zlibes_tpu_torch.inflate(comp, index=index,
                                     dictionary=b"wrong dict", device="cpu")


def test_single_stream_dictionary_device_path():
    """deflate(dictionary=) runs the device pipeline (the first block's
    matcher sees the dictionary as a context prefix), not the host model;
    the dictionary must still help."""
    raw = RAW[:100000]
    dictionary = raw[:20000]
    data = raw[15000:80000]
    stats = CodecStats()
    out = zlibes_tpu_torch.deflate(data, dictionary=dictionary,
                                   config=_small(5), block_size=32768,
                                   stats=stats, device="cpu")
    assert stats.dispatches == 1 and "select" in stats.stage_s
    d = pyzlib.decompressobj(zdict=dictionary)
    assert d.decompress(out) == data
    assert zlibes_tpu_torch.inflate(out, dictionary=dictionary,
                                    device="cpu") == data
    plain = zlibes_tpu_torch.deflate(data, config=_small(5),
                                     block_size=32768, device="cpu")
    assert len(out) < len(plain), "dictionary should shrink the member"


def test_short_dictionary_zero_run_payload():
    """The 32 KiB context prefix is left-padded for short dictionaries;
    matches into the padding would emit distances the decoder cannot
    serve."""
    sd = b"short dict 123"
    pz = b"\x00\x00\x00\x00" + b"short dict 123 tail" * 4
    out = zlibes_tpu_torch.deflate(pz, dictionary=sd, block_size=4096,
                                   config=_small(), device="cpu")
    d = pyzlib.decompressobj(zdict=sd)
    assert d.decompress(out) == pz


# ---------------------------------------------------------------------------
# backend= and deflate_indexed

def test_backend_refmodel_on_deflate_and_inflate():
    data = RAW[:20000]
    host = zlibes_tpu_torch.deflate(data, backend="refmodel",
                                    block_size=8192)
    assert host == rm.deflate(data, block_size=8192)
    assert pyzlib.decompress(host) == data
    dev = zlibes_tpu_torch.deflate(data, backend="device", block_size=8192,
                                   device="cpu")
    assert dev != host and pyzlib.decompress(dev) == data
    for comp in (host, dev):
        assert zlibes_tpu_torch.inflate(comp, backend="refmodel") == data
        assert zlibes_tpu_torch.inflate(comp, backend="device",
                                        device="cpu") == data
    bad = bytearray(host)
    bad[-1] ^= 1
    with pytest.raises(errors.ChecksumError):
        zlibes_tpu_torch.inflate(bytes(bad), backend="refmodel")
    assert zlibes_tpu_torch.inflate(bytes(bad), backend="refmodel",
                                    verify_checksum=False) == data


def test_backend_refmodel_passes_the_dictionary_on():
    comp = zlibes_tpu_torch.deflate(DATA, backend="refmodel", dictionary=DICT)
    assert comp == rm.deflate(DATA, dictionary=DICT)
    assert pyzlib.decompressobj(zdict=DICT).decompress(comp) == DATA
    assert zlibes_tpu_torch.inflate(comp, backend="refmodel",
                                    dictionary=DICT) == DATA
    with pytest.raises(errors.HeaderError):
        zlibes_tpu_torch.inflate(comp, backend="refmodel")


@pytest.mark.parametrize("fn", ["deflate", "deflate_indexed", "inflate"])
def test_unknown_backend_is_refused(fn):
    for name in ("auto", "tpu", "cuda", ""):
        with pytest.raises(ValueError, match="unknown backend"):
            getattr(zlibes_tpu_torch, fn)(b"abc", backend=name)


def test_backend_refmodel_needs_no_device():
    """The host model runs whatever ``device`` says; the device path checks
    it, at level 0 too."""
    data = b"abc" * 50
    comp = zlibes_tpu_torch.deflate(data, backend="refmodel")
    assert zlibes_tpu_torch.inflate(comp, backend="refmodel") == data
    for kw in (dict(level=0), dict()):
        with pytest.raises(ValueError, match="unsupported device"):
            zlibes_tpu_torch.deflate(data, device="meta", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            zlibes_tpu_torch.deflate(data, level=0)


@pytest.mark.parametrize("backend", ["device", "refmodel"])
def test_deflate_indexed(backend):
    data = RAW[:50000]
    comp, index = zlibes_tpu_torch.deflate_indexed(
        data, backend=backend, block_size=BS, device="cpu")
    assert isinstance(index, StreamIndex)
    assert pyzlib.decompress(comp) == data
    assert index.total_out == len(data)
    assert index.wide == (backend == "device")
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == data
    if backend == "device":
        assert comp == zlibes_tpu_torch.deflate(data, block_size=BS,
                                                device="cpu")
        assert zlibes_tpu_torch.inflate_range(
            comp, index, 16380, 100, device="cpu") == data[16380:16480]
    else:
        assert (comp, index.blocks) == (lambda c, i: (c, i.blocks))(
            *rm.deflate(data, block_size=BS, with_index=True))


def test_deflate_indexed_is_exported():
    assert "deflate_indexed" in zlibes_tpu_torch.__all__
    from zlibes_tpu_torch.codec import api

    assert zlibes_tpu_torch.deflate_indexed is api.deflate_indexed
