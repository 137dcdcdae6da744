"""State carried from the JAX package into the port: an index or a config
the JAX encoder made is rebuilt as the port's own class by
``index_from_reference`` / ``config_from_reference`` (attributes and numpy
arrays only), field by field; handed over unconverted it is refused with a
TypeError at the port's public entry points."""
import dataclasses

import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.config import CodecConfig as JaxCodecConfig
from zlibes_tpu.spec.refmodel import BlockInfo as JaxBlockInfo
from zlibes_tpu.spec.refmodel import StreamIndex as JaxStreamIndex

import zlibes_tpu_torch
from zlibes_tpu_torch import (
    CodecConfig,
    StreamIndex,
    config_from_reference,
    index_from_reference,
)
from zlibes_tpu_torch.spec.refmodel import BlockInfo

torch.set_num_threads(2)

BS = 16384
JCFG = JaxCodecConfig.turbo(candidates=4, probe_words=4)
DATA = (b"the quick brown fox jumps over the lazy dog. " * 1200)[:50000]
_ARRAYS = (("anchor_bit", np.int64), ("anchor_out", np.int64),
           ("anchor_block", np.int32))
_SCALARS = ("self_contained", "chunk_reset", "turbo", "max_tokens", "wide")


def _sub_index(index):
    """Blocks 1.. of a JAX index as a JAX sub-index, rebased as
    ``inflate_range`` rebases them."""
    keep = np.arange(1, len(index.blocks))
    lo = index.blocks[1].out_start
    mask = np.isin(index.anchor_block, keep)
    return JaxStreamIndex(
        [JaxBlockInfo(b.btype, b.bfinal, b.start_bit, b.payload_start_bit,
                      b.end_bit, b.out_start - lo, b.out_len)
         for b in index.blocks[1:]],
        index.anchor_bit[mask], index.anchor_out[mask] - lo,
        (index.anchor_block[mask] - 1).astype(np.int32), True,
        index.chunk_reset, index.turbo, index.max_tokens, index.wide)


@pytest.fixture(scope="module")
def jax_indexes():
    turbo_comp, turbo = dp.deflate(DATA, with_index=True, config=JCFG,
                                   block_size=BS)
    wide_comp, wide = dp.deflate(DATA, with_index=True, block_size=BS)
    assert turbo.turbo and wide.wide
    return {"turbo": (turbo_comp, turbo), "wide": (wide_comp, wide),
            "sub": (wide_comp, _sub_index(wide))}


@pytest.mark.parametrize("kind", ["turbo", "wide", "sub"])
def test_index_from_reference_field_by_field(jax_indexes, kind):
    _, jindex = jax_indexes[kind]
    index = index_from_reference(jindex)
    assert type(index) is StreamIndex and type(jindex) is JaxStreamIndex
    assert len(index.blocks) == len(jindex.blocks) > 0
    for b, jb in zip(index.blocks, jindex.blocks):
        assert type(b) is BlockInfo
        assert dataclasses.astuple(b) == dataclasses.astuple(jb)
    for name, dtype in _ARRAYS:
        got, want = getattr(index, name), getattr(jindex, name)
        assert got.dtype == dtype and np.array_equal(got, want)
        assert not np.shares_memory(got, want)
    for name in _SCALARS:
        assert getattr(index, name) == getattr(jindex, name), name
    assert index.total_out == jindex.total_out
    # a second pass returns the port's object as it is
    assert index_from_reference(index) is index


@pytest.mark.parametrize("kind", ["turbo", "wide"])
def test_index_round_trips_through_the_npz_layout(jax_indexes, kind,
                                                  tmp_path):
    """The sidecar layout is shared: what one package saves the other
    loads."""
    _, jindex = jax_indexes[kind]
    index = index_from_reference(jindex)
    index.save(tmp_path / "port.npz")
    jindex.save(tmp_path / "jax.npz")
    for loaded in (StreamIndex.load(tmp_path / "jax.npz"),
                   index_from_reference(
                       JaxStreamIndex.load(tmp_path / "port.npz"))):
        assert loaded.blocks == index.blocks
        for name, _ in _ARRAYS:
            assert np.array_equal(getattr(loaded, name), getattr(index, name))
        assert [getattr(loaded, n) for n in _SCALARS] == \
            [getattr(index, n) for n in _SCALARS]


@pytest.mark.parametrize("kind", ["turbo", "wide"])
def test_converted_index_decodes(jax_indexes, kind):
    comp, jindex = jax_indexes[kind]
    index = index_from_reference(jindex)
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cpu") == DATA
    assert zlibes_tpu_torch.inflate_range(comp, index, BS - 5, 10,
                                          device="cpu") == DATA[BS - 5:BS + 5]


def test_index_from_reference_reads_any_object_with_the_fields(jax_indexes):
    """Duck typing: no class of the other package is asked for."""
    from types import SimpleNamespace

    _, jindex = jax_indexes["wide"]
    fields = {f.name: getattr(jindex, f.name)
              for f in dataclasses.fields(jindex)}
    fields["blocks"] = [SimpleNamespace(**dataclasses.asdict(b))
                        for b in jindex.blocks]
    fields["anchor_bit"] = list(jindex.anchor_bit)
    index = index_from_reference(SimpleNamespace(**fields))
    assert index.blocks == index_from_reference(jindex).blocks
    assert np.array_equal(index.anchor_bit, jindex.anchor_bit)
    del fields["wide"]
    with pytest.raises(AttributeError, match="wide"):
        index_from_reference(SimpleNamespace(**fields))


@pytest.mark.parametrize("entry", ["inflate", "inflate_range",
                                   "inflate_to_device"])
@pytest.mark.parametrize("kind", ["turbo", "wide"])
def test_unconverted_index_raises_type_error(jax_indexes, kind, entry):
    """The decision: the port does not convert at its boundary; an index of
    another class fails loudly, naming the converter."""
    comp, jindex = jax_indexes[kind]
    with pytest.raises(TypeError, match="index_from_reference"):
        if entry == "inflate":
            zlibes_tpu_torch.inflate(comp, index=jindex, device="cpu")
        elif entry == "inflate_range":
            zlibes_tpu_torch.inflate_range(comp, jindex, 0, 10, device="cpu")
        else:
            zlibes_tpu_torch.inflate_to_device(comp, jindex, device="cpu")


@pytest.mark.parametrize("make", [
    lambda: JCFG, lambda: JaxCodecConfig(),
    lambda: JaxCodecConfig.from_level(9),
    lambda: dataclasses.replace(JCFG, phase1_cache_blocks=2,
                                blocks_per_dispatch=2)],
    ids=["turbo", "default", "level9", "replaced"])
def test_config_from_reference_field_by_field(make):
    jcfg = make()
    cfg = config_from_reference(jcfg)
    assert type(cfg) is CodecConfig and type(jcfg) is JaxCodecConfig
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.pack_row_width() == jcfg.pack_row_width()
    assert config_from_reference(cfg) is cfg


def test_unconverted_config_raises_type_error():
    with pytest.raises(TypeError, match="config_from_reference"):
        zlibes_tpu_torch.deflate(DATA, config=JCFG, block_size=BS,
                                 device="cpu")
    out = zlibes_tpu_torch.deflate(DATA, config=config_from_reference(JCFG),
                                   block_size=BS, device="cpu")
    assert out == dp.deflate(DATA, config=JCFG, block_size=BS)
