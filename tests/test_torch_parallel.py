"""Twins, for the PyTorch port, of ``tests/test_parallel.py`` and of
``__graft_entry__.dryrun_multichip``: ``zlibes_tpu_torch.parallel`` in a
gloo world of 8 ranks (the reference's virtual mesh has 8 devices) and in a
world of one in this process, each held byte for byte against the
reference's ``zlibes_tpu.parallel`` on an 8-device mesh (its bytes do not
depend on the mesh size).

The 8 ranks are ``tests/torch_parallel_worker.py`` processes, spawned once
for the module; the reference runs once for the module too.
"""
import zlib as pyzlib

import numpy as np
import pytest
import torch

import torch_parallel_worker as w

import zlibes_tpu_torch
from zlibes_tpu_torch import parallel as P
from zlibes_tpu_torch.codec import deflate_pipeline as dp
from zlibes_tpu_torch.spec import refmodel as rm

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return w.run_world("parallel", 8, tmp_path_factory.mktemp("parallel"))


@pytest.fixture(scope="module")
def ref():
    from zlibes_tpu.parallel import make_mesh, parallel_deflate

    mesh = make_mesh(8)
    dyn, index = parallel_deflate(w.ratio_data(), mesh, block_size=16384,
                                  with_index=True)
    return dict(
        roundtrip=parallel_deflate(w.roundtrip_data(), mesh, block_size=2048,
                                   seg_size=256),
        adler=parallel_deflate(w.adler_data(), mesh, block_size=1024,
                               seg_size=256),
        dynamic=dyn, index=index,
        fixed=parallel_deflate(w.ratio_data(), mesh, block_size=16384,
                               dynamic=False),
        dryrun=parallel_deflate(w.dryrun_data()[0], mesh, block_size=2048,
                                seg_size=256),
    )


def _mesh1():
    return P.make_mesh(1, device="cpu")


def test_parallel_deflate_roundtrip(world, ref):
    data = w.roundtrip_data()
    comp = w.value(world, "roundtrip")
    assert comp == ref["roundtrip"]
    assert pyzlib.decompress(comp) == data
    assert rm.inflate(comp) == data


def test_parallel_deflate_adler_psum(world, ref):
    """The Adler-32 trailer summed over the ranks is the canonical value."""
    comp = w.value(world, "adler")
    assert comp == ref["adler"]
    assert int.from_bytes(comp[-4:], "big") == pyzlib.adler32(w.adler_data())


def test_parallel_inflate_matches(world):
    assert w.value(world, "inflate_generic") == w.generic_data()


def test_parallel_single_device_mesh():
    """A world of one without a process group (the one-card case)."""
    from zlibes_tpu.parallel import make_mesh, parallel_deflate

    data = b"single device mesh " * 100
    comp = P.parallel_deflate(data, _mesh1(), block_size=1024, seg_size=256)
    assert pyzlib.decompress(comp) == data
    assert comp == parallel_deflate(data, make_mesh(1), block_size=1024,
                                    seg_size=256)


def test_parallel_dynamic_deflate_ratio(world, ref):
    """One shared table pair from the histograms summed over the ranks:
    clearly smaller than fixed tables, near the per-block-table encoder."""
    import dataclasses

    data = w.ratio_data()
    res = w.value(world, "ratio")
    comp_dyn, comp_fix = res["dynamic"], res["fixed"]
    assert comp_dyn == ref["dynamic"] and comp_fix == ref["fixed"]
    assert pyzlib.decompress(comp_dyn) == data
    assert pyzlib.decompress(comp_fix) == data
    assert len(comp_dyn) < len(comp_fix) * 0.92
    cfg = dataclasses.replace(zlibes_tpu_torch.CodecConfig(),
                              blocks_per_dispatch=4)
    single = dp.deflate(data, block_size=16384, config=cfg, device="cpu")
    assert len(comp_dyn) <= len(single) * 1.10


def test_parallel_dynamic_index_equals_reference(world, ref):
    """parallel_deflate(with_index=True) of dynamic tables: the index
    arrays are the reference's, and the index drives parallel_inflate."""
    res = w.value(world, "ratio")
    got, want = res["index"], rm.index_from_reference(ref["index"])
    assert got["blocks"] == [tuple(vars(b).values()) for b in want.blocks]
    for name in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(got[name], getattr(want, name)), name
    assert (got["turbo"], got["chunk_reset"], got["max_tokens"]) == (
        want.turbo, want.chunk_reset, want.max_tokens)
    assert res["inflated"] == w.ratio_data()


def test_dryrun_multichip_round_trips(world, ref):
    """The four round trips of ``__graft_entry__.dryrun_multichip``: the
    block-parallel deflate, the generic, turbo and wide inflates."""
    data, data3 = w.dryrun_data()
    res = w.value(world, "dryrun")
    assert res["deflate"] == ref["dryrun"]
    assert res["deflate_back"] == data
    assert res["generic"] == data
    assert res["turbo_back"] == data3 and res["turbo_inflate"] == data3
    assert res["wide"] == data3


@pytest.mark.parametrize("case", ["roundtrip", "adler"])
def test_world_of_one_equals_reference(case, ref):
    data = {"roundtrip": w.roundtrip_data, "adler": w.adler_data}[case]()
    kw = {"roundtrip": dict(block_size=2048, seg_size=256),
          "adler": dict(block_size=1024, seg_size=256)}[case]
    assert P.parallel_deflate(data, _mesh1(), **kw) == ref[case]


def test_last_timings_keys():
    P.LAST_TIMINGS.clear()
    comp = P.parallel_deflate(w.adler_data(), _mesh1(), block_size=1024,
                              seg_size=256)
    assert pyzlib.decompress(comp) == w.adler_data()
    assert {"host_stage", "dispatch", "readback", "host_splice",
            "dispatches"} <= set(P.LAST_TIMINGS)
    assert "collective" not in P.LAST_TIMINGS    # no group, no collective


def test_make_mesh_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        P.make_mesh(device="cuda")


def test_make_mesh_of_many_needs_a_group():
    with pytest.raises(ValueError, match="process group"):
        P.make_mesh(8, device="cpu")


def test_parallel_inflate_refuses_reference_index():
    from zlibes_tpu.spec import refmodel as jrm

    comp, jindex = jrm.deflate(w.generic_data(), block_size=4096,
                               with_index=True, anchor_every=1024)
    with pytest.raises(TypeError, match="index_from_reference"):
        P.parallel_inflate(comp, jindex, _mesh1())
    index = rm.index_from_reference(jindex)
    assert P.parallel_inflate(comp, index, _mesh1()) == w.generic_data()


@pytest.mark.parametrize("with_index", [False, True])
def test_parallel_deflate_of_no_bytes_equals_reference(with_index):
    from zlibes_tpu.parallel import make_mesh, parallel_deflate

    got = P.parallel_deflate(b"", _mesh1(), with_index=with_index)
    want = parallel_deflate(b"", make_mesh(1), with_index=with_index)
    if with_index:
        index = rm.index_from_reference(want[1])
        assert got[0] == want[0] and got[1].blocks == index.blocks
        assert got[1].total_out == 0
        got = got[0]
    assert pyzlib.decompress(got) == b""
