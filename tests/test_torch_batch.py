"""Twins, for the PyTorch port, of ``tests/test_dictionary.py``'s two
``compress_batch`` tests: ``zlibes_tpu_torch.parallel.compress_batch``
without a mesh (a world of one in this process) and in a gloo world of 2
ranks (``tests/torch_parallel_worker.py``), members held byte for byte
against the reference's ``zlibes_tpu.parallel.batch.compress_batch`` and
through CPython's ``zlib`` with ``zdict``.
"""
import zlib as pyzlib

import pytest
import torch

import torch_parallel_worker as w

from zlibes_tpu_torch.parallel import compress_batch, decompress_batch

torch.set_num_threads(2)

DICT = w.BATCH_DICT
DATA = b"a lazy dog jumps; the quick brown fox naps " * 30


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return w.run_world("batch", 2, tmp_path_factory.mktemp("batch"))


@pytest.fixture(scope="module")
def ref():
    from zlibes_tpu.parallel import make_mesh
    from zlibes_tpu.parallel.batch import compress_batch as jcompress

    return dict(mesh=jcompress(w.batch_payloads(), DICT, mesh=make_mesh(8)),
                single=jcompress([DATA, b"", b"x", DICT[:100]], DICT,
                                 mesh=make_mesh(1)))


def _oracle(members, payloads):
    for m, p in zip(members, payloads):
        assert pyzlib.decompressobj(zdict=DICT).decompress(m) == p


def test_compress_batch_mesh_broadcast(world, ref):
    payloads = w.batch_payloads()
    res = w.value(world, "batch")
    members = res["members"]
    assert len(members) == len(payloads)
    assert members == ref["mesh"]
    _oracle(members, payloads)
    assert res["back"] == [bytes(p) for p in payloads]


def test_compress_batch_single_device(ref):
    payloads = [DATA, b"", b"x", DICT[:100]]
    members = compress_batch(payloads, DICT, device="cpu")
    assert members == ref["single"]
    _oracle(members, payloads)
    assert decompress_batch(members, DICT, device="cpu") == payloads


def test_compress_batch_world_of_one_equals_world_of_two(world):
    members = compress_batch(w.batch_payloads(), DICT, device="cpu")
    assert members == w.value(world, "batch")["members"]
    assert compress_batch([], DICT, device="cpu") == []
